"""The angular eigen-kernel's arithmetic on the CPU: the host build of
``qnmfits_tpu_torch/csrc/angular_eig.cu`` (the same functions, one lane
doing a warp's work) and the port's plain versions
(``ops/eig_cuda.eigvals_plain``, ``eigpair_plain``) against the JAX
package's ``spectrum/solver._batched_angular_eig`` + ``_select_eig`` on the
same c, and the solver's track of (5,2,8) with its eig run by the host
build against the JAX package's ``track_mode``.

The source is compiled with g++ into the test's temporary directory,
without contraction (``-ffp-contract=off``), as nvcc builds it for the
card (``-fmad=false``).  Bars: every eigenvalue matched as a set within
1e-12 max(1, ||M||_F); the selected eigenvalue the one the JAX package
selects; the selected vector within 1e-10 after the phase rule, its
residual ||M v - A v|| within 1e-13 ||M||_F.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import solver as jsolver
from qnmfits_tpu.spectrum.angular import angular_matrix
from qnmfits_tpu_torch.ops import eig_cuda
from qnmfits_tpu_torch.spectrum import solver
from qnmfits_tpu_torch.spectrum.angular import lmin
from qnmfits_tpu_torch.spectrum.tables import table_path
from qnmfits_tpu_torch.testing import eig_matching

EIG_TOL = 1e-12
VEC_TOL = 1e-10
RES_TOL = 1e-13
# nl: a single entry, a 2 x 2, the solver's orders (25 for (2,2,n), 28
# for (5,2,8), 34 for (11,2,0)), two warps' worth, and past the card's
# shared memory (a warp's matrix in the global workspace there).
NLS = (1, 2, 5, 25, 28, 34, 64)
NL_GLOBAL = 130


@pytest.fixture(scope="module")
def host_eig(tmp_path_factory):
    """The host build's entry, as f(s, m, c, nl, guess=None, sel=0,
    max_its=None) -> (eigenvalues (B, nl), A (B,), C (B, nl), info (B,
    2)); A and C None without a guess."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host twin")
    lib_path = tmp_path_factory.mktemp("eig_host") / "libangular_eig_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-ffp-contract=off",
                    "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(eig_cuda.SOURCE)],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib_path)).qnm_angular_eig_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int

    def run(s, m, c, nl, guess=None, sel=0, max_its=None):
        c = np.ascontiguousarray(np.atleast_1d(c), dtype=complex)
        B = c.shape[0]
        band = np.ascontiguousarray(eig_cuda.bands(s, m, nl))
        eig = np.empty((B, nl), complex)
        info = np.empty((B, 2), np.int64)
        A = C = None
        if guess is not None:
            guess = np.ascontiguousarray(np.broadcast_to(guess, (B,)),
                                         dtype=complex)
            A, C = np.empty(B, complex), np.empty((B, nl), complex)

        def p(x):
            return None if x is None else x.ctypes.data

        cap = eig_cuda.max_iterations(nl) if max_its is None else max_its
        rc = fn(B, nl, s, sel, cap, p(c), p(guess), p(band), p(eig), p(A),
                p(C), p(info))
        assert rc == 0
        return eig, A, C, info

    return run


def _jax_mats(s, m, c, nl):
    return np.stack([angular_matrix(s, m, ci, nl) for ci in c])


def _held_values(eig, info, ref, mats):
    """Every matrix solved, its eigenvalues ref's (B, nl) as a set; returns
    the matching (``eig_matching``'s perm)."""
    assert (info[:, 0] >= 0).all()
    fro = np.linalg.norm(mats, axis=(1, 2))
    perm, gap = eig_matching(eig, ref)
    assert np.all(gap <= EIG_TOL * np.maximum(1.0, fro)), gap.max()
    return perm


def _pair_case(host_eig, s, l, m, c, nl, guess):
    """Both modes of the host build on c against the JAX package's
    _batched_angular_eig + _select_eig: the eigenvalues as a set, the
    selection (the eigenvalue JAX selects), the vector and its
    residual."""
    mats = _jax_mats(s, m, c, nl)
    fro = np.linalg.norm(mats, axis=(1, 2))
    A_all, C_all = jsolver._batched_angular_eig(s, m, c, nl)
    Aj, Cj = jsolver._select_eig(A_all, C_all, guess, l, m, s)
    kj = np.argmin(np.abs(A_all - guess[:, None]), axis=1)
    eig, A, C, info = host_eig(s, m, c, nl, guess, l - lmin(s, m))
    perm = _held_values(eig, info, A_all, mats)
    k = np.argmin(np.abs(eig - guess[:, None]), axis=1)
    rows = np.arange(len(c))
    assert np.array_equal(perm[rows, k], kj)
    assert np.array_equal(A, eig[rows, k])
    assert np.all(np.abs(A - Aj) <= EIG_TOL * np.maximum(1.0, fro))
    assert np.max(np.abs(C - Cj)) <= VEC_TOL
    res = np.linalg.norm(np.einsum("bij,bj->bi", mats, C) - A[:, None] * C,
                         axis=1)
    assert np.all(res <= RES_TOL * fro)
    return info


def _well_posed_guess(s, l, m, c, nl, rng):
    """A guess near the eigenvalue whose vector has the largest entry
    l - lmin: where that entry is ~1e-16 (the other parity of an s = 0
    matrix), the phase rule has no answer."""
    A_all, C_all = np.linalg.eig(_jax_mats(s, m, c, nl))
    k = np.argmax(np.abs(C_all[:, l - lmin(s, m), :]), axis=1)
    A = A_all[np.arange(len(c)), k]
    return A + 1e-3 * (rng.random(len(c)) - 0.5)


@pytest.mark.parametrize("m", range(-3, 4))
@pytest.mark.parametrize("s", [-2, -1, 0])
def test_host_twin_matches_jax_random_c(host_eig, s, m):
    """Random c with |c| up to 5 at every order of NLS, both modes."""
    rng = np.random.default_rng(100 * (s + 2) + m + 7)
    for nl in NLS:
        c = 5.0 * rng.random(6) * np.exp(2j * np.pi * rng.random(6))
        l = lmin(s, m) + min(2, nl - 1)
        mats = _jax_mats(s, m, c, nl)
        eig, _, _, info = host_eig(s, m, c, nl)
        _held_values(eig, info, np.linalg.eigvals(mats), mats)
        _pair_case(host_eig, s, l, m, c, nl,
                   _well_posed_guess(s, l, m, c, nl, rng))


@pytest.mark.parametrize("s,m", [(-2, 2), (0, -1)])
def test_host_twin_past_shared_memory(host_eig, s, m):
    """An order whose warp memory passes the card's shared memory (the
    global workspace's layout, which is the shared one's)."""
    assert eig_cuda.warp_bytes(NL_GLOBAL) > eig_cuda.SMEM_BYTES_LIMIT
    rng = np.random.default_rng(NL_GLOBAL + m)
    c = 3.0 * rng.random(2) * np.exp(2j * np.pi * rng.random(2))
    l = lmin(s, m) + 3
    _pair_case(host_eig, s, l, m, c, NL_GLOBAL,
               _well_posed_guess(s, l, m, c, NL_GLOBAL, rng))


def _table_c(l, m, n):
    """c = chi omega (M = 1 units) along a tracked row of the s = -2 table,
    every 25th spin and the last, and the extremal 0.9999 from the last
    omega; A along the row."""
    with np.load(table_path(-2)) as z:
        keys = [tuple(k) for k in z["keys"]]
        row = keys.index((l, m, n))
        chi, w, A = z["chi"], z["omega"][row], z["A"][row]
    sel = np.r_[np.arange(0, len(chi), 25), len(chi) - 1]
    c = np.r_[chi[sel] * w[sel], 0.9999 * w[-1]]
    return c, np.r_[A[sel], A[-1]]


@pytest.mark.parametrize("l,m,n", [(2, 2, 0), (2, 2, 7), (2, -2, 7)])
def test_host_twin_on_tracked_rows(host_eig, l, m, n):
    """c along the baked tracks, chi 0 to 0.9999 (Im c up to ~2.4 for
    the n = 7 overtones), the guess each spin's A."""
    c, A = _table_c(l, m, n)
    nl = l - lmin(-2, m) + 1 + 24
    _pair_case(host_eig, -2, l, m, c, nl, A)


def test_host_twin_on_on_demand_modes(host_eig, track_528):
    """c along the JAX package's (5,2,8) track (nl = 28) and at the
    (11,2,0) pin (chi = 0.68; nl = 34)."""
    chi, w, A, _, _ = track_528
    _pair_case(host_eig, -2, 5, 2, chi * w, 28, A)
    c11 = 0.68 * (2.3864244708 - 0.0906875519j)
    A_all = np.linalg.eigvals(angular_matrix(-2, 2, c11, 34))
    A11 = A_all[np.argmin(np.abs(A_all - (11 * 12 - 2 - c11 ** 2 / 2)))]
    _pair_case(host_eig, -2, 11, 2, np.array([c11, 0.0]), 34,
               np.array([A11, 11 * 12 - 2.0]))


@pytest.mark.parametrize("m", range(-3, 4))
@pytest.mark.parametrize("s", [-2, -1, 0])
def test_host_twin_at_c_zero_is_exact(host_eig, s, m):
    """At c = 0 the matrix is diagonal: every eigenvalue is the integer
    l(l+1) - s(s+1) exactly, each deflated at once with no sweep."""
    nl = 28
    eig, _, _, info = host_eig(s, m, np.zeros(3), nl)
    ls = lmin(s, m) + np.arange(nl)
    exact = (ls * (ls + 1) - s * (s + 1)).astype(complex)
    assert np.array_equal(np.sort_complex(eig[0]), np.sort_complex(exact))
    assert (info == 0).all()


def test_host_twin_mixed_batch(host_eig):
    """Converged (c = 0), easy and hard elements (|c| to 20, large Im c)
    in one batch: each as in a batch of its own, all held to JAX."""
    rng = np.random.default_rng(5)
    c = np.r_[0.0, 0.1 + 0.01j, 20.0 * np.exp(-1.2j), 3.0 - 2.5j,
              15.0 * rng.random(4) * np.exp(2j * np.pi * rng.random(4))]
    s, m, l, nl = -2, 2, 2, 25
    guess = _well_posed_guess(s, l, m, c, nl, rng)
    eig, A, C, info = host_eig(s, m, c, nl, guess, 0)
    _pair_case(host_eig, s, l, m, c, nl, guess)
    assert info[0, 0] == 0 and info[2, 0] > info[1, 0]
    for b in range(len(c)):
        e1, A1, C1, _ = host_eig(s, m, c[b:b + 1], nl, guess[b:b + 1], 0)
        assert np.array_equal(e1[0], eig[b]) and A1[0] == A[b]
        assert np.array_equal(C1[0], C[b])


def test_iteration_cap_raises(host_eig):
    """A cap the QR iteration cannot meet marks the matrix (info -1), and
    the wrapper's check raises on it; a non-finite c marks -2."""
    c = np.array([0.0, 2.0 - 1.0j])
    _, _, _, info = host_eig(-2, 2, c, 25, max_its=0)
    assert info[0, 0] == 0 and info[1, 0] == -1
    with pytest.raises(RuntimeError, match="did not converge within 0"):
        eig_cuda.check_info(torch.as_tensor(info), torch.as_tensor(c), -2, 2,
                            25, 0)
    _, _, _, info = host_eig(-2, 2, np.array([np.nan + 0j]), 25)
    assert info[0, 0] == -2
    with pytest.raises(RuntimeError, match="not finite"):
        eig_cuda.check_info(torch.as_tensor(info),
                            torch.as_tensor([np.nan + 0j]), -2, 2, 25, 750)
    eig_cuda.check_info(torch.as_tensor(host_eig(-2, 2, c, 25)[3]),
                        torch.as_tensor(c), -2, 2, 25, 750)


def test_host_twin_counts_its_operations(host_eig):
    """info's second column, the FP64 operations of the kernel's loops
    (the bound's count): a 2 x 2's sweep is one rotation updating 4 pairs
    (20 each); an order-n reduction's step k updates its 2n - k - 1 rows
    and columns with a reflector of len_k = min(k + 2, n - k - 1) entries
    (16 len_k + 6 a row or column), each rotation 20 a pair; vectors mode
    adds the band LU's and its three solves' multiply-adds (8 each)."""
    rng = np.random.default_rng(3)
    c = 3.0 * rng.random(6) * np.exp(2j * np.pi * rng.random(6))
    eig, _, _, info = host_eig(-2, 2, c, 2)
    assert np.all(info[:, 0] > 0)
    assert np.array_equal(info[:, 1], 80 * info[:, 0])
    n = 28
    eig, _, _, info = host_eig(-2, 2, c, n)
    hess = sum((2 * n - k - 1) * (16 * min(k + 2, n - k - 1) + 6)
               for k in range(n - 2))
    sweeps = info[:, 1] - hess
    # Each sweep runs at least one rotation of at least 4 pairs.
    assert np.all(sweeps % 20 == 0) and np.all(sweeps >= 80 * info[:, 0])
    lo = [min(k + 2, n - 1) - k for k in range(n)]
    up = [min(k + 4, n - 1) - k for k in range(n)]
    lu = sum(8 * a * b + 3 * 8 * (a + b) for a, b in zip(lo, up))
    _, _, _, info_v = host_eig(-2, 2, c, n, eig[:, 3], 0)
    assert np.array_equal(info_v[:, 0], info[:, 0])
    assert np.array_equal(info_v[:, 1] - info[:, 1], np.full(len(c), lu))


@pytest.mark.parametrize("s,l,m", [(-2, 2, 2), (-2, 4, -3), (-1, 1, 0),
                                   (0, 3, 1)])
def test_plain_matches_jax(s, l, m):
    """The plain versions (the CPU path of the wrappers) against the JAX
    package's eig and selection."""
    rng = np.random.default_rng(11 + l)
    nl = l - lmin(s, m) + 1 + 24
    c = 4.0 * rng.random(8) * np.exp(2j * np.pi * rng.random(8))
    guess = _well_posed_guess(s, l, m, c, nl, rng)
    A_all, C_all = jsolver._batched_angular_eig(s, m, c, nl)
    Aj, Cj = jsolver._select_eig(A_all, C_all, guess, l, m, s)
    fro = np.linalg.norm(_jax_mats(s, m, c, nl), axis=(1, 2))
    ev = eig_cuda.angular_eigvals(s, m, torch.as_tensor(c), nl).numpy()
    _, gap = eig_matching(ev, A_all)
    assert np.all(gap <= EIG_TOL * np.maximum(1.0, fro))
    A, C = eig_cuda.angular_eigpair(s, l, m, torch.as_tensor(c), nl,
                                    torch.as_tensor(guess))
    assert np.all(np.abs(A.numpy() - Aj) <= EIG_TOL * np.maximum(1.0, fro))
    assert np.max(np.abs(C.numpy() - Cj)) <= VEC_TOL
    assert eig_cuda.launches == 0


# The short track of (5,2,8): spins to 0.9 (every point on the fine
# grid's first tier), shallow CF depths, the same in both packages.
TRACK_CHI = np.linspace(0.0, 0.9, 9)
TRACK_KW = dict(s=-2, coarse_stride=4, N_coarse=600, N_fine=1200)


@pytest.fixture(scope="module")
def track_528():
    """The JAX package's (5,2,8) on TRACK_CHI: (chi, omega, A, C)."""
    w0 = jsolver.schwarzschild_seeds(l_max=5, n_max=8, s=-2, N=1200,
                                     n_max_low_l=0)[(5, 8)]
    w, A, C = jsolver.track_mode(5, 2, 8, w0, TRACK_CHI, **TRACK_KW)
    return TRACK_CHI, w, A, C, w0


def test_track_528_with_host_twin_matches_jax(host_eig, track_528,
                                              monkeypatch):
    """The port's track_mode of (5,2,8) on the CPU with every angular
    eigenproblem run by the host build of the kernel (values mode for
    Newton, vectors mode at each tier's end) against the JAX package's:
    omega and A within 1e-11, C within 1e-10."""
    chi, wj, Aj, Cj, w0 = track_528
    calls = {"values": 0, "vectors": 0}

    def eigvals(s, m, c, nl):
        calls["values"] += 1
        return torch.as_tensor(host_eig(s, m, c.numpy(), nl)[0])

    def eigpair(s, l, m, c, nl, guess):
        calls["vectors"] += 1
        _, A, C, _ = host_eig(s, m, c.numpy(), nl, guess.numpy(),
                              l - lmin(s, m))
        return torch.as_tensor(A), torch.as_tensor(C)

    monkeypatch.setattr(solver, "angular_eigvals", eigvals)
    monkeypatch.setattr(solver, "angular_eigpair", eigpair)
    w, A, C = solver.track_mode(5, 2, 8, w0, chi, device="cpu", **TRACK_KW)
    assert calls["values"] > 0 and calls["vectors"] > 0
    assert np.max(np.abs(w - wj)) <= 1e-11
    assert np.max(np.abs(A - Aj)) <= 1e-11
    assert np.max(np.abs(C - Cj)) <= 1e-10
