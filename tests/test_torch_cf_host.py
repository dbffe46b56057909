"""The Leaver CF kernel's arithmetic on the CPU: the host build of
``qnmfits_tpu_torch/csrc/leaver_cf.cu`` (the same segments and the same
pairwise combine as a team of threads on the card, run serially) against
the port's plain version ``ops/cf_cuda.cf_parts``, the JAX package's
``spectrum/solver._cf_vec_a`` and its 80-bit native CF
(``spectrum/csrc/cf_kernel.cpp``).

The source is compiled with g++ into the test's temporary directory,
without contraction (``-ffp-contract=off``), as nvcc builds it for the
card (``-fmad=false``); the kernel writes its loop's fused multiply-adds
out, so both builds round alike.  Bound: 1e-12 of |U| + |T| (near a root
U - T cancels, so the residual is no scale), the card's ``CF_TOL``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import solver as jsolver
from qnmfits_tpu_torch.ops import cf_cuda

TOL = 1e-12
# The kernel's arithmetic against the 80-bit CF: its host build reads
# <= 2.8e-14 of |U| + |T| on S1's distribution and <= 1.8e-14 at the
# solver's deep tiers near extremal spin (scripts/torch_cf_teams.py
# --host).
TOL_80 = 1e-13
CF_80 = (Path(jsolver.__file__).parent / "csrc" / "cf_kernel.cpp")


def _build(tmp_path_factory, source, name, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host twin")
    lib_path = tmp_path_factory.mktemp("cf_host") / name
    subprocess.run([gxx, *flags, "-O2", "-shared", "-fPIC", "-o",
                    str(lib_path), str(source)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def host_cf(tmp_path_factory):
    """The host build's entry, as f(w, a, A, n_inv, N, team) -> (U - T,
    |U| + |T|) for s = -2, m = 2."""
    lib = _build(tmp_path_factory, cf_cuda.SOURCE, "libleaver_cf_host.so",
                 "-x", "c++", "-std=c++17", "-ffp-contract=off")
    fn = lib.qnm_leaver_cf_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(w, a, A, n_inv, N, team):
        B = len(w)
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        out = np.empty((3, B))
        rc = fn(B, *(x.ctypes.data for x in ins), ni.ctypes.data, -2, 2, N,
                team, *(o.ctypes.data for o in out))
        if rc:
            raise ValueError(f"host twin refused N={N}, team={team}")
        return out[0] + 1j * out[1], out[2]

    return run


@pytest.fixture(scope="module")
def cf_80(tmp_path_factory):
    """The JAX package's 80-bit CF (U - T) for s = -2, m = 2, built from
    its source into the test's temporary directory."""
    lib = _build(tmp_path_factory, CF_80, "libcf_kernel_80.so")
    fn = lib.radial_cf_batch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = None

    def run(w, a, A, n_inv, N):
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        out = np.empty((2, len(w)))
        fn(len(w), *(x.ctypes.data for x in ins), -2, 2, ni.ctypes.data, N,
           out[0].ctypes.data, out[1].ctypes.data)
        return out[0] + 1j * out[1]

    return run


def _cf_inputs(B, seed, n_inv_max=8):
    """Phase 12's S1 distribution: omega (Leaver units), spins to chi =
    0.999, A near real modes, n_inv 0..n_inv_max."""
    rng = np.random.default_rng(seed)
    w = 2.0 * (0.3 + 0.6 * rng.random(B) - 1j * (0.05 + 0.6 * rng.random(B)))
    a = 0.5 * 0.999 * rng.random(B)
    A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
    return w, a, A, rng.integers(0, n_inv_max + 1, B)


def _plain(w, a, A, n_inv, N):
    U, T = cf_cuda.cf_parts(torch.as_tensor(w), torch.as_tensor(a),
                            torch.as_tensor(A), -2, 2,
                            torch.as_tensor(n_inv), N)
    return (U - T).numpy(), (U.abs() + T.abs()).numpy()


def _jax(w, a, A, n_inv, N):
    """The JAX package's NumPy CF, one call per inversion count."""
    out = np.empty(len(w), complex)
    for n in np.unique(n_inv):
        sel = n_inv == n
        out[sel] = jsolver._cf_vec_a(w[sel], a[sel], A[sel], -2, 2, int(n),
                                     N)
    return out


# (B, N, largest n_inv): B = 2 is the coarse continuation's launch; 1001
# and 4000 are depths no team of 32 or 256 divides; with 256 threads a
# segment is 2-16 steps, so n_inv up to 8 or 20 reaches past the first
# segments, and with 32 it stays inside the first.
CASES = [(2, 2000, 8), (17, 300, 8), (12, 1001, 20), (9, 4000, 8)]


@pytest.mark.parametrize("team", [1, 32, 256])
@pytest.mark.parametrize("B,N,n_inv_max", CASES)
def test_host_twin_matches_plain_and_jax(host_cf, team, B, N, n_inv_max):
    w, a, A, n_inv = _cf_inputs(B, seed=N + team, n_inv_max=n_inv_max)
    f, scale = host_cf(w, a, A, n_inv, N, team)
    ref, ref_scale = _plain(w, a, A, n_inv, N)
    assert np.max(np.abs(f - ref) / ref_scale) <= TOL
    assert np.max(np.abs(scale - ref_scale) / ref_scale) <= TOL
    jax_ref = _jax(w, a, A, n_inv, N)
    assert np.max(np.abs(f - jax_ref) / ref_scale) <= TOL


# (B, seed, N, largest n_inv): S1's distribution, and the inputs of
# tests/test_torch_cuda.py::test_cf_kernel_every_team_agrees, where near
# chi = 0.998 the plain version's serial recursion is 2.5e-13 off.
CASES_80 = [(200, 5, 2000, 8), (24, 256, 3001, 20)]


@pytest.mark.parametrize("team", [1, 32, 256])
@pytest.mark.parametrize("B,seed,N,n_inv_max", CASES_80)
def test_host_twin_matches_the_80_bit_cf(host_cf, cf_80, team, B, seed, N,
                                         n_inv_max):
    w, a, A, n_inv = _cf_inputs(B, seed=seed, n_inv_max=n_inv_max)
    f, scale = host_cf(w, a, A, n_inv, N, team)
    assert np.max(np.abs(f - cf_80(w, a, A, n_inv, N)) / scale) <= TOL_80


def _near_extremal(B, seed):
    """S1's distribution with spins at chi = 0.998-0.9995, n_inv 0..20."""
    w, _, A, n_inv = _cf_inputs(B, seed, n_inv_max=20)
    a = 0.5 * (0.998 + 0.0015 * np.random.default_rng(seed + 1).random(B))
    return w, a, A, n_inv


@pytest.fixture(scope="module")
def deep_refs(cf_80):
    """(inputs, 80-bit CF, plain U - T, |U| + |T|) at (B, N), each formed
    once (the plain version takes seconds at these depths)."""
    cache = {}

    def get(B, N):
        if (B, N) not in cache:
            w, a, A, n_inv = _near_extremal(B, seed=N)
            ref, scale = _plain(w, a, A, n_inv, N)
            cache[B, N] = ((w, a, A, n_inv), cf_80(w, a, A, n_inv, N), ref,
                           scale)
        return cache[B, N]

    return get


# The solver's depths near extremal spin (spectrum/solver.py track_mode):
# the tier 16384, its retries at 3x and 9x the depth, and a few elements at
# 27x; the teams plan() gives such launches (8 at the largest batches, 256
# at the retries' pairs).  Here the FP64 coefficients alone move the
# residual up to a few 1e-13 of |U| + |T| from the 80-bit CF, the plain
# version's serial recursion as much: the kernel may add at most TOL_80 to
# the plain version's own error there, and stays within TOL of it.
DEEP = [(6, 16384), (6, 49152), (6, 147456), (2, 442368)]


@pytest.mark.parametrize("team", [8, 32, 256])
@pytest.mark.parametrize("B,N", DEEP)
def test_host_twin_at_the_solvers_deep_tiers(host_cf, deep_refs, team, B, N):
    (w, a, A, n_inv), ref_80, ref, scale = deep_refs(B, N)
    f, _ = host_cf(w, a, A, n_inv, N, team)
    plain_err = np.abs(ref - ref_80) / scale
    assert np.all(np.abs(f - ref_80) / scale <= plain_err + TOL_80)
    assert np.max(np.abs(f - ref) / scale) <= TOL


@pytest.mark.parametrize("team", [1, 32, 256])
def test_host_twin_without_backward_steps(host_cf, team):
    """n_inv at or past N: the product is empty and T is the tail's start,
    as in the plain version."""
    N = 40
    w, a, A, _ = _cf_inputs(4, seed=7)
    n_inv = np.array([N, N + 3, N - 1, 0])
    f, scale = host_cf(w, a, A, n_inv, N, team)
    ref, ref_scale = _plain(w, a, A, n_inv, N)
    assert np.max(np.abs(f - ref) / ref_scale) <= TOL
    assert np.max(np.abs(scale - ref_scale) / ref_scale) <= TOL


def test_host_twin_at_the_deepest_depth(host_cf):
    """At the card's depth limit the rescaled products stay finite and
    every team agrees with the serial product (team 1)."""
    w, a, A, n_inv = _cf_inputs(2, seed=11)
    f1, s1 = host_cf(w, a, A, n_inv, cf_cuda.MAX_N, 1)
    assert np.all(np.isfinite(f1)) and np.all(np.isfinite(s1))
    for team in (32, 1024):
        f, _ = host_cf(w, a, A, n_inv, cf_cuda.MAX_N, team)
        assert np.max(np.abs(f - f1) / s1) <= TOL


def test_host_twin_refuses_what_the_kernel_refuses(host_cf):
    w, a, A, n_inv = _cf_inputs(2, seed=3)
    for N, team in ((0, 32), (cf_cuda.MAX_N + 1, 32), (100, 0)):
        with pytest.raises(ValueError, match="refused"):
            host_cf(w, a, A, n_inv, N, team)


@pytest.mark.parametrize("sm_count", [1, 132])
def test_plan_fills_the_card_with_segments_kept(sm_count):
    """The wrapper's team: a power of two of TEAMS, no smaller as B falls,
    and either one thread or a team whose half would leave the SMs short of
    THREADS_PER_SM, with at least MIN_SEGMENT steps a thread."""
    want = cf_cuda.THREADS_PER_SM * sm_count
    for N in (300, 2000, 8192, 32768):
        last = None
        for B in (4096, 792, 400, 17, 2, 1):
            team, segment = cf_cuda.plan(B, N, sm_count)
            assert team in cf_cuda.TEAMS and segment == -(-N // team)
            if team > 1:
                assert B * team // 2 < want
                assert segment >= cf_cuda.MIN_SEGMENT
            assert last is None or team >= last
            last = team
    # The solver's shapes on an H100's 132 SMs: the coarse continuation's
    # pair, F1's largest grid launch, S1's largest batch.
    assert cf_cuda.plan(2, 2000, 132) == (128, 16)
    assert cf_cuda.plan(792, 8192, 132) == (64, 128)
    assert cf_cuda.plan(4096, 2000, 132) == (8, 250)
    assert cf_cuda.plan(4096, 32768, 132) == (8, 4096)
