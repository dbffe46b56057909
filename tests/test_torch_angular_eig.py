"""The angular eigen-kernel's arithmetic on the CPU: the host build of
``qnmfits_tpu_torch/csrc/angular_eig.cu`` (the same functions, one lane
doing a warp's work) and the port's plain versions
(``ops/eig_cuda.eigvals_plain``, ``eigpair_plain``) against the JAX
package's ``spectrum/solver._batched_angular_eig`` + ``_select_eig`` on the
same c, and the solver's track of (5,2,8) with its eig run by the host
build against the JAX package's ``track_mode``.  The card's own code path
of the source (its lanes' split of each sweep step, shuffles, votes and
barriers) runs on host threads, one a lane (``_LANES_SHIM``), and must
give the host build's results bit for bit.

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
# Orders 1-4, and either side of 32, where a lane first takes two entries.
NLS_EDGE = (1, 2, 3, 4, 31, 32, 33)


def _entry(fn, team=None):
    """A Python face for a C entry of the host builds' signature (with
    ``team``, the entry that takes the warps a matrix last):
    f(s, m, c, nl, guess=None, sel=0, max_its=None) ->
    (eigenvalues (B, nl), A (B,), C (B, nl), info (B, 2)); A and C None
    without a guess."""
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 7
                   + ([ctypes.c_int] if team is not None else []))
    fn.restype = ctypes.c_int
    tail = () if team is None else (team,)

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
                p(C), p(info), *tail)
        assert rc == 0
        return eig, A, C, info

    return run


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host twin")
    return gxx


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The host build of the source (g++)."""
    lib_path = tmp_path_factory.mktemp("eig_host") / "libangular_eig_host.so"
    subprocess.run([_gxx(), "-x", "c++", "-std=c++17", "-ffp-contract=off",
                    "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(eig_cuda.SOURCE)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def host_eig(host_lib):
    """The host build's entry (``_entry``), one warp a matrix."""
    return _entry(host_lib.qnm_angular_eig_host)


@pytest.fixture(scope="module")
def host_eig_team(host_lib):
    """The host build with a team of two warps a matrix: its QR iterations
    on two bulges in the order of the card's ticks."""
    return _entry(host_lib.qnm_angular_eig_host_team, team=2)


# The card's code path of the source on the host: __CUDA_ARCH__ defined,
# one host thread a lane, __syncwarp a barrier of the warp's 32 threads
# (which aborts after two minutes: a lane that skipped one), and the
# shuffles and votes through a slot a lane and a barrier.
_LANES_SHIM = r"""
#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
struct QnmWarp {
  std::atomic<int> count{0}, gen{0};
  int size = 32;
  double slot[2][32];
  bool flag[2][32];
  void sync() {
    const int g = gen.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == size - 1) {
      count.store(0, std::memory_order_relaxed);
      gen.fetch_add(1, std::memory_order_release);
      return;
    }
    const auto t0 = std::chrono::steady_clock::now();
    for (long spins = 1; gen.load(std::memory_order_acquire) == g; ++spins) {
      if (spins % 64) continue;
      std::this_thread::yield();
      if (spins % 65536 == 0 &&
          std::chrono::steady_clock::now() - t0 > std::chrono::seconds(120)) {
        std::fprintf(stderr, "a lane barrier timed out\n");
        std::abort();
      }
    }
  }
};
static thread_local QnmWarp* qnm_warp;
static thread_local QnmWarp* qnm_team;
static thread_local int qnm_lane, qnm_parity;
#define __CUDA_ARCH__ 900
#define QNM_TEAM_BAR(id) qnm_team->sync()
#define __device__
#define __host__
#define __forceinline__
static inline void __syncwarp() { qnm_warp->sync(); }
// A shuffle or a vote writes one of two slot sets, in turn, then waits on
// one barrier: a set is written again only after the next exchange's
// barrier, which every lane reaches after reading it.
static inline double qnm_exchange(double v, int src) {
  double* slot = qnm_warp->slot[qnm_parity ^= 1];
  slot[qnm_lane] = v;
  qnm_warp->sync();
  return slot[src];
}
static inline double __shfl_sync(unsigned, double v, int src) {
  return qnm_exchange(v, src);
}
static inline double __shfl_xor_sync(unsigned, double v, int off) {
  return qnm_exchange(v, qnm_lane ^ off);
}
static inline unsigned __ballot_sync(unsigned, bool pred) {
  bool* flag = qnm_warp->flag[qnm_parity ^= 1];
  flag[qnm_lane] = pred;
  qnm_warp->sync();
  unsigned mask = 0;
  for (int j = 0; j < 32; ++j) mask |= (flag[j] ? 1u : 0u) << j;
  return mask;
}
static inline bool __any_sync(unsigned m, bool pred) {
  return __ballot_sync(m, pred) != 0;
}
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
#include "SOURCE"

extern "C" int qnm_angular_eig_lanes_team(long long B, int n, int s,
                                          int sel, int max_its,
                                          const double* c,
                                          const double* guess,
                                          const double* bands, double* eig,
                                          double* A, double* C,
                                          long long* info, int team) {
  std::vector<cplx> mem(static_cast<size_t>(matrix_entries(n, team)));
  const Args a{B, n, s, sel, max_its, 1, team,
               reinterpret_cast<const cplx*>(c),
               reinterpret_cast<const cplx*>(guess), bands,
               reinterpret_cast<cplx*>(eig), reinterpret_cast<cplx*>(A),
               reinterpret_cast<cplx*>(C), info, nullptr};
  for (long long b = 0; b < B; ++b) {
    QnmWarp warps[2], bar;
    bar.size = 32 * team;
    std::vector<std::thread> lanes;
    for (int t = 0; t < 32 * team; ++t)
      lanes.emplace_back([&, t] {
        qnm_warp = &warps[t / 32];
        qnm_team = &bar;
        qnm_lane = t % 32;
        qnm_parity = 0;
        run_one(a, b, mem.data(), 0, t / 32, t % 32);
      });
    for (auto& th : lanes) th.join();
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def lane_lib(tmp_path_factory):
    """The card's code path run by host threads (``_LANES_SHIM``)."""
    d = tmp_path_factory.mktemp("eig_lanes")
    src = d / "lanes.cpp"
    src.write_text(_LANES_SHIM.replace("SOURCE", str(eig_cuda.SOURCE)))
    lib_path = d / "libangular_eig_lanes.so"
    subprocess.run([_gxx(), "-std=c++17", "-ffp-contract=off", "-O2",
                    "-pthread", "-shared", "-fPIC", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def lane_eig(lane_lib):
    """The card's code path, one warp a matrix, with the host build's
    entry's face (``_entry``)."""
    return _entry(lane_lib.qnm_angular_eig_lanes_team, team=1)


@pytest.fixture(scope="module")
def lane_eig_team(lane_lib):
    """The card's code path with a team of two warps a matrix (64 host
    threads, the team's barrier one of all of them)."""
    return _entry(lane_lib.qnm_angular_eig_lanes_team, team=2)


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


@pytest.mark.parametrize("nl", NLS_EDGE)
def test_host_twin_at_edge_orders(host_eig, nl):
    """Orders 1-4 and either side of 32 (a lane's second entry), both
    modes, for three spin weights."""
    rng = np.random.default_rng(nl + 50)
    for s, m in ((-2, 2), (-1, -3), (0, 1)):
        c = 5.0 * rng.random(5) * np.exp(2j * np.pi * rng.random(5))
        l = lmin(s, m) + min(3, nl - 1)
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


# A c at which an eigenvalue of the order-25 (s, m) = (-2, 2) matrix takes
# more than 10 QR iterations: zlahqr's exceptional shift runs at its
# tenth.
C_EXCEPTIONAL = -7.185595814617672 - 14.430760740742672j


def test_host_twin_mixed_batch(host_eig):
    """Converged (c = 0), easy and hard elements (|c| to 20, large Im c,
    one that takes exceptional shifts) in one batch: each as in a batch
    of its own, all held to JAX."""
    rng = np.random.default_rng(5)
    c = np.r_[0.0, 0.1 + 0.01j, 20.0 * np.exp(-1.2j), 3.0 - 2.5j,
              C_EXCEPTIONAL,
              15.0 * rng.random(4) * np.exp(2j * np.pi * rng.random(4))]
    s, m, l, nl = -2, 2, 2, 25
    guess = _well_posed_guess(s, l, m, c, nl, rng)
    eig, A, C, info = host_eig(s, m, c, nl, guess, 0)
    _pair_case(host_eig, s, l, m, c, nl, guess)
    assert info[0, 0] == 0 and info[2, 0] > info[1, 0]
    capped = host_eig(s, m, c, nl, max_its=9)[3]
    assert capped[4, 0] == -1 and capped[1, 0] >= 0
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
    (the bound's count): a 2 x 2's iteration is one rotation updating 4
    pairs (20 each); an order-n reduction's step k updates its 2n - k - 1
    rows and columns with a reflector of len_k = min(k + 2, n - k - 1)
    entries (16 len_k + 6 a row or column), each rotation 20 a pair;
    vectors mode adds the band LU's and its three solves' multiply-adds
    (8 each)."""
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


@pytest.mark.parametrize("nl", (1, 2, 3, 5, 8, 25, 28, 33, 40))
def test_lane_path_matches_host_twin(lane_eig, host_eig, nl):
    """The card's code path (each sweep step's lanes, loads and two
    barriers; the reduction's shuffles and the votes) gives the host
    build's eigenvalues, selected pairs and info bit for bit."""
    rng = np.random.default_rng(nl + 7)
    c = 5.0 * rng.random(2) * np.exp(2j * np.pi * rng.random(2))
    guess = _well_posed_guess(-2, 2, 2, c, nl, rng)
    for args in ((), (guess, 0)):
        lane = lane_eig(-2, 2, c, nl, *args)
        host = host_eig(-2, 2, c, nl, *args)
        for x, y in zip(lane, host):
            if x is not None:
                assert np.array_equal(x.view(np.float64) if x.dtype == complex
                                      else x, y.view(np.float64)
                                      if y.dtype == complex else y)


def test_lane_path_failures_and_exceptional_shifts(lane_eig, host_eig):
    """On the card's code path a non-finite matrix (info -2) and a capped
    one (-1) end every lane together, and a matrix that takes exceptional
    shifts matches the host build; an order of two entries a lane too."""
    c = np.array([np.nan + 0j, 0.0, C_EXCEPTIONAL])
    for max_its in (None, 0):
        lane = lane_eig(-2, 2, c, 25, max_its=max_its)[3]
        assert np.array_equal(lane, host_eig(-2, 2, c, 25,
                                             max_its=max_its)[3])
        assert lane[0, 0] == -2 and lane[1, 0] == 0
        assert (lane[2, 0] == -1) == (max_its == 0)
    c = 3.0 * np.exp(-0.7j) * np.ones(1)
    assert np.array_equal(lane_eig(-2, 2, c, 64)[0], host_eig(-2, 2, c, 64)[0])


# Orders for a team of two warps a matrix: below the team's smallest
# active block (one bulge throughout), the solver's, either side of 32
# (two slots a lane from 32), and 63, the largest a team takes.
NLS_TEAM = (1, 2, 5, 6, 25, 28, 31, 33, 34, 40, 63)


@pytest.mark.parametrize("nl", NLS_TEAM)
def test_team_host_twin_matches_jax(host_eig_team, nl):
    """The host build's QR iterations on two bulges (the card's plan for
    at most TEAM_MAX_B matrices) against the JAX package: every eigenvalue
    as a set, the selection, the vector and its residual, in both modes;
    info counts two sweeps an iteration on two bulges."""
    rng = np.random.default_rng(nl + 101)
    for s, m in ((-2, 2), (-1, -1), (0, 0)):
        l = max(abs(s), abs(m)) + min(2, nl - 1)
        c = 5.0 * rng.random(4) * np.exp(2j * np.pi * rng.random(4))
        eig, _, _, info = host_eig_team(s, m, c, nl)
        _held_values(eig, info, jsolver._batched_angular_eig(s, m, c, nl)[0],
                     _jax_mats(s, m, c, nl))
        _pair_case(host_eig_team, s, l, m, c, nl,
                   _well_posed_guess(s, l, m, c, nl, rng))


def test_team_takes_two_bulges_where_the_block_allows(host_eig,
                                                      host_eig_team):
    """A team's iterations on two bulges run where the active block has 6
    rows or more: at n = 25 and 34 the team's solve differs from one
    warp's and counts more sweeps (two an iteration on two bulges), its
    FP64 count past the reduction's whole pairs (20 each), at least a
    rotation of 4 pairs a sweep; at orders below 6 it is the one-warp
    solve bit for bit."""
    rng = np.random.default_rng(5)
    for nl in (25, 34):
        c = 4.0 * rng.random(6) * np.exp(2j * np.pi * rng.random(6))
        one, team = host_eig(-2, 2, c, nl), host_eig_team(-2, 2, c, nl)
        assert (team[3][:, 0] > one[3][:, 0]).all()
        assert not np.array_equal(team[0], one[0])
        hess = sum((2 * nl - k - 1) * (16 * min(k + 2, nl - k - 1) + 6)
                   for k in range(nl - 2))
        sweeps = team[3][:, 1] - hess
        assert np.all(sweeps % 20 == 0)
        assert np.all(sweeps >= 80 * team[3][:, 0])
    c = 4.0 * rng.random(6) * np.exp(2j * np.pi * rng.random(6))
    for nl in (1, 2, 5):
        one, team = host_eig(-2, 2, c, nl), host_eig_team(-2, 2, c, nl)
        for x, y in zip(one, team):
            if x is not None:
                assert np.array_equal(x, y)


def test_team_failures_and_exceptional_shifts(host_eig_team):
    """With a team: a non-finite matrix reports -2, the cap -1 (and the
    wrapper raises), and a batch mixing easy matrices with the one that
    takes exceptional shifts with one warp solves each as alone, against
    the JAX package."""
    c = np.array([np.nan + 0j, 0.0, C_EXCEPTIONAL])
    info = host_eig_team(-2, 2, c, 25)[3]
    assert info[0, 0] == -2 and info[1, 0] == 0 and info[2, 0] > 0
    capped = host_eig_team(-2, 2, c, 25, max_its=0)[3]
    assert capped[2, 0] == -1
    with pytest.raises(RuntimeError, match="did not converge"):
        eig_cuda.check_info(torch.as_tensor(capped[1:]), torch.as_tensor(
            c[1:]), -2, 2, 25, 0)
    rng = np.random.default_rng(17)
    easy = 2.0 * rng.random(3) * np.exp(2j * np.pi * rng.random(3))
    mixed = np.concatenate([easy[:2], [C_EXCEPTIONAL], easy[2:]])
    eig, _, _, info = host_eig_team(-2, 2, mixed, 25)
    _held_values(eig, info, jsolver._batched_angular_eig(-2, 2, mixed, 25)[0],
                 _jax_mats(-2, 2, mixed, 25))
    for b in range(len(mixed)):
        alone = host_eig_team(-2, 2, mixed[b:b + 1], 25)
        assert np.array_equal(alone[0][0], eig[b])
        assert np.array_equal(alone[3][0], info[b])


@pytest.mark.parametrize("nl", (6, 25, 28, 34, 40, 63))
def test_team_lane_path_matches_host_twin(lane_eig_team, host_eig_team, nl):
    """The card's code path with a team of two warps (64 host threads: the
    leader's split tests, shifts and word, both warps' ticks with the
    team's barrier, the late loads of rows a tick's left passes wrote)
    gives the host build's team results bit for bit, in both modes."""
    rng = np.random.default_rng(nl + 29)
    c = 5.0 * rng.random(2) * np.exp(2j * np.pi * rng.random(2))
    guess = _well_posed_guess(-2, 2, 2, c, nl, rng)
    for args in ((), (guess, 0)):
        lane = lane_eig_team(-2, 2, c, nl, *args)
        host = host_eig_team(-2, 2, c, nl, *args)
        for x, y in zip(lane, host):
            if x is not None:
                assert np.array_equal(x, y)


def test_team_lane_path_failures(lane_eig_team, host_eig_team):
    """On the card's code path with a team, a non-finite matrix, a capped
    one and one that takes exceptional shifts end both warps together
    with the host build's info."""
    c = np.array([np.nan + 0j, 0.0, C_EXCEPTIONAL])
    for max_its in (None, 0):
        lane = lane_eig_team(-2, 2, c, 25, max_its=max_its)[3]
        assert np.array_equal(lane, host_eig_team(-2, 2, c, 25,
                                                  max_its=max_its)[3])
        assert lane[0, 0] == -2
        assert (lane[2, 0] == -1) == (max_its == 0)


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
