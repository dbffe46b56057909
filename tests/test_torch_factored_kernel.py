"""The factored sweep's systems and epilogue (``ops/sweep_cuda.py``,
``csrc/factored_sweep.cu``) on the CPU.

* The plain versions that CPU tensors reach against the JAX package's
  ``engine_real``: the closed-form Grams of ``_analytic_grams`` mixed by
  mu^H mu (relative 1e-12 of each system's largest entry), and the sweep's
  C and mm through ``sweep_t0_modesets_factored_real(analytic=True)``
  (mm 1e-11 for t0 >= 0, C 1e-9 of each window's largest).  K = 351 samples on [-5, 30],
  I = 2 rows, ragged sets padded to J = 1, 8 and 17, 40 start times in
  chunks of 8, each chunk referenced to its own first start time, with a
  window of one sample, a window that runs off the grid's end and one that
  starts past it (empty: mm is NaN in both packages).
* The kernels' own source, built with g++ for the host (the CUDA names
  supplied below, each block's threads run as host threads), against the
  plain versions on random inputs (``testing.random_factored_sweep``):
  J = 1, 5, 8, 17 and 40, I = 1, 2, 5, 17 and 40 (past 16 rows a mode's
  rows take several passes), several chunks, padded sets (skips without
  g++).
* On CPU tensors the dispatch reaches the plain versions and neither
  kernel's launch counter moves; a tensor on another device raises; the
  module imports without nvcc, and building raises RuntimeError naming
  nvcc.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from qnmfits_tpu import engine_real as jer
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch.engine import SpectrumEvaluator
from qnmfits_tpu_torch.ops import sweep_cuda
from qnmfits_tpu_torch.testing import random_factored_sweep, synthetic_multimode

SPH = [(2, 2), (3, 2)]
MM_TOL = 1e-11           # t0 >= 0, the port against the JAX package
C_RTOL = 1e-9            # amplitudes, of each window's largest
SYSTEMS_RTOL = 1e-12     # each system's largest entry
SET_17 = ([(2, 2, n, 1) for n in range(5)]
          + [(2, 2, n, -1) for n in range(4)]
          + [(3, 2, n, 1) for n in range(4)]
          + [(3, 2, n, -1) for n in range(2)]
          + [(4, 2, n, 1) for n in range(2)])
# Eight modes of several (l, m) and both signs: ladders of six or more
# overtones are too ill-conditioned on this short grid for a 1e-11 parity
# bar (ROADMAP C.3).
SET_8 = [(2, 2, 0, 1), (2, 2, 1, 1), (2, 2, 0, -1), (3, 2, 0, 1),
         (3, 2, 1, 1), (2, 2, 2, 1), (3, 2, 0, -1), (4, 2, 0, 1)]
# Ragged sets padded to the widest: J = 1, 8 and 17.
SETS = {1: [[(2, 2, 0, 1)]],
        8: [SET_8, [(2, 2, 0, 1), (2, 2, 1, 1), (2, 2, 0, -1)],
            [(2, 2, n, 1) for n in range(4)] + [(3, 2, 0, 1)]],
        17: [SET_17, SET_8]}
CHUNK = 8


@pytest.fixture(scope="module")
def problem():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-5.0, 30.05, 0.1), seed=8)
    times = syn["times"]
    rows = np.stack([syn["data_dict"][lm] for lm in SPH])
    t0s = np.linspace(-1.0, 12.0, 40)
    Ts = np.full_like(t0s, 15.0)
    Ts[5] = 0.05                              # one sample
    t0s[-2], Ts[-2] = 25.03, 20.0             # off the grid's end
    t0s[-1] = times[-1] + 0.5                 # past the grid: empty
    return times, rows, t0s, Ts


def _padded(sets):
    """omegas (S, J), mus (S, I, J) and col_masks (S, J) of ragged sets
    padded to the widest with zero slots."""
    J = max(len(ms) for ms in sets)
    S = len(sets)
    om = np.zeros((S, J), complex)
    mu = np.zeros((S, len(SPH), J), complex)
    masks = np.zeros((S, J), bool)
    for s, ms in enumerate(sets):
        ev = SpectrumEvaluator(ms, SPH)
        om[s, :len(ms)] = ev.omega(0.692, 0.952)
        mu[s, :, :len(ms)] = ev.mu(0.692)
        masks[s, :len(ms)] = True
    return om, mu, masks


def _system_rel(x, ref, lead):
    d = np.abs(x - ref).reshape(*ref.shape[:lead], -1).max(-1)
    r = np.abs(ref).reshape(*ref.shape[:lead], -1).max(-1)
    return float(np.max(d / np.maximum(r, 1e-300)))


@pytest.mark.parametrize("J", [1, 8, 17])
def test_plain_systems_hold_the_jax_grams(problem, J):
    """G and G2 of ``factored_systems_plain`` against M o Gt and M o Gtau
    from the JAX package's ``_analytic_grams`` on each chunk, anchored at
    its own first start time; identity rows and columns where a set is
    padded."""
    times, rows, t0s, Ts = problem
    om, mu, masks = _padded(SETS[J])
    G, G2, _, _, _ = (x.numpy() for x in sweep_cuda.factored_systems_plain(
        *(torch.as_tensor(x) for x in (times, rows, om, mu, t0s, Ts,
                                       masks)), CHUNK))
    for lo in range(0, len(t0s), CHUNK):
        t0c, Tc = t0s[lo:lo + CHUNK], Ts[lo:lo + CHUNK]
        a = np.sum(times[None, :] < t0c[:, None], axis=1)
        m = np.sum((times[None, :] >= t0c[:, None])
                   & (times[None, :] < (t0c + Tc)[:, None]), axis=1)
        for s in range(len(om)):
            Gt_re, Gt_im, Gtau_re, Gtau_im = (np.asarray(x) for x in
                                              jer._analytic_grams(
                times, om[s].real, om[s].imag, t0c, a, m))
            M = mu[s].conj().T @ mu[s]
            kk = masks[s][:, None] & masks[s][None, :]
            ref = np.where(kk, M * (Gt_re + 1j * Gt_im), np.eye(J))
            ref2 = M * (Gtau_re + 1j * Gtau_im)
            got = G[s, lo:lo + CHUNK]
            assert _system_rel(got, ref, 1) <= SYSTEMS_RTOL
            assert _system_rel(G2[s, lo:lo + CHUNK], ref2, 1) <= SYSTEMS_RTOL


@pytest.mark.parametrize("J", [1, 8, 17])
def test_sweep_matches_jax(problem, J):
    """``sweep_t0_modesets_factored_real(analytic=True)`` on CPU tensors
    against the JAX package's, C and mm, ragged sets padded, several
    chunks; the empty window is NaN in both."""
    times, rows, t0s, Ts = problem
    om, mu, masks = _padded(SETS[J])
    C, mm = ter.sweep_t0_modesets_factored_real(
        *(torch.as_tensor(x) for x in (times, rows, om, mu, t0s, Ts,
                                       masks)), chunk=CHUNK, analytic=True)
    Cre, Cim, mm_j = jer.sweep_t0_modesets_factored_real(
        times, rows.real, rows.imag, om.real, om.imag, mu.real, mu.imag,
        t0s, Ts, masks, chunk=CHUNK, analytic=True)
    mm, C = mm.numpy(), C.numpy()
    mm_j, C_j = np.asarray(mm_j), np.asarray(Cre) + 1j * np.asarray(Cim)
    # The empty window is NaN in both packages; the one-sample window has
    # no trapezoid weight, so its mismatch is 0 / 0 up to rounding in each.
    assert np.all(np.isnan(mm[:, -1])) and np.all(np.isnan(mm_j[:, -1]))
    live = t0s >= 0
    live[[5, -1]] = False
    assert np.max(np.abs(mm - mm_j)[:, live]) <= MM_TOL
    # Amplitudes relative to each window's largest, for the sets of up to
    # eight modes: the 17-mode set's are ill-conditioned on this grid, so
    # its mismatch alone is held.
    for s in range(len(om)):
        assert np.all(C[s][:, ~masks[s]] == 0)
        if masks[s].sum() <= 8:
            assert _system_rel(C[s][live], C_j[s][live], 1) <= C_RTOL


# ---------------------------------------------------------------------------
# The kernels' source on the host
# ---------------------------------------------------------------------------

_SHIM = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <functional>
#include <memory>
#include <optional>
#include <pthread.h>
#include <vector>
using std::max;
using std::min;
struct double2 { double x, y; };
static inline double2 make_double2(double x, double y) { return {x, y}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
// Each host thread is one CUDA thread: its block and cluster, their
// barriers, and the cluster's blocks' dynamic shared buffers.
static thread_local dim3 blockIdx, threadIdx, gridDim;
static thread_local std::barrier<>* qnm_block_barrier;
static thread_local std::barrier<>* qnm_cluster_barrier;
static thread_local unsigned char* const* qnm_buffers;
static thread_local unsigned qnm_rank;
static inline void __syncthreads() { qnm_block_barrier->arrive_and_wait(); }
static inline unsigned char* shared_buffer() { return qnm_buffers[qnm_rank]; }
// The cluster's barrier in two halves, as barrier.cluster.arrive / wait.
static thread_local std::optional<std::barrier<>::arrival_token> qnm_token;
static inline void cluster_arrive() {
  qnm_token.emplace(qnm_cluster_barrier->arrive());
}
static inline void cluster_wait() {
  qnm_cluster_barrier->wait(std::move(*qnm_token));
  qnm_token.reset();
}
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return qnm_rank; }
  // The same offset in another block's buffer.
  template <class T> T* map_shared_rank(T* addr, unsigned rank) const {
    const auto off = (const unsigned char*)addr - qnm_buffers[qnm_rank];
    return (T*)(qnm_buffers[rank] + off);
  }
};
static inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
static inline int atomicMin(int* a, int v) {
  std::atomic_ref<int> r(*a);
  int old = r.load();
  while (v < old && !r.compare_exchange_weak(old, v)) {}
  return old;
}
static inline int atomicMax(int* a, int v) {
  std::atomic_ref<int> r(*a);
  int old = r.load();
  while (v > old && !r.compare_exchange_weak(old, v)) {}
  return old;
}
static double qnm_slots[1024];
static inline double __shfl_down_sync(unsigned, double v, int off) {
  const int t = threadIdx.x, lane = t % 32;
  qnm_slots[t] = v;
  __syncthreads();
  const double r = lane + off < 32 ? qnm_slots[t + off] : v;
  __syncthreads();
  return r;
}
#define __global__
#define __device__
#define __host__
#define __launch_bounds__(...)
#include "SOURCE"

struct Thread {
  std::function<void()> kernel;
  dim3 block, thread, grid;
  std::barrier<>* block_barrier;
  std::barrier<>* cluster_barrier;
  unsigned char* const* buffers;
  unsigned rank;
};

static void* run_thread(void* arg) {
  const Thread& t = *static_cast<Thread*>(arg);
  blockIdx = t.block;
  threadIdx = t.thread;
  gridDim = t.grid;
  qnm_block_barrier = t.block_barrier;
  qnm_cluster_barrier = t.cluster_barrier;
  qnm_buffers = t.buffers;
  qnm_rank = t.rank;
  t.kernel();
  return nullptr;
}

// The grid cluster by cluster: a cluster's blocks at once, every thread a
// host thread, each block with its own dynamic shared buffer.
static void run_grid(unsigned gx, unsigned gy, unsigned cluster, int threads,
                     size_t bytes, std::function<void()> kernel) {
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 1 << 19);
  for (unsigned y = 0; y < gy; ++y)
    for (unsigned x0 = 0; x0 < gx; x0 += cluster) {
      std::vector<std::vector<double2>> store(cluster);
      std::vector<unsigned char*> buffers(cluster);
      for (unsigned r = 0; r < cluster; ++r) {
        store[r].assign(bytes / 16 + 1, make_double2(NAN, NAN));
        buffers[r] = reinterpret_cast<unsigned char*>(store[r].data());
      }
      std::barrier<> cluster_barrier(cluster * threads);
      std::vector<std::unique_ptr<std::barrier<>>> block_barriers;
      std::vector<Thread> jobs;
      jobs.reserve(cluster * threads);
      for (unsigned r = 0; r < cluster; ++r) {
        block_barriers.emplace_back(new std::barrier<>(threads));
        for (int t = 0; t < threads; ++t) {
          Thread job;
          job.kernel = kernel;
          job.block.x = x0 + r;
          job.block.y = y;
          job.thread.x = t;
          job.grid.x = gx;
          job.grid.y = gy;
          job.block_barrier = block_barriers.back().get();
          job.cluster_barrier = &cluster_barrier;
          job.buffers = buffers.data();
          job.rank = r;
          jobs.push_back(job);
        }
      }
      std::vector<pthread_t> pool(jobs.size());
      for (size_t i = 0; i < jobs.size(); ++i)
        pthread_create(&pool[i], &attr, run_thread, &jobs[i]);
      for (pthread_t th : pool) pthread_join(th, nullptr);
    }
  pthread_attr_destroy(&attr);
}

extern "C" {
void host_factored_plan(int K, int J, int nbits, int cluster, int global,
                        long long* out) {
  const Layout L = make_layout(K, J, nbits, cluster, global != 0);
  out[0] = L.bytes;
  out[1] = L.ws;
  out[2] = L.tpb;
}
void host_factored_systems(const double* times, const double2* data,
                           const double2* omegas, const double2* mus,
                           const unsigned char* keep, const double* t0s,
                           const double* Ts, double2* G, double2* G2,
                           double2* rhs, double2* rt, double* dnorm,
                           double2* ws, long long B, int K, int I, int J,
                           int S, int chunk, int nbits, int cluster) {
  Sweep p{times, data, omegas, mus, keep, t0s, Ts, G, G2, rhs, rt, dnorm,
          ws, B, K, I, J, chunk, make_layout(K, J, nbits, cluster,
                                            ws != nullptr)};
  const long long nchunk = (B + chunk - 1) / chunk;
  run_grid((unsigned)(nchunk * cluster), (unsigned)S, cluster, THREADS,
           p.L.bytes, [&] { factored_systems_kernel(p); });
}
void host_mismatch_rephase(const double2* C0, const double2* G2,
                           const double2* rt, const double* dnorm,
                           const double2* omegas, const double* t0s,
                           double2* C, double* mm, long long B, int S, int J,
                           int chunk) {
  Epilogue p{C0, G2, rt, dnorm, omegas, t0s, C, mm, B, B * S, J, chunk};
  run_grid((unsigned)((p.systems + EPI_WARPS - 1) / EPI_WARPS), 1, 1,
           32 * EPI_WARPS, 0, [&] { mismatch_rephase_kernel(p); });
}
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' host twin")
    d = tmp_path_factory.mktemp("factored_host")
    src = d / "shim.cpp"
    src.write_text(_SHIM.replace("SOURCE", str(sweep_cuda.SOURCE)))
    lib = d / "libfactored_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-ffp-contract=off", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    host = ctypes.CDLL(str(lib))
    P, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    host.host_factored_plan.argtypes = [i32] * 5 + [P]
    host.host_factored_systems.argtypes = [P] * 13 + [i64] + [i32] * 7
    host.host_mismatch_rephase.argtypes = [P] * 8 + [i64, i32, i32, i32]
    return host


def host_systems(host, t, chunk, cluster, variant):
    """The systems kernel's host twin on one join group's tensors ``t``
    (``random_factored_sweep``'s keys), the tile sums in shared memory or,
    for variant "global", in a workspace allocated here as the wrapper
    does.  Returns G, G2, rhs, rt, dnorm."""
    (S, J), B, (I, K) = t["omegas"].shape, t["t0s"].shape[0], \
        t["data"].shape
    nbits = sweep_cuda._nbits(K)
    G, G2 = (torch.empty((S, B, J, J), dtype=torch.complex128)
             for _ in range(2))
    rhs, rt = (torch.empty((S, B, J), dtype=torch.complex128)
               for _ in range(2))
    dnorm = torch.empty(B, dtype=torch.float64)
    plan = (ctypes.c_longlong * 3)()
    host.host_factored_plan(K, J, nbits, cluster, int(variant == "global"),
                            plan)
    nchunk = -(-B // chunk)
    ws = (torch.full((S * nchunk * plan[1],), complex("nan+nanj"),
                     dtype=torch.complex128) if variant == "global" else None)
    keep = t["col_masks"].to(torch.uint8)
    host.host_factored_systems(
        *(t[k].data_ptr() for k in ("times", "data", "omegas", "mus")),
        keep.data_ptr(), t["t0s"].data_ptr(), t["Ts"].data_ptr(),
        *(x.data_ptr() for x in (G, G2, rhs, rt, dnorm)),
        None if ws is None else ws.data_ptr(), B, K, I, J, S, chunk, nbits,
        cluster)
    return G, G2, rhs, rt, dnorm


# (K, I, S, J, B, chunk, n_pad, layout, cluster, variant): the window
# layouts of ``random_factored_sweep``; clusters of 1 to 8 blocks; the tile
# sums in shared memory or the global workspace.  The first six are random
# layouts; then windows one sample apart (dedup's layout) in blocks of 16
# windows, 16 windows a sample (no dedup's) in two rounds a block, chunks
# of one window, a last chunk of one window and one that fills three of
# eight blocks, windows with no whole tile inside, spans in the workspace,
# J = 40 with I = 17, and blocks of more windows than a Gram round takes
# (150 at J = 8; 30 at J = 40, several groups of (j, l) pairs a round).
HOST_CASES = [(200, 2, 2, 8, 37, 8, 3, "random", 2, "shared"),
              (150, 1, 2, 1, 19, 5, 0, "random", 1, "shared"),
              (150, 5, 2, 17, 21, 7, 4, "random", 3, "shared"),
              (120, 2, 1, 40, 9, 4, 0, "random", 4, "shared"),
              (120, 17, 2, 8, 11, 4, 2, "random", 2, "shared"),
              (100, 40, 1, 5, 9, 4, 1, "random", 8, "shared"),
              (400, 2, 1, 8, 129, 64, 1, "dedup", 4, "shared"),
              (300, 2, 2, 8, 130, 64, 0, "per_sample", 2, "shared"),
              (200, 2, 1, 8, 6, 1, 2, "dedup", 8, "shared"),
              (300, 2, 1, 8, 37, 16, 0, "dedup", 8, "shared"),
              (250, 3, 2, 5, 40, 16, 1, "short", 4, "shared"),
              (400, 2, 2, 8, 60, 32, 1, "dedup", 4, "global"),
              (200, 5, 1, 17, 30, 8, 2, "random", 2, "global"),
              (150, 17, 1, 40, 12, 6, 3, "per_sample", 2, "shared"),
              (200, 2, 1, 8, 150, 150, 1, "per_sample", 1, "shared"),
              (150, 2, 1, 40, 30, 30, 2, "dedup", 1, "shared")]


@pytest.mark.parametrize("case", HOST_CASES)
def test_kernel_source_on_host_matches_plain(host_kernels, case):
    K, I, S, J, B, chunk, n_pad, layout, cluster, variant = case
    r = random_factored_sweep(K, I, S, J, B, seed=sum(case[:7]),
                              n_pad=n_pad, layout=layout)
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    args = (t["times"], t["data"], t["omegas"], t["mus"], t["t0s"], t["Ts"],
            t["col_masks"])
    ref = sweep_cuda.factored_systems_plain(*args, chunk)
    got = host_systems(host_kernels, t, chunk, cluster, variant)
    for x, r_ in zip(got, ref):
        assert _system_rel(x.numpy(), r_.numpy(),
                           2 if r_.dim() > 1 else 1) <= SYSTEMS_RTOL
    # A window of one sample has no trapezoid weight: G2, rt and dnorm are
    # exactly 0, as in the plain version.
    a = np.searchsorted(r["times"], r["t0s"], side="left")
    m = np.searchsorted(r["times"], r["t0s"] + r["Ts"], side="left") - a
    one = m == 1
    if layout != "random":
        assert one.any()
    G, G2, rhs, rt, dnorm = got
    assert not G2[:, one].any() and not rt[:, one].any()
    assert not dnorm[one].any()

    C0 = ter._regularised_solve_plain(
        ref[0].reshape(S * B, J, J), ref[2].reshape(S * B, J)).reshape(S, B, J)
    C_ref, mm_ref = sweep_cuda.mismatch_rephase_plain(
        C0, ref[1], ref[3], ref[4], t["omegas"], t["t0s"], chunk)
    C = torch.empty_like(C0)
    mm = torch.empty((S, B), dtype=torch.float64)
    host_kernels.host_mismatch_rephase(
        *(x.data_ptr() for x in (C0, ref[1], ref[3], ref[4], t["omegas"],
                                 t["t0s"], C, mm)), B, S, J, chunk)
    assert _system_rel(C.numpy(), C_ref.numpy(), 2) <= SYSTEMS_RTOL
    nan = np.isnan(mm_ref.numpy())
    assert np.array_equal(nan, np.isnan(mm.numpy()))
    gap = np.abs(mm.numpy() - mm_ref.numpy())[~nan]
    bound = chip_smoke.epilogue_bound(C0, ref[1], ref[3], mm_ref).numpy()
    assert np.all(gap <= bound[~nan])


@pytest.mark.parametrize("S,nchunk,chunk,expect", [
    (16, 5, 128, 4),        # the main path with dedup: 80 clusters
    (16, 32, 256, 4),       # without: several waves at any size
    (16, 7, 16, 2),         # chunks of 16: 8 windows a block
    (1, 9, 64, 8),          # one wide set: 72 blocks
    (128, 16, 256, 4),      # the remnant axis without dedup
    (2, 6, 1, 1), (1, 3, 4, 1)])
def test_cluster_size_fills_the_card(S, nchunk, chunk, expect):
    """A cluster leaves each block 8 windows or more; within that it is
    the largest that lets the grid's clusters fit on 132 SMs at once, but
    not under 4."""
    assert sweep_cuda.cluster_size(S, nchunk, chunk, 132) == expect


# ---------------------------------------------------------------------------
# Dispatch and build
# ---------------------------------------------------------------------------

def test_cpu_dispatch_reaches_the_plain_versions(problem, monkeypatch):
    """On CPU tensors the sweep's systems and epilogue are the plain
    versions, one call each a join group (three groups here), and neither
    kernel's launch counter moves; the summation branch calls neither."""
    times, rows, t0s, Ts = problem
    om, mu, masks = _padded(SETS[8])
    args = [torch.as_tensor(x) for x in (times, rows, om, mu, t0s, Ts,
                                         masks)]
    calls = {"systems": 0, "epilogue": 0}

    def counting(key, fn):
        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(sweep_cuda, "factored_systems_plain",
                        counting("systems", sweep_cuda.factored_systems_plain))
    monkeypatch.setattr(ter, "_mismatch_rephase",
                        counting("epilogue", ter._mismatch_rephase))
    S, J = om.shape
    monkeypatch.setattr(ter, "JOIN_BYTES", 2 * CHUNK * 2 * S * J * J * 16)
    sweep_cuda.systems_launches = sweep_cuda.epilogue_launches = 0
    C, mm = ter.sweep_t0_modesets_factored_real(*args, chunk=CHUNK,
                                                analytic=True)
    groups = len(ter.join_groups([CHUNK] * (len(t0s) // CHUNK),
                                 2 * S * J * J * 16))
    assert groups == 3
    assert calls == {"systems": groups, "epilogue": groups}
    assert (sweep_cuda.systems_launches, sweep_cuda.epilogue_launches) == (
        0, 0)
    monkeypatch.undo()
    C1, mm1 = ter.sweep_t0_modesets_factored_real(*args, chunk=CHUNK,
                                                  analytic=True)
    np.testing.assert_array_equal(mm.numpy(), mm1.numpy())
    calls.update(systems=0, epilogue=0)
    monkeypatch.setattr(sweep_cuda, "factored_systems",
                        counting("systems", sweep_cuda.factored_systems))
    monkeypatch.setattr(sweep_cuda, "mismatch_rephase",
                        counting("epilogue", sweep_cuda.mismatch_rephase))
    ter.sweep_t0_modesets_factored_real(*args, chunk=CHUNK, analytic=False)
    assert calls == {"systems": 0, "epilogue": 0}


def test_other_devices_raise_and_nothing_falls_back(problem):
    times, rows, t0s, Ts = problem
    om, mu, masks = _padded(SETS[8])
    meta = [torch.as_tensor(x).to("meta") for x in (times, rows, om, mu,
                                                    t0s, Ts, masks)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sweep_cuda.factored_systems(*meta, CHUNK)
    S, J, B = om.shape[0], om.shape[1], len(t0s)
    C0 = torch.zeros((S, B, J), dtype=torch.complex128, device="meta")
    G2 = torch.zeros((S, B, J, J), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sweep_cuda.mismatch_rephase(C0, G2, C0, meta[4], meta[2], meta[4],
                                    CHUNK)
    assert (sweep_cuda.systems_launches, sweep_cuda.epilogue_launches) == (
        0, 0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The module imports here (no nvcc); building names nvcc and raises
    RuntimeError."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(sweep_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        sweep_cuda.build()
    assert not (tmp_path / "build").exists()
