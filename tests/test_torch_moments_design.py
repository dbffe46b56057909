"""The window moments kernel's design (``csrc/window_moments.cu``) on the
CPU: its uniform variant's arithmetic as plain PyTorch, the wrapper's
plan, the inputs' grids, and the kernel's own source built for the host.

* The mirror.  ``uniform_mirror`` repeats the uniform-grid variant's
  arithmetic in plain PyTorch: each phase a tile's anchor exp(-i omega
  s_a) times a step exp(-i omega b dlt), only the w moments summed, the
  tau moments dlt times the w moments less half of the window's two end
  samples' terms.  It is held to ``window_moments_plain`` at 1e-13 of
  each moment's largest entry (the trapezoid's per-sample steps differ
  from the fitted one by the grid's rounding, ~1e-15 of a step here), and
  its fits (``optimize._fit_derivs`` at order 0) to the JAX package's
  ``engine.fit_core`` mismatch at 1e-11 (the array optimisers' bar).
* The plan: which variant a grid takes, the tile, the units a trajectory
  and the shared bytes, as the wrapper reads them from the source (here
  from its host twin's ``qnm_window_moments_plan``).
* The host twin: the source compiled with g++ under a shim that runs each
  warp's 32 lanes as host threads and does mma.sync m16n8k8 and m16n8k16
  (FP64) and the warp shuffle from the lanes' operands, so the lanes' fragment
  layout, the work units and the epilogue's combination of the four real
  blocks are checked here against the plain version at 1e-12 (the card
  tests' bar), in both variants, with units split over a block's warps
  and a warp each.  Skips without g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qnmfits_tpu import engine as jengine
from qnmfits_tpu_torch import batched, engine_real
from qnmfits_tpu_torch import optimize as to
from qnmfits_tpu_torch.ops import moments_cuda
from qnmfits_tpu_torch.ops.cmath import damped_phase
from qnmfits_tpu_torch.ops.windows import trapz_weights, window_geq
from qnmfits_tpu_torch.testing import random_window_moments

MIRROR_RTOL = 1e-13
MM_TOL = 1e-11
HOST_RTOL = 1e-12
GRIDS = ("uniform", "near-uniform", "random")
# The mirror's samples between anchors: the source's (the plan's tile).
TILE = 32


def inputs(K, N, M, I, J, seed, grid="uniform"):
    """window_moments' arguments before the order (CPU tensors) from
    ``testing.random_window_moments``, with its windows' Ts."""
    r = random_window_moments(K, N, M, I, J, seed=seed, grid=grid)
    times = torch.as_tensor(r["times"])
    t0s = torch.as_tensor(r["t0s"])
    Ts = torch.as_tensor(r["Ts"])
    w = window_geq(times, t0s[:, None], Ts[:, None])
    return (times, torch.as_tensor(r["data"]), torch.as_tensor(r["omega"]),
            t0s, w, torch.as_tensor(r["win"])), Ts


def gap(out, ref):
    """The largest |difference| of each moment (S or P, weight, power)
    over that moment's largest entry, the largest over the moments."""
    worst = 0.0
    for a, b in zip(out, ref):
        for v in range(2):
            for p in range(a.shape[2]):
                scale = float(b[:, v, p].abs().max())
                d = float((a[:, v, p] - b[:, v, p]).abs().max())
                worst = max(worst, d / scale if scale else d)
    return worst


def uniform_mirror(times, rows, omega, t0s, w, win, order, grid=None,
                   tile=TILE):
    """The uniform variant's arithmetic in plain PyTorch, on the step of
    ``grid`` (``moments_cuda.moments_grid``; None: the grid's fitted step):
    S (M, 2, order + 1, J, J), P (M, 2, order + 1, I, J)."""
    dlt = grid[1] if grid else engine_real._fitted_step(times)
    first, count = moments_cuda.window_bounds(w)
    M, J = omega.shape
    I = rows.shape[0]
    S = torch.zeros((M, 2, order + 1, J, J), dtype=torch.complex128)
    P = torch.zeros((M, 2, order + 1, I, J), dtype=torch.complex128)
    for m in range(M):
        n = int(win[m])
        k0, c = int(first[n]), int(count[n])
        if c == 0:
            continue
        t0, om = t0s[n], omega[m]
        idx = torch.arange(c)
        k = k0 + idx
        anchor = damped_phase(om, (times[k0 + idx // tile * tile]
                                   - t0)[:, None])
        step = damped_phase(om, ((idx % tile).to(times.dtype) * dlt)[:, None])
        phi = anchor * step                                   # (c, J)
        s = times[k] - t0
        ends = (k0, k0 + c - 1)
        edge = [(times[e] - t0, damped_phase(om, times[e] - t0))
                for e in ends]
        for p in range(order + 1):
            a = phi.conj() * (s ** p)[:, None]
            S[m, 0, p] = a.T @ phi
            P[m, 0, p] = rows[:, k] @ a
            if c < 2:
                continue
            es = sum(se ** p * torch.outer(pe.conj(), pe) for se, pe in edge)
            ep = sum(se ** p * rows[:, e, None] * pe.conj()[None]
                     for (se, pe), e in zip(edge, ends))
            S[m, 1, p] = dlt * S[m, 0, p] - 0.5 * dlt * es
            P[m, 1, p] = dlt * P[m, 0, p] - 0.5 * dlt * ep
    return S, P


# ---------------------------------------------------------------------------
# The grids of the tests' inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [7, 301, 2001, 20001])
def test_random_window_moments_grids_take_their_variant(K):
    """The "uniform" grid passes the port's gate and the "near-uniform"
    running sum of 0.1 steps does not (at K >= 301), nor does the random
    one: the card tests' grids reach both variants."""
    seen = {g: batched._uniform_spacing(
        random_window_moments(K, 4, 4, 1, 1, seed=K, grid=g)["times"])
        for g in GRIDS}
    assert seen["uniform"] and not seen["random"]
    assert seen["near-uniform"] == (K < 301)
    with pytest.raises(ValueError, match="unknown grid"):
        random_window_moments(K, 4, 4, 1, 1, grid="log")


# ---------------------------------------------------------------------------
# The uniform variant's arithmetic against the plain version and JAX
# ---------------------------------------------------------------------------

MIRROR_CASES = [(order, I, J) for order in (0, 1, 2) for I in (1, 2, 3)
                for J in (1, 3, 8, 9, 17)
                if (order + I + J) % 2 == 0 or J in (8, 17)]


@pytest.mark.parametrize("order,I,J", MIRROR_CASES)
def test_uniform_mirror_matches_plain(order, I, J):
    """Anchors and steps, tau from the w moments and the end samples:
    every moment within 1e-13 of its largest entry of the plain version,
    over windows that are empty, of one sample, or run off the grid's
    end (``random_window_moments``' first four)."""
    args, _ = inputs(301, 9, 23, I, J, seed=100 * order + 10 * I + J)
    assert batched._uniform_spacing(args[0].numpy())
    ref = moments_cuda.window_moments_plain(*args, order)
    got = uniform_mirror(*args, order)
    assert gap(got, ref) <= MIRROR_RTOL
    first, count = moments_cuda.window_bounds(args[4])
    assert {0, 1} <= set(count.tolist())


def _spectrum(omega, mu):
    """A fixed spectrum in ``_fit_derivs``' form: order-0 jets only."""
    def jets(x, order):
        assert order == 0
        return omega[None], mu[None]
    return type("Fixed", (), {"jets": staticmethod(jets)})


@pytest.mark.parametrize("I,J", [(1, 1), (2, 3), (3, 8), (1, 9), (2, 17)])
def test_uniform_mirror_fits_match_jax_fit_core(monkeypatch, I, J):
    """With the mirror's moments in place of the kernel's, the fits'
    mismatches (``optimize._fit_derivs`` at order 0) agree with the JAX
    package's ``engine.fit_core`` on the same trajectories within 1e-11
    wherever the fit is determined to rounding (the plain moments' own fit
    within 1e-12 of JAX's); windows with no trapezoid weight (empty, one
    sample) are NaN in both.  Windows of fewer samples than modes (or
    barely more, at J = 8-17 on these short windows) leave the fit to the
    solve's floor, where two routes part by up to 1e-5: there the mirror
    is held to no more than 4 times the plain moments' own distance."""
    args, Ts = inputs(301, 9, 23, I, J, seed=7 * I + J)
    times, rows, omega, t0s, w, win = args
    rng = np.random.default_rng(J)
    mu = torch.as_tensor(rng.standard_normal((23, I, J))
                         + 1j * rng.standard_normal((23, I, J)))
    prob = to._Problem(times.numpy(), rows.numpy(), t0s.numpy(), Ts.numpy(),
                       "geq", torch.device("cpu"), None)
    fit = jax.vmap(jengine.fit_core, in_axes=(None, None, 0, 0, 0, 0))
    _, ref = fit(jnp.asarray(times.numpy()), jnp.asarray(rows.numpy()),
                 jnp.asarray(omega.numpy()), jnp.asarray(mu.numpy()),
                 jnp.asarray(t0s.numpy()[win.numpy()]),
                 jnp.asarray(w.numpy()[win.numpy()]))
    ref = np.asarray(ref)
    f = {}
    def plain(*a, grid=None):
        return moments_cuda.window_moments_plain(*a)

    for name, moments in (("plain", plain), ("mirror", uniform_mirror)):
        monkeypatch.setattr(moments_cuda, "window_moments", moments)
        f[name] = to._fit_derivs(prob, _spectrum(omega, mu), None, win,
                                 0)[0].numpy()
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(f["mirror"]), nan)
    assert 2 <= nan.sum() <= 10
    plain_gap = np.abs(f["plain"][~nan] - ref[~nan])
    gap_ = np.abs(f["mirror"][~nan] - ref[~nan])
    determined = plain_gap <= 1e-12
    assert determined.sum() >= (13 if J <= 8 else 0)
    assert np.all(gap_[determined] <= MM_TOL)
    if not determined.all():
        assert gap_[~determined].max() <= MM_TOL + 4 * plain_gap.max()


# ---------------------------------------------------------------------------
# The wrapper's plan
# ---------------------------------------------------------------------------

# (I, J) the array optimisers reach: the free frequency's single rows with
# 1-8 fixed modes and the remnant's (2,2,n<8) ladder on one or two rows,
# and the larger sets of the tests.
PLAN_SHAPES = [(1, J) for J in range(1, 10)] + [(2, 8), (2, 4), (3, 9),
                                                (2, 17), (3, 40), (17, 5),
                                                (48, 3)]


@pytest.mark.parametrize("I,J", PLAN_SHAPES)
def test_plan_units_cover_every_entry(host_kernel, I, J):
    """The source's plan (through its host twin), for each order and
    variant: the units a trajectory cover every
    column mode group of the Gram's upper block triangle once and every
    data fragment of every row group once, with at most ``h_per_unit``
    data fragments a unit; one unit a trajectory at J <= 8 with the
    optimisers' rows; the tile and warps are the source's; a unit takes a
    block below 2048 units a launch (O1's Newton steps) and a warp above
    (O2's seeds and Newton steps); the shared bytes (step tables, stage
    buffers, a split unit's sums) within a block's default 48 KiB for the
    optimisers' I <= 2 (and 3), past it by opt-in up to 227 KiB."""
    for order in (0, 1, 2):
        for uniform in (True, False):
            for M in (1, 513, 2565, 45657):
                pl = moments_cuda.plan(I, J, order, uniform, M, host_kernel)
                assert pl["variant"] == ("uniform" if uniform else "general")
                assert pl["tile"] == TILE
                assert pl["warps"] == 4
                assert pl["split"] == (4 if M * pl["units"] < 2048 else 1)
                nv = 1 if uniform else 2
                stages = 4 * 2 * 32 * (nv + 2 * I) * 8
                assert pl["smem_bytes"] >= stages + 32768 * uniform
                assert pl["smem_bytes"] <= (48 * 1024 if I <= 3
                                            else 227 * 1024)
            nv = 1 if uniform else 2
            assert pl["h_frags"] == -(-2 * nv * (order + 1) * I // 8)
            Q = -(-J // 8)
            units = _units(Q, pl["h_frags"], pl["h_per_unit"])
            assert len(units) == pl["units"]
            for q in range(Q):
                mine = [u for u in units if u[0] == q]
                assert sorted(u[1] for u in mine if u[1] >= 0) == list(
                    range(q, Q))
                frags = [f for u in mine for f in range(u[2], u[2] + u[3])]
                assert frags == list(range(pl["h_frags"]))
                assert all(u[3] <= pl["h_per_unit"] for u in mine)
            if J <= 8 and I <= 2:
                assert pl["units"] == 1


def _units(Q, HF, NH):
    """The source's ``unit_of`` in Python: (q, q2, hb0, nh) a unit."""
    out = []
    for q in range(Q):
        rest = HF - (Q - q) * NH
        n = Q - q + (-(-rest // NH) if rest > 0 else 0)
        for u in range(n):
            hb0 = u * NH
            out.append((q, q + u if u < Q - q else -1, hb0,
                        max(0, min(NH, HF - hb0))))
    return out


def test_plan_rejects_what_no_kernel_takes(host_kernel):
    """No plan for no rows or modes or an order outside 0-2, nor for more
    data rows than a block's stage buffers hold (48 on a uniform grid, 55
    on any grid; 227 KiB a block)."""
    for I, J, order in ((0, 8, 0), (2, 0, 0), (2, 8, 3), (2, 8, -1)):
        with pytest.raises(ValueError, match="no plan"):
            moments_cuda.plan(I, J, order, True, 10, host_kernel)
    for uniform, I in ((True, 48), (False, 55)):
        for order in (0, 1, 2):
            for M in (10, 10000):
                assert moments_cuda.plan(I, 8, order, uniform, M,
                                         host_kernel)[
                    "smem_bytes"] <= 227 * 1024
        with pytest.raises(ValueError, match="at most 232448"):
            moments_cuda.plan(I + 1, 8, 0, uniform, 10, host_kernel)


def test_wrapper_takes_the_plain_version_on_the_cpu_whatever_the_grid():
    """CPU tensors take ``window_moments_plain`` on either grid: no plan
    is made and nothing is launched."""
    before, plan_before = moments_cuda.launches, moments_cuda.last_plan
    for grid in ("uniform", "near-uniform"):
        args, _ = inputs(101, 5, 7, 2, 3, seed=3, grid=grid)
        out = moments_cuda.window_moments(*args, 1)
        ref = moments_cuda.window_moments_plain(*args, 1)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert moments_cuda.launches == before
    assert moments_cuda.last_plan is plan_before


def test_moments_grid_is_the_ports_gate_and_step():
    """``moments_grid`` is ``batched._uniform_spacing`` and, on a grid
    that passes it, ``engine_real._fitted_step`` (else 0); the optimisers'
    problems make it once, at their first launch, on their own times."""
    for grid in GRIDS:
        times = torch.as_tensor(random_window_moments(
            2001, 4, 4, 1, 1, grid=grid)["times"])
        uniform, dlt = moments_cuda.moments_grid(times)
        assert uniform == batched._uniform_spacing(times.numpy()) == (
            grid == "uniform")
        assert dlt == (float(engine_real._fitted_step(times.numpy()))
                       if uniform else 0.0)
    prob = to._Problem(times.numpy(), np.ones((1, 2001), complex),
                       np.zeros(2), np.full(2, 5.0), "geq",
                       torch.device("cpu"), None)
    assert "grid" not in vars(prob)
    assert prob.grid == moments_cuda.moments_grid(prob.times)
    assert vars(prob)["grid"] is prob.grid


# ---------------------------------------------------------------------------
# The kernel's source on the host
# ---------------------------------------------------------------------------

_SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <memory>
#include <pthread.h>
#include <vector>
using std::max;
using std::min;
struct double2 { double x, y; };
static inline double2 make_double2(double x, double y) { return {x, y}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
// Each host thread is one lane of a warp: the warp's barrier and its
// lanes' operand slots, and the block's dynamic shared buffer.
struct Warp {
  std::barrier<>* bar;
  double a[32][8], b[32][4], v[32];
};
static thread_local dim3 blockIdx, threadIdx;
static thread_local Warp* qnm_warp;
static thread_local std::barrier<>* qnm_block_barrier;
static thread_local unsigned char* qnm_block_shared;
static inline void __syncthreads() { qnm_block_barrier->arrive_and_wait(); }
static inline void __syncwarp() { qnm_warp->bar->arrive_and_wait(); }
// cp.async as a plain copy (its group's commit and wait nothing).
static inline void copy_async(void* dst, const void* src, int bytes) {
  std::memcpy(dst, src, bytes);
}
static inline void copy_commit() {}
static inline void copy_wait_older() {}
static inline double2* step_slots() { return (double2*)qnm_block_shared; }
static inline double __shfl_sync(unsigned, double v, int src) {
  Warp* w = qnm_warp;
  const int l = threadIdx.x & 31;
  w->v[l] = v;
  w->bar->arrive_and_wait();
  const double r = w->v[src & 31];
  w->bar->arrive_and_wait();
  return r;
}
// mma.sync m16n8k(4 KS) (FP64) from the lanes' fragments: A (16 x 4 KS)
// row g, column t + 4 u from lane 4 g + t (a[2 u]; rows 8 + g from
// a[2 u + 1]), B (4 KS x 8) row t + 4 u, column g from lane 4 g + t
// (b[u]), D rows g / 8 + g, columns 2 t, 2 t + 1.
template <int KS>
static inline void mma_16x8(double (&d)[4], const double (&a)[2 * KS],
                            const double (&b)[KS]) {
  Warp* w = qnm_warp;
  const int l = threadIdx.x & 31;
  for (int i = 0; i < 2 * KS; ++i) w->a[l][i] = a[i];
  for (int u = 0; u < KS; ++u) w->b[l][u] = b[u];
  w->bar->arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int e = 0; e < 2; ++e) {
    const int col = 2 * t + e;
    for (int u = 0; u < KS; ++u)
      for (int k = 0; k < 4; ++k) {
        d[e] += w->a[g * 4 + k][2 * u] * w->b[col * 4 + k][u];
        d[2 + e] += w->a[g * 4 + k][2 * u + 1] * w->b[col * 4 + k][u];
      }
  }
  w->bar->arrive_and_wait();
}
#define __global__
#define __device__
#define __host__
#define __launch_bounds__(...)
#include "SOURCE"

struct Lane {
  std::function<void()> kernel;
  unsigned block, thread;
  Warp* warp;
  std::barrier<>* block_barrier;
  unsigned char* shared;
};

static void* run_lane(void* arg) {
  const Lane& t = *static_cast<Lane*>(arg);
  blockIdx.x = t.block;
  threadIdx.x = t.thread;
  qnm_warp = t.warp;
  qnm_block_barrier = t.block_barrier;
  qnm_block_shared = t.shared;
  t.kernel();
  return nullptr;
}

extern "C" void host_window_moments(
    const double* times, const double2* rows, const double2* omega,
    const double* t0s, const double* tau, const int* first,
    const int* count, const long long* win, double2* S, double2* P, int K,
    int I, int J, long long M, int order, int uniform, double dlt) {
  const Moments p{times, rows, omega, t0s, tau, first, count, win, S, P,
                  M, K, I, J, dlt};
  long long plan[8];
  qnm_window_moments_plan(M, I, J, order, uniform, plan);
  const int units = (int)plan[0], split = (int)plan[6];
  const long long blocks = split > 1 ? M * units
                                     : (M * units + WARPS - 1) / WARPS;
  std::function<void()> kernel;
  switch (order * 2 + (uniform ? 0 : 1)) {
    case 0: kernel = [&] { window_moments_kernel<0, 1>(p, units, split); };
      break;
    case 1: kernel = [&] { window_moments_kernel<0, 2>(p, units, split); };
      break;
    case 2: kernel = [&] { window_moments_kernel<1, 1>(p, units, split); };
      break;
    case 3: kernel = [&] { window_moments_kernel<1, 2>(p, units, split); };
      break;
    case 4: kernel = [&] { window_moments_kernel<2, 1>(p, units, split); };
      break;
    default: kernel = [&] { window_moments_kernel<2, 2>(p, units, split); };
  }
  pthread_attr_t attr;
  pthread_attr_init(&attr);
  pthread_attr_setstacksize(&attr, 1 << 18);
  // The blocks one after another, a block's threads at once, each block
  // with its own shared buffer (NaN at the start).
  for (long long b = 0; b < blocks; ++b) {
    std::vector<double2> shared(plan[3] / 16 + 1, make_double2(NAN, NAN));
    std::barrier<> block_barrier(32 * WARPS);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<Warp> warps(WARPS);
    for (int w = 0; w < WARPS; ++w) {
      bars.emplace_back(new std::barrier<>(32));
      warps[w].bar = bars.back().get();
    }
    std::vector<Lane> lanes(32 * WARPS);
    std::vector<pthread_t> pool(32 * WARPS);
    for (int t = 0; t < 32 * WARPS; ++t) {
      lanes[t] = Lane{kernel, (unsigned)b, (unsigned)t, &warps[t / 32],
                      &block_barrier,
                      reinterpret_cast<unsigned char*>(shared.data())};
      pthread_create(&pool[t], &attr, run_lane, &lanes[t]);
    }
    for (pthread_t th : pool) pthread_join(th, nullptr);
  }
  pthread_attr_destroy(&attr);
}
"""


def _build_host(tmp_path_factory, name, flags=()):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host twin")
    d = tmp_path_factory.mktemp(name)
    src = d / "shim.cpp"
    src.write_text(_SHIM.replace("SOURCE", str(moments_cuda.SOURCE)))
    lib = d / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-ffp-contract=off", *flags, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=300)
    host = moments_cuda.bind_plan(ctypes.CDLL(str(lib)))
    P, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    host.host_window_moments.argtypes = [P] * 10 + [i32] * 3 + [i64] + \
        [i32] * 2 + [ctypes.c_double]
    return host


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The source as it ships: the tests' small launches split each unit
    over a block's warps."""
    return _build_host(tmp_path_factory, "moments_host")


# The host twin's builds: the source as it ships (the tests' small
# launches split each unit over a block's warps, as O1's Newton launches
# run) and with no launch split (a warp a unit, as O2's seed and Newton
# launches run).
HOST_BUILDS = {"split": (), "warp": ("-DQNM_MOMENTS_SPLIT_BELOW=0",)}


@pytest.fixture(scope="module")
def host_builds(host_kernel, tmp_path_factory):
    return {name: host_kernel if not flags else
            _build_host(tmp_path_factory, f"moments_{name}", flags)
            for name, flags in HOST_BUILDS.items()}


def host_moments(host, args, order, uniform):
    """The host twin's S and P on CPU inputs ``args`` (the wrapper's,
    before the order), of the given variant (the general one reads the
    windows' trapezoid weights, the uniform one the grid's fitted step)."""
    times, rows, omega, t0s, w, win = args
    tau = trapz_weights(times, w)
    first, count = (b.to(torch.int32) for b in moments_cuda.window_bounds(w))
    M, J = omega.shape
    I, K = rows.shape
    S = torch.full((M, 2, order + 1, J, J), complex("nan+nanj"),
                   dtype=torch.complex128)
    P = torch.full((M, 2, order + 1, I, J), complex("nan+nanj"),
                   dtype=torch.complex128)
    host.host_window_moments(
        times.data_ptr(), rows.data_ptr(), omega.data_ptr(), t0s.data_ptr(),
        None if uniform else tau.data_ptr(), first.data_ptr(),
        count.data_ptr(), win.data_ptr(), S.data_ptr(), P.data_ptr(), K, I,
        J, M, order, int(uniform), float(engine_real._fitted_step(times)))
    return S, P


@pytest.mark.parametrize("I,J", PLAN_SHAPES)
def test_source_plan_matches_wrapper(host_builds, I, J):
    """The wrapper's plan is the source's ``qnm_window_moments_plan``
    field for field; a build with no launch split plans a warp a unit at
    every M, as the shipped build does for large launches."""
    out = (ctypes.c_longlong * 8)()
    split, warp = host_builds["split"], host_builds["warp"]
    for order in (0, 1, 2):
        for uniform in (True, False):
            for M in (1, 513, 2047, 2048, 2565, 45657):
                split.qnm_window_moments_plan(M, I, J, order, int(uniform),
                                              out)
                pl = moments_cuda.plan(I, J, order, uniform, M, split)
                assert list(out) == [pl["units"], pl["warps"], pl["tile"],
                                     pl["smem_bytes"], pl["h_frags"],
                                     pl["h_per_unit"], pl["split"],
                                     227 * 1024]
                assert moments_cuda.plan(I, J, order, uniform, M, warp) == \
                    moments_cuda.plan(I, J, order, uniform, 2048 * M, split)


# (order, I, J, grid): both variants (the uniform one on the uniform grid,
# the general one on each grid), orders 0-2, I in 1-4 (and 9, 17), J in
# 1-9 and 17 (one to three mode groups, units of data fragments only).
HOST_CASES = ([(o, I, J, "uniform") for o in (0, 1, 2)
               for I, J in ((1, 1), (2, 3), (2, 8), (3, 9), (1, 17))]
              + [(o, I, J, g) for o, I, J, g in (
                  (0, 2, 8, "near-uniform"), (1, 1, 3, "random"),
                  (2, 2, 8, "near-uniform"), (2, 3, 9, "random"),
                  (1, 2, 17, "near-uniform"), (2, 1, 1, "uniform"),
                  (0, 3, 3, "uniform"), (2, 17, 5, "uniform"),
                  (1, 9, 2, "random"), (0, 1, 9, "random"),
                  (0, 2, 5, "uniform"), (1, 3, 8, "uniform"),
                  (1, 2, 2, "near-uniform"), (2, 2, 4, "uniform"),
                  (0, 1, 2, "uniform"), (2, 1, 6, "random"),
                  (1, 1, 1, "near-uniform"), (0, 4, 5, "near-uniform"),
                  (2, 3, 3, "random"), (1, 4, 8, "uniform"),
                  (0, 2, 2, "random"))])


@pytest.mark.parametrize("order,I,J,grid", HOST_CASES)
@pytest.mark.parametrize("build", list(HOST_BUILDS))
def test_kernel_source_on_host_matches_plain(host_builds, build, order, I,
                                             J, grid):
    """The host twin of each variant the grid may take (the uniform one
    only on a uniform grid; the general one on any), in each of
    ``HOST_BUILDS`` (units split over a block's warps or a warp each),
    within 1e-12 of each moment's
    largest entry of the plain version, the Gram Hermitian with a real
    diagonal, on windows of 0, 1 and up to 200 samples (7 tiles), some
    running off the grid's end (partial k-steps and tiles, a warp's share
    of none)."""
    host = host_builds[build]
    args, _ = inputs(1001, 9, 19, I, J, seed=order + 10 * I + J, grid=grid)
    ref = moments_cuda.window_moments_plain(*args, order)
    uniform = batched._uniform_spacing(args[0].numpy())
    assert uniform == (grid == "uniform")
    for variant in ((True, False) if uniform else (False,)):
        S, P = host_moments(host, args, order, variant)
        assert not (S.isnan().any() or P.isnan().any())
        assert gap((S, P), ref) <= HOST_RTOL, variant
        assert torch.equal(S, S.mH)
