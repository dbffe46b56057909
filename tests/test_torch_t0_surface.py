"""The rest of the port's t0 x mode-set surface against the JAX package's,
on the CPU: 'closest' windows, the remnant axis folded into the set axis,
width buckets, the 'closest' dedup keys, the join budget of the batched
solve, and one-mode, 17-mode and 72-mode sweeps (system sizes the team
kernel of the card does not take).

The same numpy inputs go through qnmfits_tpu.batched /
qnmfits_tpu.fitting and qnmfits_tpu_torch (device="cpu": the plain
PyTorch solve).  K = 351 samples, I = 2, J <= 4 (17 and 72 in the wide
cases), B <= 64.  Bounds: mismatch 1e-11 (1e-12 where both sides are the port),
amplitudes rtol 1e-10 / atol 1e-12.  The cases mirror
tests/test_batched.py's TestModesetSweep and its dedup tests.
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu import batched as jb
from qnmfits_tpu import fitting as jf
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch import mismatch_t0_mode_sets
from qnmfits_tpu_torch.ops.windows import window_closest
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MF, CHIF = 0.952, 0.692
MODE_SETS = [[(2, 2, n, 1) for n in range(nmax)] for nmax in (1, 2, 3, 4)]
CHIFS = np.array([0.60, CHIF, 0.75])
MM_TOL = 1e-11
C_RTOL, C_ATOL = 1e-10, 1e-12


@pytest.fixture(scope="module")
def problem():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-5.0, 30.05, 0.1), seed=8)
    return syn["times"], syn["data_dict"]


class CountingSolve:
    """The plain solve, recording the batch of every call."""

    def __init__(self):
        self.batches = []

    def __call__(self, G, b):
        self.batches.append(b.shape[0])
        return ter._regularised_solve_plain(G, b)


def _both(problem, t0s, chif=CHIF, mode_sets=MODE_SETS, **kw):
    """The port's and the JAX package's sweep on the same inputs, with
    amplitudes."""
    times, data = problem
    kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
              **kw)
    port = mismatch_t0_mode_sets(times, data, mode_sets, MF, chif, t0s,
                                 device="cpu", **kw)
    ref = jf.mismatch_t0_mode_sets(times, data, mode_sets, MF, chif, t0s,
                                   **kw)
    return port, ref


def _exact_solve(G, b):
    """The solve's exact answer: each equilibrated, floored system of
    ter._equilibrated solved by LU in 40-digit arithmetic (mpmath), then
    unscaled as the plain solve unscales."""
    import mpmath
    A, bs, Di = ter._equilibrated(G, b)
    x = torch.empty_like(bs)
    with mpmath.workdps(40):
        for s in range(A.shape[0]):
            z = mpmath.lu_solve(mpmath.matrix(A[s].tolist()),
                                mpmath.matrix(bs[s].tolist()))
            x[s] = torch.tensor([complex(v) for v in z],
                                dtype=torch.complex128)
    return x * Di


def _assert_close(port, ref, mm_tol=MM_TOL):
    (mm, C), (mm_j, C_j) = port, ref
    assert mm.shape == mm_j.shape
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=mm_tol)
    assert len(C) == len(C_j)
    for c, cj in zip(C, C_j):
        assert c.shape == cj.shape
        np.testing.assert_allclose(c, cj, rtol=C_RTOL, atol=C_ATOL)


@pytest.mark.parametrize("dedup", [True, False])
def test_closest_matches_jax(problem, dedup):
    """t0_method='closest' through the complex window sweep; the t0 grid
    is finer than the sampling, so dedup groups windows; start times
    need not be sorted."""
    t0s = np.linspace(0.3, 6.0, 64)
    t0s[[3, 40]] = t0s[[40, 3]]
    port, ref = _both(problem, t0s, t0_method="closest", dedup=dedup)
    assert port[0].shape == (len(MODE_SETS), 64)
    _assert_close(port, ref)


@pytest.mark.parametrize("t0_method", ["geq", "closest"])
@pytest.mark.parametrize("dedup", [True, False])
def test_remnant_axis_matches_jax(problem, t0_method, dedup):
    """Array chif folds the per-spin spectra into the set axis: (S, R, B)
    mismatches and (R, B, len) amplitudes, as the JAX sweep gives."""
    t0s = np.linspace(0.0, 4.0, 48)
    port, ref = _both(problem, t0s, chif=CHIFS, t0_method=t0_method,
                      dedup=dedup)
    assert port[0].shape == (len(MODE_SETS), len(CHIFS), 48)
    assert port[1][2].shape == (len(CHIFS), 48, 3)
    _assert_close(port, ref)


def test_remnant_axis_equals_per_spin_sweeps(problem):
    """The folded sweep equals R scalar-remnant sweeps, with an array Mf
    broadcast against the spins."""
    times, data = problem
    t0s = np.linspace(0.0, 12.0, 5)
    Mfs = np.array([0.95, MF, 0.96])
    kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
              device="cpu")
    mm, C = mismatch_t0_mode_sets(times, data, MODE_SETS, Mfs, CHIFS, t0s,
                                  **kw)
    for r in range(len(CHIFS)):
        mm_s, C_s = mismatch_t0_mode_sets(times, data, MODE_SETS,
                                          float(Mfs[r]), float(CHIFS[r]),
                                          t0s, **kw)
        np.testing.assert_allclose(mm[:, r], mm_s, rtol=0, atol=1e-12)
        for s in range(len(MODE_SETS)):
            np.testing.assert_allclose(C[s][r], C_s[s], rtol=C_RTOL,
                                       atol=C_ATOL)


# A fifth set of five modes makes a second width (5, the cap).
WIDE_SET = [(2, 2, 0, 1), (2, 2, 1, 1), (2, 2, 0, -1), (3, 2, 0, 1),
            (3, 2, 1, 1)]


@pytest.mark.parametrize("chif", [CHIF, CHIFS], ids=["scalar", "remnant"])
def test_bucketed_matches_flat_and_jax(problem, chif):
    """bucket=True (one factored sweep per padded width) equals the JAX
    bucketed sweep, and the flat padded sweep to the bounds of
    tests/test_batched.py:379 (the 500 J eps floor follows the padded
    width, so the amplitudes move by ~3e-10 relative: 1e-9 relative
    here, where the amplitudes reach 16)."""
    times, data = problem
    t0s = np.linspace(0.0, 12.0, 5)
    mode_sets = MODE_SETS + [WIDE_SET]
    port, ref = _both(problem, t0s, chif=chif, mode_sets=mode_sets,
                      bucket=True)
    _assert_close(port, ref)
    flat = mismatch_t0_mode_sets(times, data, mode_sets, MF, chif, t0s,
                                 T_array=20.0, spherical_modes=SPH,
                                 return_amplitudes=True, device="cpu")
    np.testing.assert_allclose(port[0], flat[0], rtol=0, atol=1e-12)
    for a, b in zip(port[1], flat[1]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_bucket_runs_one_sweep_per_width(problem):
    """Widths 4 (sets of 1..4 modes) and 5 (capped at J): two solves, of
    4 and 1 sets' systems."""
    times, data = problem
    t0s = np.linspace(0.0, 12.0, 5)
    solve = CountingSolve()
    tb.batch_mismatch_t0_modesets(
        times, data, MODE_SETS + [WIDE_SET], MF,
        CHIF, t0s, T_array=20.0, spherical_modes=SPH, bucket=True,
        dedup=False, device="cpu", solve=solve)
    assert solve.batches == [4 * 5, 1 * 5]
    assert [tb._bucket_width(n, 8) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert tb._bucket_width(5, 5) == 5


def test_positional_contract(problem):
    """T_array stays at positional slot 7 and everything newer is
    keyword-only (tests/test_batched.py:358)."""
    times, data = problem
    t0s = np.linspace(0.0, 10.0, 3)
    kw = dict(spherical_modes=SPH, device="cpu")
    mm_pos = mismatch_t0_mode_sets(times, data, MODE_SETS[:1], MF, CHIF,
                                   t0s, 25.0, **kw)
    mm_kw = mismatch_t0_mode_sets(times, data, MODE_SETS[:1], MF, CHIF,
                                  t0s, T_array=25.0, **kw)
    np.testing.assert_array_equal(mm_pos, mm_kw)
    with pytest.raises(TypeError):
        mismatch_t0_mode_sets(times, data, MODE_SETS[:1], MF, CHIF, t0s,
                              25.0, "closest", **kw)


# ---------------------------------------------------------------------------
# 'closest' dedup keys
# ---------------------------------------------------------------------------

def _adversarial_t0s(times):
    """Exact midpoints between samples, their ulp neighbours, and draws
    near a midpoint (tests/test_batched.py:1124)."""
    dt = times[1] - times[0]
    rng = np.random.default_rng(7)
    mids = 0.5 * (times[40:200:3] + times[41:201:3])
    t0s = np.concatenate([mids, np.nextafter(mids, np.inf),
                          np.nextafter(mids, -np.inf),
                          times[40] + dt * rng.uniform(0.49, 0.51, 100)])
    return np.sort(t0s)


@pytest.mark.parametrize("half_step", [True, False])
def test_closest_keys_match_jax_and_windows(problem, half_step):
    """The keys equal the JAX keys bit for bit, and every start time's
    window from ops.windows.window_closest (the window the sweep fits)
    equals its representative's."""
    times = np.asarray(problem[0], float)
    t0s = _adversarial_t0s(times)
    Ts = np.full_like(t0s, 20.0 + (0.05 if half_step else 0.0))
    dd = tb._window_dedup_closest(times, t0s, Ts)
    dd_j = jb._window_dedup_closest(times, t0s, Ts)
    assert dd is not None
    for a, b in zip(dd, dd_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rep, inverse = dd
    w = window_closest(torch.as_tensor(times), torch.as_tensor(t0s)[:, None],
                       torch.as_tensor(Ts)[:, None]).numpy()
    assert np.array_equal(w[rep][inverse], w)
    assert np.all(np.diff(t0s[rep]) >= 0)


def test_closest_keys_at_ulp_equidistance():
    """t0 + T within a few ulps of the exact midpoint of two samples
    (tests/test_batched.py:1163): the keys still equal the device
    expression's argmin."""
    rng = np.random.default_rng(1)
    for _ in range(25):
        dt = 10 ** rng.uniform(-3, 0)
        ta = rng.uniform(0.0, 200.0)
        tb_ = ta + dt
        T = rng.uniform(10.0, 100.0)
        t0 = (ta + 0.5 * dt) - T
        for step in range(-4, 5):
            t = t0
            for _ in range(abs(step)):
                t = np.nextafter(t, np.inf if step > 0 else -np.inf)
            times = np.unique(np.concatenate([
                np.linspace(t - 5.0, ta - 1e-3, 300), [ta, tb_],
                np.linspace(tb_ + 1e-3, tb_ + 5.0, 50)]))
            t0s, Ts = np.array([t, t]), np.full(2, T)
            rep, inverse = tb._window_dedup_closest(times, t0s, Ts)
            rep_j, inverse_j = jb._window_dedup_closest(times, t0s, Ts)
            assert np.array_equal(rep, rep_j)
            assert np.array_equal(inverse, inverse_j)
            k1 = torch.argmin((torch.as_tensor(times) - t - T) ** 2).item()
            d = (times - t) - T
            assert k1 == int(np.argmin(d * d))


# ---------------------------------------------------------------------------
# The join budget of the batched solve
# ---------------------------------------------------------------------------

def test_join_groups():
    ter.JOIN_BYTES  # the module constant the groups read
    assert ter.join_groups([4, 4, 4], 1) == [(0, 3)]
    assert ter.join_groups([], 1) == []


@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_join_budget_groups_the_solves(problem, monkeypatch, t0_method):
    """With a budget of two chunks' systems, the sweep of 5 chunks solves
    in 3 calls, one per group, and gives the one-call sweep's results."""
    times, data = problem
    t0s = np.linspace(0.0, 6.0, 40)
    kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
              dedup=False, device="cpu", t0_method=t0_method, chunk=8)
    if t0_method == "closest":
        kw.pop("chunk")
        monkeypatch.setattr(tb, "_CHUNK", 8)
    S, J = len(MODE_SETS), 4
    item = 2 * S * len(CHIFS) * J * J * 16
    one = CountingSolve()
    mm1, C1 = tb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF,
                                            CHIFS, t0s, solve=one, **kw)
    assert one.batches == [S * len(CHIFS) * 40]
    monkeypatch.setattr(ter, "JOIN_BYTES", 16 * item)
    assert ter.join_groups([8] * 5, item) == [(0, 2), (2, 4), (4, 5)]
    grouped = CountingSolve()
    mm3, C3 = tb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF,
                                            CHIFS, t0s, solve=grouped, **kw)
    assert grouped.batches == [S * len(CHIFS) * n for n in (16, 16, 8)]
    np.testing.assert_allclose(mm3, mm1, rtol=0, atol=1e-13)
    for a, b in zip(C3, C1):
        np.testing.assert_allclose(a, b, rtol=C_RTOL, atol=C_ATOL)


def test_closest_chunk_shrinks_with_the_set_axis(problem, monkeypatch):
    """The complex sweep's chunk of start times shrinks so the sets'
    (S, chunk, K, J) basis stays within _BASIS_BYTES: a budget of 5 start
    times' basis gives chunks of 5; the results do not depend on it."""
    times, data = problem
    t0s = np.linspace(0.3, 6.0, 23)
    kw = dict(T_array=20.0, spherical_modes=SPH, t0_method="closest",
              dedup=False, device="cpu")
    mm1 = tb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF, CHIFS,
                                        t0s, **kw)
    S = len(MODE_SETS) * len(CHIFS)
    monkeypatch.setattr(tb, "_BASIS_BYTES", 5 * S * len(times) * 4 * 16)
    monkeypatch.setattr(ter, "JOIN_BYTES", 5 * 2 * S * 4 * 4 * 16)
    solve = CountingSolve()
    mm5 = tb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF, CHIFS,
                                        t0s, solve=solve, **kw)
    assert solve.batches == [S * 5] * 4 + [S * 3]
    np.testing.assert_allclose(mm5, mm1, rtol=0, atol=1e-13)


def test_grid_join_budget(problem, monkeypatch):
    """The (Mf, chif) grid's 16 points in chunks of 4 under a budget of
    two chunks: two solves, the same grid as one solve."""
    times, data = problem
    args = (times, data, MODE_SETS[2], (0.9, 1.0), (0.6, 0.8), 0.5)
    monkeypatch.setattr(tb, "_CHUNK", 4)
    one = CountingSolve()
    mm1 = tb.batch_mismatch_M_chi(*args, res=4, spherical_modes=SPH,
                                  device="cpu", solve=one)
    monkeypatch.setattr(ter, "JOIN_BYTES", 8 * 2 * 3 * 3 * 16)
    two = CountingSolve()
    mm2 = tb.batch_mismatch_M_chi(*args, res=4, spherical_modes=SPH,
                                  device="cpu", solve=two)
    assert one.batches == [16] and two.batches == [8, 8]
    np.testing.assert_allclose(mm1, mm2, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# One-mode, 17-mode and 72-mode systems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["J=1", "J=17", "J=72"])
def test_narrow_and_wide_sweeps_match_jax(problem, case):
    """Sweeps whose systems are 1 x 1 (every set one mode), 17 x 17 and
    72 x 72: the sizes outside the card's team kernel, the last beyond the
    64 modes the card's solve once stopped at."""
    t0s = np.linspace(0.0, 8.0, 32)
    if case == "J=1":
        mode_sets = [[(2, 2, 0, 1)], [(2, 2, 1, 1)], [(3, 2, 0, 1)]]
        _assert_close(*_both(problem, t0s, mode_sets=mode_sets))
        return
    if case == "J=17":
        # Seventeen m = 2 modes: prograde and mirror overtones of l = 2..4.
        # A 17-overtone (2,2) ladder would sit at the floor's conditioning
        # cap, where two solvers differ by ~1e-7 in mismatch.
        mode_sets = [[(2, 2, n, 1) for n in range(5)]
                     + [(2, 2, n, -1) for n in range(4)]
                     + [(3, 2, n, 1) for n in range(4)]
                     + [(3, 2, n, -1) for n in range(2)]
                     + [(4, 2, n, 1) for n in range(2)],
                     [(2, 2, 0, 1), (2, 2, 1, 1)]]
        port, ref = _both(problem, t0s, mode_sets=mode_sets)
        # Seventeen modes leave some amplitudes weakly determined (1e-6
        # of the largest, set by the floor): there the two packages'
        # rounding moves them by up to 3% of themselves, 1.5e-8 of the
        # set's norm.  The fit, and so the mismatch, agrees to the full
        # bound.
        np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=MM_TOL)
        amp_tol = (1e-7, 1e-7)
    else:
        # Seventy-two m = 2 modes: prograde overtones n < 8 of l = 2..6
        # and mirror overtones n < 8 of l = 2..5.  'closest' windows: the
        # JAX package's 'geq' sweep runs its column-unrolled solve, which
        # takes minutes to compile at 72 columns; its 'closest' sweep
        # solves with XLA's Cholesky (ops.solve.gram_cholesky).
        mode_sets = [[(l, 2, n, 1) for l in range(2, 7) for n in range(8)]
                     + [(l, 2, n, -1) for l in range(2, 6) for n in range(8)],
                     [(2, 2, 0, 1), (2, 2, 1, 1)]]
        port, ref = _both(problem, t0s, mode_sets=mode_sets,
                          t0_method="closest")
        # The equilibrated 72-mode Grams sit at condition ~5e12, where the
        # port's column-unrolled Cholesky and XLA's, both backward stable
        # to ~1e-15, differ by 2.5e-10 in mismatch at t0 = 0 (a mismatch
        # of 1e-3) and by 1e-15 at every later start time.  The amplitudes
        # of the floor-set directions move by up to 1.7e-2 of the set's
        # norm; the two-mode set's by 2e-14.
        np.testing.assert_allclose(port[0], ref[0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(port[0][:, 1:], ref[0][:, 1:], rtol=0,
                                   atol=MM_TOL)
        amp_tol = (5e-2, 1e-7)
        # A third witness at t0 = 0: the same sweep with the exact solution
        # (40 digits) of each equilibrated, floored system that the two
        # solves round.  (The NumPy oracle's SVD fits the system without
        # the floor, a mismatch of 9e-5 here: no witness of the solve.)
        # Both packages stand ~5e-9 from it in the 72-mode mismatch (the
        # port 5.26e-9, JAX 5.01e-9): the 2.5e-10 between them is a small
        # part of what either solve loses at this conditioning.  The
        # port's amplitudes stand nearer (8.8e-5 of the set's norm, JAX
        # 1.7e-4); the two-mode set sits on it (1e-16).
        times, data = problem
        mm_x, C_x = tb.batch_mismatch_t0_modesets(
            times, data, mode_sets, MF, CHIF, t0s[:1], T_array=20.0,
            spherical_modes=SPH, return_amplitudes=True,
            t0_method="closest", device="cpu", solve=_exact_solve)
        for side in (port, ref):
            assert np.all(np.abs(side[0][:, 0] - mm_x[:, 0])
                          <= [1e-8, MM_TOL])
        away = [np.linalg.norm(side[1][0][0] - C_x[0][0])
                for side in (port, ref)]
        assert away[0] <= away[1] <= 1e-3 * np.linalg.norm(C_x[0][0])
    for c, cj, tol in zip(port[1], ref[1], amp_tol):
        assert c.shape == cj.shape
        err = np.linalg.norm(c - cj, axis=-1) / np.linalg.norm(cj, axis=-1)
        assert np.max(err) <= tol
