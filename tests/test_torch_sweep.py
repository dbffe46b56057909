"""The port's t0 x mode-set sweep against the JAX package's, on the CPU.

Same numpy inputs through qnmfits_tpu.batched.batch_mismatch_t0_modesets
and qnmfits_tpu_torch.mismatch_t0_mode_sets(device="cpu") (the plain
PyTorch solve): K = 401 samples, S = 4 mode sets padded to J = 4, 64
start times; dedup on and off, the closed-form (uniform grid) and the
summation (jittered grid) Gram branches, amplitudes.
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu import batched as jb
from qnmfits_tpu import engine_real as jer
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch import mismatch_t0_mode_sets
from qnmfits_tpu_torch.ops import windows as tw
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MODE_SETS = [[(2, 2, 0, 1), (2, 2, 1, 1)],
             [(2, 2, n, 1) for n in range(4)],
             [(2, 2, 0, 1), (2, 2, 1, 1), (2, 2, 0, -1)],
             [(2, 2, 0, 1), (3, 2, 0, 1), (3, 2, 1, 1)]]
MM_TOL = 1e-11          # t0 >= 0
# Windows starting before the ringdown hold zeros ahead of the signal and
# sit at their own conditioning floor.  Measured on the CPU, port vs JAX:
# 5.9e-15 there on the uniform grid and 2.3e-14 on the jittered grid
# (1.6e-15 and 3.6e-15 for t0 >= 0), so the same bound holds.
MM_TOL_PRE = 1e-11


@pytest.fixture(scope="module")
def problem():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-5.0, 35.05, 0.1), seed=8)
    t0s = np.linspace(-2.0, 10.0, 64)
    return syn["times"], syn["data_dict"], t0s


def _jittered(times, data):
    rng = np.random.default_rng(3)
    t = times.copy()
    t[1:-1] += rng.uniform(-0.02, 0.02, t.size - 2)
    return t, data


def _compare(times, data, t0s, T, dedup):
    kw = dict(T_array=T, spherical_modes=SPH, return_amplitudes=True,
              dedup=dedup)
    mm, C = mismatch_t0_mode_sets(times, data, MODE_SETS, 0.952, 0.692,
                                  t0s, device="cpu", **kw)
    mm_j, C_j = jb.batch_mismatch_t0_modesets(times, data, MODE_SETS, 0.952,
                                              0.692, t0s, **kw)
    assert mm.shape == (len(MODE_SETS), len(t0s))
    pre = t0s < 0
    assert np.max(np.abs(mm - mm_j)[:, ~pre]) <= MM_TOL
    assert np.max(np.abs(mm - mm_j)[:, pre], initial=0.0) <= MM_TOL_PRE
    for c, cj, ms in zip(C, C_j, MODE_SETS):
        assert c.shape == cj.shape == (len(t0s), len(ms))
        np.testing.assert_allclose(c, cj, rtol=1e-9, atol=1e-12)
    return mm, C


@pytest.mark.parametrize("grid", ["uniform", "jittered"])
@pytest.mark.parametrize("dedup", [True, False])
def test_sweep_matches_jax(problem, grid, dedup):
    times, data, t0s = problem
    if grid == "jittered":
        times, data = _jittered(times, data)
    assert tb._uniform_spacing(times) == (grid == "uniform")
    _compare(times, data, t0s, 20.0, dedup)


def test_dense_grid_dedup_with_T_drop(problem):
    """t0 finer than the sampling (duplicates) with T dropping mid-sweep:
    dedup keys equal the JAX keys exactly, and the deduplicated sweep
    equals both the per-t0 sweep and the JAX sweep."""
    times, data, _ = problem
    t0s = np.linspace(0.0, 10.0, 201)
    Ts = np.where(t0s < 5.0, 24.0, 18.0)
    dd = tb._window_dedup(times, t0s, Ts)
    dd_j = jb._window_dedup(times, t0s, Ts)
    assert dd is not None
    for a, b in zip(dd, dd_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.all(np.diff(t0s[dd[0]]) > 0)
    mm_d, C_d = _compare(times, data, t0s, Ts, dedup=True)
    mm_0, C_0 = mismatch_t0_mode_sets(
        times, data, MODE_SETS, 0.952, 0.692, t0s, T_array=Ts,
        spherical_modes=SPH, return_amplitudes=True, dedup=False,
        device="cpu")
    np.testing.assert_allclose(mm_d, mm_0, rtol=0, atol=1e-13)
    for a, b in zip(C_d, C_0):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-11)


def test_host_prep_matches_jax(problem):
    times, data, t0s = problem
    for grid in (times, times.astype(np.float32), _jittered(times, data)[0]):
        assert tb._uniform_spacing(grid) == jb._uniform_spacing(grid)
    for t0v, wi in ((np.linspace(0.0, 51.2, 2048), 1.36),
                    (np.linspace(-5.0, 46.2, 513), 1.6), (t0s, 0.0)):
        assert tb._safe_chunk(t0v, wi, 512) == jb._safe_chunk(t0v, wi, 512)
    rng = np.random.default_rng(0)
    t0v = np.sort(rng.uniform(0.0, 10.0, 300))
    Ts = rng.choice([15.0, 22.0], 300)
    for a, b in zip(tb._window_dedup(times, t0v, Ts),
                    jb._window_dedup(times, t0v, Ts)):
        assert np.array_equal(a, b)
    rep, inverse = jb._window_dedup(times, t0v, Ts)
    omegas = rng.standard_normal((3, 4)) - 1j * rng.uniform(0.1, 1, (3, 4))
    C = rng.standard_normal((3, len(rep), 4)) \
        + 1j * rng.standard_normal((3, len(rep), 4))
    mm = rng.standard_normal((3, len(rep)))
    mm_p, C_p = tb._dedup_scatter((rep, inverse), t0v, mm, C, omegas)
    mm_j, Cre_j, Cim_j = jb._dedup_scatter((rep, inverse), t0v, mm, C.real,
                                           C.imag, omegas)
    assert np.array_equal(mm_p, mm_j)
    np.testing.assert_allclose(C_p, Cre_j + 1j * Cim_j, rtol=1e-15,
                               atol=1e-15)


def test_spectrum_fn_matches_jax():
    sets_key = tuple(tuple(ms) for ms in MODE_SETS)
    fn, masks = tb._modesets_spectrum_fn(sets_key, tuple(SPH))
    fn_j, _, masks_j = jb._modesets_spectrum_fn(sets_key, tuple(SPH))
    w, mu = fn(0.692, 0.952)
    w_j, mu_j = (np.asarray(a) for a in fn_j(0.692, 0.952))
    assert np.array_equal(masks, masks_j)
    np.testing.assert_allclose(w, w_j, rtol=1e-13, atol=0)
    np.testing.assert_allclose(mu, mu_j, rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("analytic", [True, False])
def test_engine_sweep_matches_jax(problem, analytic):
    """sweep_t0_factored_real (one mode set) against the JAX kernel."""
    times, data, _ = problem
    t0s = np.linspace(0.0, 12.0, 40)
    Ts = np.full_like(t0s, 20.0)
    rows = np.stack([data[lm] for lm in SPH])
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    ev = SpectrumEvaluator(MODE_SETS[1], SPH)
    w, mu = ev.omega(0.692, 0.952), ev.mu(0.692)
    C, mm = ter.sweep_t0_factored_real(
        torch.as_tensor(times), torch.as_tensor(rows), torch.as_tensor(w),
        torch.as_tensor(mu), torch.as_tensor(t0s), torch.as_tensor(Ts),
        chunk=16, analytic=analytic)
    Cre, Cim, mm_j = jer.sweep_t0_factored_real(
        times, rows.real, rows.imag, w.real, w.imag, mu.real, mu.imag, t0s,
        Ts, chunk=16, analytic=analytic)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cre) + 1j
                               * np.asarray(Cim), rtol=1e-10, atol=1e-12)


def test_windows_match_jax(problem):
    from qnmfits_tpu.ops import windows as jw
    times = problem[0]
    tt = torch.as_tensor(times)
    for t0, T in ((0.0, 10.0), (1.23, 7.77), (-3.05, 20.0)):
        w = tw.window_geq(tt, t0, T)
        assert np.array_equal(w.numpy(), np.asarray(jw.window_geq(times, t0,
                                                                  T)))
        assert np.array_equal(tw.window_closest(tt, t0, T).numpy(),
                              np.asarray(jw.window_closest(times, t0, T)))
        np.testing.assert_allclose(
            tw.trapz_weights(tt, w).numpy(),
            np.asarray(jw.trapz_weights(times, np.asarray(w))), rtol=1e-15,
            atol=0)


def test_unsorted_and_unported_raise(problem):
    """Unsorted 'geq' start times, bad spins and bad arguments raise, and
    so does the part of the JAX signature the port does not have yet (a
    device mesh); dynamic=True refuses buckets and tracks of the wrong
    length."""
    times, data, _ = problem
    kw = dict(spherical_modes=SPH, device="cpu")
    args = (times, data, MODE_SETS, 0.952)
    t0s = np.array([0.0, 5.0])
    with pytest.raises(ValueError, match="sorted"):
        mismatch_t0_mode_sets(*args, 0.692, np.array([5.0, 0.0]), **kw)
    with pytest.raises(ValueError, match="chif"):
        mismatch_t0_mode_sets(*args, 1.2, t0s, **kw)
    with pytest.raises(ValueError, match="chif"):
        mismatch_t0_mode_sets(*args, np.array([0.5, 1.2]), t0s, **kw)
    with pytest.raises(ValueError, match="1-D"):
        mismatch_t0_mode_sets(*args, np.full((2, 2), 0.692), t0s, **kw)
    with pytest.raises(ValueError, match="bucket"):
        mismatch_t0_mode_sets(*args, 0.692, t0s, t0_method="closest",
                              bucket=True, **kw)
    with pytest.raises(ValueError, match="t0_method"):
        mismatch_t0_mode_sets(*args, 0.692, t0s, t0_method="GEQ", **kw)
    with pytest.raises(ValueError, match="init_process_group"):
        mismatch_t0_mode_sets(*args, 0.692, t0s, mesh="auto", **kw)
    with pytest.raises(ValueError, match="t0_method='geq'"):
        mismatch_t0_mode_sets(*args, 0.692, t0s, mesh="auto",
                              t0_method="closest", **kw)
    with pytest.raises(ValueError, match="bucket"):
        mismatch_t0_mode_sets(*args, np.full(len(times), 0.692), t0s,
                              dynamic=True, bucket=True, **kw)
    with pytest.raises(ValueError, match="tracks"):
        mismatch_t0_mode_sets(*args, np.full(len(times) - 1, 0.692), t0s,
                              dynamic=True, **kw)
