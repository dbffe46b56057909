"""The port's stacked spectrum engine and the grids it carries -- the
(Mf, chif) grid's 'fast' engine and the free-frequency grid's
'fast-full' -- against the JAX package's, on the CPU.

The same numpy inputs go through qnmfits_tpu and qnmfits_tpu_torch
(device="cpu": the plain PyTorch solve).  Bounds: the stacked engine
against the summed-Gram fits of the same window <= 1e-12 in mismatch
(tests/test_batched.py:1296's bar); the public grids against JAX's 'fast'
/ 'fast-full' and against the port's 'batched' <= 1e-11.
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu import engine_real as jer
from qnmfits_tpu import fitting as jf
from qnmfits_tpu.testing import synthetic_multimode, synthetic_single
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine_real as ter

STACK_TOL = 1e-12
MM_TOL = 1e-11
SPH = [(2, 2), (3, 2)]


@pytest.fixture(scope="module")
def single():
    return synthetic_single(
        modes=[(2, 2, n, 1) for n in range(4)] + [(2, 2, 0, -1)],
        noise=1e-3, seed=3, times=np.arange(-10.0, 30.0, 0.1))


@pytest.fixture(scope="module")
def multi():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(3)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-10.0, 30.0, 0.1), seed=4)
    syn["data_dict"] = {k: v + 1e-3 * np.exp(-0.05 * np.abs(syn["times"]))
                        for k, v in syn["data_dict"].items()}
    return syn


# ---------------------------------------------------------------------------
# The stacked engine (tests/test_batched.py:1296-1345)
# ---------------------------------------------------------------------------

def _problem(Q=37, J=5, I=2):
    """Random data and spectra, as the JAX package's kernel test makes
    them."""
    rng = np.random.default_rng(3)
    times = np.arange(-10.0, 40.05, 0.1)
    K = len(times)
    data = rng.standard_normal((I, K)) + 1j * rng.standard_normal((I, K))
    omegas = (0.5 + rng.random((Q, J))) + 1j * (-0.05 - 0.3 * rng.random(
        (Q, J)))
    mus = (rng.standard_normal((Q, I, J))
           + 1j * rng.standard_normal((Q, I, J)))
    return times, data, omegas, mus


def _summed(times, data, omegas, mus, t0, w):
    """The fits of the same window with summed Grams (engine.fit_systems,
    the complex128 form of sweep_spectra_real(analytic=False))."""
    from qnmfits_tpu_torch.engine import fit_core
    t = torch.as_tensor
    _, mm = fit_core(t(times), t(data), t(omegas), t(mus),
                     torch.tensor(t0, dtype=torch.float64), t(w))
    return mm.numpy()


WINDOWS = {
    "geq": (0.7, lambda t: (t >= 0.7) & (t < 25.7)),
    # 'closest': the nearest sample to t0 = 0.74 is 0.7, before t0.
    "closest_before_t0": (0.74, lambda t: (t >= 0.7) & (t < 25.7)),
    "one_sample": (0.7, lambda t: (t >= 0.65) & (t < 0.75)),
}


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_stacked_engine_matches_summed(window, chunk):
    times, data, omegas, mus = _problem()
    t0, sel = WINDOWS[window]
    w = sel(times).astype(float)
    idx = np.nonzero(w)[0]
    sl = slice(int(idx[0]), int(idx[-1]) + 1)
    t = torch.as_tensor
    C, mm = ter.sweep_spectra_stacked_real(
        t(times[sl]), t(data[:, sl]), t(omegas), t(mus), t0, chunk=chunk)
    assert C.shape == omegas.shape and mm.shape == (len(omegas),)
    mm_sum = _summed(times, data, omegas, mus, t0, w)
    if window == "one_sample":           # a zero trapezoid: 0/0 in both
        assert np.all(np.isnan(mm.numpy())) and np.all(np.isnan(mm_sum))
        return
    np.testing.assert_allclose(mm.numpy(), mm_sum, rtol=0, atol=STACK_TOL)
    _, _, mm_j = jer.sweep_spectra_stacked_real(
        times[sl], data.real[:, sl], data.imag[:, sl], omegas.real,
        omegas.imag, mus.real, mus.imag, t0, chunk=8)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=0,
                               atol=STACK_TOL)


@pytest.mark.parametrize("s", [-3.7, -0.04, 0.0, 0.06, 12.5])
def test_geom_series_eval_exact_for_negative_offsets(s):
    """The closed form at a first-sample offset s < 0 (a 'closest' window
    starting before t0) and with a scalar m broadcast over (Q, J, J),
    against the direct sums over m samples."""
    rng = np.random.default_rng(7)
    Q, J, K, dlt = 3, 4, 251, 0.1
    w = (0.3 + rng.random((Q, J))) - 1j * (0.05 + 0.4 * rng.random((Q, J)))
    nu = (w.imag[:, :, None] + w.imag[:, None, :]) \
        + 1j * (w.real[:, :, None] - w.real[:, None, :])
    Gt, Gtau = ter._geom_series_eval(
        dlt, K, torch.as_tensor(nu.real), torch.as_tensor(nu.imag),
        torch.tensor(s, dtype=torch.float64), torch.tensor(K))
    tk = s + dlt * np.arange(K)
    terms = np.exp(nu[..., None] * tk)
    ref = terms.sum(-1)
    tau = np.full(K, dlt)
    tau[[0, -1]] = dlt / 2
    ref_tau = (terms * tau).sum(-1)
    scale = np.abs(ref).max()
    assert np.abs(Gt.numpy() - ref).max() <= 1e-12 * scale
    assert np.abs(Gtau.numpy() - ref_tau).max() <= 1e-12 * scale


def test_stacked_engine_join_groups(monkeypatch):
    """A join budget of 10 grid points' systems: the grid is solved in
    groups of whole chunks, one solve call each, to the same result."""
    times, data, omegas, mus = _problem(Q=37, J=5)
    t = torch.as_tensor
    args = (t(times[107:358]), t(data[:, 107:358]), t(omegas), t(mus), 0.7)
    C1, mm1 = ter.sweep_spectra_stacked_real(*args, chunk=4)
    calls = []

    def solve(G, b):
        calls.append(b.shape[0])
        return ter._regularised_solve_plain(G, b)

    monkeypatch.setattr(ter, "JOIN_BYTES", 10 * 2 * 5 * 5 * 16)
    C2, mm2 = ter.sweep_spectra_stacked_real(*args, chunk=4, solve=solve)
    assert calls == [8, 8, 8, 8, 5]
    np.testing.assert_array_equal(mm1.numpy(), mm2.numpy())
    np.testing.assert_array_equal(C1.numpy(), C2.numpy())


# ---------------------------------------------------------------------------
# The public grids
# ---------------------------------------------------------------------------

M_CHI = ((0.9, 1.0), (0.6, 0.8))


@pytest.mark.parametrize("kind,t0_method,delta,t0", [
    ("array", "geq", 0.0, 0.7), ("array", "closest", 0.0, 0.74),
    ("array", "geq", 0.02, 0.0), ("dict", "geq", 0.0, 1.3),
    ("dict", "closest", [0.01, -0.02, 0.0, 0.03], 0.74)])
def test_M_chi_fast_matches_jax_and_batched(single, multi, kind, t0_method,
                                            delta, t0):
    if kind == "array":
        s = single
        args = (s["times"], s["data"], s["modes"][:3])
        kw = {}
    else:
        s = multi
        args = (s["times"], s["data_dict"], s["modes"])
        kw = dict(spherical_modes=SPH)
    kw.update(t0_method=t0_method, T=20.0, res=5, delta=delta)
    mm = tq.mismatch_M_chi_grid(*args, *M_CHI, t0, engine="fast",
                                device="cpu", **kw)
    mm_j = jf.mismatch_M_chi_grid(*args, *M_CHI, t0, engine="fast", **kw)
    mm_b = tq.mismatch_M_chi_grid(*args, *M_CHI, t0, device="cpu", **kw)
    assert mm.shape == mm_j.shape == (5, 5) and np.all(np.isfinite(mm))
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(mm, mm_b, rtol=0, atol=MM_TOL)


@pytest.mark.parametrize("n_fixed", [0, 1, 2])
@pytest.mark.parametrize("t0_method,t0", [("geq", 0.0), ("closest", 0.74)])
def test_omega_fast_full_matches_jax_and_batched(single, n_fixed, t0_method,
                                                 t0):
    """Fixed QNMs plus one free frequency (none fixed: one-mode systems);
    the Im axis reaches a growing mode (Im w > 0)."""
    s = single
    args = (s["times"], s["data"], s["modes"][:n_fixed], s["Mf"], s["chif"],
            (0.4, 0.6), (-0.2, 0.05), t0)
    kw = dict(t0_method=t0_method, T=20.0, res=4)
    mm = tq.mismatch_omega_grid(*args, engine="fast-full", device="cpu", **kw)
    mm_j = jf.mismatch_omega_grid(*args, engine="fast-full", **kw)
    mm_b = tq.mismatch_omega_grid(*args, device="cpu", **kw)
    assert mm.shape == (4, 4) and np.all(np.isfinite(mm))
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(mm, mm_b, rtol=0, atol=MM_TOL)


def test_grids_route_the_engines(single, monkeypatch):
    """A uniform grid with a contiguous window runs the stacked engine
    (one solve call for the grid); a non-uniform grid the summed sweep,
    equal to 'batched' and to JAX's 'fast' there."""
    s = single
    calls = []
    real = ter.sweep_spectra_stacked_real

    def spy(*a, **k):
        calls.append(a[2].shape)
        return real(*a, **k)

    monkeypatch.setattr(tb, "sweep_spectra_stacked_real", spy)
    kw = dict(T=20.0, res=3)
    tq.mismatch_M_chi_grid(s["times"], s["data"], s["modes"][:2], *M_CHI,
                           0.7, engine="fast", device="cpu", **kw)
    tq.mismatch_omega_grid(s["times"], s["data"], s["modes"][:1], s["Mf"],
                           s["chif"], (0.4, 0.6), (-0.2, 0.0), 0.7,
                           engine="fast-full", device="cpu", **kw)
    assert calls == [(9, 2), (9, 2)]

    rng = np.random.default_rng(1)
    times = np.sort(s["times"] + rng.uniform(-0.02, 0.02, len(s["times"])))
    args = (times, s["data"], s["modes"][:2], *M_CHI, 0.7)
    mm = tq.mismatch_M_chi_grid(*args, engine="fast", device="cpu", **kw)
    assert len(calls) == 2
    np.testing.assert_allclose(
        mm, tq.mismatch_M_chi_grid(*args, device="cpu", **kw), rtol=0,
        atol=MM_TOL)
    np.testing.assert_allclose(
        mm, jf.mismatch_M_chi_grid(*args, engine="fast", **kw), rtol=0,
        atol=MM_TOL)


def test_fast_grids_solve_once_through_the_layer(single):
    """Each grid is one call of the batched solve (the layer under the
    public entry point, with the solve substituted)."""
    s = single
    calls = []

    def solve(G, b):
        calls.append(tuple(b.shape))
        return ter._regularised_solve_plain(G, b)

    mm = tb.batch_mismatch_M_chi_fast(
        s["times"], s["data"], s["modes"][:3], *M_CHI, 0.7, T=20.0, res=6,
        chunk=5, device="cpu", solve=solve)
    assert calls == [(36, 3)]
    np.testing.assert_allclose(
        mm, tq.mismatch_M_chi_grid(s["times"], s["data"], s["modes"][:3],
                                   *M_CHI, 0.7, T=20.0, res=6, engine="fast",
                                   device="cpu"), rtol=0, atol=STACK_TOL)
    tb.batch_mismatch_omega_fast(
        s["times"], s["data"], s["modes"][:2], s["Mf"], s["chif"],
        (0.4, 0.6), (-0.2, 0.0), 0.7, T=20.0, res=5, device="cpu",
        solve=solve)
    assert calls == [(36, 3), (25, 3)]


def test_fast_grids_raise(single, multi):
    s = single
    args = (s["times"], s["data"], s["modes"][:2])
    for call in (
            lambda: tb.batch_mismatch_M_chi_fast(*args, *M_CHI, 0.0,
                                                 mesh="auto", device="cpu"),
            lambda: tb.batch_mismatch_omega_fast(
                *args, s["Mf"], s["chif"], (0.4, 0.6), (-0.2, -0.05), 0.0,
                mesh="auto", device="cpu"),
            lambda: tq.mismatch_M_chi_grid(*args, *M_CHI, 0.0, engine="fast",
                                           mesh="auto", device="cpu")):
        with pytest.raises(ValueError, match="init_process_group"):
            call()
    with pytest.raises(NotImplementedError, match="x64"):
        tq.mismatch_M_chi_grid(*args, *M_CHI, 0.0, engine="fast",
                               precision="f32", device="cpu")
    with pytest.raises(ValueError, match="single data series"):
        tq.mismatch_omega_grid(multi["times"], multi["data_dict"],
                               s["modes"][:1], s["Mf"], s["chif"],
                               (0.4, 0.6), (-0.2, -0.05), t0=0.0,
                               engine="fast-full", device="cpu")
    with pytest.raises(ValueError, match="chif"):
        tq.mismatch_M_chi_grid(*args, (0.9, 1.0), (0.6, 1.2), t0=0.0,
                               engine="fast", device="cpu")
    with pytest.raises(ValueError, match="t0_method"):
        tq.mismatch_M_chi_grid(*args, *M_CHI, 0.0, t0_method="nearest",
                               engine="fast", device="cpu")
