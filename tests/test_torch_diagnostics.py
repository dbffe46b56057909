"""The port's diagnostics against the JAX package's, on the CPU: the
rational filter, amplitude stability, the orthonormal-mode decomposition
and its t0 sweep, the amplitude uncertainty and mode selection.

The same numpy inputs go through qnmfits_tpu and qnmfits_tpu_torch
(device="cpu").  Bounds: the filter <= 1e-12 of max |data| (the JAX
package's own bar, tests/test_filters.py:63); amplitude_stability mm
<= 1e-11 for t0 >= 0 and its amplitudes and statistics <= 1e-9 relative
(the largest |difference| over the largest |value|); orthonormal powers
<= 1e-10 of the data norm; uncertainty C, cov, aic and bic <= 1e-9
relative, p-values <= 1e-9 absolute.
"""

import numpy as np
import pytest

import qnmfits_tpu as jq
from qnmfits_tpu import ref_impl as jref
from qnmfits_tpu.testing import synthetic_multimode, synthetic_single
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import ref_impl as tref

FILTER_TOL = 1e-12
MM_TOL = 1e-11
REL_TOL = 1e-9
POWER_TOL = 1e-10
P_TOL = 1e-9
SPH = [(2, 2), (3, 2)]


def _rel(x, ref):
    """max |x - ref| / max |ref| over the finite entries of ref (where ref
    is not finite, x must equal it); max |x| where ref is all zero."""
    x, ref = np.asarray(x), np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(x[~fin], ref[~fin])
    x, ref = x[fin], ref[fin]
    scale = np.max(np.abs(ref), initial=0.0)
    d = np.max(np.abs(x - ref), initial=0.0)
    return float(d / scale) if scale > 0 else float(np.max(np.abs(x),
                                                           initial=0.0))


@pytest.fixture(scope="module")
def single():
    """Three (2,2) overtones with noise, 400 samples (the stability and
    uncertainty statistics need a residual)."""
    return synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                            noise=1e-3, seed=3,
                            times=np.arange(-10.0, 30.0, 0.1))


@pytest.fixture(scope="module")
def multi():
    syn = synthetic_multimode(modes=[(2, 2, 0, 1), (2, 2, 1, 1),
                                     (3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-10.0, 30.0, 0.1), seed=4)
    rng = np.random.default_rng(5)
    syn["data_dict"] = {
        k: v + 1e-3 * (rng.standard_normal(v.shape)
                       + 1j * rng.standard_normal(v.shape))
        for k, v in syn["data_dict"].items()}
    return syn


def _case(kind, single, multi):
    """(times, data, modes, Mf, chif, extra kwargs) of array or dict data."""
    if kind == "array":
        s = single
        return s["times"], s["data"], s["modes"], s["Mf"], s["chif"], {}
    m = multi
    return (m["times"], m["data_dict"], m["modes"], m["Mf"], m["chif"],
            dict(spherical_modes=SPH))


# ---------------------------------------------------------------------------
# Rational filter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_mode_signal():
    """(2,2,0) + (2,2,1) from t = 0 on [-300, 150] at dt = 0.1
    (tests/test_filters.py:20-27)."""
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    w = SpectrumEvaluator([(2, 2, 0, 1), (2, 2, 1, 1)]).omega(0.692, 0.952)
    times = np.arange(-300.0, 150.0, 0.1)
    data = tref.ringdown(times, 0.0, [0.8 * np.exp(0.3j),
                                      2.1 * np.exp(-1.1j)], w)
    return dict(times=times, data=data, Mf=0.952, chif=0.692)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("modes,t_taper", [
    ([(2, 2, 0, 1), (2, 2, 1, 1)], 100),
    ([(2, 2, 0, 1)], 100),
    ([(2, 2, 0, 1), (2, 2, 1, 1)], 0),              # no taper
    ([(3, 2, 0, 1), (2, 2, 0, -1)], 50)])
def test_rational_filter_matches_jax(two_mode_signal, modes, t_taper, align):
    from qnmfits_tpu.filters import rational_filter_jax
    s = two_mode_signal
    args = (s["times"], s["data"], modes, s["Mf"], s["chif"])
    kw = dict(t_start=-300.0, t_taper=t_taper, align_inspiral=align)
    scale = np.max(np.abs(s["data"]))
    t_t, d_t = tq.rational_filter(*args, device="cpu", **kw)
    t_j, d_j = rational_filter_jax(*args, **kw)
    t_o, d_o = tref.rational_filter(*args, **kw)
    t_jo, d_jo = jref.rational_filter(*args, **kw)
    for t in (t_t, t_o):
        np.testing.assert_array_equal(t, t_j)
    np.testing.assert_array_equal(t_jo, t_j)
    assert np.max(np.abs(d_t - d_j)) <= FILTER_TOL * scale
    assert np.max(np.abs(d_o - d_jo)) <= FILTER_TOL * scale
    assert np.max(np.abs(d_t - d_o)) <= FILTER_TOL * scale


def test_rational_filter_removes_the_mode_and_engines(two_mode_signal):
    """Filtering (2,2,0) drops its refit amplitude >= 1e4 (the JAX
    package's behavioural bar, tests/test_filters.py:31); engine='numpy'
    is the oracle, any other engine a ValueError."""
    s = two_mode_signal
    args = (s["times"], s["data"], [(2, 2, 0, 1)], s["Mf"], s["chif"])
    t_u, d_f = tq.rational_filter(*args, t_start=-300.0,
                                  align_inspiral=False, device="cpu")
    modes2 = [(2, 2, 0, 1), (2, 2, 1, 1)]
    before = tref.ringdown_fit(s["times"], s["data"], modes2, s["Mf"],
                               s["chif"], t0=10.0, T=80.0)
    after = tref.ringdown_fit(t_u, d_f, modes2, s["Mf"], s["chif"], t0=10.0,
                              T=80.0)
    assert abs(after["C"][0]) / abs(before["C"][0]) < 1e-4
    assert abs(after["C"][1]) > 0.3 * abs(before["C"][1])
    t_n, d_n = tq.rational_filter(*args, engine="numpy")
    np.testing.assert_array_equal(t_n, tref.rational_filter(*args)[0])
    np.testing.assert_array_equal(d_n, tref.rational_filter(*args)[1])
    with pytest.raises(ValueError, match="engine"):
        tq.rational_filter(*args, engine="jax", device="cpu")


# ---------------------------------------------------------------------------
# Amplitude stability
# ---------------------------------------------------------------------------

STAB_T0S = np.linspace(-2.0, 10.0, 61)


@pytest.mark.parametrize("kind,t0_method,delta", [
    ("array", "geq", 0.0), ("array", "closest", 0.0),
    ("array", "geq", 0.01), ("dict", "geq", 0.0), ("dict", "closest", 0.0)])
def test_amplitude_stability_matches_jax(single, multi, kind, t0_method,
                                         delta):
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    kw = dict(kw, t0_method=t0_method, T_array=20.0, t_ref=0.5)
    if delta:
        kw["delta"] = delta
    out = tq.amplitude_stability(times, data, modes, Mf, chif, STAB_T0S,
                                 device="cpu", **kw)
    ref = jq.amplitude_stability(times, data, modes, Mf, chif, STAB_T0S,
                                 **kw)
    assert sorted(out) == sorted(ref)
    assert out["modes"] == [tuple(m) for m in ref["modes"]]
    np.testing.assert_array_equal(out["t0s"], ref["t0s"])
    np.testing.assert_allclose(out["omega"], ref["omega"], rtol=1e-14,
                               atol=0)
    post = STAB_T0S >= 0
    assert np.max(np.abs(out["mm"] - ref["mm"])[post]) <= MM_TOL
    for key in ("C", "A", "mean_A", "rel_std", "scatter", "phase_std"):
        assert out[key].shape == ref[key].shape, key
        assert _rel(out[key], ref[key]) <= REL_TOL, key


def test_amplitude_stability_dedup_and_raises(single):
    s = single
    args = (s["times"], s["data"], s["modes"], s["Mf"], s["chif"], STAB_T0S)
    on = tq.amplitude_stability(*args, T_array=20.0, device="cpu")
    off = tq.amplitude_stability(*args, T_array=20.0, dedup=False,
                                 device="cpu")
    np.testing.assert_allclose(on["mm"], off["mm"], rtol=0, atol=1e-13)
    assert _rel(on["A"], off["A"]) <= 1e-12
    track = np.full(len(s["times"]), s["chif"])
    with pytest.raises(ValueError, match="static"):
        tq.amplitude_stability(s["times"], s["data"], s["modes"], s["Mf"],
                               track, STAB_T0S, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        tq.amplitude_stability(*args[:5], np.array([]), device="cpu")
    with pytest.raises(NotImplementedError, match="x64"):
        tq.amplitude_stability(*args, precision="f32", device="cpu")


def test_amplitude_stability_zero_mode_rules():
    """A mode with zero amplitude everywhere (all-zero data) reads inf in
    every relative measure, as in the JAX function."""
    times = np.arange(-5.0, 30.0, 0.1)
    data = np.zeros(len(times), complex)
    modes = [(2, 2, 0, 1), (2, 2, 1, 1)]
    kw = dict(T_array=20.0)
    t0s = np.linspace(0.0, 5.0, 11)
    out = tq.amplitude_stability(times, data, modes, 0.952, 0.692, t0s,
                                 device="cpu", **kw)
    ref = jq.amplitude_stability(times, data, modes, 0.952, 0.692, t0s, **kw)
    for key in ("rel_std", "scatter", "phase_std"):
        np.testing.assert_array_equal(out[key], ref[key])
        assert np.all(np.isinf(out[key]))


# ---------------------------------------------------------------------------
# Orthonormal modes
# ---------------------------------------------------------------------------

ORTHO_T0S = np.linspace(-1.0, 12.0, 27)


@pytest.mark.parametrize("kind", ["array", "dict"])
@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_orthonormal_decomposition_matches_jax(single, multi, kind,
                                               t0_method):
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    for t0 in (0.0, 3.33):
        out = tq.orthonormal_decomposition(times, data, modes, Mf, chif, t0,
                                           t0_method=t0_method, T=20.0,
                                           device="cpu", **kw)
        ref = jq.orthonormal_decomposition(times, data, modes, Mf, chif, t0,
                                           t0_method=t0_method, T=20.0, **kw)
        assert sorted(out) == sorted(ref)
        dn = ref["data_norm"]
        assert abs(out["data_norm"] - dn) <= POWER_TOL * dn
        assert np.max(np.abs(out["power"] - ref["power"])) <= POWER_TOL * dn
        assert _rel(out["b"], ref["b"]) <= REL_TOL
        assert _rel(out["C"], ref["C"]) <= REL_TOL
        for key in ("explained_fraction", "cumulative_explained",
                    "mismatch"):
            assert np.max(np.abs(np.asarray(out[key]) - ref[key])) \
                <= POWER_TOL, key


@pytest.mark.parametrize("kind", ["array", "dict"])
@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_orthonormal_t0_sweep_matches_jax(single, multi, kind, t0_method,
                                          monkeypatch):
    """Every window's power against the JAX sweep, in chunks of 5 windows
    (the basis budget monkeypatched down) and in one."""
    from qnmfits_tpu_torch import batched
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    args = (times, data, modes, Mf, chif, ORTHO_T0S)
    kw = dict(kw, t0_method=t0_method, T_array=20.0)
    ref = jq.orthonormal_t0_sweep(*args, **kw)
    one = tq.orthonormal_t0_sweep(*args, device="cpu", **kw)
    monkeypatch.setattr(batched, "_BASIS_BYTES",
                        5 * len(times) * len(modes) * 16)
    out = tq.orthonormal_t0_sweep(*args, device="cpu", **kw)
    for key in ref:
        np.testing.assert_array_equal(out[key], one[key])
    assert sorted(out) == sorted(ref)
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    assert np.all(out["ok"])
    dn = ref["data_norm"]
    assert np.max(np.abs(out["data_norm"] - dn) / dn) <= POWER_TOL
    assert np.max(np.abs(out["power"] - ref["power"]) / dn[:, None]) \
        <= POWER_TOL
    for key in ("cumulative_explained", "explained_fraction", "mismatch"):
        assert np.max(np.abs(out[key] - ref[key])) <= POWER_TOL, key


def test_orthonormal_sweep_matches_single_shot(single):
    s = single
    t0s = ORTHO_T0S[ORTHO_T0S >= 0][::5]
    out = tq.orthonormal_t0_sweep(s["times"], s["data"], s["modes"], s["Mf"],
                                  s["chif"], t0s, T_array=20.0, device="cpu")
    for i, t0 in enumerate(t0s):
        one = tq.orthonormal_decomposition(
            s["times"], s["data"], s["modes"], s["Mf"], s["chif"], t0,
            T=20.0, device="cpu")
        assert np.max(np.abs(out["power"][i] - one["power"])) \
            <= POWER_TOL * one["data_norm"]


def test_orthonormal_degenerate_and_empty(single):
    """A duplicated mode: the single shot raises, and the sweep flags the
    windows of the JAX package's own degenerate case not ok
    (tests/test_orthonormal.py:128), as JAX's sweep does.  (Whether a
    factor of an exactly singular Gram fails is rounding noise, in both
    packages: elsewhere the flags of that set are not compared.)  A
    window past the data flags not ok in both and one of no data power ok
    with a NaN mismatch; the single shot raises on both."""
    s = single
    dup = [s["modes"][0], s["modes"][0]]
    args = (s["times"], s["data"], dup, s["Mf"], s["chif"])
    with pytest.raises(ValueError, match="degenerate"):
        tq.orthonormal_decomposition(*args, 0.0, T=20.0, device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        jq.orthonormal_decomposition(*args, 0.0, T=20.0)
    syn = synthetic_single(modes=[(2, 2, n, 1) for n in range(4)],
                           noise=0.0, seed=5)
    args = (syn["times"], syn["data"], [syn["modes"][0]] * 2, syn["Mf"],
            syn["chif"], np.array([0.0, 5.0]))
    out = tq.orthonormal_t0_sweep(*args, T_array=80.0, device="cpu")
    ref = jq.orthonormal_t0_sweep(*args, T_array=80.0)
    np.testing.assert_array_equal(out["ok"], ref["ok"])
    assert not np.any(out["ok"])

    args = (s["times"], s["data"], s["modes"], s["Mf"], s["chif"])
    t0s = np.array([-9.0, 0.0, 5.0, 1e4])         # -9: only zero data
    data0 = np.where(s["times"] < 0, 0.0, s["data"])
    for d in (s["data"], data0):
        out = tq.orthonormal_t0_sweep(s["times"], d, *args[2:], t0s,
                                      T_array=5.0, device="cpu")
        ref = jq.orthonormal_t0_sweep(s["times"], d, *args[2:], t0s,
                                      T_array=5.0)
        np.testing.assert_array_equal(out["ok"], ref["ok"])
        ok = ref["ok"]
        assert not ok[-1] and ok[1] and ok[2]
        np.testing.assert_array_equal(np.isfinite(out["mismatch"]),
                                      np.isfinite(ref["mismatch"]))
    with pytest.raises(ValueError, match="empty fit window"):
        tq.orthonormal_decomposition(*args, 1e4, T=10.0, device="cpu")
    with pytest.raises(ValueError, match="empty fit window"):
        tq.orthonormal_decomposition(s["times"], data0, *args[2:], -9.0,
                                     T=5.0, device="cpu")


@pytest.mark.parametrize("kind", ["array", "dict"])
def test_fit_systems_trapezoid_pieces_are_the_orthonormal_gram(single, multi,
                                                               kind):
    """engine.fit_systems' G_tau, r_tau and data_norm are the Gram, the
    projections and the data norm the JAX orthonormal functions build
    (orthonormal.py:71-86), on the same window."""
    import torch
    from qnmfits_tpu.engine import SpectrumEvaluator as JEv, _window as jwin
    from qnmfits_tpu.ops.windows import trapz_weights as jtrapz
    from qnmfits_tpu_torch.engine import _window, fit_systems
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    sph = kw.get("spherical_modes")
    rows = (np.asarray(data)[None] if sph is None
            else np.stack([data[lm] for lm in sph]))
    ev = JEv([tuple(m) for m in modes], sph)
    omega = np.array(ev.omega(chif, Mf))
    mu = (np.ones((1, len(omega)), complex) if sph is None
          else np.array(ev.mu(chif)))
    t0, T = 1.37, 20.0
    w = np.asarray(jwin(times, t0, T, "geq"))
    tau = np.asarray(jtrapz(times, w))
    phi = np.exp(-1j * omega[None, :] * ((times[:, None] - t0) * w[:, None]))
    phit = phi * tau[:, None]
    G = (mu.conj().T @ mu) * (phit.conj().T @ phi)
    r = np.einsum("ij,ij->j", mu.conj(),
                  np.einsum("kj,ik->ij", phit.conj(), rows))
    dn = float(np.real(np.sum(tau[None, :] * rows * np.conj(rows))))

    tt = torch.as_tensor(times)
    t0t = torch.tensor(t0, dtype=torch.float64)
    wt = _window(tt, t0t, T, "geq")
    _, _, G_t, r_t, dn_t = fit_systems(tt, torch.as_tensor(rows),
                                       torch.as_tensor(omega),
                                       torch.as_tensor(mu), t0t, wt)
    np.testing.assert_array_equal(wt.numpy(), w)
    assert _rel(G_t.numpy(), G) <= 1e-13
    assert _rel(r_t.numpy(), r) <= 1e-13
    assert abs(float(dn_t) - dn) <= 1e-13 * dn


# ---------------------------------------------------------------------------
# Amplitude uncertainty and mode selection
# ---------------------------------------------------------------------------

def _check_uncertainty(out, ref):
    assert sorted(out) == sorted(ref)
    assert out["n_obs"] == ref["n_obs"] and out["dof"] == ref["dof"]
    np.testing.assert_allclose(out["omega"], ref["omega"], rtol=1e-13,
                               atol=0)
    for key in ("C", "cov", "sigma_C", "corr", "snr"):
        assert out[key].shape == ref[key].shape, key
        assert _rel(out[key], ref[key]) <= REL_TOL, key
    assert abs(out["sigma2"] - ref["sigma2"]) <= REL_TOL * ref["sigma2"]


@pytest.mark.parametrize("kind,t0_method,sigma", [
    ("array", "geq", None), ("array", "closest", None),
    ("array", "geq", 2e-3), ("dict", "geq", None), ("dict", "closest", 0.0)])
def test_amplitude_uncertainty_matches_jax(single, multi, kind, t0_method,
                                           sigma):
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    kw = dict(kw, t0_method=t0_method, T=20.0, sigma=sigma)
    out = tq.amplitude_uncertainty(times, data, modes, Mf, chif, 1.05,
                                   device="cpu", **kw)
    ref = jq.amplitude_uncertainty(times, data, modes, Mf, chif, 1.05, **kw)
    _check_uncertainty(out, ref)


@pytest.mark.parametrize("kind", ["array", "dict"])
@pytest.mark.parametrize("tracks", ["Mf", "chif", "both"])
def test_amplitude_uncertainty_dynamic_matches_jax(single, multi, kind,
                                                   tracks):
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    K = len(times)
    if tracks in ("Mf", "both"):
        Mf = np.linspace(1.02 * Mf, Mf, K)
    if tracks in ("chif", "both"):
        chif = np.linspace(0.65, chif, K)
    out = tq.amplitude_uncertainty(times, data, modes, Mf, chif, 1.05,
                                   T=20.0, device="cpu", **kw)
    ref = jq.amplitude_uncertainty(times, data, modes, Mf, chif, 1.05,
                                   T=20.0, **kw)
    assert out["omega"].ndim == 2
    _check_uncertainty(out, ref)
    with pytest.raises(ValueError, match="track length"):
        tq.amplitude_uncertainty(times, data, modes, np.full(K - 1, 0.95),
                                 0.69, 1.05, device="cpu", **kw)


@pytest.mark.parametrize("kind", ["array", "dict"])
def test_mode_selection_matches_jax(single, multi, kind):
    times, data, modes, Mf, chif, kw = _case(kind, single, multi)
    models = [modes[:1], modes[:2], modes, modes[1:]]    # last: not nested
    out = tq.mode_selection(times, data, models, Mf, chif, 0.5, T=20.0,
                            device="cpu", **kw)
    ref = jq.mode_selection(times, data, models, Mf, chif, 0.5, T=20.0, **kw)
    assert sorted(out) == sorted(ref)
    for key in ("n_modes", "n_params", "best_aic", "best_bic", "n_obs"):
        np.testing.assert_array_equal(out[key], ref[key])
    for key in ("rss", "aic", "bic", "fstat"):
        np.testing.assert_array_equal(np.isnan(out[key]),
                                      np.isnan(ref[key]))
        ok = ~np.isnan(ref[key])
        assert _rel(out[key][ok], ref[key][ok]) <= REL_TOL, key
    for key in ("delta_aic", "delta_bic"):
        assert np.max(np.abs(out[key] - ref[key])) \
            <= REL_TOL * np.max(np.abs(ref["aic"])), key
    np.testing.assert_array_equal(np.isnan(out["pvalue"]),
                                  np.isnan(ref["pvalue"]))
    ok = ~np.isnan(ref["pvalue"])
    assert np.max(np.abs(out["pvalue"][ok] - ref["pvalue"][ok])) <= P_TOL
    assert np.isnan(out["pvalue"][-1])


def test_uncertainty_errors(single, multi):
    """The degenerate (text matched as JAX's tests match it), empty-window,
    too-few-candidates and no-residual errors; mapping_modes= with array
    data or a remnant track raises the JAX package's errors."""
    s = single
    args = (s["times"], s["data"])
    dup = [s["modes"][0], s["modes"][0]]
    for fn in (tq.amplitude_uncertainty, jq.amplitude_uncertainty):
        kw = dict(device="cpu") if fn is tq.amplitude_uncertainty else {}
        with pytest.raises(ValueError, match="degenerate"):
            fn(*args, dup, s["Mf"], s["chif"], 0.0, T=20.0, **kw)
        with pytest.raises(ValueError, match="empty fit window"):
            fn(*args, s["modes"], s["Mf"], s["chif"], 1e4, T=20.0, **kw)
        with pytest.raises(ValueError, match="residual degrees"):
            fn(*args, s["modes"][:1], s["Mf"], s["chif"], 0.05, T=0.1, **kw)
    models = [s["modes"][:1], dup]
    for fn in (tq.mode_selection, jq.mode_selection):
        kw = dict(device="cpu") if fn is tq.mode_selection else {}
        with pytest.raises(ValueError, match="candidate 1 is numerically "
                                             "degenerate"):
            fn(*args, models, s["Mf"], s["chif"], 0.0, T=20.0, **kw)
        with pytest.raises(ValueError, match="at least two"):
            fn(*args, models[:1], s["Mf"], s["chif"], 0.0, **kw)
    m = multi
    track = np.full(len(m["times"]), m["chif"])
    for call, match in (
            (lambda: tq.amplitude_uncertainty(
                s["times"], s["data"], s["modes"], s["Mf"], s["chif"], 0.0,
                mapping_modes=[(2, 2, 0, 1)], device="cpu"), "dict data"),
            (lambda: tq.mode_selection(
                m["times"], m["data_dict"], [m["modes"][:1], m["modes"]],
                m["Mf"], track, 0.0, spherical_modes=SPH,
                mapping_modes=[(2, 2, 0, 1)], device="cpu"), "static")):
        with pytest.raises(ValueError, match=match):
            call()
