"""The port's waveform layer (qnmfits_tpu_torch.waveforms: the base
pipeline and Custom) against the JAX package's on the same seed-made
modes: every transform, both foft methods, the zero_time anchors and the
spin guards.  Arrays must agree to 1e-13 of their largest magnitude."""

import numpy as np
import pytest

from qnmfits_tpu.waveforms import Custom as CustomJ
from qnmfits_tpu_torch.waveforms import Custom as CustomT

ELL, K = 4, 2001
MF = 0.952
REL = 1e-13
ARRAYS = ("Edot", "Moft", "Jdot", "chioft", "chioft_mag", "times")


@pytest.fixture(scope="module")
def modes():
    """Every (l, m) to ELL on K samples at 0.1 from t = -20: two damped
    sinusoids a mode switched on smoothly, amplitudes and frequencies from
    seed 5, so that the fluxes, the peak and the spin track are not
    trivial."""
    rng = np.random.default_rng(5)
    times = np.arange(K) * 0.1 - 20.0
    env = 0.5 * (1.0 + np.tanh(times / 4.0))
    data = {}
    for l in range(2, ELL + 1):
        for m in range(-l, l + 1):
            w = rng.uniform(0.2, 0.9, 2) * np.sign(m or 1) \
                - 1j * rng.uniform(0.05, 0.2, 2)
            a = (rng.standard_normal(2) + 1j * rng.standard_normal(2)) \
                * 10.0 ** (2 - l)
            data[l, m] = env * (np.exp(-1j * np.outer(times, w)) @ a)
    return times, data


def _spin(theta, phi, mag=0.692):
    return mag * np.array([np.sin(theta) * np.cos(phi),
                           np.sin(theta) * np.sin(phi), np.cos(theta)])


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(float(np.max(np.abs(b))), 1e-300)
    assert float(np.max(np.abs(a - b))) <= REL * scale, what


def _same(wt, wj):
    """Every array of the two containers agrees."""
    for name in ARRAYS:
        _close(getattr(wt, name), getattr(wj, name), name)
    assert set(wt.h) == set(wj.h)
    for lm in wj.h:
        _close(wt.h[lm], wj.h[lm], f"h{lm}")
        _close(wt.hdot[lm], wj.hdot[lm], f"hdot{lm}")
        _close(wt.foft[lm], wj.foft[lm], f"foft{lm}")
    _close(wt.chif, wj.chif, "chif")
    assert wt.zero_time == wj.zero_time
    assert wt.zero_time_method == wj.zero_time_method


def _both(times, data, chif, **kw):
    md = {"remnant_mass": MF, "remnant_dimensionless_spin": chif}
    return (CustomT(times, dict(data), md, **kw),
            CustomJ(times, dict(data), md, **kw))


@pytest.mark.parametrize("transform", [
    None, "boost", "rotation", "dynamic_rotation",
    ["rotation", "dynamic_rotation"]])
def test_transforms_match_jax(modes, transform):
    times, data = modes
    wt, wj = _both(times, data, _spin(0.6, 2.0), transform=transform)
    _same(wt, wj)
    expected = [transform] if not isinstance(transform, list) else transform
    stages = {"rotation", "dynamic_rotation"} & set(expected)
    assert stages <= set(wt.stage_seconds)
    assert {"hdot", "Moft", "chioft", "time_shift", "foft"} \
        <= set(wt.stage_seconds)


@pytest.mark.parametrize("zero_time", [0, 3.7, (2, 2), (3, -1), "norm",
                                       "Edot"])
def test_zero_time_anchors_match_jax(modes, zero_time):
    times, data = modes
    wt, wj = _both(times, data, _spin(0.3, -1.0), zero_time=zero_time)
    _same(wt, wj)


def test_foft_zero_crossings_match_jax(modes):
    times, data = modes
    wt, wj = _both(times, data, _spin(0.6, 2.0), transform="rotation")
    wt.calculate_foft("zero_crossings")
    wj.calculate_foft("zero_crossings")
    for lm in wj.foft:
        for pol in ("plus", "cross"):
            _close(wt.foft[lm][pol], wj.foft[lm][pol], f"foft{lm}{pol}")
    with pytest.raises(ValueError, match="unknown foft method"):
        wt.calculate_foft("bogus")


@pytest.mark.parametrize("chif", [[0.0, 0.0, 0.7], [0.0, 0.0, -0.7],
                                  [0.0, 0.0, 0.0]],
                         ids=["aligned", "anti-aligned", "zero"])
@pytest.mark.parametrize("transform", ["rotation", "dynamic_rotation"])
def test_spin_guards_match_jax(modes, chif, transform):
    """Aligned spin: 'rotation' is a no-op; anti-aligned: a rotation by
    pi; zero spin: no rotation (and 'dynamic_rotation' the identity at
    samples whose spin vanishes).  All finite, all as the JAX package."""
    times, data = modes
    wt, wj = _both(times, data, np.array(chif), transform=transform)
    _same(wt, wj)
    assert all(np.all(np.isfinite(v)) for v in wt.h.values())
    if transform == "rotation":
        np.testing.assert_allclose(wt.chif, [0.0, 0.0, np.linalg.norm(chif)],
                                   atol=1e-15)


def test_dynamic_rotation_zero_spin_samples_match_jax():
    """A spin track through zero (data that radiate no angular momentum):
    the identity at those samples, as the JAX package."""
    times = np.arange(0.0, 60.0, 0.1)
    d = {(2, m): np.zeros(len(times), complex) for m in range(-2, 3)}
    d[(2, 0)] = np.exp(-0.09 * times) * np.cos(0.5 * times)
    wt, wj = _both(times, d, np.zeros(3), transform="dynamic_rotation")
    _same(wt, wj)


def test_project_signal_and_ellmax_match_jax(modes):
    times, data = modes
    wt, wj = _both(times, data, _spin(0.6, 2.0), ellMax=3,
                   transform="rotation")
    assert wt.ellMax == 3 and max(l for l, _ in wt.h) == 3
    _same(wt, wj)
    for th, ph in ((0.3, 1.0), (2.0, -0.4)):
        _close(wt.project_signal(th, ph), wj.project_signal(th, ph),
               "project_signal")


def test_metadata_and_errors_match_jax(modes):
    times, data = modes
    md = {"remnant_mass": MF, "remnant_dimensionless_spin": _spin(0.6, 2.0),
          "reference_mass1": 0.6, "reference_mass2": 0.4,
          "reference_time": 120.0, "remnant_velocity": [1e-3, 0.0, 0.0]}
    wt, wj = CustomT(times, data, md), CustomJ(times, data, md)
    for name in ("M", "m1", "m2", "reference_time", "thetaf", "phif",
                 "chif_mag"):
        assert getattr(wt, name) == getattr(wj, name), name
    np.testing.assert_array_equal(wt.vf, wj.vf)
    with pytest.raises(KeyError, match="remnant_mass"):
        CustomT(times, data, {"remnant_mass": MF})
    with pytest.raises(ValueError, match="unknown transformation"):
        CustomT(times, data, md, transform="shear")
