"""The port's surrogate containers (qnmfits_tpu_torch.waveforms:
NRSur7dq4, NRHybSur3dq8) against the JAX package's, both through the
playback shims of tests/test_surrogate_fixture.py, which serve the
recorded surrogate arrays (tests/data/fixture_surrogate.npz) in the
gwsurrogate / surfinBH call signatures; and the ImportError without
those packages."""

import sys

import numpy as np
import pytest

from qnmfits_tpu import waveforms as wj
from qnmfits_tpu_torch import waveforms as wt
from test_surrogate_fixture import FIXTURE, _playback_modules

ARRAYS = ("times", "Edot", "Moft", "Jdot", "chioft", "chioft_mag", "chif")
META = ("Mf", "Mf_err", "chif_mag", "thetaf", "phif", "q", "m1", "m2", "M",
        "f_ref", "ellMax", "zero_time", "zero_time_method")

CASES = {
    "hyb": ("NRHybSur3dq8", dict(q=2.0, chi1=[0, 0, 0.2],
                                 chi2=[0, 0, -0.1])),
    "sur": ("NRSur7dq4", dict(q=1.5, chi1=[0.1, 0.0, 0.3],
                              chi2=[0, 0, 0])),
}


@pytest.fixture(scope="module")
def rec():
    return np.load(FIXTURE)


def _same(a, b):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for name in META:
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.chif_err, b.chif_err)
    assert set(a.h) == set(b.h)
    for lm in b.h:
        np.testing.assert_array_equal(a.h[lm], b.h[lm], err_msg=str(lm))
    # The fluxes and foft run to ellMax (a recorded (5, 5) stays in h).
    assert set(a.hdot) == set(b.hdot) and set(a.foft) == set(b.foft)
    for lm in b.hdot:
        np.testing.assert_array_equal(a.hdot[lm], b.hdot[lm])
        np.testing.assert_array_equal(a.foft[lm], b.foft[lm])


@pytest.mark.parametrize("transform", [None, "rotation", "dynamic_rotation"])
@pytest.mark.parametrize("section", ["hyb", "sur"])
def test_surrogates_match_jax(rec, monkeypatch, section, transform):
    _playback_modules(monkeypatch, rec, section)
    name, kw = CASES[section]
    a = getattr(wt, name)(transform=transform, **kw)
    _same(a, getattr(wj, name)(transform=transform, **kw))
    assert np.all(np.isfinite(a.chioft_mag))
    assert a.Moft[-1] == pytest.approx(a.Mf, abs=1e-12)


def test_hybrid_symmetry_fill_and_truncation(rec, monkeypatch):
    """NRHybSur3dq8 fills m < 0 by h_{l,-m} = (-1)^l conj(h_{l,m}) and
    zeroes the modes it does not model, (4, +-1) and (4, 0); ellMax
    truncates; zero_time=None leaves the times as recorded."""
    _playback_modules(monkeypatch, rec, "hyb")
    kw = CASES["hyb"][1]
    a = wt.NRHybSur3dq8(**kw)
    np.testing.assert_array_equal(a.h[3, -3], -np.conj(a.h[3, 3]))
    for lm in ((4, 0), (4, 1), (4, -1)):
        assert not np.any(a.h[lm])
    assert a.times[0] == rec["times"][0]
    a3 = wt.NRHybSur3dq8(ellMax=3, **kw)
    assert max(l for l, _ in a3.h) == 3
    _same(a3, wj.NRHybSur3dq8(ellMax=3, **kw))


def test_precessing_remnant_contract(rec, monkeypatch):
    """NRSur7dq4Remnant is called with omega0 = pi f_ref (the shim
    asserts it); the rotation leaves chif along +z."""
    _playback_modules(monkeypatch, rec, "sur")
    a = wt.NRSur7dq4(transform="rotation", **CASES["sur"][1])
    assert a.Mf_err == pytest.approx(8e-5)
    assert a.thetaf > 1e-3
    np.testing.assert_allclose(a.chif, [0.0, 0.0, a.chif_mag], atol=1e-14)


@pytest.mark.parametrize("name", ["NRSur7dq4", "NRHybSur3dq8"])
def test_import_error_without_the_packages(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "gwsurrogate", None)
    monkeypatch.setitem(sys.modules, "surfinBH", None)
    with pytest.raises(ImportError) as got:
        getattr(wt, name)()
    with pytest.raises(ImportError) as ref:
        getattr(wj, name)()
    assert str(got.value) == str(ref.value)
    assert "gwsurrogate" in str(got.value)
