"""The port's SXS loader (qnmfits_tpu_torch.waveforms.SXS) against the JAX
package's on the BBH fixture in an SXS-format cache under tmp_path, with
the `sxs` package blocked (nothing is downloaded): the arrays and the
metadata, Lev selection, the error texts, a zero-spin remnant; then fits
through the port (device="cpu") against the JAX package's and its pins
(tests/test_sxs_fixture.py)."""

import json
import os
import sys

import h5py
import numpy as np
import pytest

import chip_smoke
import qnmfits_tpu as qf
import qnmfits_tpu_torch as qt
from qnmfits_tpu.waveforms import sxs as sxs_j
from qnmfits_tpu_torch import ref_impl
from qnmfits_tpu_torch.waveforms import sxs as sxs_t

ARRAYS = ("times", "Edot", "Moft", "Jdot", "chioft", "chioft_mag")
META = ("Mf", "chif_mag", "thetaf", "phif", "q", "M", "chi_eff", "chip",
        "Sp", "S1_perp", "S2_perp", "chi1_para", "chi2_para", "Norbits",
        "common_horizon_time", "reference_time", "level", "highest_lev",
        "zero_time", "zero_time_method", "ellMax")
META_ARRAYS = ("chif", "chi1", "chi2", "r1", "r2", "L", "L_norm", "com",
               "Sf", "vf", "omega_ref")


@pytest.fixture(scope="module")
def fix():
    return np.load(os.path.join(chip_smoke.FIXTURES,
                                "fixture_bbh_waveform.npz"))


@pytest.fixture(scope="module")
def cache(fix, tmp_path_factory):
    root = tmp_path_factory.mktemp("sxs_cache_torch")
    chip_smoke.write_sxs_cache(str(root), fix)
    return root


def _load(module, root, ID=chip_smoke.W1_ID, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "sxs", None)
        mp.setenv("SXS_CACHE_DIR", str(root))
        return module.SXS(ID, **kw)


def _same(wt, wj):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name),
                                      err_msg=name)
    for name in META:
        assert getattr(wt, name) == getattr(wj, name), name
    for name in META_ARRAYS:
        np.testing.assert_array_equal(getattr(wt, name), getattr(wj, name),
                                      err_msg=name)
    assert set(wt.h) == set(wj.h)
    for lm in wj.h:
        np.testing.assert_array_equal(wt.h[lm], wj.h[lm])
        np.testing.assert_array_equal(wt.hdot[lm], wj.hdot[lm])
        np.testing.assert_array_equal(wt.foft[lm], wj.foft[lm])


@pytest.fixture(scope="module")
def wf(cache):
    return _load(sxs_t, cache, zero_time=(2, 2))


@pytest.mark.parametrize("kw", [
    dict(zero_time=(2, 2)), dict(zero_time="common_horizon"),
    dict(zero_time="Edot", transform="rotation"),
    dict(ellMax=2, transform="dynamic_rotation")],
    ids=["peak", "common_horizon", "Edot-rotation", "ellMax2-dynamic"])
def test_loader_matches_jax(cache, kw):
    wt = _load(sxs_t, cache, **kw)
    _same(wt, _load(sxs_j, cache, **kw))
    assert "load" in wt.stage_seconds


def test_default_zero_time_and_print_metadata(cache, capsys):
    wt = _load(sxs_t, cache)
    assert wt.zero_time_method == "Simulation default"
    wt.print_metadata()
    assert "chi_eff" in capsys.readouterr().out


def test_sxs_package_branch_reads_what_the_cache_holds(fix, wf,
                                                       monkeypatch):
    """chip_smoke's playback serves the fixture through the loader's
    `sxs`-package branch (the card's machine has no h5py): the waveform
    equals the one from the SXS-format cache, array for array."""
    monkeypatch.setitem(sys.modules, "sxs", chip_smoke.sxs_playback(fix))
    wp = sxs_t.SXS(chip_smoke.W1_ID, zero_time=(2, 2))
    _same(wp, wf)
    with pytest.raises(KeyError, match="holds no"):
        sxs_t.SXS(chip_smoke.W1_ID, lev_minus_highest=-1)


@pytest.fixture()
def multi_lev(tmp_path):
    """Lev2 and Lev5 of one simulation, told apart by their remnant mass
    (tests/test_sxs_loader.py:99-132), and an ID with a flat file."""
    root = tmp_path / "cache"
    times = np.arange(0.0, 400.0, 0.2)
    h = 0.3 * np.exp(-((times - 300.0) / 60.0) ** 2) \
        * np.exp(-2j * 0.2 * (times - 300.0))
    for ID, lev, mf, flat in ((8888, 2, 0.90, False), (8888, 5, 0.95, False),
                              (6666, 1, 0.93, True)):
        sim = root / f"SXS_BBH_{ID}" / f"Lev{lev}"
        sim.mkdir(parents=True)
        md = {
            "simulation_name": f"SXS:BBH:{ID}/Lev{lev}",
            "reference_time": 200.0,
            "reference_mass1": 0.5556, "reference_mass2": 0.4444,
            "reference_dimensionless_spin1": [0.0, 0.0, 0.33],
            "reference_dimensionless_spin2": [0.0, 0.0, -0.44],
            "reference_position1": [5.0, 0.1, 0.0],
            "reference_position2": [-6.0, -0.1, 0.0],
            "reference_orbital_frequency": [0.0, 0.0, 0.017],
            "common_horizon_time": 3812.0, "number_of_orbits": 5.2,
            "remnant_mass": mf,
            "remnant_dimensionless_spin": [0.0, 0.0, 0.69],
            "remnant_velocity": [1e-4, -2e-4, 3e-5],
        }
        (sim / "metadata.json").write_text(json.dumps(md))
        with h5py.File(sim / "rhOverM_Asymptotic_GeometricUnits_CoM.h5",
                       "w") as f:
            grp = f if flat else f.create_group("Extrapolated_N2.dir")
            for m in range(-2, 3):
                hm = h if abs(m) == 2 else np.zeros(len(times), complex)
                grp.create_dataset(
                    f"Y_l2_m{m}.dat",
                    data=np.stack([times, hm.real, hm.imag], axis=1))
    return root


@pytest.mark.parametrize("kw,level", [
    (dict(), 5), (dict(lev_minus_highest=-3), 2)])
def test_lev_selection_matches_jax(multi_lev, kw, level):
    wt = _load(sxs_t, multi_lev, ID=8888, zero_time=(2, 2), **kw)
    _same(wt, _load(sxs_j, multi_lev, ID=8888, zero_time=(2, 2), **kw))
    assert wt.level == level and wt.highest_lev == 5


def test_flat_file_matches_jax(multi_lev):
    kw = dict(ID=6666, zero_time=(2, 2), extrapolation_order=4)
    _same(_load(sxs_t, multi_lev, **kw), _load(sxs_j, multi_lev, **kw))


def _error(module, root, exc, **kw):
    with pytest.raises(exc) as info:
        _load(module, root, **kw)
    return str(info.value)


@pytest.mark.parametrize("kw,exc", [
    (dict(ID=8888, lev_minus_highest=-1), FileNotFoundError),
    (dict(ID=8888, extrapolation_order=4), KeyError),
    (dict(ID=8888, extrapolation_order=-1), KeyError),
    (dict(ID=1234), FileNotFoundError)],
    ids=["missing-lev", "missing-extrapolation", "missing-outermost",
         "missing-id"])
def test_errors_word_for_word(multi_lev, kw, exc):
    assert _error(sxs_t, multi_lev, exc, **kw) \
        == _error(sxs_j, multi_lev, exc, **kw)


def test_zero_spin_remnant_matches_jax(tmp_path):
    """chif = 0: thetaf = phif = 0, 'rotation' a no-op, every array
    finite, as the JAX package (tests/test_sxs_loader.py:180)."""
    sim = tmp_path / "cache" / "SXS_BBH_7777" / "Lev3"
    sim.mkdir(parents=True)
    md = {
        "simulation_name": "SXS:BBH:7777/Lev3", "reference_time": 200.0,
        "reference_mass1": 0.5, "reference_mass2": 0.5,
        "reference_dimensionless_spin1": [0.0, 0.0, 0.6],
        "reference_dimensionless_spin2": [0.0, 0.0, -0.6],
        "reference_position1": [5.0, 0.1, 0.0],
        "reference_position2": [-5.0, -0.1, 0.0],
        "reference_orbital_frequency": [0.0, 0.0, 0.017],
        "common_horizon_time": 300.0, "number_of_orbits": 5.2,
        "remnant_mass": 0.95, "remnant_dimensionless_spin": [0.0, 0.0, 0.0],
        "remnant_velocity": [0.0, 0.0, 0.0],
    }
    (sim / "metadata.json").write_text(json.dumps(md))
    times = np.arange(0.0, 400.0, 0.2)
    h = 0.3 * np.exp(-((times - 300.0) / 60.0) ** 2) \
        * np.exp(-2j * 0.2 * (times - 300.0))
    with h5py.File(sim / "rhOverM_Asymptotic_GeometricUnits_CoM.h5",
                   "w") as f:
        grp = f.create_group("Extrapolated_N2.dir")
        for m in range(-2, 3):
            hm = h if abs(m) == 2 else np.zeros(len(times), complex)
            grp.create_dataset(f"Y_l2_m{m}.dat",
                               data=np.stack([times, hm.real, hm.imag], 1))
    kw = dict(ID=7777, zero_time=(2, 2), transform="rotation")
    wt = _load(sxs_t, tmp_path / "cache", **kw)
    _same(wt, _load(sxs_j, tmp_path / "cache", **kw))
    assert wt.thetaf == 0.0 and wt.phif == 0.0
    assert all(np.all(np.isfinite(v)) for v in wt.h.values())


# -- fits through the port's loader ----------------------------------------

T0S = np.linspace(-5.0, 46.2, 33)


def _bounds(wf, data, sets, sph, Mf, chif, T, t0s):
    """Each (set, start time)'s bound on two Gram-path mismatches: 1e-11
    for t0 >= 0 and 1e-8 for t0 < 0 (ROADMAP C.2), or where larger the
    normal equations' error at the window's conditioning
    (chip_smoke.gram_bound, ROADMAP C.3: the deep ladders near the
    peak)."""
    out = np.empty((len(sets), len(t0s)))
    for si, ms in enumerate(sets):
        for i, t0 in enumerate(t0s):
            fit = ref_impl.fit_dispatch(wf.times, data, ms, Mf, chif,
                                        float(t0), "geq", T, sph)
            out[si, i] = max(1e-11 if t0 >= 0 else 1e-8,
                             chip_smoke.gram_bound(fit, len(ms)))
    return out


def test_mode_set_sweep_matches_jax(wf):
    row = {(2, 2): wf.h[2, 2]}
    args = (wf.times, row, chip_smoke.W1_LADDERS, wf.Mf, wf.chif_mag, T0S)
    kw = dict(T_array=chip_smoke.W1_T, spherical_modes=[(2, 2)])
    mm = qt.mismatch_t0_mode_sets(*args, device="cpu", **kw)
    mm_j = np.asarray(qf.mismatch_t0_mode_sets(*args, **kw))
    bound = _bounds(wf, row, chip_smoke.W1_LADDERS, [(2, 2)], wf.Mf,
                    wf.chif_mag, chip_smoke.W1_T, T0S)
    assert np.all(np.abs(mm - mm_j) <= bound)
    # Where the ladders are well conditioned the standing bar holds.
    assert np.max(np.abs(mm - mm_j)[:5, T0S >= 0]) <= 1e-11
    mm_nd = qt.mismatch_t0_mode_sets(*args, device="cpu", dedup=False, **kw)
    assert np.all(np.abs(mm_nd - mm_j) <= bound)


def test_dynamic_sweep_on_the_loaders_tracks_matches_jax(wf):
    deep = chip_smoke.W1_LADDERS[-1]
    chit = np.clip(wf.chioft_mag, 0.0, 0.99)
    t0s = T0S[::4]
    args = (wf.times, wf.h[2, 2], deep, wf.Moft, chit, t0s)
    mm = qt.mismatch_t0_array(*args, T_array=chip_smoke.W1_DYN_T,
                              device="cpu")
    mm_j = np.asarray(qf.mismatch_t0_array(*args,
                                           T_array=chip_smoke.W1_DYN_T))
    bound = _bounds(wf, wf.h[2, 2], [deep], None, wf.Moft, chit,
                    chip_smoke.W1_DYN_T, t0s)[0]
    assert np.all(np.abs(mm - mm_j) <= bound)


def test_fits_at_t0_10_hold_the_pins_and_match_jax(wf):
    deep = chip_smoke.W1_LADDERS[-1]
    chit = np.clip(wf.chioft_mag, 0.0, 0.99)
    two = {(2, 2): wf.h[2, 2], (3, 2): wf.h[3, 2]}
    dyn = (wf.times, wf.h[2, 2], deep, wf.Moft, chit, chip_smoke.W1_T0)
    multi = (wf.times, two, deep, wf.Mf, wf.chif_mag, chip_smoke.W1_T0)
    found = {
        "dynamic_ringdown_fit": (
            qt.dynamic_ringdown_fit(*dyn, T=chip_smoke.W1_DYN_T,
                                    device="cpu")["mismatch"],
            qf.dynamic_ringdown_fit(*dyn, T=chip_smoke.W1_DYN_T)["mismatch"]),
        "multimode_ringdown_fit": (
            qt.multimode_ringdown_fit(*multi, spherical_modes=list(two),
                                      device="cpu")["mismatch"],
            qf.multimode_ringdown_fit(*multi,
                                      spherical_modes=list(two))["mismatch"]),
    }
    for name, (mm, mm_j) in found.items():
        ref, rtol = chip_smoke.W1_PINS[name]
        assert mm == pytest.approx(ref, rel=rtol), name
        assert abs(mm - float(mm_j)) <= 1e-11, name
    eps = qt.calculate_epsilon(wf.times, wf.h[2, 2], chip_smoke.W1_EPS_MODES,
                               wf.Mf, wf.chif_mag, t0=chip_smoke.W1_T0,
                               device="cpu")
    ref, rtol = chip_smoke.W1_PINS["calculate_epsilon"]
    assert eps[0] == pytest.approx(ref, rel=rtol)
    assert abs(eps[1] - wf.Mf) < 0.02 and abs(eps[2] - wf.chif_mag) < 0.03
