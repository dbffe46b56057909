"""The port's spatial mapping against the JAX package's, on the CPU: the
harmonics, the s = 0 and s = -1 tables and the ``qnm`` class, kappa and
the Qmu predictions A-D, the spheroidal expansions, the sky predictions
and spatial mismatches, the mapping design, fit and start-time sweep, and
the uncertainty's mapping branch.

The same seeded numpy inputs go through qnmfits_tpu (spatial,
spatial_engine, harmonics, uncertainty) and qnmfits_tpu_torch
(device="cpu").  Bounds: harmonics 1e-14; kappa and Qmu_A/B/D 1e-13;
Qmu_C, the spheroidal coefficients, the sky maps and spatial mismatches
1e-12; the mapping design's omega and mu 1e-14; the mapping fit's
mismatch 1e-11 and amplitudes 1e-9 relative; the sweeps' mismatch 1e-11
for t0 >= 0 (1e-8 before the ringdown) and amplitudes 1e-9 relative; the
uncertainty as tests/test_torch_diagnostics.py bounds it.  The cases
mirror tests/test_spatial.py and tests/test_harmonics.py; the J = 11 and
J = 18 systems are chip_smoke.py's phase-10 models at K = 1300.
"""

import re

import numpy as np
import pytest

import chip_smoke
from qnmfits_tpu import harmonics as jh
from qnmfits_tpu import spatial as js
from qnmfits_tpu import spatial_engine as jse
from qnmfits_tpu import uncertainty as ju
from qnmfits_tpu.qnm_api import qnm as jqnm
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import harmonics as th
from qnmfits_tpu_torch import spatial as ts
from qnmfits_tpu_torch import spatial_engine as tse
from qnmfits_tpu_torch.qnm_api import get_qnm, qnm as tqnm
from qnmfits_tpu_torch.ref_impl import ringdown
from qnmfits_tpu_torch.spectrum import solver as tsolver
from qnmfits_tpu_torch.spectrum import tables as ttab

H_TOL = 1e-14
QMU_TOL = 1e-13
C_TOL = 1e-12
DESIGN_TOL = 1e-14
MM_TOL = 1e-11
PRE_TOL = 1e-8
REL_TOL = 1e-9
MF, CHIF = 0.952, 0.692
QUAD = (2, 2, 0, 1, 2, 2, 0, 1)
# tests/test_spatial.py's Qmu index lists.
IDX = [(4, 4, 2, 2, 0, 1, 2, 2, 0, 1),
       (5, 4, 2, 2, 0, 1, 2, 2, 1, 1),
       (6, 4, 3, 2, 0, 1, 3, 2, 0, 1),
       (4, 4, 2, 2, 0, -1, 2, 2, 0, 1),
       (2, 0, 2, 2, 0, 1, 2, -2, 0, -1)]
IDX_C = [(2, 4, 2, 2, 0, 1, 2, 2, 0, 1),
         (4, 4, 2, 2, 0, 1, 2, 2, 0, 1),
         (5, 4, 2, 2, 0, 1, 2, 2, 0, 1),
         (4, 3, 2, 2, 0, 1, 2, 2, 0, 1)]     # j != b + f: exactly zero


def _close(x, ref, tol):
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=0,
                               atol=tol)


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# Harmonics
# ---------------------------------------------------------------------------

ANGLES = np.meshgrid(np.linspace(0.05, np.pi - 0.05, 9),
                     np.linspace(0.0, 2 * np.pi, 10), indexing="ij")


@pytest.mark.parametrize("s", [-2, -1, 0])
def test_sylm_and_matrix_match_jax(s):
    TH, PH = ANGLES
    for l in range(abs(s), 9):
        for m in range(-l, l + 1):
            _close(th.sYlm(s, l, m, TH, PH), jh.sYlm(s, l, m, TH, PH), H_TOL)
    _close(th.sYlm(s, 1, 3, TH, PH), jh.sYlm(s, 1, 3, TH, PH), 0.0)
    _close(th.sYlm_matrix(s, 6, TH, PH), jh.sYlm_matrix(s, 6, TH, PH), H_TOL)
    assert th.Yindex(5, -2, abs(s)) == jh.Yindex(5, -2, abs(s))


def test_quaternions_and_wigner_match_jax():
    rng = np.random.default_rng(0)
    theta, phi = rng.uniform(0, np.pi, 6), rng.uniform(0, 2 * np.pi, 6)
    q_t = th.quat_from_spherical(theta, phi)
    _close(q_t, jh.quat_from_spherical(theta, phi), H_TOL)
    for vec in ([0.0, 0.0, 0.0], [0.3, -0.5, 0.2]):
        _close(th.quat_from_axis_angle(vec), jh.quat_from_axis_angle(vec),
               H_TOL)
    for a, b in zip(th.quat_to_euler_zyz(q_t), jh.quat_to_euler_zyz(q_t)):
        _close(a, b, H_TOL)
    beta = np.linspace(0.0, np.pi, 7)
    for l in (2, 3, 5, 8):
        for mp in range(-l, l + 1, 2):
            for m in range(-l, l + 1, 3):
                _close(th.wigner_d(l, mp, m, beta), jh.wigner_d(l, mp, m,
                                                              beta), H_TOL)
                _close(th.wigner_D(l, mp, m, q_t), jh.wigner_D(l, mp, m,
                                                             q_t), H_TOL)


@pytest.mark.parametrize("args", [
    (2, 2, 2, 2, -2, 0), (2, 2, 4, 2, 2, -4), (3, 2, 3, 1, -2, 1),
    (2, 2, 3, -2, 0, 2), (4, 3, 5, 2, 2, -4), (2, 2, 2, 0, 0, 0),
    (8, 6, 4, 2, 0, -2), (7, 8, 12, -3, 1, 2), (2, 2, 2, 1, 1, 1),
    (2, 2, 5, 0, 0, 0)])
def test_wigner_3j_matches_jax(args):
    assert abs(th.wigner_3j(*args) - jh.wigner_3j(*args)) <= H_TOL


@pytest.mark.parametrize("per_time", [False, True])
def test_rotate_mode_dict_matches_jax(per_time):
    rng = np.random.default_rng(1)
    ell_max, K = 4, 5
    h = {(l, m): rng.standard_normal(K) + 1j * rng.standard_normal(K)
         for l in range(2, ell_max + 1) for m in range(-l, l + 1)}
    if per_time:
        q = th.quat_from_spherical(np.linspace(0.1, 1.2, K),
                                   np.linspace(0.3, 2.0, K))
    else:
        q = th.quat_from_axis_angle([0.62 * np.sin(1.37),
                                     -0.62 * np.cos(1.37), 0.0])
    out, ref = th.rotate_mode_dict(h, q, ell_max), jh.rotate_mode_dict(
        h, q, ell_max)
    assert sorted(out) == sorted(ref)
    for key in ref:
        _close(out[key], ref[key], H_TOL)


# ---------------------------------------------------------------------------
# Tables, the qnm class, the angular solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [0, -1, -2])
def test_qnm_class_matches_jax_at_each_spin_weight(s):
    q, ref = tqnm(), jqnm()
    lo = abs(s)
    modes = [(l, m, n, sg) for l in range(max(lo, 2), 4)
             for m in (-l, 0, 1, l) for n in (0, 1) for sg in (1, -1)]
    for chif, Mf in ((0.692, 0.952), (np.array([0.0, 0.4, 0.9]), 1.0),
                     (0.5, np.array([0.9, 1.0]))):
        _close(q.omega_list(modes, chif, Mf, s=s),
               ref.omega_list(modes, chif, Mf, s=s), 0.0)
    assert q.omega(2, 2, 0, 1, 0.6, s=s) == ref.omega(2, 2, 0, 1, 0.6, s=s)
    # Components offset by max(|m|, |s|): at s = 0 the m < 2 rows start
    # below l = 2, where an off-by-one would show.
    idx = [(l, m, lp, m, n, sg) for m in (0, 1, -1, 2) for l in
           range(max(abs(m), lo), 7) for lp in range(max(abs(m), lo, 1), 4)
           for n in (0, 1) for sg in (1, -1)]
    idx += [(3, 2, 3, 1, 0, 1)]                      # m != m': zero
    for chif in (0.692, np.array([0.1, 0.7])):
        _close(q.mu_list(idx, chif, s=s), ref.mu_list(idx, chif, s=s), 0.0)
    assert q.mu(3, 2, 3, 1, 0, 1, 0.5, s=s) == 0
    assert q.mu(3, 2, 3, 2, 0, -1, 0.5, s=s) == ref.mu(3, 2, 3, 2, 0, -1,
                                                       0.5, s=s)
    t = q._t(s)
    got = t.compile_mu_indices(idx)
    want = ref._t(s).compile_mu_indices(idx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# The modes test_tables_raise_and_write_nothing asks the port for, as
# (s, l, m, n): the names its track cache would give their tracks.
_ASKED = [(0, 2, 2, 0), (-2, 2, 2, 0), (0, 2, 3, 0)]


def _data_dir_entries(data_dir):
    """The entries of the JAX package's data directory, where the port
    reads its tables, with ``track_cache/`` set aside: the JAX package's
    own on-demand solves create and fill it, in other xdist workers too."""
    return sorted(p.name for p in data_dir.iterdir()
                  if p.name != "track_cache")


def _port_named_tracks(data_dir, asked):
    """Files in the data directory's ``track_cache/`` named as the port's
    track cache names the tracks of ``asked`` (spectrum/tables.py,
    ``_solve_missing``: s{s}_l{l}_m{m}_n{n}_P{spins}.npz)."""
    cache = data_dir / "track_cache"
    if not cache.is_dir():
        return []
    pattern = re.compile("|".join(rf"s{s}_l{l}_m{m}_n{n}_P\d+\.npz"
                                  for s, l, m, n in asked))
    return sorted(p.name for p in cache.iterdir() if pattern.fullmatch(p.name))


def _assert_wrote_nothing(data_dir, before, asked):
    assert _data_dir_entries(data_dir) == before
    assert _port_named_tracks(data_dir, asked) == []


def test_tables_raise_and_write_nothing(tmp_path, monkeypatch):
    """A spin weight without a table names its path; spins off the grid
    raise on both factor tables; loading never writes a sidecar, nor
    anything else into the JAX package's data directory."""
    before = _data_dir_entries(ttab.DATA_DIR)
    q = tqnm()
    with pytest.raises(FileNotFoundError, match="qnm_tables_s-3.npz"):
        q._t(-3)
    for s in (0, -2):
        with pytest.raises(ValueError, match="chif must be in"):
            q.mu_list([(2, 2, 2, 2, 0, 1)], 1.2, s=s)
        with pytest.raises(ValueError, match="chif must be in"):
            q.omega_list([(2, 2, 0, 1)], np.array([0.2, np.nan]), s=s)
    with pytest.raises(ValueError, match="chif must be in"):
        ts.Qmu_B(IDX, 1.1, l_max=8)
    # |m| > l: the JAX package rejects it before any solve.
    with pytest.raises(KeyError, match="invalid mode"):
        q.omega_list([(2, 3, 0, 1)], 0.5, s=0)
    _assert_wrote_nothing(ttab.DATA_DIR, before, _ASKED)


def test_write_into_the_data_dir_is_caught(tmp_path, monkeypatch):
    """The check above fails when the port writes into the data directory:
    a data directory of its own (the tables linked in), a file written
    beside the tables, and the port's track cache pointed into its
    ``track_cache/`` by a monkeypatched ``track_cache_dir``."""
    data = tmp_path / "data"
    data.mkdir()
    for table in ttab.DATA_DIR.glob("qnm_tables_s*[0-9].npz"):
        (data / table.name).symlink_to(table)
    before = _data_dir_entries(data)
    _assert_wrote_nothing(data, before, _ASKED)
    np.save(data / "written_by_the_port.npy", np.zeros(1))
    with pytest.raises(AssertionError):
        _assert_wrote_nothing(data, before, _ASKED)
    (data / "written_by_the_port.npy").unlink()
    # A track the port solves on demand, cached into track_cache/.
    monkeypatch.setattr(ttab, "track_cache_dir",
                        lambda: data / "track_cache")
    t = ttab.SpectrumTables.from_arrays(
        tsolver.default_chi_grid(9, 0.5), [(2, 2, 0)], [[0.5 - 0.1j] * 9],
        [[[1.0] * 12] * 9], -2, 12)
    with ttab.solve_on("cpu"):
        t.compile_modes([(3, 1, 0, 1)])
    assert _data_dir_entries(data) == before
    with pytest.raises(AssertionError):
        _assert_wrote_nothing(data, before, _ASKED + [(-2, 3, 1, 0)])


@pytest.mark.parametrize("s,l,m,gamma", [
    (-2, 2, 2, 0.45 - 0.06j), (-2, 4, 4, 1.2 - 0.2j), (0, 3, 1, 0.7 - 0.1j),
    (-2, 3, -2, 0.0)])
def test_spheroidal_expansions_match_jax(s, l, m, gamma):
    l0, C = ts.spheroidal_coefficients(s, l, m, gamma)
    l0_j, C_j = js.spheroidal_coefficients(s, l, m, gamma)
    assert l0 == l0_j
    _close(C, C_j, C_TOL)
    TH, PH = ANGLES
    _close(ts.spheroidal_harmonic(s, l, m, gamma)(TH, PH),
           js.spheroidal_harmonic(s, l, m, gamma)(TH, PH), C_TOL)
    gammas = [gamma, 0.5 * gamma, 0.3 - 0.05j]
    for a, b in zip(tse.spheroidal_coeffs_batched(s, [l] * 3, [m] * 3,
                                                  gammas),
                    jse.spheroidal_coeffs_batched(s, [l] * 3, [m] * 3,
                                                  gammas)):
        _close(a, b, C_TOL)


# ---------------------------------------------------------------------------
# kappa and the Qmu predictions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (4, 4, 2, 2, 2, 2, -2, -2), (4, 4, 2, 2, 2, 2, -2, 0),
    (2, 2, 2, 2, 2, 0, -2, 0), (6, 4, 5, 3, 2, 2, -2, 0),
    (5, -1, 3, 4, 1, -2, -2, -2), (3, 4, 2, 2, 2, 2, -2, 0)])
def test_kappa_matches_jax(args):
    assert abs(ts.kappa(*args) - js.kappa(*args)) <= QMU_TOL


@pytest.mark.parametrize("name,s2", [("Qmu_A", -2), ("Qmu_B", 0),
                                     ("Qmu_B", -2), ("Qmu_D", -2)])
@pytest.mark.parametrize("chif", [0.0, 0.68, 0.95, "array"])
def test_qmu_matches_jax(name, s2, chif):
    chif = np.array([0.1, 0.5, 0.9]) if chif == "array" else chif
    kw = {} if name != "Qmu_B" else dict(s2=s2)
    out = np.array(getattr(ts, name)(IDX, chif, l_max=8, **kw))
    ref = np.array(getattr(js, name)(IDX, chif, l_max=8, **kw))
    assert out.shape == ref.shape
    _close(out, ref, QMU_TOL)
    if np.ndim(chif) == 0:
        extra = (None if name != "Qmu_D" else
                 lambda i: np.sqrt((i + 4) * (i - 3) * (i + 3) * (i - 2)))
        s2_ = s2 if name == "Qmu_B" else -2
        _close(out, ts._Qmu_sum_loop(IDX, chif, 8, -2, s2_, extra=extra),
               QMU_TOL)


def test_qmu_h_slots_past_the_table_do_not_compile():
    """The s = 0 table holds 12 mixing components; at l_max = 12 the
    (2,0,0) factor's h slots reach component 12.  Where their kappa
    column vanishes (here j != b + f, so every kappa is 0) they must not
    be compiled; where it does not, the compile raises as the JAX
    package's does."""
    idx = [(4, 3, 2, 2, 0, 1, 2, 0, 0, 1), (4, 4, 2, 2, 0, 1, 2, 2, 0, 1)]
    out = np.array(ts.Qmu_B(idx, 0.5, l_max=12))
    _close(out, js.Qmu_B(idx, 0.5, l_max=12), QMU_TOL)
    assert out[0] == 0 and out[1] != 0
    for mod in (ts, js):
        with pytest.raises(KeyError, match="out of stored range"):
            mod.Qmu_B([(4, 2, 2, 2, 0, 1, 2, 0, 0, 1)], 0.5, l_max=12)


@pytest.mark.parametrize("chif", [0.68, "array"])
def test_qmu_c_matches_jax(chif):
    chif = np.array([0.1, 0.45, 0.7]) if chif == "array" else chif
    out = ts.Qmu_C(IDX_C, chif)
    _close(out, js.Qmu_C(IDX_C, chif), C_TOL)
    assert np.all(np.asarray(out[3]) == 0)
    if np.ndim(chif) == 0:
        quad = ts.Qmu_C(IDX_C[:2], chif, method="quadrature", n_quad=48)
        _close(quad, js.Qmu_C(IDX_C[:2], chif, method="quadrature",
                              n_quad=48), C_TOL)
        _close(quad, out[:2], 1e-6)


# ---------------------------------------------------------------------------
# Sky predictions and spatial mismatches
# ---------------------------------------------------------------------------

def _mapping_setup():
    """tests/test_spatial.py's mapping_setup, built with the port."""
    times = np.arange(-10.0, 120.0, 0.1)
    q = get_qnm()
    sph, lin = [(4, 4), (5, 4)], [(4, 4, 0, 1)]
    rng = np.random.default_rng(3)
    amps_lin = rng.standard_normal(1) + 1j * rng.standard_normal(1)
    amp_quad = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    w_lin = np.array(q.omega_list(lin, CHIF, MF))
    [w_quad] = q.omega_list([QUAD], CHIF, MF)
    data = {}
    for i, lm in enumerate(sph):
        mu = np.array(q.mu_list([lm + m for m in lin], CHIF))
        data[lm] = (ringdown(times, 0.0, mu * amps_lin, w_lin)
                    + ringdown(times, 0.0, [amp_quad[i]], [w_quad]))
    return dict(times=times, data=data, sph=sph, lin=lin)


@pytest.fixture(scope="module")
def setup():
    return _mapping_setup()


@pytest.fixture(scope="module")
def phase10():
    """chip_smoke.py's phase-10 data on the JAX fixtures' grid."""
    times = np.arange(-10.0, 120.0, 0.1)
    return dict(times=times, data=chip_smoke.build_mapping(times))


def test_sky_predictions_match_jax():
    TH, PH = ANGLES
    for mode in ((2, 2, 0, 1), (3, 2, 1, -1), (4, 4, 0, 1)):
        _close(ts.spatial_prediction_linear(TH, PH, mode, 8, 0.68),
               js.spatial_prediction_linear(TH, PH, mode, 8, 0.68), C_TOL)
    for name, kw in (("Qmu_A", dict(s2=-2)), ("Qmu_B", {}),
                     ("Qmu_D", dict(s2=-2)), ("Qmu_C", {})):
        _close(ts.spatial_prediction_quadratic(TH, PH, QUAD, 8, 0.68,
                                               getattr(ts, name), **kw),
               js.spatial_prediction_quadratic(TH, PH, QUAD, 8, 0.68,
                                               getattr(js, name), **kw),
               C_TOL)
    _close(ts.spatial_prediction_C(TH, PH, QUAD, 0.68),
           js.spatial_prediction_C(TH, PH, QUAD, 0.68), C_TOL)


def test_reconstruction_and_spatial_mismatches_match_jax(setup):
    """Both packages' fits of the same data, and their sky reconstruction
    and spatial mismatches (the round trips of tests/test_spatial.py)."""
    s, q = setup, get_qnm()
    times = s["times"]
    lin = (2, 2, 0, 1)
    [w] = q.omega_list([lin], CHIF, MF)
    sph = [(2, 2), (3, 2), (4, 2), (5, 2)]
    data = {lm: ringdown(times, 0.0, [(0.7 - 0.4j) * q.mu_list(
        [lm + lin], CHIF)[0]], [w]) for lm in sph}
    fits = [mod.mapping_multimode_ringdown_fit(
        times, data, [lin], MF, CHIF, 0.0, [lin], T=100, spherical_modes=sph,
        **kw) for mod, kw in ((ts, dict(device="cpu")), (js, {}))]
    for a, b in zip(ts.spatial_mismatch_linear(fits[0], lin, CHIF, l_max=8),
                    js.spatial_mismatch_linear(fits[1], lin, CHIF, l_max=8)):
        assert abs(a - b) <= C_TOL
    sph4 = [(l, 4) for l in range(4, 9)]
    alphas = np.array(ts.Qmu_B([lm + QUAD for lm in sph4], CHIF, l_max=8))
    [wq] = q.omega_list([QUAD], CHIF, MF)
    data = {lm: ringdown(times, 0.0, [(-0.3 + 0.9j) * alphas[i]], [wq])
            for i, lm in enumerate(sph4)}
    fits = [mod.mapping_multimode_ringdown_fit(
        times, data, [QUAD], MF, CHIF, 0.0, [QUAD], T=100,
        spherical_modes=sph4, **kw) for mod, kw in ((ts, dict(device="cpu")),
                                                    (js, {}))]
    for name in ("Qmu_A", "Qmu_B", "Qmu_C", "Qmu_D"):
        got = ts.spatial_mismatch_quadratic(fits[0], QUAD, 8, CHIF,
                                            getattr(ts, name))
        want = js.spatial_mismatch_quadratic(fits[1], QUAD, 8, CHIF,
                                             getattr(js, name))
        for a, b in zip(got, want):
            assert abs(a - b) <= C_TOL, name
    assert ts.spatial_mismatch_quadratic(fits[0], QUAD, 8, CHIF,
                                         ts.Qmu_B)[0] < 1e-8
    TH, PH = ANGLES
    _close(ts.spatial_reconstruction(TH, PH, fits[0], QUAD, 8),
           js.spatial_reconstruction(TH, PH, fits[1], QUAD, 8), C_TOL)
    assert ts.spatial_data_mismatch(fits[0], fits[0], QUAD) < 1e-14
    assert abs(ts.spatial_data_mismatch(fits[0], fits[1], QUAD)
               - js.spatial_data_mismatch(fits[0], fits[1], QUAD)) <= C_TOL


def test_data_mismatch_matches_jax(setup):
    """data_mismatch duck-types on .times and .h."""
    class Sim:
        def __init__(self, times, h):
            self.times, self.h = times, h

    s = setup
    rng = np.random.default_rng(9)
    other = {lm: h + 1e-3 * rng.standard_normal(len(h))
             for lm, h in s["data"].items()}
    a, b = Sim(s["times"], s["data"]), Sim(s["times"] + 0.03, other)
    for kw in ({}, dict(t0=5.0, T=50, modes=[(4, 4)], shift=0.2)):
        assert abs(ts.data_mismatch(a, b, **kw)
                   - js.data_mismatch(a, b, **kw)) <= C_TOL


# ---------------------------------------------------------------------------
# The mapping design, fit and sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["m1", "m2", "setup"])
def test_mapping_design_matches_jax(model):
    if model == "setup":
        sph, modes, mapped = [(4, 4), (5, 4)], [(4, 4, 0, 1), QUAD], [QUAD]
    else:
        sph = chip_smoke.MAP_SPH
        modes, mapped = chip_smoke.MAP_MODELS[model]
    for chif, Mf in ((CHIF, MF), (0.3, 1.0)):
        got = tse.mapping_design(sph, modes, mapped, chif, Mf)
        want = jse.mapping_design(sph, modes, mapped, chif, Mf)
        assert got[0] == want[0]
        _close(got[1], want[1], DESIGN_TOL)
        _close(got[2], want[2], DESIGN_TOL)
    J = len(modes) - len(mapped) + len(mapped) * len(sph)
    assert got[2].shape == (len(sph), J)
    with pytest.raises(ValueError, match="wrong number of indices"):
        tse.mapping_design(sph, modes + [(2, 2, 0)], mapped, CHIF, MF)


@pytest.mark.parametrize("model,t0", [("m1", 0.0), ("m1", 10.0),
                                      ("m2", 10.0), ("m1", -3.0)])
def test_mapping_fit_matches_jax(phase10, model, t0):
    p = phase10
    modes, mapped = chip_smoke.MAP_MODELS[model]
    kw = dict(T=60, spherical_modes=chip_smoke.MAP_SPH)
    out = ts.mapping_multimode_ringdown_fit(p["times"], p["data"], modes, MF,
                                            CHIF, t0, mapped, device="cpu",
                                            **kw)
    ref = js.mapping_multimode_ringdown_fit(p["times"], p["data"], modes, MF,
                                            CHIF, t0, mapped, **kw)
    assert sorted(out) == sorted(ref)
    assert abs(out["mismatch"] - ref["mismatch"]) <= MM_TOL
    assert _rel(out["C"], ref["C"]) <= REL_TOL
    assert out["residual"].shape == ref["residual"].shape == (1,)
    assert _rel(out["residual"], ref["residual"]) <= REL_TOL
    assert out["modes"] == ref["modes"]
    assert out["mode_labels"] == ref["mode_labels"]
    _close(out["frequencies"], ref["frequencies"], DESIGN_TOL)
    _close(out["model_times"], ref["model_times"], 0.0)
    for lm in chip_smoke.MAP_SPH:
        assert _rel(out["model"][lm], ref["model"][lm]) <= REL_TOL
        assert _rel(out["weighted_C"][lm], ref["weighted_C"][lm]) <= REL_TOL
        np.testing.assert_array_equal(out["data"][lm], ref["data"][lm])


def test_mapping_fit_rank_deficient_residual_is_empty(setup):
    """np.linalg.lstsq's form: no residual when the design has no more
    rows than columns (one sample a sphere: 2 rows, 3 columns), one when
    it has (two samples: 4 rows)."""
    s = setup
    args = (s["times"], s["data"], s["lin"] + [QUAD], MF, CHIF, 0.0, [QUAD])
    for T, shape in ((0.15, (0,)), (0.25, (1,))):
        kw = dict(T=T, spherical_modes=s["sph"])
        with np.errstate(invalid="ignore"):     # 0/0 mismatch at one sample
            out = ts.mapping_multimode_ringdown_fit(*args, device="cpu",
                                                    **kw)
            ref = js.mapping_multimode_ringdown_fit(*args, **kw)
        assert out["residual"].shape == ref["residual"].shape == shape
        _close(out["C"], ref["C"], C_TOL)


@pytest.fixture(scope="module")
def sweep_grid():
    """Start times finer than the 0.1 M sampling (windows repeat, so
    dedup acts), from before the ringdown to t0 = 11."""
    return np.linspace(-1.0, 11.0, 97)


@pytest.mark.parametrize("model", ["m1", "m2"])
@pytest.mark.parametrize("engine", ["batched", "fast"])
def test_mapping_sweep_matches_jax(phase10, sweep_grid, model, engine):
    """J = 11 (the team kernel's width) and J = 18 (the wide kernel's),
    with and without dedup, against the JAX sweep with dedup."""
    p, t0s = phase10, sweep_grid
    modes, mapped = chip_smoke.MAP_MODELS[model]
    kw = dict(T_array=60, spherical_modes=chip_smoke.MAP_SPH, engine=engine,
              return_amplitudes=True)
    args = (p["times"], p["data"], modes, MF, CHIF, t0s, mapped)
    mm_j, C_j = js.mapping_mismatch_t0_array(*args, **kw)
    pre = t0s < 0
    for dedup in (True, False):
        mm, C = ts.mapping_mismatch_t0_array(*args, dedup=dedup,
                                             device="cpu", **kw)
        assert mm.shape == (len(t0s),) and C.shape == C_j.shape
        assert np.max(np.abs(mm - mm_j)[~pre]) <= MM_TOL
        assert np.max(np.abs(mm - mm_j)[pre]) <= PRE_TOL
        assert _rel(C[~pre], C_j[~pre]) <= REL_TOL


def test_mapping_sweep_closest_and_loop_match_jax(phase10):
    p = phase10
    modes, mapped = chip_smoke.MAP_MODELS["m1"]
    t0s = np.linspace(0.0, 20.0, 9)
    kw = dict(T_array=60, spherical_modes=chip_smoke.MAP_SPH)
    args = (p["times"], p["data"], modes, MF, CHIF, t0s, mapped)
    mm_c = ts.mapping_mismatch_t0_array(*args, t0_method="closest",
                                        device="cpu", **kw)
    _close(mm_c, js.mapping_mismatch_t0_array(*args, t0_method="closest",
                                              **kw), MM_TOL)
    mm_l, C_l = ts.mapping_mismatch_t0_array(*args, engine="loop",
                                             return_amplitudes=True,
                                             device="cpu", **kw)
    mm_lj, C_lj = js.mapping_mismatch_t0_array(*args, engine="loop",
                                               return_amplitudes=True, **kw)
    _close(mm_l, mm_lj, MM_TOL)
    assert _rel(C_l, C_lj) <= REL_TOL
    mm_b = ts.mapping_mismatch_t0_array(*args, device="cpu", **kw)
    _close(mm_b, mm_l, MM_TOL)


def test_mapping_sweep_raises(phase10):
    p = phase10
    modes, mapped = chip_smoke.MAP_MODELS["m1"]
    kw = dict(T_array=60, spherical_modes=chip_smoke.MAP_SPH, device="cpu")
    args = (p["times"], p["data"], modes, MF, CHIF)
    t0_bad = np.array([5.0, 5.0, 0.0, 0.0])        # dedupable, unsorted
    for mod, extra in ((ts, kw), (js, dict(T_array=60, spherical_modes=
                                           chip_smoke.MAP_SPH))):
        with pytest.raises(ValueError, match="sorted ascending"):
            mod.mapping_mismatch_t0_array(*args, t0_bad, mapped,
                                          engine="fast", **extra)
        with pytest.raises(ValueError, match="geq"):
            mod.mapping_mismatch_t0_array(*args, np.array([0.0, 1.0]),
                                          mapped, engine="fast",
                                          t0_method="closest", **extra)
    t0s = np.array([0.0, 1.0])
    for bad in (dict(engine="sharded"), dict(mesh="auto")):
        with pytest.raises(ValueError, match="init_process_group"):
            ts.mapping_mismatch_t0_array(*args, t0s, mapped, **bad, **kw)
    with pytest.raises(NotImplementedError, match="x64"):
        ts.mapping_mismatch_t0_array(*args, t0s, mapped, precision="f32",
                                     **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        ts.mapping_mismatch_t0_array(*args, t0s, mapped, engine="nope", **kw)
    with pytest.raises(ValueError, match="chif"):
        ts.mapping_mismatch_t0_array(p["times"], p["data"], modes, MF, 1.3,
                                     t0s, mapped, **kw)


# ---------------------------------------------------------------------------
# The uncertainty's mapping branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["m1", "m2"])
@pytest.mark.parametrize("sigma", [None, 1e-3])
def test_mapping_uncertainty_matches_jax(phase10, model, sigma):
    p = phase10
    modes, mapped = chip_smoke.MAP_MODELS[model]
    kw = dict(T=60, spherical_modes=chip_smoke.MAP_SPH, mapping_modes=mapped,
              sigma=sigma)
    args = (p["times"], p["data"], modes, MF, CHIF, 10.0)
    out = tq.amplitude_uncertainty(*args, device="cpu", **kw)
    ref = ju.amplitude_uncertainty(*args, **kw)
    assert sorted(out) == sorted(ref)
    assert out["n_obs"] == ref["n_obs"] and out["dof"] == ref["dof"]
    _close(out["omega"], ref["omega"], DESIGN_TOL)
    for key in ("C", "cov", "sigma_C", "corr", "snr"):
        assert out[key].shape == ref[key].shape, key
        assert _rel(out[key], ref[key]) <= REL_TOL, key
    assert abs(out["sigma2"] - ref["sigma2"]) <= REL_TOL * ref["sigma2"]
    fit = ts.mapping_multimode_ringdown_fit(*args[:-1], 10.0, mapped, T=60,
                                            spherical_modes=chip_smoke.
                                            MAP_SPH, device="cpu")
    assert _rel(out["C"], fit["C"]) <= REL_TOL


def test_mapping_mode_selection_matches_jax(phase10):
    p = phase10
    lin, QU, QM = (chip_smoke.MAP_LINEAR, chip_smoke.QUAD_UNMAPPED,
                   chip_smoke.QUAD_MAPPED)
    models = [lin[:1] + [QM], lin[:4] + [QM], lin + [QU, QM], lin[1:] + [QM]]
    kw = dict(T=60, spherical_modes=chip_smoke.MAP_SPH, mapping_modes=[QM])
    args = (p["times"], p["data"], models, MF, CHIF, 10.0)
    out = tq.mode_selection(*args, device="cpu", **kw)
    ref = ju.mode_selection(*args, **kw)
    assert sorted(out) == sorted(ref)
    for key in ("n_modes", "n_params", "best_aic", "best_bic", "n_obs"):
        np.testing.assert_array_equal(out[key], ref[key])
    assert list(out["n_modes"]) == [6, 9, 11, 9]
    for key in ("rss", "aic", "bic"):
        assert _rel(out[key], ref[key]) <= REL_TOL, key
    np.testing.assert_array_equal(np.isnan(out["fstat"]),
                                  np.isnan(ref["fstat"]))
    ok = ~np.isnan(ref["pvalue"])
    assert _rel(out["fstat"][ok], ref["fstat"][ok]) <= REL_TOL
    assert np.max(np.abs(out["pvalue"][ok] - ref["pvalue"][ok])) <= REL_TOL
    assert np.isnan(out["pvalue"][-1])


def test_mapping_uncertainty_errors(phase10):
    """The JAX errors, word for word: dict data and a static remnant."""
    p = phase10
    modes, mapped = chip_smoke.MAP_MODELS["m1"]
    h = p["data"][(4, 4)]
    K = len(p["times"])
    for fn, kw in ((tq.amplitude_uncertainty, dict(device="cpu")),
                   (ju.amplitude_uncertainty, {})):
        with pytest.raises(ValueError, match="need dict data over "
                                             "spherical modes"):
            fn(p["times"], h, modes, MF, CHIF, 0.0, mapping_modes=mapped,
               **kw)
        with pytest.raises(ValueError, match="take a static"):
            fn(p["times"], p["data"], modes, np.full(K, MF), CHIF, 0.0,
               spherical_modes=chip_smoke.MAP_SPH, mapping_modes=mapped,
               **kw)
    with pytest.raises(ValueError, match="take a static"):
        tq.mode_selection(p["times"], p["data"], [modes[:2], modes], MF,
                          np.full(K, CHIF), 0.0,
                          spherical_modes=chip_smoke.MAP_SPH,
                          mapping_modes=mapped, device="cpu")
