"""The port's dynamic-spectrum sweeps and catalog event batches against the
JAX package's, on the CPU: ``engine.dynamic_fit_systems``, the dynamic
start-time and mode-set sweeps, ``mismatch_t0_array`` with Mf/chif time
tracks, ``fit_events`` and ``batched.sweep_events_real``, the NumPy
oracle's dynamic loop, and the join and basis budgets of the dynamic sweep.

The same numpy inputs go through qnmfits_tpu and qnmfits_tpu_torch
(device="cpu": the plain PyTorch solve).  K = 351 samples on [-5, 30],
I = 2, J <= 4 (17 in the wide case), B <= 9; events: K = 400, E = 24,
J = 3.  Tracks Mf(t) = linspace(1.02 Mf, Mf, K), chif(t) =
linspace(0.60, chif, K), as tests/test_batched.py:332-340.  Bounds are
the JAX package's own (tests/test_batched.py:134-215, :332-360,
:558-607, :636-716): mismatch 1e-11, amplitudes 1e-9 (events 1e-8).  The
start times reach t0 = -2, before the ringdown; the same bounds hold
there, since both packages solve the same floored systems on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnmfits_tpu import batched as jb
from qnmfits_tpu import engine as je
from qnmfits_tpu import engine_real as jer
from qnmfits_tpu import fitting as jf
from qnmfits_tpu import ref_impl as jref
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine as te
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch import ref_impl as tref
from qnmfits_tpu_torch.ops.solve import gram_cholesky
from qnmfits_tpu_torch.ops.windows import window_closest, window_geq
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MF, CHIF = 0.952, 0.692
MODES = [(2, 2, n, 1) for n in range(3)]
SETS = [[(2, 2, 0, 1)], MODES]
T0S = np.linspace(-2.0, 10.0, 9)
MM_TOL = 1e-11
C_TOL = 1e-9
EVENT_C_TOL = 1e-8
SET_17 = ([(2, 2, n, 1) for n in range(5)]
          + [(2, 2, n, -1) for n in range(4)]
          + [(3, 2, n, 1) for n in range(4)]
          + [(3, 2, n, -1) for n in range(2)]
          + [(4, 2, n, 1) for n in range(2)])


@pytest.fixture(scope="module")
def problem():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-5.0, 30.05, 0.1), seed=8)
    K = len(syn["times"])
    return dict(times=syn["times"], data=syn["data_dict"],
                Mf_t=np.linspace(1.02 * MF, MF, K),
                chif_t=np.linspace(0.60, CHIF, K))


@pytest.fixture(scope="module")
def catalog():
    """A small catalog in the shape of examples/catalog_events.py."""
    rng = np.random.default_rng(5)
    E, times = 24, np.arange(-5.0, 35.0, 0.1)
    Mfs = rng.uniform(0.90, 0.99, E)
    chifs = rng.uniform(0.45, 0.85, E)
    t0s = rng.uniform(0.0, 6.0, E)
    omegas = te.SpectrumEvaluator(MODES).omega(chifs, Mfs).T      # (E, J)
    amps = (rng.standard_normal((E, 3)) + 1j * rng.standard_normal((E, 3))) \
        * np.array([1.0, 0.5, 0.2])
    tpos = np.maximum(times, 0.0)
    rows = (amps[:, None, :] * np.exp(-1j * omegas[:, None, :]
                                      * tpos[None, :, None])).sum(-1)
    rows = np.where(times >= 0, rows, 0.0)
    rows = rows + 2e-5 * (rng.standard_normal(rows.shape)
                          + 1j * rng.standard_normal(rows.shape))
    return dict(times=times, rows=rows, Mfs=Mfs, chifs=chifs, t0s=t0s,
                omegas=omegas)


class CountingSolve:
    """The plain solve, recording the batch of every call."""

    def __init__(self):
        self.batches = []

    def __call__(self, G, b):
        self.batches.append(b.shape[0])
        return ter._regularised_solve_plain(G, b)


def _tracks_spectrum(problem, modes, n_pad=0):
    """omega_t (K, J) and mu_t (I, K, J) of the problem's tracks, with
    n_pad zero padding slots."""
    ev = te.SpectrumEvaluator(modes, SPH)
    om = ev.omega(problem["chif_t"], problem["Mf_t"]).T
    mu = np.moveaxis(ev.mu(problem["chif_t"]), -1, 1)
    return (np.pad(om, ((0, 0), (0, n_pad))),
            np.pad(mu, ((0, 0), (0, 0), (0, n_pad))))


# ---------------------------------------------------------------------------
# The dynamic fit core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_dynamic_fit_systems_matches_jax(problem, padded):
    """dynamic_fit_systems + the plain solve + fit_mismatch, batched over
    three windows, against engine.dynamic_fit_core one window at a time;
    with two padded slots their amplitudes are exactly zero."""
    n_pad = 2 if padded else 0
    om, mu = _tracks_spectrum(problem, MODES, n_pad)
    J = om.shape[1]
    mask = np.arange(J) < len(MODES) if padded else None
    times = problem["times"]
    rows = np.stack([problem["data"][lm] for lm in SPH])
    t0s = np.array([-1.0, 2.0, 6.5])
    tt = torch.as_tensor(times)
    t0_t = torch.as_tensor(t0s)
    w = window_geq(tt, t0_t[:, None], 20.0)
    G, rhs, G_tau, r_tau, dn = te.dynamic_fit_systems(
        tt, torch.as_tensor(rows), torch.as_tensor(om), torch.as_tensor(mu),
        t0_t, w, None if mask is None else torch.as_tensor(mask))
    C = gram_cholesky(G, rhs)
    mm = te.fit_mismatch(C, G_tau, r_tau, dn).numpy()
    C = C.numpy()
    for b, t0 in enumerate(t0s):
        C_j, mm_j = je.dynamic_fit_core(
            jnp.asarray(times), jnp.asarray(rows), jnp.asarray(om),
            jnp.asarray(mu), t0, jnp.asarray(w[b].numpy()),
            col_mask=None if mask is None else jnp.asarray(mask))
        assert abs(mm[b] - float(mm_j)) <= MM_TOL
        np.testing.assert_allclose(C[b], np.asarray(C_j), rtol=0,
                                   atol=C_TOL)
    if padded:
        assert np.all(C[:, len(MODES):] == 0)


# ---------------------------------------------------------------------------
# Dynamic start-time and mode-set sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multimode", [True, False])
@pytest.mark.parametrize("t0_method", ["geq", "closest"])
@pytest.mark.parametrize("engine", ["batched", "fast"])
def test_batch_dynamic_matches_jax(problem, multimode, t0_method, engine):
    data = problem["data"] if multimode else problem["data"][(2, 2)]
    args = (problem["times"], data, MODES, problem["Mf_t"],
            problem["chif_t"], T0S)
    kw = dict(t0_method=t0_method, T_array=20.0, return_amplitudes=True,
              spherical_modes=SPH if multimode else None, engine=engine)
    mm, C = tb.batch_mismatch_t0_dynamic(*args, device="cpu", **kw)
    mm_j, C_j = jb.batch_mismatch_t0_dynamic(*args, **kw)
    assert mm.shape == (len(T0S),) and C.shape == (len(T0S), len(MODES))
    np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(C, np.asarray(C_j), rtol=0, atol=C_TOL)


def test_t0_array_with_tracks_matches_jax(problem):
    """mismatch_t0_array with an Mf track and a chif track, on 'batched',
    'fast' and 'loop', against the JAX package; batch_mismatch_t0 routes
    tracks to the dynamic sweep, and a scalar Mf with a chif track is a
    dynamic fit too."""
    times, data = problem["times"], problem["data"]
    kw = dict(T_array=20.0, spherical_modes=SPH)
    ref = np.asarray(jf.mismatch_t0_array(
        times, data, MODES, problem["Mf_t"], problem["chif_t"], T0S, **kw))
    for engine in ("batched", "fast", "loop"):
        mm = tq.mismatch_t0_array(times, data, MODES, problem["Mf_t"],
                                  problem["chif_t"], T0S, engine=engine,
                                  device="cpu", **kw)
        np.testing.assert_allclose(np.asarray(mm), ref, rtol=0, atol=MM_TOL)
    routed, C = tb.batch_mismatch_t0(
        times, data, MODES, problem["Mf_t"], problem["chif_t"], T0S,
        return_amplitudes=True, device="cpu", **kw)
    direct, C_d = tb.batch_mismatch_t0_dynamic(
        times, data, MODES, problem["Mf_t"], problem["chif_t"], T0S,
        return_amplitudes=True, device="cpu", **kw)
    np.testing.assert_array_equal(routed, direct)
    np.testing.assert_array_equal(C, C_d)
    half = tq.mismatch_t0_array(times, data, MODES, MF, problem["chif_t"],
                                T0S, device="cpu", **kw)
    half_j = jf.mismatch_t0_array(times, data, MODES, MF, problem["chif_t"],
                                  T0S, **kw)
    np.testing.assert_allclose(half, np.asarray(half_j), rtol=0, atol=MM_TOL)
    with pytest.raises(ValueError, match="delta"):
        tb.batch_mismatch_t0(times, data, MODES, MF, problem["chif_t"], T0S,
                             delta=0.01, device="cpu", **kw)


def test_modesets_dynamic_ragged_matches_jax(problem):
    """dynamic=True on ragged sets (1 and 3 modes), against the JAX
    package; the padded amplitude slots are exactly zero."""
    times, data = problem["times"], problem["data"]
    kw = dict(T_array=20.0, spherical_modes=SPH, dynamic=True,
              return_amplitudes=True)
    for t0_method in ("geq", "closest"):
        mm, Cs = tq.mismatch_t0_mode_sets(
            times, data, SETS, problem["Mf_t"], problem["chif_t"], T0S,
            t0_method=t0_method, device="cpu", **kw)
        mm_j, Cs_j = jf.mismatch_t0_mode_sets(
            times, data, SETS, problem["Mf_t"], problem["chif_t"], T0S,
            t0_method=t0_method, **kw)
        assert mm.shape == (2, len(T0S))
        np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0,
                                   atol=MM_TOL)
        for C, C_j, ms in zip(Cs, Cs_j, SETS):
            assert C.shape == (len(T0S), len(ms))
            np.testing.assert_allclose(C, np.asarray(C_j), rtol=0,
                                       atol=C_TOL)
    _, C_full, _ = tb._dynamic_sweep(
        times, data, SETS, problem["Mf_t"], problem["chif_t"], T0S, "geq",
        20.0, SPH, True, "cpu", None)
    assert C_full.shape == (2, len(T0S), 3)
    assert np.all(C_full[0, :, 1:] == 0)


def test_modesets_dynamic_17_modes_matches_jax(problem):
    """A 17-mode set (the card's wide kernel) at three start times."""
    times, data = problem["times"], problem["data"]
    t0s = np.array([0.0, 3.0, 8.0])
    kw = dict(T_array=20.0, spherical_modes=SPH, dynamic=True)
    mm = tq.mismatch_t0_mode_sets(times, data, [SET_17], problem["Mf_t"],
                                  problem["chif_t"], t0s, device="cpu", **kw)
    mm_j = jf.mismatch_t0_mode_sets(times, data, [SET_17], problem["Mf_t"],
                                    problem["chif_t"], t0s, **kw)
    np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0, atol=MM_TOL)


def test_modesets_dynamic_raises(problem):
    times, data = problem["times"], problem["data"]
    args = (times, data, SETS, problem["Mf_t"], problem["chif_t"], T0S)
    kw = dict(spherical_modes=SPH, dynamic=True, device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        tq.mismatch_t0_mode_sets(*args, bucket=True, **kw)
    with pytest.raises(ValueError, match="t0_method"):
        tq.mismatch_t0_mode_sets(*args, t0_method="GEQ", **kw)
    with pytest.raises(ValueError, match="tracks"):
        tq.mismatch_t0_mode_sets(times, data, SETS, problem["Mf_t"][:-1],
                                 problem["chif_t"], T0S, **kw)
    with pytest.raises(ValueError, match="init_process_group"):
        tb.batch_mismatch_t0_modesets_dynamic(*args, mesh="auto",
                                              spherical_modes=SPH,
                                              device="cpu")
    with pytest.raises(ValueError, match="chif"):
        tq.mismatch_t0_mode_sets(times, data, SETS, MF, 1.2, T0S, **kw)


def test_dynamic_join_and_basis_budgets(problem, monkeypatch):
    """A small basis budget makes several chunks a set and a small join
    budget several solve calls; the results equal the one-call sweep's."""
    times, data = problem["times"], problem["data"]
    args = (times, data, SETS, problem["Mf_t"], problem["chif_t"], T0S)
    kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
              device="cpu")
    one = CountingSolve()
    mm, Cs = tb.batch_mismatch_t0_modesets_dynamic(*args, solve=one, **kw)
    assert one.batches == [2 * len(T0S)]
    per_fit = 2 * len(times) * 3 * 16
    monkeypatch.setattr(tb, "_BASIS_BYTES", 2 * per_fit)    # 2 fits a chunk
    monkeypatch.setattr(ter, "JOIN_BYTES", 4 * 2 * 3 * 3 * 16)  # 4 fits
    many = CountingSolve()
    mm_s, Cs_s = tb.batch_mismatch_t0_modesets_dynamic(*args, solve=many,
                                                       **kw)
    assert sum(many.batches) == 2 * len(T0S) and len(many.batches) >= 4
    assert max(many.batches) <= 4
    np.testing.assert_allclose(mm_s, mm, rtol=0, atol=1e-13)
    for C, C_s in zip(Cs, Cs_s):
        np.testing.assert_allclose(C_s, C, rtol=0, atol=1e-12)


def test_window_spans_hold_every_window(problem):
    """Each start time's sample range holds its whole window, 'geq' and
    'closest', including exact sample midpoints and start times off the
    grid's ends."""
    times = torch.as_tensor(problem["times"])
    t0s = torch.as_tensor(np.concatenate([
        0.5 * (problem["times"][10:300:7] + problem["times"][11:301:7]),
        [-9.0, -5.0, 29.99, 35.0]]))
    Ts = torch.full_like(t0s, 20.0)
    lo, hi = tb._window_spans(times, t0s, Ts)
    for window in (window_geq, window_closest):
        w = window(times, t0s[:, None], Ts[:, None]) > 0.5
        idx = torch.arange(times.shape[0])
        outside = (idx[None, :] < lo[:, None]) | (idx[None, :] >= hi[:, None])
        assert not torch.any(w & outside)


# The deep ladder's systems: the port's and the JAX package's agree to this
# relative bar (each quantity against its largest entry; they read <= 3e-15).
DEEP_SYSTEM_TOL = 1e-14


def _jax_dynamic_systems(times, rows, omega_t, mu_t, t0, w):
    """The systems that the JAX package's engine.dynamic_fit_core forms
    around its solve (engine.py:281-300), in its own jnp operations:
    G, rhs, G_tau, r_tau, data_norm of one window."""
    from qnmfits_tpu.ops.cmath import damped_phase
    from qnmfits_tpu.ops.windows import trapz_weights
    times, rows, w = jnp.asarray(times), jnp.asarray(rows), jnp.asarray(w)
    tau = trapz_weights(times, w)
    phi = damped_phase(jnp.asarray(omega_t), (times[:, None] - t0) * w[:, None])
    E = jnp.asarray(mu_t) * phi[None, :, :]
    Ew = E * w[None, :, None]
    G = jnp.einsum("ikj,ikl->jl", Ew.conj(), Ew)
    rhs = jnp.einsum("ikj,ik->j", Ew.conj(), rows * w[None, :])
    Et = E * tau[None, :, None]
    G_tau = jnp.einsum("ikj,ikl->jl", Et.conj(), E)
    r_tau = jnp.einsum("ikj,ik->j", Et.conj(), rows)
    data_norm = jnp.real(jnp.sum(tau[None, :] * rows * jnp.conj(rows)))
    return [np.asarray(x) for x in (G, rhs, G_tau, r_tau, data_norm)]


def _mismatch_rounding_bound(G, rhs, G_tau, r_tau, data_norm):
    """How far rounding can move this window's mismatch, to first order.

    With D = diag(G)^(1/2), the solve works on the equilibrated system
    A x = b', A = D^-1 G D^-1, x = D C.  A perturbation (dA, db') of it
    moves x by A^-1 (db' - dA x) and the mismatch by Re g_x^H dx, where
    g_x = D^-1 g and g is the mismatch's gradient in C:
        g = -r_tau / sqrt(Q n) + N G_tau C / (sqrt(n) Q^(3/2)),
    N = Re C^H r_tau, Q = Re C^H G_tau C, n = data_norm.  So
    |d mm| <= |A^-1 g_x| (|dA| |x| + |db'|).  Each of the two routes (the
    port's, the JAX package's) perturbs A and b' twice, once in the Gram
    sums and once in the solve's backward error, each by J eps |A| |x|:
    8 J eps |A^-1 g_x| |A| |x| in all.  |A^-1 g_x| carries the system's
    conditioning (kappa(A) ~ 2.5e9 here), so this is the measured
    conditioning of the mismatch itself, where chip_smoke.gram_bound takes
    the worst direction of kappa(A)^2 (~1e-7 here, above the oracle gap).
    """
    J = G.shape[-1]
    eps = np.finfo(float).eps
    C = ter._regularised_solve_plain(torch.as_tensor(np.array(G))[None],
                                     torch.as_tensor(np.array(rhs))[None])[
        0].numpy()
    N = np.real(np.vdot(C, r_tau))
    Q = np.real(np.vdot(C, G_tau @ C))
    g = (-r_tau / np.sqrt(Q * data_norm)
         + N * (G_tau @ C) / (np.sqrt(data_norm) * Q ** 1.5))
    d = np.sqrt(np.real(np.diag(G)))
    A = G / d[:, None] / d[None, :]
    return (8 * J * eps * np.linalg.norm(np.linalg.solve(A, g / d))
            * np.linalg.norm(A, 2) * np.linalg.norm(d * C))


def test_deep_ladder_oracle_gap_is_the_jax_packages():
    """The bench's 8-overtone ladder fitted along chip_smoke.py's tracks at
    the bench shape (K = 2001, T = 100): Grams of kappa ~ 1e16 (2.5e9
    equilibrated), where the Gram path and the oracle's SVD part by ~1e-9
    (ROADMAP C.3).  The port builds the JAX package's systems to rounding
    (DEEP_SYSTEM_TOL); on them two orders of summation move the mismatch
    by up to ~2.5e-11, so the port agrees with the JAX package within the
    rounding bound of each window's mismatch
    (``_mismatch_rounding_bound``), a bound that stays under a fifth of
    the oracle gap; and both are as far from the oracle, within
    chip_smoke.DEEP_ORACLE_TOL."""
    import chip_smoke
    from qnmfits_tpu_torch.testing import bench_mode_sets
    p = chip_smoke.build_problem(**dict(chip_smoke.FULL, events=2))
    deep = bench_mode_sets()[chip_smoke.DEEPEST]
    t0s = np.array([0.5, 10.0, 25.0])
    args = (p["times"], p["data"], [deep], p["Mf_t"], p["chif_t"], t0s)
    kw = dict(T_array=p["T"], spherical_modes=SPH, dynamic=True)
    mm = tq.mismatch_t0_mode_sets(*args, device="cpu", **kw)[0]
    mm_j = np.asarray(jf.mismatch_t0_mode_sets(*args, **kw))[0]
    ref = np.array([tref.dynamic_multimode_ringdown_fit(
        p["times"], p["data"], deep, p["Mf_t"], p["chif_t"], t0, T=p["T"],
        spherical_modes=SPH)["mismatch"] for t0 in t0s])

    # The systems of each window, the port's on the sample range its sweep
    # builds them on, against the JAX package's on the same spectrum.
    times, rows, sph = jb._prep(p["times"], p["data"], SPH)
    eval_tracks, _ = jb._modesets_spectrum_dynamic_fn(
        (tuple(jb._canon(deep)),), sph)
    om, mu = (np.array(x[0]) for x in eval_tracks(p["chif_t"], p["Mf_t"]))
    tt = torch.as_tensor(times)
    lo, hi = tb._window_spans(tt, torch.as_tensor(t0s),
                              torch.full((len(t0s),), p["T"]))
    bound = np.empty(len(t0s))
    for b, t0 in enumerate(t0s):
        w = window_geq(tt, t0, p["T"])
        sys_j = _jax_dynamic_systems(times, rows, om, mu, t0, w.numpy())
        a, e = int(lo[b]), int(hi[b])
        sys_t = te.dynamic_fit_systems(
            tt[a:e], torch.as_tensor(rows[:, a:e]), torch.as_tensor(om[a:e]),
            torch.as_tensor(mu[:, a:e]), torch.tensor(t0), w[a:e])
        for x_t, x_j in zip(sys_t, sys_j):
            assert (np.max(np.abs(x_t.numpy() - x_j))
                    <= DEEP_SYSTEM_TOL * np.max(np.abs(x_j)))
        bound[b] = _mismatch_rounding_bound(*sys_j)
    assert np.all(bound <= 0.2 * np.abs(mm_j - ref))

    assert np.all(np.abs(mm - mm_j) <= bound)
    assert np.max(np.abs(mm - ref)) <= chip_smoke.DEEP_ORACLE_TOL
    assert np.all(np.abs(np.abs(mm - ref) - np.abs(mm_j - ref)) <= bound)


# ---------------------------------------------------------------------------
# Catalog event batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_fit_events_matches_jax(catalog, t0_method):
    c = catalog
    args = (c["times"], c["rows"], MODES, c["Mfs"], c["chifs"], c["t0s"])
    mm, C = tq.fit_events(*args, T=25.0, t0_method=t0_method, device="cpu")
    mm_j, C_j = jb.batch_fit_events(*args, T=25.0, t0_method=t0_method)
    assert mm.shape == (len(c["t0s"]),) and C.shape == (len(c["t0s"]), 3)
    np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(C, np.asarray(C_j), rtol=0, atol=EVENT_C_TOL)
    mm_f, C_f = tq.fit_events(*args, T=25.0, engine="fast", chunk=5,
                              device="cpu")
    mm_jf, _ = jb.batch_fit_events(*args, T=25.0, engine="fast")
    np.testing.assert_allclose(mm_f, np.asarray(mm_jf), rtol=0, atol=MM_TOL)


@pytest.mark.parametrize("jax_analytic", [False, True])
def test_sweep_events_real_matches_jax(catalog, jax_analytic):
    """The port's event sweep (summed Grams) against
    engine_real.sweep_events_real on the same spectra, with the JAX
    package's summed and its closed-form Grams."""
    c = catalog
    E = len(c["t0s"])
    Ts = np.full(E, 25.0)
    C, mm = tb.sweep_events_real(
        torch.as_tensor(c["times"]), torch.as_tensor(c["rows"]),
        torch.as_tensor(c["omegas"]), torch.as_tensor(c["t0s"]),
        torch.as_tensor(Ts), chunk=7)
    Cre, Cim, mm_j = jer.sweep_events_real(
        jnp.asarray(c["times"]), jnp.asarray(c["rows"].real),
        jnp.asarray(c["rows"].imag), jnp.asarray(c["omegas"].real),
        jnp.asarray(c["omegas"].imag), jnp.asarray(c["t0s"]),
        jnp.asarray(Ts), chunk=8, analytic=jax_analytic)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=0,
                               atol=MM_TOL)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cre) + 1j
                               * np.asarray(Cim), rtol=0, atol=EVENT_C_TOL)


@pytest.mark.parametrize("entry", ["t0_array", "fit_events"])
def test_fast_engine_is_the_batched_sweep(problem, catalog, entry):
    """With 'geq' windows, engine='fast' runs the same sweep as 'batched'
    for tracks and for event batches, so the card runs and times one of
    them: the results are identical."""
    if entry == "t0_array":
        args = (problem["times"], problem["data"], MODES, problem["Mf_t"],
                problem["chif_t"], T0S)
        kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
                  device="cpu")
        mm, C = tb.batch_mismatch_t0_dynamic(*args, engine="batched", **kw)
        mm_f, C_f = tb.batch_mismatch_t0_dynamic(*args, engine="fast", **kw)
    else:
        c = catalog
        args = (c["times"], c["rows"], MODES, c["Mfs"], c["chifs"],
                c["t0s"])
        mm, C = tq.fit_events(*args, T=25.0, device="cpu")
        mm_f, C_f = tq.fit_events(*args, T=25.0, engine="fast",
                                  device="cpu")
    np.testing.assert_array_equal(mm_f, mm)
    np.testing.assert_array_equal(C_f, C)


@pytest.mark.parametrize("precision", ["x64", "f32"])
def test_fit_events_precision(catalog, precision):
    """fit_events takes the JAX signature's precision=: 'x64' gives the
    call without it exactly, anything else raises."""
    c = catalog
    args = (c["times"], c["rows"], MODES, c["Mfs"], c["chifs"], c["t0s"])
    if precision != "x64":
        with pytest.raises(NotImplementedError, match="x64"):
            tq.fit_events(*args, T=25.0, precision=precision, device="cpu")
        return
    mm, C = tq.fit_events(*args, T=25.0, precision=precision, device="cpu")
    mm0, C0 = tq.fit_events(*args, T=25.0, device="cpu")
    np.testing.assert_array_equal(mm, mm0)
    np.testing.assert_array_equal(C, C0)
    mm_j, _ = jb.batch_fit_events(*args, T=25.0, precision=precision)
    np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0, atol=MM_TOL)


def test_fit_events_raises(catalog):
    c = catalog
    args = (c["times"], c["rows"], MODES, c["Mfs"])
    bad = c["chifs"].copy()
    bad[3] = 1.2
    with pytest.raises(ValueError, match="chif"):
        tq.fit_events(*args, bad, c["t0s"], device="cpu")
    with pytest.raises(ValueError, match=r"\(E, K\)"):
        tq.fit_events(c["times"], c["rows"][0], MODES, 0.95, 0.7, 1.0,
                      device="cpu")
    with pytest.raises(ValueError, match="geq"):
        tq.fit_events(*args, c["chifs"], c["t0s"], engine="fast",
                      t0_method="closest", device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        tq.fit_events(*args, c["chifs"], c["t0s"], mesh="auto",
                      device="cpu")
    with pytest.raises(ValueError, match="geq"):
        tq.fit_events(*args, c["chifs"], c["t0s"], mesh="auto",
                      t0_method="closest", device="cpu")


# ---------------------------------------------------------------------------
# The NumPy oracle's dynamic loop
# ---------------------------------------------------------------------------

def test_oracle_dynamic_loop_matches_jax_oracle(problem):
    times, data = problem["times"], problem["data"]
    for d, sph in ((data, SPH), (data[(2, 2)], None)):
        mm = tref.mismatch_t0_array(times, d, MODES, problem["Mf_t"],
                                    problem["chif_t"], T0S, T_array=20.0,
                                    spherical_modes=sph)
        mm_j = jref.mismatch_t0_array(times, d, MODES, problem["Mf_t"],
                                      problem["chif_t"], T0S, T_array=20.0,
                                      spherical_modes=sph)
        np.testing.assert_allclose(mm, mm_j, rtol=0, atol=1e-13)
    fit = tref.dynamic_multimode_ringdown_fit(
        times, data, MODES, problem["Mf_t"], problem["chif_t"], 3.0, T=20.0)
    fit_j = jref.dynamic_multimode_ringdown_fit(
        times, data, MODES, problem["Mf_t"], problem["chif_t"], 3.0, T=20.0)
    np.testing.assert_allclose(fit["C"], fit_j["C"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(fit["frequencies"], fit_j["frequencies"],
                               rtol=1e-13, atol=0)
