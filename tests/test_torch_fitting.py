"""The port's single fits, start-time sweeps and grids against the JAX
package's, on the CPU.

The same numpy inputs go through qnmfits_tpu.fitting and
qnmfits_tpu_torch (device="cpu": the plain PyTorch solve).  Small sizes:
K of a few hundred samples, I = 2 spherical modes, J <= 5, B <= 24
start times, res <= 4.  Bounds: mismatch 1e-11, amplitudes rtol 1e-10 /
atol 1e-12, SVD rank equal and singular values rtol 1e-12.  The cases
mirror tests/test_fitting.py and tests/test_batched.py.
"""

import numpy as np
import pytest

from qnmfits_tpu import fitting as jf
from qnmfits_tpu import ref_impl as jref
from qnmfits_tpu.testing import synthetic_single
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import ref_impl as tref
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MM_TOL = 1e-11
C_RTOL, C_ATOL = 1e-10, 1e-12
S_RTOL = 1e-12


@pytest.fixture(scope="module")
def single():
    """A noisy single series, 5 modes with a mirror mode (as
    tests/test_fitting.py's _noisy_single), cut to 400 samples."""
    return synthetic_single(
        modes=[(2, 2, n, 1) for n in range(4)] + [(2, 2, 0, -1)],
        noise=1e-3, seed=3, times=np.arange(-10.0, 30.0, 0.1))


@pytest.fixture(scope="module")
def multi():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(3)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-10.0, 30.0, 0.1), seed=4)
    # Perturbed so the fit is not exact (tests/test_fitting.py:103).
    syn["data_dict"] = {k: v + 1e-3 * np.exp(-0.05 * np.abs(syn["times"]))
                        for k, v in syn["data_dict"].items()}
    return syn


def _same_result(a, b):
    """Same keys, and every array of the same shape and dtype."""
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            assert list(va) == list(vb)
            for lm in va:
                assert np.shape(va[lm]) == np.shape(vb[lm])
        elif isinstance(va, np.ndarray):
            assert va.shape == vb.shape and va.dtype == vb.dtype, k
        else:
            assert type(va) is type(vb), k


def _check_fit(a, b):
    _same_result(a, b)
    assert abs(a["mismatch"] - b["mismatch"]) <= MM_TOL
    np.testing.assert_allclose(b["C"], a["C"], rtol=C_RTOL, atol=C_ATOL)
    np.testing.assert_allclose(b["residual"], a["residual"], rtol=1e-8,
                               atol=1e-16)
    if "rank" in a:
        # The singular values the rank keeps agree to rtol; those cut are
        # rounding noise in both packages, below the cut in both.
        r = a["rank"]
        assert b["rank"] == r and a["s"].shape == b["s"].shape
        np.testing.assert_allclose(b["s"][:r], a["s"][:r], rtol=S_RTOL,
                                   atol=0)
        cut = 1e-13 * a["s"][0]
        assert np.all(a["s"][r:] < cut) and np.all(b["s"][r:] < cut)
    np.testing.assert_allclose(b["frequencies"], a["frequencies"],
                               rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# Single fits (SVD least squares)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(t0=7.3, T=23.0),
    dict(t0=7.3, T=23.0, t0_method="closest"),
    dict(t0=0.0, T=25.0, delta=[0.01, -0.02, 0.0, 0.005, 0.0]),
    dict(t0=2.0, T=25.0, delta=0.01),
], ids=["geq", "closest", "delta-array", "delta-scalar"])
def test_ringdown_fit_matches_jax(single, kw):
    s = single
    args = (s["times"], s["data"], s["modes"], s["Mf"], s["chif"])
    a = jf.ringdown_fit(*args, **kw)
    b = tq.ringdown_fit(*args, device="cpu", **kw)
    _check_fit(a, b)
    np.testing.assert_allclose(b["model"], a["model"], rtol=0, atol=1e-12)
    o = tref.ringdown_fit(*args, **kw)
    assert abs(b["mismatch"] - o["mismatch"]) <= MM_TOL


@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_multimode_ringdown_fit_matches_jax(multi, t0_method):
    m = multi
    args = (m["times"], m["data_dict"], m["modes"], m["Mf"], m["chif"])
    kw = dict(t0=3.0, T=24.0, spherical_modes=SPH, t0_method=t0_method)
    a = jf.multimode_ringdown_fit(*args, **kw)
    b = tq.multimode_ringdown_fit(*args, device="cpu", **kw)
    _check_fit(a, b)
    for lm in SPH:
        np.testing.assert_allclose(b["weighted_C"][lm], a["weighted_C"][lm],
                                   rtol=C_RTOL, atol=C_ATOL)
    o = tref.multimode_ringdown_fit(*args, **kw)
    assert abs(b["mismatch"] - o["mismatch"]) <= MM_TOL


def test_rank_deficient_fit_matches_jax(single):
    """A mode set with a repeated mode: the SVD cut drops a singular value
    in both packages, the rank is 2 of 3 and the minimum-norm amplitudes
    agree."""
    s = single
    modes = [(2, 2, 0, 1), (2, 2, 1, 1), (2, 2, 0, 1)]
    args = (s["times"], s["data"], modes, s["Mf"], s["chif"])
    a = jf.ringdown_fit(*args, t0=5.0, T=20.0)
    b = tq.ringdown_fit(*args, t0=5.0, T=20.0, device="cpu")
    assert a["rank"] == b["rank"] == 2
    _check_fit(a, b)


@pytest.mark.parametrize("multimode", [False, True])
def test_dynamic_fits_match_jax(single, multi, multimode):
    syn = multi if multimode else single
    K = len(syn["times"])
    Mf_t = np.linspace(0.97, 0.952, K)
    chif_t = np.linspace(0.65, 0.692, K)
    if multimode:
        args = (syn["times"], syn["data_dict"], syn["modes"], Mf_t, chif_t)
        kw = dict(t0=2.0, T=20.0, spherical_modes=SPH)
        a = jf.dynamic_multimode_ringdown_fit(*args, **kw)
        b = tq.dynamic_multimode_ringdown_fit(*args, device="cpu", **kw)
        for lm in SPH:
            np.testing.assert_allclose(b["weighted_C"][lm],
                                       a["weighted_C"][lm], rtol=C_RTOL,
                                       atol=C_ATOL)
    else:
        args = (syn["times"], syn["data"], syn["modes"], Mf_t, chif_t)
        a = jf.dynamic_ringdown_fit(*args, t0=5.0, T=20.0)
        b = tq.dynamic_ringdown_fit(*args, t0=5.0, T=20.0, device="cpu")
    _check_fit(a, b)


def test_primitives_match_jax(single):
    s = single
    h = tq.ringdown(s["times"], 3.0, s["amplitudes"], s["frequencies"])
    assert np.array_equal(h, jref.ringdown(s["times"], 3.0, s["amplitudes"],
                                           s["frequencies"]))
    assert tq.mismatch(s["times"], h, s["data"]) == jf.mismatch(
        s["times"], h, s["data"])
    d = {(2, 2): h, (3, 2): s["data"]}
    assert tq.multimode_mismatch(s["times"], d, d) == \
        jf.multimode_mismatch(s["times"], d, d)


def test_precision_and_spin_rules(single):
    s = single
    args = (s["times"], s["data"], s["modes"], s["Mf"])
    with pytest.raises(NotImplementedError, match="x64"):
        tq.ringdown_fit(*args, s["chif"], t0=0.0, precision="x32",
                        device="cpu")
    with pytest.raises(ValueError, match="chif"):
        tq.ringdown_fit(*args, 1.2, t0=0.0, device="cpu")


# ---------------------------------------------------------------------------
# mismatch_t0_array: 'batched', 'fast' and 'loop'
# ---------------------------------------------------------------------------

T0S = np.linspace(-3.0, 12.0, 24)


def _sweep_case(single, multi, case):
    """(args, kwargs, engines) of a mismatch_t0_array case."""
    s, m = single, multi
    args = (s["times"], s["data"], s["modes"], s["Mf"], s["chif"], T0S)
    if case == "single":
        return args, dict(T_array=15.0), ("batched", "fast", "loop")
    if case == "multimode":
        return ((m["times"], m["data_dict"], m["modes"], m["Mf"], m["chif"],
                 T0S), dict(T_array=15.0, spherical_modes=SPH),
                ("batched", "fast", "loop"))
    if case == "per-t0-T":
        return args, dict(T_array=np.linspace(12.0, 18.0, len(T0S))), \
            ("batched", "fast", "loop")
    if case == "closest":
        return (args[:5] + (T0S + 0.013,), dict(T_array=15.0,
                                                t0_method="closest"),
                ("batched", "loop"))
    if case == "delta":
        return args, dict(T_array=15.0, delta=[0.01, -0.01, 0.0, 0.0, 0.0]), \
            ("batched", "fast", "loop")
    raise AssertionError(case)


@pytest.mark.parametrize("engine", ["batched", "fast", "loop"])
@pytest.mark.parametrize("case", ["single", "multimode", "per-t0-T",
                                  "closest", "delta"])
def test_mismatch_t0_array_matches_jax(single, multi, case, engine):
    args, kw, engines = _sweep_case(single, multi, case)
    if engine not in engines:
        with pytest.raises(ValueError, match="geq"):
            tq.mismatch_t0_array(*args, engine=engine, device="cpu", **kw)
        return
    mm = np.asarray(tq.mismatch_t0_array(*args, engine=engine, device="cpu",
                                         **kw))
    mm_j = np.asarray(jf.mismatch_t0_array(*args, engine=engine, **kw))
    assert mm.shape == mm_j.shape == (len(T0S),)
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)


@pytest.mark.parametrize("t0_method", ["geq", "closest"])
def test_t0_sweep_amplitudes_and_dedup_match_jax(multi, t0_method):
    """A t0 grid finer than the sampling: the deduplicated sweep's
    mismatches and rephased amplitudes equal the per-t0 sweep's and the
    JAX sweep's."""
    from qnmfits_tpu import batched as jb
    from qnmfits_tpu_torch import batched as tb
    m = multi
    t0s = np.linspace(0.0, 3.0, 61) + 0.0017
    args = (m["times"], m["data_dict"], m["modes"], m["Mf"], m["chif"], t0s)
    kw = dict(T_array=15.0, spherical_modes=SPH, t0_method=t0_method,
              return_amplitudes=True)
    assert tb._dedup_for(t0_method, m["times"], t0s, np.full(61, 15.0)) \
        is not None
    mm, C = tb.batch_mismatch_t0(*args, device="cpu", **kw)
    mm0, C0 = tb.batch_mismatch_t0(*args, device="cpu", dedup=False, **kw)
    mm_j, C_j = jb.batch_mismatch_t0(*args, **kw)
    np.testing.assert_allclose(mm, mm0, rtol=0, atol=1e-13)
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(C, C0, rtol=C_RTOL, atol=C_ATOL)
    np.testing.assert_allclose(C, C_j, rtol=C_RTOL, atol=C_ATOL)


def test_fast_amplitudes_match_jax(multi):
    from qnmfits_tpu import batched as jb
    from qnmfits_tpu_torch import batched as tb
    m = multi
    args = (m["times"], m["data_dict"], m["modes"], m["Mf"], m["chif"],
            np.linspace(0.0, 3.0, 61))
    kw = dict(T_array=15.0, spherical_modes=SPH, return_amplitudes=True)
    mm, C = tb.batch_mismatch_t0_fast(*args, device="cpu", **kw)
    mm_j, C_j = jb.batch_mismatch_t0_fast(*args, **kw)
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    np.testing.assert_allclose(C, np.asarray(C_j), rtol=C_RTOL, atol=C_ATOL)


def test_t0_sweep_unported_and_bad_input_raise(single):
    s = single
    K = len(s["times"])
    args = (s["times"], s["data"], s["modes"], s["Mf"])
    chif_t = np.linspace(0.6, s["chif"], K)
    with pytest.raises(ValueError, match="delta"):
        tq.mismatch_t0_array(*args, chif_t, T0S, delta=0.01, device="cpu")
    with pytest.raises(ValueError, match="static spectrum"):
        tq.mismatch_t0_array(*args, chif_t, T0S, engine="sharded",
                             device="cpu")
    for engine in ("batched", "fast"):
        with pytest.raises(ValueError, match="tracks"):
            tq.mismatch_t0_array(*args, chif_t[:-1], T0S, engine=engine,
                                 device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        tq.mismatch_t0_array(*args, s["chif"], T0S, engine="sharded",
                             device="cpu")
    with pytest.raises(ValueError, match="geq"):
        tq.mismatch_t0_array(*args, s["chif"], T0S, mesh="auto",
                             t0_method="closest", device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        tq.mismatch_t0_array(*args, s["chif"], T0S[::-1], engine="fast",
                             device="cpu")
    with pytest.raises(ValueError, match="t0_method"):
        tq.mismatch_t0_array(*args, s["chif"], T0S, t0_method="GEQ",
                             device="cpu")


# ---------------------------------------------------------------------------
# Grids: 'batched' and 'loop'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("case", ["single", "multimode-delta", "closest"])
def test_M_chi_grid_matches_jax(single, multi, case, engine):
    if case == "multimode-delta":
        m = multi
        args = (m["times"], m["data_dict"], m["modes"])
        kw = dict(t0=1.0, T=20.0, res=3, spherical_modes=SPH,
                  delta=[0.01, 0.0, -0.01, 0.0])
    else:
        s = single
        args = (s["times"], s["data"], s["modes"][:3])
        kw = dict(t0=0.3, T=20.0, res=4,
                  t0_method="closest" if case == "closest" else "geq")
    grid = ((0.9, 1.0), (0.6, 0.8))
    mm = tq.mismatch_M_chi_grid(*args, *grid, engine=engine, device="cpu",
                                **kw)
    mm_j = jf.mismatch_M_chi_grid(*args, *grid, engine=engine, **kw)
    assert mm.shape == mm_j.shape == (kw["res"], kw["res"])
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)


@pytest.mark.parametrize("engine", ["batched", "loop"])
@pytest.mark.parametrize("n_fixed", [0, 1, 2])
def test_omega_grid_matches_jax(single, n_fixed, engine):
    """Fixed QNMs plus one free frequency; the Im axis reaches Im w > 0,
    a growing mode, where the window-clamped phase must stay finite.
    n_fixed = 0 solves one-mode systems."""
    s = single
    args = (s["times"], s["data"], s["modes"][:n_fixed], s["Mf"], s["chif"])
    kw = dict(re_minmax=(0.4, 0.6), im_minmax=(-0.2, 0.05), t0=0.0, T=20.0,
              res=4)
    mm = tq.mismatch_omega_grid(*args, engine=engine, device="cpu", **kw)
    mm_j = jf.mismatch_omega_grid(*args, engine=engine, **kw)
    assert mm.shape == (4, 4) and np.all(np.isfinite(mm))
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)


def test_grids_unported_and_bad_input_raise(single, multi):
    s = single
    args = (s["times"], s["data"], s["modes"][:2])
    # 'sharded' (and a mesh for 'fast') need a process group; 'batched'
    # takes no mesh.
    for kw, match in ((dict(engine="sharded"), "init_process_group"),
                      (dict(engine="fast", mesh="auto"), "init_process_group"),
                      (dict(mesh="auto"), "takes no mesh")):
        with pytest.raises(ValueError, match=match):
            tq.mismatch_M_chi_grid(*args, (0.9, 1.0), (0.6, 0.8), t0=0.0,
                                   device="cpu", **kw)
        with pytest.raises(ValueError, match=match):
            tq.mismatch_omega_grid(*args, s["Mf"], s["chif"], (0.4, 0.6),
                                   (-0.2, -0.05), t0=0.0, device="cpu", **kw)
    with pytest.raises(ValueError, match="single data series"):
        tq.mismatch_omega_grid(multi["times"], multi["data_dict"],
                               s["modes"][:1], s["Mf"], s["chif"],
                               (0.4, 0.6), (-0.2, -0.05), t0=0.0,
                               device="cpu")
    with pytest.raises(ValueError, match="chif"):
        tq.mismatch_M_chi_grid(*args, (0.9, 1.0), (0.6, 1.2), t0=0.0,
                               device="cpu")


# ---------------------------------------------------------------------------
# The fit core and its complex primitives
# ---------------------------------------------------------------------------

def test_fit_core_with_padding_matches_jax(multi):
    """engine.fit_core batched over two windows, with two padded slots:
    the padded amplitudes are exactly zero and the rest equal the JAX
    fit_core's on the same padded system (tests/test_batched.py:110)."""
    import jax.numpy as jnp
    import torch
    from qnmfits_tpu import engine as je
    from qnmfits_tpu.ops.windows import window_geq as jwindow
    from qnmfits_tpu_torch import engine as te
    from qnmfits_tpu_torch.ops.windows import window_geq
    m = multi
    ev = te.SpectrumEvaluator(m["modes"], SPH)
    omega, mu = ev.omega(m["chif"], m["Mf"]), ev.mu(m["chif"])
    rows = np.stack([m["data_dict"][lm] for lm in SPH])
    J = omega.shape[0]
    omega_p = np.concatenate([omega, np.zeros(2, complex)])
    mu_p = np.concatenate([mu, np.zeros((len(SPH), 2), complex)], axis=1)
    mask = np.array([True] * J + [False] * 2)
    t0s, T = np.array([0.0, 4.2]), 20.0
    tt = torch.as_tensor(m["times"])
    t0t = torch.as_tensor(t0s)
    w = window_geq(tt, t0t[:, None], T)
    C, mm = te.fit_core(tt, torch.as_tensor(rows), torch.as_tensor(omega_p),
                        torch.as_tensor(mu_p), t0t, w,
                        col_mask=torch.as_tensor(mask))
    assert C.shape == (2, J + 2) and torch.all(C[:, J:] == 0)
    for i, t0 in enumerate(t0s):
        C_j, mm_j = je.fit_core(jnp.asarray(m["times"]), jnp.asarray(rows),
                                jnp.asarray(omega_p), jnp.asarray(mu_p), t0,
                                jwindow(jnp.asarray(m["times"]), t0, T),
                                col_mask=jnp.asarray(mask))
        np.testing.assert_allclose(C[i].numpy(), np.asarray(C_j),
                                   rtol=C_RTOL, atol=C_ATOL)
        assert abs(float(mm[i]) - float(mm_j)) <= MM_TOL


def test_cmath_matches_jax():
    import jax.numpy as jnp
    import torch
    from qnmfits_tpu.ops import cmath as jc
    from qnmfits_tpu_torch.ops import cmath as tc
    rng = np.random.default_rng(0)
    z = rng.standard_normal(64) * 3 + 1j * rng.standard_normal(64) * 5
    w = rng.uniform(0.2, 1.5, 8) - 1j * rng.uniform(-0.1, 2.0, 8)
    dt = rng.uniform(-5.0, 40.0, (64, 1))
    np.testing.assert_allclose(tc.cexp(torch.as_tensor(z)).numpy(),
                               np.asarray(jc.cexp(jnp.asarray(z))),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        tc.damped_phase(torch.as_tensor(w), torch.as_tensor(dt)).numpy(),
        np.asarray(jc.damped_phase(jnp.asarray(w), jnp.asarray(dt))),
        rtol=1e-14, atol=0)
