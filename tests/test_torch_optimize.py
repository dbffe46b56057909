"""The port's optimisers against the JAX package's, on the CPU: the torch
spline of the spectrum and its spin derivative, the mismatch's gradient
and Hessian, the array optimisers (seed grid + damped Newton) and the
single-start-time L-BFGS-B and Nelder-Mead paths.

Small sizes: K = 400 samples, the (2,2,n<3) ladder, 12 start times on a
grid finer than the sampling (so dedup groups them), maxiter = 8.  Each
JAX reference runs once, in a module-scoped fixture (the JAX optimisers
take seconds to compile on the CPU).  Bounds: the spline 1e-12 relative
(values and spin derivatives); gradients and Hessians 1e-8 relative;
the array optimisers omega and (Mf, chif) 1e-6 (the JAX package's own
bar, tests/test_optimize.py) and the mismatch at the optimum 1e-12; the
L-BFGS-B paths 1e-6 and the Nelder-Mead paths 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qnmfits_tpu import fitting as jf
from qnmfits_tpu import optimize as jo
from qnmfits_tpu.engine import SpectrumEvaluator as JaxEvaluator
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch import optimize as to
from qnmfits_tpu_torch.engine import SpectrumEvaluator
from qnmfits_tpu_torch.ops import moments_cuda
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MODES = [(2, 2, n, 1) for n in range(3)]
SPLINE_RTOL = 1e-12
DERIV_RTOL = 1e-8
PARAM_TOL = 1e-6
MM_TOL = 1e-12
T = 20.0
MAXITER = 8
# 12 start times, 0.05 apart on a 0.1 grid: 6 distinct 'geq' windows.
T0S = np.linspace(0.0, 0.55, 12)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def syn():
    """A (2,2,n<4) ringdown with mixing into (2,2) and (3,2), K = 400,
    with a small smooth perturbation so no fit is exact."""
    s = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)],
                            spherical_modes=SPH,
                            times=np.arange(-10.0, 30.0, 0.1), seed=21)
    s["data_dict"] = {k: v + 1e-5 * np.exp(-0.05 * np.abs(s["times"]))
                      for k, v in s["data_dict"].items()}
    s["row"] = s["data_dict"][(2, 2)]
    return s


# ---------------------------------------------------------------------------
# The torch spline
# ---------------------------------------------------------------------------

def test_spline_and_spin_derivatives_match_jax():
    """omega_t / mu_t and their derivatives in chif against jax.grad of
    the JAX evaluator, at knots (where searchsorted's side picks the
    segment) and mid-segment, for prograde, mirror and (3,2) modes."""
    modes = MODES + [(2, 2, 0, -1), (3, 2, 0, 1)]
    ev, ev_j = SpectrumEvaluator(modes, SPH), JaxEvaluator(modes, SPH)
    grid = ev.chi_grid
    chis = np.concatenate([grid[[3, 40, 100]],
                           0.5 * (grid[[10, 60, 120]] + grid[[11, 61, 121]]),
                           [0.692]])
    x = torch.tensor(chis, requires_grad=True)
    om = ev.omega_t(x, 0.952)                                # (N, J)
    mu = ev.mu_t(x)                                          # (N, I, J)
    om_j = np.asarray(ev_j.omega(chis, 0.952)).T
    mu_j = np.moveaxis(np.asarray(ev_j.mu(chis)), -1, 0)
    assert _rel(om.detach(), om_j) <= SPLINE_RTOL
    assert _rel(mu.detach(), mu_j) <= SPLINE_RTOL
    # d/dchi of the real and imaginary parts: torch per component (each
    # output depends on its own spin only), JAX by vmapped jacfwd.
    for val, ref_fn in ((om, lambda c: ev_j.omega(c, 0.952)), (mu, ev_j.mu)):
        d_j = jax.vmap(jax.jacfwd(lambda c: jnp.stack(
            [jnp.real(ref_fn(c)), jnp.imag(ref_fn(c))])))(jnp.asarray(chis))
        d_j = np.asarray(d_j)                        # (N, 2, *shape)
        for p, part in enumerate((torch.real, torch.imag)):
            for idx in np.ndindex(*val.shape[1:]):
                d, = torch.autograd.grad(
                    part(val[(slice(None),) + idx]).sum(), x,
                    retain_graph=True)
                ref = d_j[(slice(None), p) + idx]
                assert np.max(np.abs(d.numpy() - ref)) <= SPLINE_RTOL * max(
                    np.max(np.abs(d_j)), 1.0)


# ---------------------------------------------------------------------------
# Gradient and Hessian of the mismatch
# ---------------------------------------------------------------------------

def _jax_hessian(vg, x, *args):
    return np.asarray(jax.jacfwd(lambda y: vg(y, *args)[1])(jnp.asarray(x)))


def test_free_frequency_mismatch_derivatives_match_jax(syn):
    t0 = 2.0
    x = np.array([0.52, -0.27])
    fixed = MODES[:1]
    vg = jo._free_freq_objective(jo._canon(fixed), "geq")
    args = (jnp.asarray(syn["times"]), jnp.asarray(syn["row"])[None],
            syn["Mf"], syn["chif"], t0, T)
    v_j, g_j = vg(jnp.asarray(x), *args)
    H_j = _jax_hessian(vg, x, *args)

    ev = SpectrumEvaluator(fixed)
    fx = torch.tensor(ev.omega(syn["chif"], syn["Mf"]))
    prob = to._Problem(syn["times"], syn["row"][None], [t0], [T], "geq",
                       torch.device("cpu"), None)
    win = torch.zeros(1, dtype=torch.long)
    ones = torch.ones((1, 2), dtype=torch.complex128)

    def mm_fn(y):
        free = torch.complex(y[:, 0], y[:, 1])[:, None]
        om = torch.cat([fx.expand(1, -1), free], dim=1)
        return prob.mm(om, ones, win)

    g, H = to._grad(mm_fn, torch.tensor(x[None]), hessian=True)
    assert abs(float(mm_fn(torch.tensor(x[None]))) - float(v_j)) <= 1e-13
    assert _rel(g[0], g_j) <= DERIV_RTOL
    assert _rel(H[0], H_j) <= DERIV_RTOL


@pytest.mark.parametrize("sph", [None, SPH])
def test_epsilon_mismatch_derivatives_match_jax(syn, sph):
    t0 = 2.0
    x = np.array([0.97, 0.66])
    data = syn["row"][None] if sph is None else np.stack(
        [syn["data_dict"][lm] for lm in SPH])
    sph_key = None if sph is None else tuple(sph)
    vg = jo._epsilon_objective(jo._canon(MODES), sph_key, "geq", None)
    args = (jnp.asarray(syn["times"]), jnp.asarray(data), t0, T,
            jnp.asarray(1.0))
    v_j, g_j = vg(jnp.asarray(x), *args)
    H_j = _jax_hessian(vg, x, *args)

    ev = SpectrumEvaluator(MODES, sph)
    prob = to._Problem(syn["times"], data, [t0], [T], "geq",
                       torch.device("cpu"), None)
    win = torch.zeros(1, dtype=torch.long)

    def mm_fn(y):
        chif = torch.clamp(y[:, 1], 0.0, 0.99)
        om = ev.omega_t(chif, y[:, 0], 1.0)
        mu = (torch.ones((1, 3), dtype=om.dtype) if sph is None
              else ev.mu_t(chif))
        return prob.mm(om, mu, win)

    g, H = to._grad(mm_fn, torch.tensor(x[None]), hessian=True)
    assert abs(float(mm_fn(torch.tensor(x[None]))) - float(v_j)) <= 1e-13
    assert _rel(g[0], g_j) <= DERIV_RTOL
    assert _rel(H[0], H_j) <= DERIV_RTOL


def test_newton_step_solve_count(syn, monkeypatch):
    """A Newton step makes 4 solves: from one launch of the order-2 window
    moments, the fit C, its first derivatives (both parameters stacked in
    one solve) and its second (the three pairs stacked), then the trial
    fit from an order-0 launch; the winning seed's fit makes 1 and the
    final gradient check 2 (C and its first derivatives).  So a call of
    one chunk makes 1 + 4 maxiter + 2 solves and 1 + 2 maxiter + 1 moments
    launches (the launch arithmetic of PERF.md and chip_smoke.py)."""
    calls, moments = [], []
    real, real_m = ter._solve_detached, moments_cuda.window_moments
    monkeypatch.setattr(to, "_solve_detached",
                        lambda G, b: calls.append(1) or real(G, b))
    monkeypatch.setattr(moments_cuda, "window_moments",
                        lambda *a, **k: moments.append(a[-1])
                        or real_m(*a, **k))
    tq.free_frequency_fit_array(syn["times"], syn["row"], T0S[:2],
                                T_array=T, maxiter=3, device="cpu",
                                dedup=False)
    assert len(calls) == 1 + 4 * 3 + 2
    assert moments == [0] + [2, 0] * 3 + [1]


# ---------------------------------------------------------------------------
# The array optimisers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ff_ref(syn):
    """JAX's free_frequency_fit_array per start time (dedup off), one
    fixed mode, for each window method."""
    kw = dict(modes=MODES[:1], Mf=syn["Mf"], chif=syn["chif"], T_array=T,
              maxiter=MAXITER, return_mismatch=True, dedup=False)
    return {m: jo.free_frequency_fit_array(syn["times"], syn["row"], T0S,
                                           t0_method=m, **kw)
            for m in ("geq", "closest")}


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("method", ["geq", "closest"])
def test_free_frequency_fit_array_matches_jax(syn, ff_ref, method, dedup):
    w_j, mm_j, ok_j = ff_ref[method]
    w, mm, ok = tq.free_frequency_fit_array(
        syn["times"], syn["row"], T0S, modes=MODES[:1], Mf=syn["Mf"],
        chif=syn["chif"], t0_method=method, T_array=T, maxiter=MAXITER,
        return_mismatch=True, dedup=dedup, device="cpu")
    assert w.shape == mm.shape == ok.shape == T0S.shape
    np.testing.assert_allclose(w, np.asarray(w_j), rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(mm, np.asarray(mm_j), rtol=0, atol=MM_TOL)
    np.testing.assert_array_equal(ok, np.asarray(ok_j))


@pytest.fixture(scope="module")
def eps_ref(syn):
    """JAX's calculate_epsilon_array (dedup off): dict data with 'geq'
    windows, the single series with 'closest' windows and a cold x0."""
    return {
        "geq": jo.calculate_epsilon_array(
            syn["times"], syn["data_dict"], MODES, syn["Mf"], syn["chif"],
            T0S, spherical_modes=SPH, T_array=T, maxiter=MAXITER,
            dedup=False),
        "closest": jo.calculate_epsilon_array(
            syn["times"], syn["row"], MODES, syn["Mf"], syn["chif"], T0S,
            t0_method="closest", T_array=T, maxiter=MAXITER,
            x0=[1.1, 0.5], dedup=False),
    }


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("method", ["geq", "closest"])
def test_calculate_epsilon_array_matches_jax(syn, eps_ref, method, dedup):
    if method == "geq":
        args, kw = (syn["data_dict"],), dict(spherical_modes=SPH)
    else:
        args, kw = (syn["row"],), dict(t0_method="closest", x0=[1.1, 0.5])
    eps, Mf, chif, mm, ok = tq.calculate_epsilon_array(
        syn["times"], *args, MODES, syn["Mf"], syn["chif"], T0S, T_array=T,
        maxiter=MAXITER, dedup=dedup, device="cpu", return_mismatch=True,
        **kw)
    eps_j, Mf_j, chif_j = (np.asarray(a) for a in eps_ref[method])
    np.testing.assert_allclose(Mf, Mf_j, rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(chif, chif_j, rtol=0, atol=PARAM_TOL)
    np.testing.assert_allclose(eps, eps_j, rtol=0, atol=2 * PARAM_TOL)
    # The mismatch at the port's optimum, against the JAX objective's
    # value at JAX's optimum.
    sph = tuple(SPH) if method == "geq" else None
    data = (np.stack([syn["data_dict"][lm] for lm in SPH])
            if method == "geq" else syn["row"][None])
    vg = jo._epsilon_objective(jo._canon(MODES), sph, method, None)
    mm_j = [float(vg(jnp.asarray([Mf_j[i], chif_j[i]]), syn["times"], data,
                     t0, T, jnp.asarray(1.0))[0]) for i, t0 in enumerate(T0S)]
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    assert ok.dtype == bool and ok.shape == T0S.shape


def test_array_optimisers_raise(syn):
    with pytest.raises(ValueError, match="init_process_group"):
        tq.free_frequency_fit_array(syn["times"], syn["row"], T0S,
                                    mesh="auto", device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        tq.calculate_epsilon_array(syn["times"], syn["row"], MODES,
                                   syn["Mf"], syn["chif"], T0S, mesh="auto",
                                   device="cpu")
    with pytest.raises(ValueError, match="Mf and chif"):
        tq.free_frequency_fit_array(syn["times"], syn["row"], T0S,
                                    modes=MODES[:1], device="cpu")
    with pytest.raises(ValueError, match="chif"):
        tq.calculate_epsilon_array(syn["times"], syn["row"], MODES,
                                   syn["Mf"], 1.2, T0S, device="cpu")


# ---------------------------------------------------------------------------
# One start time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_method,tol", [("gradient", PARAM_TOL),
                                            ("Nelder-Mead", 1e-12)])
def test_single_start_time_paths_match_jax(syn, min_method, tol):
    t0 = 2.0
    kw = dict(T=T, min_method=min_method)
    e = tq.calculate_epsilon(syn["times"], syn["data_dict"], MODES,
                             syn["Mf"], syn["chif"], t0,
                             spherical_modes=SPH, x0=[0.96, 0.68],
                             device="cpu", **kw)
    e_j = jf.calculate_epsilon(syn["times"], syn["data_dict"], MODES,
                               syn["Mf"], syn["chif"], t0,
                               spherical_modes=SPH, x0=[0.96, 0.68], **kw)
    np.testing.assert_allclose(e[1:], e_j[1:], rtol=0, atol=tol)
    w = tq.free_frequency_fit(syn["times"], syn["row"], t0, modes=MODES[:1],
                              Mf=syn["Mf"], chif=syn["chif"], device="cpu",
                              **kw)
    w_j = jf.free_frequency_fit(syn["times"], syn["row"], t0,
                                modes=MODES[:1], Mf=syn["Mf"],
                                chif=syn["chif"], **kw)
    assert abs(w - w_j) <= tol


def test_gradient_paths_count_evaluations_and_raise(syn):
    to.evaluations = 0
    tq.free_frequency_fit(syn["times"], syn["row"], 2.0, T=T, device="cpu")
    assert to.evaluations > 0
    with pytest.raises(ValueError, match="Mf and chif"):
        tq.free_frequency_fit(syn["times"], syn["row"], 2.0,
                              modes=MODES[:1], device="cpu")
