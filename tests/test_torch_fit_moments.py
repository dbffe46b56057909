"""The array optimisers' fits and derivatives from the window moments
(``ops/moments_cuda`` and ``optimize._fit_derivs``) on the CPU, against
``engine.fit_systems``, the JAX package's objectives and the port's own
autograd.

Small sizes: K = 400 samples, the ``syn`` fixture of
tests/test_torch_optimize.py.  Each JAX reference runs once, in a
module-scoped fixture.  Bounds: the plain moments' systems 1e-13 relative
to each output's largest entry (two orders of summation over <= 400
samples); f 1e-12 (the array optimisers' mismatch bar), g and H 1e-8
relative against jax.value_and_grad / jax.jacfwd (the bar of
tests/test_torch_optimize.py), and f, g and H 1e-10 against
autograd through the same solve (the Hessian's 2 x 2 algebra in two
association orders, on Grams of equilibrated condition ~1e6); the
spectrum's jets 1e-14 against forward-mode AD of the same function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qnmfits_tpu import optimize as jo
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import engine as tengine
from qnmfits_tpu_torch import optimize as to
from qnmfits_tpu_torch.engine import cached_evaluator, fit_systems
from qnmfits_tpu_torch.ops import moments_cuda
from qnmfits_tpu_torch.ops.windows import trapz_weights
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MODES = [(2, 2, n, 1) for n in range(3)]
# (2,1,0) has no (2,2) or (3,2) content: its Gram column is dead.
DEAD_MODES = MODES + [(2, 1, 0, 1)]
T = 20.0
SYSTEMS_RTOL = 1e-13
JAX_RTOL = 1e-8
MM_TOL = 1e-12
AUTOGRAD_RTOL = 1e-10
JETS_RTOL = 1e-14
CPU = torch.device("cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def syn():
    """tests/test_torch_optimize.py's fixture: a (2,2,n<4) ringdown with
    mixing into (2,2) and (3,2), K = 400, slightly perturbed."""
    s = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)],
                            spherical_modes=SPH,
                            times=np.arange(-10.0, 30.0, 0.1), seed=21)
    s["data_dict"] = {k: v + 1e-5 * np.exp(-0.05 * np.abs(s["times"]))
                      for k, v in s["data_dict"].items()}
    s["row"] = s["data_dict"][(2, 2)]
    s["rows"] = np.stack([s["data_dict"][lm] for lm in SPH])
    return s


# ---------------------------------------------------------------------------
# The plain moments reproduce engine.fit_systems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("I,J", [(1, 1), (2, 3), (1, 8), (2, 8)])
@pytest.mark.parametrize("method", ["geq", "closest"])
def test_plain_moments_reproduce_fit_systems(method, I, J, uniform):
    """G = (mu^H mu) o S^{w,0}, rhs = sum_i conj(mu) P^{w,0}, G_tau, r_tau
    from the tau moments, and the window's data norm, against
    ``fit_systems`` on the same trajectories: 9 windows, among them one
    that runs off the grid's end, on a uniform or a jittered grid."""
    rng = np.random.default_rng(10 * I + J + uniform)
    K = 400
    steps = np.full(K - 1, 0.1) if uniform else rng.uniform(0.05, 0.15,
                                                            K - 1)
    times = torch.as_tensor(-10.0 + np.concatenate([[0.0], np.cumsum(steps)]))
    rows = torch.as_tensor(rng.standard_normal((I, K))
                           + 1j * rng.standard_normal((I, K)))
    t0s = torch.as_tensor(np.concatenate([rng.uniform(-8.0, 20.0, 8),
                                          [float(times[-1]) - 1.05]]))
    Ts = torch.as_tensor(np.concatenate([rng.uniform(1.0, 25.0, 8), [50.0]]))
    w = tengine._window(times, t0s[:, None], Ts[:, None], method)
    assert float(w[-1, -1 if method == "geq" else -2]) == 1.0
    tau = trapz_weights(times, w)
    M = 23
    win = torch.as_tensor(np.concatenate([np.arange(9),
                                          rng.integers(0, 9, M - 9)]))
    omega = torch.as_tensor(rng.uniform(0.2, 1.5, (M, J))
                            - 1j * rng.uniform(0.02, 0.6, (M, J)))
    mu = torch.as_tensor(rng.standard_normal((M, I, J))
                         + 1j * rng.standard_normal((M, I, J)))
    S, P = moments_cuda.window_moments(times, rows, omega, t0s, w, win, 0)
    assert S.shape == (M, 2, 1, J, J) and P.shape == (M, 2, 1, I, J)
    Mmu = mu.mH @ mu
    got = (Mmu * S[:, 0, 0], (mu.conj() * P[:, 0, 0]).sum(dim=-2),
           Mmu * S[:, 1, 0], (mu.conj() * P[:, 1, 0]).sum(dim=-2),
           tau[win] @ (rows.real ** 2 + rows.imag ** 2).sum(dim=0))
    ref = fit_systems(times, rows, omega, mu, t0s[win], w[win])
    for name, a, b in zip(("G", "rhs", "G_tau", "r_tau", "data_norm"),
                          got, ref):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= SYSTEMS_RTOL, name


# ---------------------------------------------------------------------------
# f, g and H against the JAX package
# ---------------------------------------------------------------------------

# (name, objective, modes, sph, x, t0): an interior point; a spin beyond
# 0.99, where the clip holds chif; a late window with a dead column; the
# free frequency.
JAX_CASES = [
    ("eps_single", "eps", MODES, None, (0.97, 0.66), 2.0),
    ("eps_sph", "eps", MODES, SPH, (0.97, 0.66), 2.0),
    ("eps_sph_clip", "eps", MODES, SPH, (0.96, 0.995), 2.0),
    ("eps_dead", "eps", DEAD_MODES, SPH, (0.95, 0.7), 18.0),
    ("ff", "ff", MODES[:1], None, (0.52, -0.27), 2.0),
]


def _case_data(syn, kind, sph):
    return syn["rows"] if sph is not None else syn["row"][None]


@pytest.fixture(scope="module")
def jax_refs(syn):
    """(f, g, H) of every JAX_CASES entry from the JAX package's
    objective: jax.value_and_grad and jax.jacfwd of its gradient."""
    refs = {}
    for name, kind, modes, sph, x, t0 in JAX_CASES:
        data = jnp.asarray(_case_data(syn, kind, sph))
        if kind == "eps":
            vg = jo._epsilon_objective(jo._canon(modes),
                                       None if sph is None else tuple(sph),
                                       "geq", None)
            args = (jnp.asarray(syn["times"]), data, t0, T, jnp.asarray(1.0))
        else:
            vg = jo._free_freq_objective(jo._canon(modes), "geq")
            args = (jnp.asarray(syn["times"]), data, syn["Mf"], syn["chif"],
                    t0, T)
        v, g = vg(jnp.asarray(x), *args)
        H = jax.jacfwd(lambda y: vg(y, *args)[1])(jnp.asarray(x))
        refs[name] = (float(v), np.asarray(g), np.asarray(H))
    return refs


def _port_case(syn, kind, modes, sph, t0, clip):
    """The port's problem and spectrum of a case (one window)."""
    prob = to._Problem(syn["times"], _case_data(syn, kind, sph), [t0], [T],
                       "geq", CPU, None)
    if kind == "eps":
        spectrum = to.epsilon_spectrum(cached_evaluator(modes, sph), sph,
                                       1.0, CPU, clip_mass=clip)
    else:
        fixed = torch.as_tensor(cached_evaluator(modes).omega(syn["chif"],
                                                               syn["Mf"]))
        spectrum = to.free_frequency_spectrum(fixed, clip=clip)
    return prob, spectrum


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_fit_derivs_match_jax(syn, jax_refs, case):
    name, kind, modes, sph, x, t0 = case
    prob, spectrum = _port_case(syn, kind, modes, sph, t0, clip=False)
    win = torch.zeros(1, dtype=torch.long)
    x = torch.tensor([x], dtype=torch.float64)
    f, g, H = to._fit_derivs(prob, spectrum, x, win, 2)
    v_j, g_j, H_j = jax_refs[name]
    assert abs(float(f[0]) - v_j) <= MM_TOL
    assert _rel(g[0], g_j) <= JAX_RTOL
    assert _rel(H[0], H_j) <= JAX_RTOL
    if name == "eps_sph_clip":
        assert float(g[0, 1]) == 0.0 and float(H[0, 1, 1]) == 0.0
    # Orders 0 and 1 give the same f, and order 1 the same g (its product
    # rule sums fewer terms in one product).
    f1, g1 = to._fit_derivs(prob, spectrum, x, win, 1)
    f0, = to._fit_derivs(prob, spectrum, x, win, 0)
    assert float(f0[0]) == float(f1[0]) == float(f[0])
    assert _rel(g1, g) <= 1e-13


# ---------------------------------------------------------------------------
# f, g and H against the port's autograd, and the spectrum's jets
# ---------------------------------------------------------------------------

def _batch(syn, kind, sph, modes, rng, M=50):
    """The array optimisers' spectrum (clips on) on M trajectories over 6
    windows, parameters inside and outside the clip boxes."""
    t0s = [0.0, 1.05, 2.0, 5.0, 12.0, 18.0]
    prob = to._Problem(syn["times"], _case_data(syn, kind, sph), t0s,
                       [T] * len(t0s), "geq", CPU, None)
    if kind == "eps":
        spectrum = to.epsilon_spectrum(cached_evaluator(modes, sph), sph,
                                       1.0, CPU)
        x = np.stack([rng.uniform(0.5, 1.3, M), rng.uniform(0.3, 1.02, M)], 1)
        x[:3] = [[2.1, 0.7], [0.9, -0.02], [0.95, 0.995]]
    else:
        fixed = torch.as_tensor(cached_evaluator(modes).omega(syn["chif"],
                                                               syn["Mf"]))
        spectrum = to.free_frequency_spectrum(fixed)
        x = np.stack([rng.uniform(0.1, 2.1, M), rng.uniform(-1.1, -0.02, M)],
                     1)
        x[:2] = [[2.2, -0.3], [0.5, -1.2]]
    win = torch.as_tensor(rng.integers(0, len(t0s), M))
    return prob, spectrum, torch.as_tensor(x), win


BATCHES = [("eps", None, MODES), ("eps", SPH, MODES), ("eps", SPH, DEAD_MODES),
           ("ff", None, MODES[:1])]


@pytest.mark.parametrize("kind,sph,modes", BATCHES,
                         ids=["eps_single", "eps_sph", "eps_dead", "ff"])
def test_fit_derivs_match_autograd(syn, kind, sph, modes):
    prob, spectrum, x, win = _batch(syn, kind, sph, modes,
                                    np.random.default_rng(len(modes)))
    f, g, H = to._fit_derivs(prob, spectrum, x, win, 2)
    g_a, H_a = to._grad(lambda y: prob.mm(*spectrum(y), win), x,
                        hessian=True)
    f_a = prob.mm(*spectrum(x), win)
    assert _rel(f, f_a) <= AUTOGRAD_RTOL
    assert _rel(g, g_a) <= AUTOGRAD_RTOL
    assert _rel(H, H_a) <= AUTOGRAD_RTOL


@pytest.mark.parametrize("kind,sph,modes", BATCHES[:2] + BATCHES[3:],
                         ids=["eps_single", "eps_sph", "ff"])
@pytest.mark.parametrize("clip", [True, False])
def test_spectrum_jets_match_forward_ad(syn, kind, sph, modes, clip):
    """The spectrum's analytic jets (the spline's own derivative, the
    clips' 0/1 factors) against nested torch.func.jvp of the spectrum
    function, which differentiates the clamps as autograd does."""
    from torch.func import jvp
    _, spectrum, x, _ = _batch(syn, kind, sph, modes,
                               np.random.default_rng(7))
    if kind == "eps" and not clip:
        spectrum = to.epsilon_spectrum(cached_evaluator(modes, sph), sph,
                                       1.0, CPU, clip_mass=False)
    elif not clip:
        spectrum = to.free_frequency_spectrum(
            torch.as_tensor(cached_evaluator(modes).omega(syn["chif"],
                                                          syn["Mf"])),
            clip=False)
    E = [torch.zeros_like(x) for _ in range(2)]
    for a in (0, 1):
        E[a][:, a] = 1.0

    def first(a, y):
        return jvp(spectrum, (y,), (E[a],))[1]

    ref = [spectrum(x)] + [first(a, x) for a in (0, 1)]
    ref += [jvp(lambda y: first(a, y), (x,), (E[b],))[1]
            for a, b in to._PAIRS]
    omega, mu = spectrum.jets(x, 2)
    assert omega.shape[0] == 6
    for c, (om_r, mu_r) in enumerate(ref):
        if float(om_r.abs().max()) == 0.0:
            assert float(omega[c].abs().max()) == 0.0
        else:
            assert _rel(omega[c], om_r) <= JETS_RTOL
        if mu.shape[0] == 1:
            assert float(mu_r.abs().max()) == (c == 0)
        elif float(mu_r.abs().max()) == 0.0:
            assert float(mu[c].abs().max()) == 0.0
        else:
            assert _rel(mu[c], mu_r) <= JETS_RTOL
    assert torch.equal(omega[0], spectrum(x)[0])


# ---------------------------------------------------------------------------
# The array optimisers go through the moments
# ---------------------------------------------------------------------------

def test_array_optimisers_never_build_designs(syn, monkeypatch):
    """calculate_epsilon_array and free_frequency_fit_array call neither
    engine.fit_systems nor autograd (``optimize._grad``), and their every
    fit launches the moments: one call each, maxiter 2."""
    def refuse(*a, **k):
        raise AssertionError("the array optimisers built a design")

    monkeypatch.setattr(tengine, "fit_systems", refuse)
    monkeypatch.setattr(to, "_grad", refuse)
    orders = []
    real = moments_cuda.window_moments
    monkeypatch.setattr(moments_cuda, "window_moments",
                        lambda *a, **k: orders.append(a[-1]) or real(*a, **k))
    t0s = np.linspace(0.0, 0.55, 4)
    w, mm, ok = tq.free_frequency_fit_array(
        syn["times"], syn["row"], t0s, modes=MODES[:1], Mf=syn["Mf"],
        chif=syn["chif"], T_array=T, maxiter=2, return_mismatch=True,
        device="cpu")
    assert np.all(np.isfinite(mm)) and orders == [0, 2, 0, 2, 0, 1]
    orders.clear()
    out = tq.calculate_epsilon_array(
        syn["times"], syn["data_dict"], MODES, syn["Mf"], syn["chif"], t0s,
        spherical_modes=SPH, T_array=T, maxiter=2, return_mismatch=True,
        device="cpu")
    assert np.all(np.isfinite(out[3])) and orders == [0, 0, 2, 0, 2, 0, 1]
