"""Gradient-based ringdown optimisers (port of qnmfits_tpu/optimize.py).

The mismatch of a fit is a differentiable function of the remnant
(Mf, chif) -- through the torch spline of the spectrum
(``engine.SpectrumEvaluator.omega_t`` / ``mu_t``) -- and of a free complex
frequency, and the batched solve under it is differentiable twice
(``engine_real.RegularisedSolve``: on the card every forward and backward
pass launches the hand-written CUDA solve).

* ``calculate_epsilon_gradient`` / ``free_frequency_fit_gradient``: one
  start time, scipy L-BFGS-B fed a torch value and autograd gradient.
* ``calculate_epsilon_array`` / ``free_frequency_fit_array``: every start
  time in lock-step batches: a deterministic seed grid (the free
  frequency's scored by the bordered fixed-block solve of
  ``engine_real``), then a fixed number of damped-Newton steps with exact
  2 x 2 Hessians.  Their fits, gradients and Hessians come from the
  window moments (``ops/moments_cuda``, a hand-written CUDA kernel on the
  card) and J x J algebra a trajectory (``_fit_derivs``): no design and no
  autograd graph.  With ``mesh=`` the distinct windows are sharded over
  the mesh's 'sweep' ranks: each rank runs the same lock-step optimiser on
  its block and the results are gathered.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import RDTYPE, resolve_device
from .batched import (_canon, _check_t0_method, _cplx, _mesh_for,
                      _omega_fixed, _prep, _real, _window_dedup,
                      _window_dedup_closest)
from .engine import (_window, cached_evaluator, check_spin, chunk_bounds,
                     fit_core)
from .engine_real import (_omega_border_apply, _omega_border_prep,
                          _solve_detached)
from .ops import moments_cuda
from .ops.windows import trapz_weights
from .ref_impl import _delta_factor
from .spectrum.tables import solves_on_device

__all__ = ["calculate_epsilon_array", "calculate_epsilon_gradient",
           "free_frequency_fit_array", "free_frequency_fit_gradient"]

# Objective evaluations of the single-start-time gradient paths since the
# last reset (callers set it to 0 and read it); each makes one forward and
# one backward solve.
evaluations = 0

# The windows of a call are taken in chunks whose Newton trajectories'
# (M, K, J) complex128 phases would stay within this many bytes: it bounds
# a chunk's seed fits and moments (the kernel writes no design; the plain
# moments make that basis in chunks of their own).
DESIGN_BYTES = 1 << 30
# Most bytes of the (n, Q, K) complex free-column phases of the bordered
# seed stage (a chunk of n windows x Q candidates).
SEED_BYTES = 1 << 29

# The free frequency's seed grid over the search box (re in (0, 2), im in
# (-1, 0)), 16 x 12, plus x0 (optimize.py:221-225).
_FF_GRID = np.stack(np.meshgrid(np.linspace(0.08, 1.9, 16),
                                -np.geomspace(0.012, 0.9, 12),
                                indexing="ij"), axis=-1).reshape(-1, 2)
# The remnant's seeds (optimize.py:425-447): a +-0.12 patch of 5 x 5
# offsets around x0, an 8 x 8 bounded global (Mf, chif) grid, and a patch
# around each of its NPOL best cells.
_OFFS = np.stack(np.meshgrid(np.linspace(-0.12, 0.12, 5),
                             np.linspace(-0.12, 0.12, 5), indexing="ij"),
                 -1).reshape(-1, 2)
_GLOBAL = np.stack(np.meshgrid(np.linspace(0.3, 1.9, 8),
                               np.linspace(0.0, 0.95, 8), indexing="ij"),
                   -1).reshape(-1, 2)
NPOL = 4


def _optimizer_dedup(times, t0s, Ts, t0_method):
    """Distinct-window keys (optimize.py:30): start times whose windows
    hold the same samples pose the same optimisation problem (the
    mismatch is invariant under the basis t0 shift), and every returned
    quantity is window-pure, so the scatter needs no rephase."""
    if t0_method == "geq":
        return _window_dedup(times, t0s, Ts)
    return _window_dedup_closest(times, t0s, Ts)


def _nanargmin(v, dim):
    """jnp.nanargmin: the first minimum ignoring NaN; where every entry is
    NaN, the last index (JAX's -1)."""
    nan = torch.isnan(v)
    k = torch.where(nan, torch.full_like(v, float("inf")), v).argmin(dim=dim)
    return torch.where(nan.all(dim=dim), v.shape[dim] - 1, k)


def _take(v, k):
    """v[i, k[i]] along the second axis."""
    return torch.gather(v, 1, k[:, None])[:, 0]


def _grad(mm_fn, x, hessian=False):
    """The gradient g (M, 2) of the summed mismatches of M independent
    trajectories at x (M, 2) by autograd, and with ``hessian`` the (M, 2,
    2) Hessians H[m, i] = d g_i / dx: two more backward passes through the
    first's graph, one a row (the trajectories are independent).  The
    one-window L-BFGS-B paths take their gradient so; the array optimisers
    take ``_fit_derivs``, which this checks."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        f = mm_fn(x)
        g, = torch.autograd.grad(f.sum(), x, create_graph=hessian)
        if not hessian:
            return g
        rows = []
        for i in range(2):
            h = None
            if g.requires_grad:
                h, = torch.autograd.grad(g[:, i].sum(), x, retain_graph=i == 0,
                                         allow_unused=True)
            rows.append(torch.zeros_like(x) if h is None else h)
    return g.detach(), torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# Exact fits and their derivatives from the window moments
# ---------------------------------------------------------------------------
#
# A jet is a quantity with its derivatives in the two parameters stacked on
# a leading axis of components: 0 the value, 1 + a the first derivative in
# x_a (a = 0, 1), 3 + k the second in the pair k of ``_PAIRS``; 1, 3 or 6
# components to order 0, 1 or 2.  A jet of one component where the order
# asks for more is a constant.

_PAIRS = ((0, 0), (0, 1), (1, 1))


def _ncomp(order):
    return (1, 3, 6)[order]


@functools.lru_cache(maxsize=None)
def _leibniz(order, device):
    """The product rule to ``order`` as index tensors on ``device``: the
    components (of u, of w) of each term of the product's components, and
    the (components x terms) 0/1 matrix that sums the terms into them."""
    terms = [(0, 0, 0)]
    if order >= 1:
        terms += [t for a in (0, 1) for t in ((1 + a, 0, 1 + a),
                                              (0, 1 + a, 1 + a))]
    if order == 2:
        terms += [t for k, (a, b) in enumerate(_PAIRS)
                  for t in ((3 + k, 0, 3 + k), (1 + a, 1 + b, 3 + k),
                            (1 + b, 1 + a, 3 + k), (0, 3 + k, 3 + k))]
    iu, iw, ic = (torch.tensor(t, device=device) for t in zip(*terms))
    sums = torch.zeros((_ncomp(order), len(terms)), dtype=torch.float64,
                       device=device)
    sums[ic, torch.arange(len(terms), device=device)] = 1.0
    return iu, iw, sums


def _product(op, u, w, order):
    """The jet of op(u, w) for op bilinear (and batched over the leading
    component axis): op once over every term of the product rule, the
    terms summed into their components by one product with a 0/1 matrix.
    A constant factor (one component) scales every component of the
    other."""
    if u.shape[0] == 1 or w.shape[0] == 1:
        return op(u, w)
    iu, iw, sums = _leibniz(order, u.device)
    terms = op(u[iu], w[iw])
    flat = terms.reshape(terms.shape[0], -1)
    return (sums.to(flat.dtype) @ flat).reshape(sums.shape[0],
                                               *terms.shape[1:])


@functools.lru_cache(maxsize=None)
def _second(device):
    """The first-derivative components a and b of each second-derivative
    component (``_PAIRS``), as index tensors."""
    return (torch.tensor([1 + a for a, _ in _PAIRS], device=device),
            torch.tensor([1 + b for _, b in _PAIRS], device=device))


def _moment_jets(mom, delta, order):
    """The jets of the order-0 moments from the orders 0..order the kernel
    returns: mom (M, 2, order + 1, ...) S or P; delta (components, M, 1,
    ...) the jet of the phase exponent's derivative factor, i (conj w_j -
    w_l) for S, i conj w_j for P, with d_a S^0 = delta_a S^1 and d_ab S^0 =
    delta_ab S^1 + delta_a delta_b S^2 (S^p sums s^p conj(phi_j) phi_l, and
    d_a of conj(phi_j) phi_l is delta_a s conj(phi_j) phi_l).  Returns
    (components, M, 2, ...)."""
    value = mom[:, :, 0][None]
    if order == 0:
        return value
    first = delta[1:] * mom[:, :, 1][None]
    if order == 1:
        return torch.cat([value, first])
    ia, ib = _second(mom.device)
    second = delta[ia] * delta[ib] * mom[:, :, 2][None]
    return torch.cat([value, first[:2], first[2:] + second])


def _solve_jet(solve, G, rhs, order):
    """The jet of C = solve(G, rhs), the regularised solve, from the jets
    of G (components, B, J, J) and rhs (components, B, J): C = M^-1 rhs on
    the live columns (0 on the dead ones), M = G + f diag(Re G_jj), f =
    500 J eps (``engine_real.RegularisedSolve``), differentiated
    implicitly: d_a C = M^-1 (d_a rhs - d_a M C) and d_ab C = M^-1 (d_ab
    rhs - d_ab M C - d_a M d_b C - d_b M d_a C).  Each order is one stacked
    call of the solve on the same G, whose dead rows and columns come out
    zero."""
    B, J = rhs.shape[1:]
    floor = 500.0 * J * torch.finfo(torch.float64).eps
    C = solve(G[0], rhs[0])[None]
    if order == 0:
        return C

    def dM(dG, y):
        diag = torch.diagonal(dG, dim1=-2, dim2=-1).real
        return (dG @ y[..., None])[..., 0] + floor * diag * y

    def stacked(r):
        n = r.shape[0]
        return solve(G[0].expand(n, B, J, J).reshape(n * B, J, J),
                     r.reshape(n * B, J)).reshape(n, B, J)

    dC = stacked(rhs[1:3] - dM(G[1:3], C))
    if order == 1:
        return torch.cat([C, dC])
    ia, ib = (i - 1 for i in _second(G.device))
    hC = stacked(rhs[3:] - dM(G[3:], C) - dM(G[1:3][ia], dC[ib])
                 - dM(G[1:3][ib], dC[ia]))
    return torch.cat([C, dC, hC])


def _fit_derivs(prob, spectrum, x, win, order):
    """The mismatches f (M,) of the fits at parameters x (M, 2) on windows
    win (M,), and to ``order`` (0, 1 or 2) their gradients g (M, 2) and
    Hessians H (M, 2, 2): what ``_grad`` takes by autograd through
    ``prob.mm``, from one launch of the window moments of orders 0..order
    (``ops/moments_cuda``), one solve an order (``_solve_jet``) and J x J
    algebra a trajectory on jets (``_product``).  At order 0 the moments
    give ``engine.fit_systems``' pieces: G = (mu^H mu) o S^{w,0}, rhs_j =
    sum_i conj(mu_ij) P^{w,0}_ij, G_tau and r_tau likewise from the tau
    moments, and the mismatch f = 1 - N / sqrt(Q D) with N = Re sum C
    conj(r_tau), Q = C^H G_tau C and D the window's data norm
    (``engine.fit_mismatch``).  The spectrum's jets, omega (components,
    M, J) and mu (components, M, I, J) or a constant (1, 1, 1, J), are its
    own (``free_frequency_spectrum``, ``epsilon_spectrum``).  Returns
    (f,), (f, g) or (f, g, H)."""
    omega, mu = spectrum.jets(x, order)
    S, P = moments_cuda.window_moments(
        prob.times, prob.rows, omega[0].contiguous(), prob.t0s, prob.w, win,
        order, grid=prob.grid)
    # The jets of the moments, from the phase exponents' derivative
    # factors (components, M, 1, J, J) and (components, M, 1, 1, J).
    dS = _moment_jets(S, 1j * (omega.conj()[:, :, None, :, None]
                               - omega[:, :, None, None, :]), order)
    dP = _moment_jets(P, 1j * omega.conj()[:, :, None, None, :], order)
    Mmu = _product(lambda a, b: a.mH @ b, mu, mu, order)[:, :, None]
    G2 = _product(torch.mul, Mmu, dS, order)           # (c, M, 2, J, J)
    mu2 = mu[:, :, None]

    def proj(m, p):
        return (m.conj() * p).sum(dim=-2)

    r2 = _product(proj, mu2, dP, order)                # (c, M, 2, J)
    G, G_tau = G2[:, :, 0].contiguous(), G2[:, :, 1]
    rhs, r_tau = r2[:, :, 0].contiguous(), r2[:, :, 1]
    C = _solve_jet(prob.solve or _solve_detached, G, rhs, order)
    N = _product(lambda c, r: (c * r.conj()).sum(dim=-1).real, C, r_tau,
                 order)
    GC = _product(lambda g, c: (g @ c[..., None])[..., 0], G_tau, C, order)
    Q = _product(lambda c, y: (c.conj() * y).sum(dim=-1).real, C, GC, order)
    # f = 1 - N u with u = (Q D)^-1/2 (the value rounded as
    # engine.fit_mismatch rounds it).
    root = torch.sqrt(Q[0] * prob.dnorm[win])
    f = 1.0 - N[0] / root
    if order == 0:
        return (f,)
    inv, u0 = 1.0 / Q[0], 1.0 / root
    u = [u0[None], -0.5 * inv * Q[1:3] * u0]
    if order == 2:
        ia, ib = _second(Q.device)
        u.append(u0 * inv * (0.75 * inv * Q[ia] * Q[ib] - 0.5 * Q[3:]))
    Nu = _product(torch.mul, N, torch.cat(u), order)
    g = -Nu[1:3].T
    if order == 1:
        return f, g
    h = -Nu[3:]
    H = torch.stack([h[0], h[1], h[1], h[2]], dim=1).reshape(-1, 2, 2)
    return f, g, H


def _newton_polish(derivs, x, fx, iters: int = 12):
    """Damped-Newton (Levenberg) steps for M independent 2-parameter
    objectives in lock-step (optimize.py:177): a fixed ``iters`` steps, no
    early exit; each solves (H + lam I) step = -g, keeps a trial that
    lowers the objective (a NaN trial never does) and scales lam by 0.3,
    or else by 8.  ``derivs(x, order)`` returns the objective and its
    derivatives to ``order`` (``_fit_derivs``).  Returns (x, fx)."""
    eye = torch.eye(2, dtype=x.dtype, device=x.device)
    lam = torch.full_like(fx, 1e-9)
    for _ in range(iters):
        _, g, H = derivs(x, 2)
        step = torch.linalg.solve_ex(H + lam[:, None, None] * eye, -g)[0]
        xn = x + step
        fn, = derivs(xn, 0)
        better = fn < fx
        x = torch.where(better[:, None], xn, x)
        fx = torch.where(better, fn, fx)
        lam = torch.where(better, lam * 0.3, lam * 8.0)
    return x, fx


def _chunks(n_windows, per_window_bytes, budget):
    """[(lo, hi)] window chunks whose bytes stay within ``budget``."""
    size = max(1, int(budget // max(per_window_bytes, 1)))
    return chunk_bounds(n_windows, size)


class _Problem:
    """A call's data on its device: times (K,), rows (I, K), and the
    distinct windows' start times (N,), {0,1} weights and trapezoid
    weights (N, K) and data norms (N,)."""

    def __init__(self, times, rows, t0s, Ts, t0_method, dev, solve):
        self.times = _real(times, dev)
        self.rows = _cplx(rows, dev)
        self.t0s = _real(t0s, dev)
        Ts = _real(Ts, dev)
        self.w = _window(self.times, self.t0s[:, None], Ts[:, None],
                         t0_method)
        self.tau = trapz_weights(self.times, self.w)
        self.dnorm = self.tau @ (self.rows.real ** 2
                                 + self.rows.imag ** 2).sum(dim=0)
        self.solve = solve

    @functools.cached_property
    def grid(self):
        """The window moments' grid, made at the first launch and kept
        (``moments_cuda.moments_grid``: one copy of times to the host)."""
        return moments_cuda.moments_grid(self.times)

    def mm(self, omega, mu, win):
        """Mismatches of fits with spectra omega (M, J) and mu (M, I, J)
        or (1, J) on windows win (M,) (indices), differentiable (the
        one-window L-BFGS-B paths and ``_grad``)."""
        return fit_core(self.times, self.rows, omega, mu, self.t0s[win],
                        self.w[win], solve=self.solve)[1]


def _inside(v, lo, hi, clip):
    """1 where torch.clamp(v, lo, hi) passes its derivative (lo <= v <=
    hi, as autograd has it), else 0; ones where ``clip`` is off."""
    if not clip:
        return torch.ones_like(v)
    return ((v >= lo) & (v <= hi)).to(v.dtype)


def free_frequency_spectrum(fixed, clip=True):
    """x (M, 2) -> (omega (M, Jf + 1), mu (1, Jf + 1)): the fixed
    frequencies (Jf,) and the free one Re + i Im, clipped to the search
    box re in [0, 2], im in [-1, 0] where ``clip`` (the array optimiser;
    the L-BFGS-B path is bounded instead).  ``spectrum.jets(x, order)``
    gives the jets of ``_fit_derivs``: the free frequency's derivatives
    are 1 and i inside the box, 0 where the clip holds it."""
    ones = torch.ones((1, fixed.shape[0] + 1), dtype=fixed.dtype,
                      device=fixed.device)

    def spectrum(x):
        re, im = x[:, 0], x[:, 1]
        if clip:
            re, im = torch.clamp(re, 0.0, 2.0), torch.clamp(im, -1.0, 0.0)
        free = torch.complex(re, im)[:, None]
        return torch.cat([fixed.expand(x.shape[0], -1), free], dim=1), ones

    def jets(x, order):
        omega, _ = spectrum(x)
        out = torch.zeros((_ncomp(order),) + omega.shape, dtype=omega.dtype,
                          device=omega.device)
        out[0] = omega
        if order:
            out[1, :, -1] = _inside(x[:, 0], 0.0, 2.0, clip)
            out[2, :, -1] = 1j * _inside(x[:, 1], -1.0, 0.0, clip)
        return out, ones[None, None]

    spectrum.jets = jets
    return spectrum


def epsilon_spectrum(ev, sph, delta_factor, dev, clip_mass=True):
    """x (M, 2) = (Mf, chif) -> (omega (M, J), mu (M, I, J) or (1, J)):
    the torch spline at chif clipped to [0, 0.99] and Mf clipped to
    [1e-3, 2] where ``clip_mass`` (the array optimiser; the L-BFGS-B path
    is bounded instead).  ``spectrum.jets(x, order)`` gives the jets of
    ``_fit_derivs``: omega = W(chif) / Mf with the spline's own chif
    derivatives of W (``SpectrumEvaluator.omega_chi_t``), mu's likewise
    (``mu_chi_t``), each derivative 0 where a clip holds its parameter."""
    J = ev.mode_set.J

    def spectrum(x):
        Mf = torch.clamp(x[:, 0], 1e-3, 2.0) if clip_mass else x[:, 0]
        chif = torch.clamp(x[:, 1], 0.0, 0.99)
        omega = ev.omega_t(chif, Mf, delta_factor)
        mu = (torch.ones((1, J), dtype=omega.dtype, device=dev)
              if sph is None else ev.mu_t(chif))
        return omega, mu

    def jets(x, order):
        Mf = torch.clamp(x[:, 0], 1e-3, 2.0) if clip_mass else x[:, 0]
        chif = torch.clamp(x[:, 1], 0.0, 0.99)
        if order == 0:
            omega, mu = spectrum(x)
            return omega[None], (mu[None, None] if sph is None else mu[None])
        W = ev.omega_chi_t(chif, order, delta_factor)          # (o+1, M, J)
        m, c, inv = (v[:, None].to(W.dtype) for v in (
            _inside(x[:, 0], 1e-3, 2.0, clip_mass),
            _inside(x[:, 1], 0.0, 0.99, True), 1.0 / Mf))
        # The value exactly as ``spectrum`` rounds it.
        parts = [(W[0].T / Mf).T, -W[0] * inv * inv * m, W[1] * inv * c]
        if order == 2:
            parts += [2.0 * W[0] * inv * inv * inv * m,
                      -W[1] * inv * inv * m * c, W[2] * inv * c]
        omega = torch.stack(parts)
        if sph is None:
            return omega, torch.ones((1, 1, 1, J), dtype=omega.dtype,
                                     device=dev)
        U = ev.mu_chi_t(chif, order)                          # (o+1, M, I, J)
        c = c[:, :, None]
        zero = torch.zeros_like(U[0])
        mparts = [U[0], zero, U[1] * c]
        if order == 2:
            mparts += [zero, zero, U[2] * c]
        return omega, torch.stack(mparts)

    spectrum.jets = jets
    return spectrum


# ---------------------------------------------------------------------------
# One start time: scipy L-BFGS-B on a torch value and gradient
# ---------------------------------------------------------------------------

def _lbfgs(mm_fn, x0, bounds, gtol, dev):
    """scipy L-BFGS-B on mm_fn(x (1, 2)) -> (1,), with its torch gradient
    (optimize.py:96-107)."""
    from scipy.optimize import minimize

    def obj(x):
        global evaluations
        evaluations += 1
        xt = torch.tensor(np.asarray(x, float)[None], dtype=RDTYPE,
                          device=dev, requires_grad=True)
        with torch.enable_grad():
            f = mm_fn(xt)
            g, = torch.autograd.grad(f.sum(), xt)
        return float(f.detach()[0]), g[0].cpu().numpy()

    return minimize(obj, list(x0), jac=True, method="L-BFGS-B",
                    bounds=bounds,
                    options={"ftol": 1e-15, "gtol": gtol}).x


@solves_on_device
def calculate_epsilon_gradient(times, data, modes, Mf, chif, t0,
                               t0_method="geq", T=100, spherical_modes=None,
                               delta=0.0, x0=None, device="cuda",
                               solve=None):
    """L-BFGS-B remnant recovery on the differentiable mismatch
    (optimize.py:62; reference qnmfits.py:1418-1594): returns (epsilon,
    Mf_bestfit, chif_bestfit) within Mf in [0, 2], chif in [0, 0.99].
    delta applies to single-series data only, as in the reference.
    ``solve`` substitutes the batched solve (checks)."""
    _check_t0_method(t0_method)
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    ev = cached_evaluator(_canon(modes), sph)
    df = _delta_factor(0.0 if sph is not None else delta, len(modes))
    prob = _Problem(times, rows, [float(t0)], [float(T)], t0_method, dev,
                    solve)
    win = torch.zeros(1, dtype=torch.long, device=dev)
    spectrum = epsilon_spectrum(ev, sph, df, dev, clip_mass=False)

    def mm_fn(x):
        return prob.mm(*spectrum(x), win)

    Mf_bf, chif_bf = _lbfgs(mm_fn, x0 if x0 is not None else [Mf, chif],
                            [(0.0, 2.0), (0.0, 0.99)], 1e-12, dev)
    eps = float(np.sqrt((Mf_bf - Mf) ** 2 + (chif_bf - chif) ** 2))
    return eps, float(Mf_bf), float(chif_bf)


def _require_remnant(modes, Mf, chif):
    if len(modes) and (Mf is None or chif is None):
        # A silent Mf = 1 / chif = 0 would bias the fixed frequencies.
        raise ValueError(
            "free_frequency_fit with fixed QNM modes requires Mf and chif")


@solves_on_device
def free_frequency_fit_gradient(times, data, t0, modes=[], Mf=None,
                                chif=None, t0_method="geq", T=100,
                                x0=(1.0, -0.5), device="cuda", solve=None):
    """L-BFGS-B free complex-frequency fit on top of fixed QNMs
    (optimize.py:129; reference qnmfits.py:1905-2043) within re in
    [0, 2], im in [-1, 0].  Returns omega_bestfit."""
    _check_t0_method(t0_method)
    _require_remnant(modes, Mf, chif)
    dev = resolve_device(device)
    fixed = _cplx(_omega_fixed(modes, Mf, chif), dev)
    prob = _Problem(times, np.asarray(data, complex)[None], [float(t0)],
                    [float(T)], t0_method, dev, solve)
    win = torch.zeros(1, dtype=torch.long, device=dev)
    spectrum = free_frequency_spectrum(fixed, clip=False)

    def mm_fn(x):
        return prob.mm(*spectrum(x), win)

    x = _lbfgs(mm_fn, x0, [(0.0, 2.0), (-1.0, 0.0)], 1e-14, dev)
    return x[0] + 1j * x[1]


# ---------------------------------------------------------------------------
# Every start time: seed grid + damped Newton in lock-step batches
# ---------------------------------------------------------------------------

def _windows(times, t0_array, T_array, t0_method, dedup, mesh=None):
    """The distinct windows (t0s, Ts) of a call, this rank's block of them
    where a mesh shards them, their dedup map and their count."""
    t0s = np.asarray(t0_array, float)
    Ts = np.ascontiguousarray(
        np.broadcast_to(np.asarray(T_array, float), t0s.shape))
    dd = _optimizer_dedup(times, t0s, Ts, t0_method) if dedup else None
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]
    n = len(t0s)
    if mesh is not None:
        from .parallel.mesh import _block, _pad_to, _size
        t0s, Ts = (_block(mesh, _pad_to(x, _size(mesh, "sweep"))[0])
                   for x in (t0s, Ts))
    return t0s, Ts, dd, n


def _scatter(dd, mesh, n, *outs):
    """Per-window results to NumPy over the caller's start times: gathered
    over the mesh's 'sweep' ranks and trimmed to the n distinct windows,
    then scattered over their duplicates."""
    if mesh is not None:
        from .parallel.mesh import gather_sweep
        outs = [gather_sweep(mesh, o)[:n] for o in outs]
    outs = [o.cpu().numpy() for o in outs]
    return outs if dd is None else [o[dd[1]] for o in outs]


def free_frequency_chunks(n_windows, K, Jf):
    """The window chunks of ``free_frequency_fit_array``: n trajectories'
    (n, K, Jf + 1) phases within ``DESIGN_BYTES``."""
    return _chunks(n_windows, K * (Jf + 1) * 16, DESIGN_BYTES)


@solves_on_device
def free_frequency_fit_array(times, data, t0_array, modes=[], Mf=None,
                             chif=None, t0_method="geq", T_array=100,
                             x0=(1.0, -0.5), maxiter=30,
                             return_mismatch=False, mesh=None, dedup=True,
                             device="cuda", solve=None):
    """Free complex-frequency fit at every start time (optimize.py:343).

    Per window: the 16 x 12 seed grid over the search box plus x0 (193
    candidates) scored by the bordered fixed-block solve (the fixed
    block factored once a window; no solve kernel), the best one polished
    by ``maxiter`` damped-Newton steps on the exact mismatch (each the
    fit with its gradient and Hessian, then a trial fit), clipped to the
    box; ``ok`` marks a final gradient norm
    below 1e-7.  Windows run in lock-step chunks
    (``free_frequency_chunks``); each fit, with its gradient and Hessian
    where Newton needs them, is one launch of the window moments and one
    solve an order (``_fit_derivs``).  dedup=True optimises each distinct
    window once.  ``mesh`` (a ``parallel.mesh.sweep_mesh``, or 'auto')
    shards the distinct windows over its 'sweep' ranks; every rank calls
    with the same arguments and gets the whole result.  Returns omega
    (B,) complex; with return_mismatch=True also the (B,) mismatch at the
    optimum and the (B,) success mask."""
    _check_t0_method(t0_method)
    _require_remnant(modes, Mf, chif)
    check_spin(chif)
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _mesh_for(mesh, dev)
    t0s, Ts, dd, n_win = _windows(times, t0_array, T_array, t0_method,
                                  dedup, mesh)
    prob = _Problem(times, np.asarray(data, complex)[None], t0s, Ts,
                    t0_method, dev, solve)
    fixed = _cplx(_omega_fixed(modes, Mf, chif), dev)
    Jf, K = fixed.shape[0], prob.times.shape[0]
    cand = torch.cat([_real(_FF_GRID, dev),
                      _real(np.asarray(x0, float)[None], dev)])
    cre = torch.clamp(cand[:, 0], 0.0, 2.0)
    cim = torch.clamp(cand[:, 1], -1.0, 0.0)
    spectrum = free_frequency_spectrum(fixed)
    d = prob.rows[0]
    xs, fxs, oks = [], [], []
    for lo, hi in free_frequency_chunks(len(t0s), K, Jf):
        win = torch.arange(lo, hi, device=dev)

        def derivs(x, order, win=win):
            return _fit_derivs(prob, spectrum, x, win, order)

        # Bordered seed scores, in chunks of SEED_BYTES of phases; only
        # the argmin is used, and the winner is evaluated exactly.
        vals = []
        for a, b in _chunks(hi - lo, cand.shape[0] * K * 16, SEED_BYTES):
            prep = _omega_border_prep(prob.times, d, fixed,
                                      prob.t0s[lo + a:lo + b],
                                      prob.w[lo + a:lo + b])
            dt = prep["dt"][:, None, :]
            Ef = torch.exp(cim[None, :, None] * dt)
            ph = cre[None, :, None] * dt
            phif = torch.complex(Ef * torch.cos(ph), -Ef * torch.sin(ph))
            vals.append(_omega_border_apply(prep, phif, Ef * Ef)[2])
        x = cand[_nanargmin(torch.cat(vals), 1)]
        f0, = derivs(x, 0)
        x, fx = _newton_polish(derivs, x, f0, iters=maxiter)
        x = torch.stack([torch.clamp(x[:, 0], 0.0, 2.0),
                         torch.clamp(x[:, 1], -1.0, 0.0)], dim=1)
        xs.append(x)
        fxs.append(fx)
        oks.append(torch.linalg.vector_norm(derivs(x, 1)[1], dim=1) < 1e-7)
    x, mm, ok = _scatter(dd, mesh, n_win, torch.cat(xs), torch.cat(fxs),
                         torch.cat(oks))
    omega = x[:, 0] + 1j * x[:, 1]
    if return_mismatch:
        return omega, mm, ok
    return omega


def epsilon_chunks(n_windows, K, J):
    """The window chunks of ``calculate_epsilon_array``: the 1 + NPOL
    Newton trajectories of each window, their (5 n, K, J) phases within
    ``DESIGN_BYTES``."""
    return _chunks(n_windows, (1 + NPOL) * K * J * 16, DESIGN_BYTES)


@solves_on_device
def calculate_epsilon_array(times, data, modes, Mf, chif, t0_array,
                            t0_method="geq", T_array=100,
                            spherical_modes=None, delta=0.0, x0=None,
                            maxiter=30, return_remnant=True, mesh=None,
                            dedup=True, device="cuda", solve=None,
                            return_mismatch=False):
    """Remnant recovery (epsilon) at every start time (optimize.py:540).

    Per window, tiered seeds: the +-0.12 patch around x0 (default
    [Mf, chif]) and the 8 x 8 global (Mf, chif) grid, then a patch around
    each of the NPOL best global cells (189 exact fits a window, each
    stage one launch of the window moments and one solve); the x0-patch
    winner and the NPOL refined winners are each polished by ``maxiter``
    damped-Newton steps, and the best polished endpoint is kept, preferring the x0 one unless another
    is lower by max(1e-13, 1e-6 |f|).  Windows run in lock-step chunks
    (``epsilon_chunks``).  Returns (eps (B,), Mf_bf (B,), chif_bf (B,)),
    or eps alone with return_remnant=False; return_mismatch=True (not in
    the JAX package, which computes and drops it) appends the (B,)
    mismatch at the optimum and the (B,) mask of final gradient norms
    below 1e-7.  ``mesh`` (or 'auto') shards the distinct windows over its
    'sweep' ranks, as in ``free_frequency_fit_array``."""
    _check_t0_method(t0_method)
    check_spin(chif)
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _mesh_for(mesh, dev)
    times, rows, sph = _prep(times, data, spherical_modes)
    ev = cached_evaluator(_canon(modes), sph)
    df = _delta_factor(0.0 if sph is not None else delta, len(modes))
    t0s, Ts, dd, n_win = _windows(times, t0_array, T_array, t0_method,
                                  dedup, mesh)
    prob = _Problem(times, rows, t0s, Ts, t0_method, dev, solve)
    J, K = len(modes), prob.times.shape[0]
    x0_t = _real(np.asarray(x0 if x0 is not None else [Mf, chif],
                            float), dev)
    offs, glob = _real(_OFFS, dev), _real(_GLOBAL, dev)
    cand0 = torch.cat([x0_t + offs, glob])                  # (89, 2)
    n_l, P = len(_OFFS), 1 + NPOL
    spectrum = epsilon_spectrum(ev, sph, df, dev)
    xs, fxs, oks = [], [], []
    for lo, hi in epsilon_chunks(len(t0s), K, J):
        n = hi - lo
        win = torch.arange(lo, hi, device=dev)
        vals = _fit_derivs(prob, spectrum, cand0.repeat(n, 1),
                           win.repeat_interleave(len(cand0)), 0
                           )[0].reshape(n, len(cand0))
        vals_l, vals_g = vals[:, :n_l], vals[:, n_l:]
        k_l = _nanargmin(vals_l, 1)
        # The NPOL best global cells, ties to the lower index (top_k).
        top = torch.sort(torch.nan_to_num(vals_g, nan=float("inf")), dim=1,
                         stable=True)[1][:, :NPOL]
        patches = glob[top][:, :, None, :] + offs              # (n, 4, 25, 2)
        vals_p = _fit_derivs(prob, spectrum, patches.reshape(-1, 2),
                             win.repeat_interleave(NPOL * n_l), 0
                             )[0].reshape(n * NPOL, n_l)
        k_p = _nanargmin(vals_p, 1)
        seeds = torch.cat([(x0_t + offs)[k_l][:, None],
                           patches.reshape(n * NPOL, n_l, 2)[
                               torch.arange(n * NPOL, device=dev), k_p
                           ].reshape(n, NPOL, 2)], dim=1)       # (n, 5, 2)
        f0 = torch.cat([_take(vals_l, k_l)[:, None],
                        _take(vals_p, k_p).reshape(n, NPOL)], dim=1)
        traj = win.repeat_interleave(P)

        def traj_derivs(x, order, traj=traj):
            return _fit_derivs(prob, spectrum, x, traj, order)

        x, fx = _newton_polish(traj_derivs, seeds.reshape(n * P, 2),
                               f0.reshape(-1), iters=maxiter)
        x, fx = x.reshape(n, P, 2), fx.reshape(n, P)
        # Prefer the x0-seeded endpoint unless another is meaningfully
        # lower: near the optimum all agree to ~eps and an unbiased
        # argmin would break the tie arbitrarily.
        f_loc = fx[:, 0]
        margin = torch.where(torch.isnan(f_loc), torch.zeros_like(f_loc),
                             torch.clamp(1e-6 * f_loc.abs(), min=1e-13))
        bias = (torch.arange(P, device=dev) > 0).to(fx.dtype)
        j = _nanargmin(fx + margin[:, None] * bias, 1)
        pick = torch.arange(n, device=dev)
        x = torch.stack([torch.clamp(x[pick, j, 0], 1e-3, 2.0),
                         torch.clamp(x[pick, j, 1], 0.0, 0.99)], dim=1)
        xs.append(x)
        fxs.append(fx[pick, j])
        if return_mismatch:
            g = _fit_derivs(prob, spectrum, x, win, 1)[1]
            oks.append(torch.linalg.vector_norm(g, dim=1) < 1e-7)
    x, = _scatter(dd, mesh, n_win, torch.cat(xs))
    eps = np.sqrt((x[:, 0] - Mf) ** 2 + (x[:, 1] - chif) ** 2)
    out = (eps, x[:, 0], x[:, 1]) if return_remnant else (eps,)
    if return_mismatch:
        out += tuple(_scatter(dd, mesh, n_win, torch.cat(fxs),
                              torch.cat(oks)))
    return out if len(out) > 1 else eps
