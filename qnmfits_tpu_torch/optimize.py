"""Gradient-based ringdown optimisers (port of qnmfits_tpu/optimize.py).

The mismatch of a fit is a differentiable function of the remnant
(Mf, chif) -- through the torch spline of the spectrum
(``engine.SpectrumEvaluator.omega_t`` / ``mu_t``) -- and of a free complex
frequency, and the batched solve under it is differentiable twice
(``engine_real.RegularisedSolve``: on the card every forward, backward and
Hessian pass launches the hand-written CUDA solve).

* ``calculate_epsilon_gradient`` / ``free_frequency_fit_gradient``: one
  start time, scipy L-BFGS-B fed a torch value and gradient.
* ``calculate_epsilon_array`` / ``free_frequency_fit_array``: every start
  time in lock-step batches: a deterministic seed grid (the free
  frequency's scored by the bordered fixed-block solve of
  ``engine_real``), then a fixed number of damped-Newton steps with exact
  2 x 2 Hessians from a double backward.  With ``mesh=`` the distinct
  windows are sharded over the mesh's 'sweep' ranks: each rank runs the
  same lock-step optimiser on its block and the results are gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from . import RDTYPE, resolve_device
from .batched import (_canon, _check_t0_method, _cplx, _mesh_for,
                      _omega_fixed, _prep, _real, _window_dedup,
                      _window_dedup_closest)
from .engine import (_window, cached_evaluator, check_spin, chunk_bounds,
                     fit_core, fit_systems, solve_fits)
from .engine_real import _omega_border_apply, _omega_border_prep
from .ref_impl import _delta_factor
from .spectrum.tables import solves_on_device

__all__ = ["calculate_epsilon_array", "calculate_epsilon_gradient",
           "free_frequency_fit_array", "free_frequency_fit_gradient"]

# Objective evaluations of the single-start-time gradient paths since the
# last reset (callers set it to 0 and read it); each makes one forward and
# one backward solve.
evaluations = 0

# Most bytes of one (M, K, J) complex128 design in the Newton stage of the
# array optimisers: the windows of a call are taken in chunks whose M
# trajectories stay within it, because the double backward keeps about a
# dozen tensors of that size alive.
DESIGN_BYTES = 1 << 30
# Most bytes of the (n, Q, K) complex free-column phases of the bordered
# seed stage (a chunk of n windows x Q candidates).
SEED_BYTES = 1 << 29
# Seed fits (items) per chunk of the remnant seed stage: (chunk, K, J)
# bases of at most this many bytes, all solved in one launch per join
# group (engine_real.JOIN_BYTES).
SEED_BASIS_BYTES = 1 << 28

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
    trajectories at x (M, 2), and with ``hessian`` the (M, 2, 2) Hessians
    H[m, i] = d g_i / dx: two more backward passes through the first's
    graph, one a row (the trajectories are independent)."""
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


def _newton_polish(mm_fn, x, fx, iters: int = 12):
    """Damped-Newton (Levenberg) steps for M independent 2-parameter
    objectives in lock-step (optimize.py:177): a fixed ``iters`` steps, no
    early exit; each solves (H + lam I) step = -g, keeps a trial that
    lowers the objective (a NaN trial never does) and scales lam by 0.3,
    or else by 8.  Returns (x, fx)."""
    eye = torch.eye(2, dtype=x.dtype, device=x.device)
    lam = torch.full_like(fx, 1e-9)
    for _ in range(iters):
        g, H = _grad(mm_fn, x, hessian=True)
        step = torch.linalg.solve_ex(H + lam[:, None, None] * eye, -g)[0]
        xn = x + step
        with torch.no_grad():
            fn = mm_fn(xn)
        better = fn < fx
        x = torch.where(better[:, None], xn, x)
        fx = torch.where(better, fn, fx)
        lam = torch.where(better, lam * 0.3, lam * 8.0)
    return x, fx


def _chunks(n_windows, per_window_bytes, budget):
    """[(lo, hi)] window chunks whose bytes stay within ``budget``."""
    size = max(1, int(budget // max(per_window_bytes, 1)))
    return chunk_bounds(n_windows, size)


def _seed_chunk(K, J):
    """Seed fits a chunk of the remnant seed stage: (chunk, K, J) bases
    within ``SEED_BASIS_BYTES``."""
    return max(1, SEED_BASIS_BYTES // (K * J * 16))


class _Problem:
    """A call's data on its device: times (K,), rows (I, K), and the
    distinct windows' start times (N,) and {0,1} weights (N, K)."""

    def __init__(self, times, rows, t0s, Ts, t0_method, dev, solve):
        self.times = _real(times, dev)
        self.rows = _cplx(rows, dev)
        self.t0s = _real(t0s, dev)
        Ts = _real(Ts, dev)
        self.w = _window(self.times, self.t0s[:, None], Ts[:, None],
                         t0_method)
        self.solve = solve

    def mm(self, omega, mu, win):
        """Mismatches of fits with spectra omega (M, J) and mu (M, I, J)
        or (1, J) on windows win (M,) (indices)."""
        return fit_core(self.times, self.rows, omega, mu, self.t0s[win],
                        self.w[win], solve=self.solve)[1]

    def seed_mm(self, spectrum, x, win):
        """Mismatches (M,) of fits at parameters x (M, 2) on windows win
        (M,), forward only, in chunks of ``SEED_BASIS_BYTES`` of basis
        solved in one launch per join group."""
        omega, mu = spectrum(x)
        K, J = self.times.shape[0], omega.shape[-1]

        def systems(lo, hi):
            m = mu if mu.dim() == 2 else mu[lo:hi]
            return fit_systems(self.times, self.rows, omega[lo:hi], m,
                               self.t0s[win[lo:hi]], self.w[win[lo:hi]])

        bounds = chunk_bounds(x.shape[0], _seed_chunk(K, J))
        with torch.no_grad():
            return solve_fits(bounds, 2 * J * J * 16, systems,
                              self.solve)[1]


def free_frequency_spectrum(fixed, clip=True):
    """x (M, 2) -> (omega (M, Jf + 1), mu (1, Jf + 1)): the fixed
    frequencies (Jf,) and the free one Re + i Im, clipped to the search
    box re in [0, 2], im in [-1, 0] where ``clip`` (the array optimiser;
    the L-BFGS-B path is bounded instead)."""
    ones = torch.ones((1, fixed.shape[0] + 1), dtype=fixed.dtype,
                      device=fixed.device)

    def spectrum(x):
        re, im = x[:, 0], x[:, 1]
        if clip:
            re, im = torch.clamp(re, 0.0, 2.0), torch.clamp(im, -1.0, 0.0)
        free = torch.complex(re, im)[:, None]
        return torch.cat([fixed.expand(x.shape[0], -1), free], dim=1), ones

    return spectrum


def epsilon_spectrum(ev, sph, delta_factor, dev, clip_mass=True):
    """x (M, 2) = (Mf, chif) -> (omega (M, J), mu (M, I, J) or (1, J)):
    the torch spline at chif clipped to [0, 0.99] and Mf clipped to
    [1e-3, 2] where ``clip_mass`` (the array optimiser; the L-BFGS-B path
    is bounded instead)."""
    J = ev.mode_set.J

    def spectrum(x):
        Mf = torch.clamp(x[:, 0], 1e-3, 2.0) if clip_mass else x[:, 0]
        chif = torch.clamp(x[:, 1], 0.0, 0.99)
        omega = ev.omega_t(chif, Mf, delta_factor)
        mu = (torch.ones((1, J), dtype=omega.dtype, device=dev)
              if sph is None else ev.mu_t(chif))
        return omega, mu

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
    """The window chunks of ``free_frequency_fit_array``'s Newton stage:
    (n, K, Jf + 1) designs within ``DESIGN_BYTES``."""
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
    by ``maxiter`` damped-Newton steps on the exact mismatch (each a
    forward, a backward and two Hessian passes through the solve, plus a
    trial fit), clipped to the box; ``ok`` marks a final gradient norm
    below 1e-7.  Windows run in lock-step chunks
    (``free_frequency_chunks``).  dedup=True optimises each distinct
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

        def mm_fn(x, win=win):
            return prob.mm(*spectrum(x), win)

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
        with torch.no_grad():
            f0 = mm_fn(x)
        x, fx = _newton_polish(mm_fn, x, f0, iters=maxiter)
        x = torch.stack([torch.clamp(x[:, 0], 0.0, 2.0),
                         torch.clamp(x[:, 1], -1.0, 0.0)], dim=1)
        xs.append(x)
        fxs.append(fx)
        oks.append(torch.linalg.vector_norm(_grad(mm_fn, x), dim=1) < 1e-7)
    x, mm, ok = _scatter(dd, mesh, n_win, torch.cat(xs), torch.cat(fxs),
                         torch.cat(oks))
    omega = x[:, 0] + 1j * x[:, 1]
    if return_mismatch:
        return omega, mm, ok
    return omega


def epsilon_chunks(n_windows, K, J):
    """The window chunks of ``calculate_epsilon_array``'s Newton stage:
    the 1 + NPOL trajectories of each window, (5 n, K, J) designs within
    ``DESIGN_BYTES``."""
    return _chunks(n_windows, (1 + NPOL) * K * J * 16, DESIGN_BYTES)


def epsilon_seed_items(n_windows, K, J):
    """The two seed stages of a chunk of ``n_windows`` windows, each as
    (fits, fits a basis chunk): the x0 patch and the global grid (89 a
    window), then the refining patches (NPOL x 25 a window)."""
    return [(n_windows * (len(_OFFS) + len(_GLOBAL)), _seed_chunk(K, J)),
            (n_windows * NPOL * len(_OFFS), _seed_chunk(K, J))]


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
    stage solved in one launch per join group); the x0-patch winner and the NPOL refined
    winners are each polished by ``maxiter`` damped-Newton steps, and the
    best polished endpoint is kept, preferring the x0 one unless another
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
        vals = prob.seed_mm(spectrum, cand0.repeat(n, 1),
                            win.repeat_interleave(len(cand0))
                            ).reshape(n, len(cand0))
        vals_l, vals_g = vals[:, :n_l], vals[:, n_l:]
        k_l = _nanargmin(vals_l, 1)
        # The NPOL best global cells, ties to the lower index (top_k).
        top = torch.sort(torch.nan_to_num(vals_g, nan=float("inf")), dim=1,
                         stable=True)[1][:, :NPOL]
        patches = glob[top][:, :, None, :] + offs              # (n, 4, 25, 2)
        vals_p = prob.seed_mm(spectrum, patches.reshape(-1, 2),
                              win.repeat_interleave(NPOL * n_l)
                              ).reshape(n * NPOL, n_l)
        k_p = _nanargmin(vals_p, 1)
        seeds = torch.cat([(x0_t + offs)[k_l][:, None],
                           patches.reshape(n * NPOL, n_l, 2)[
                               torch.arange(n * NPOL, device=dev), k_p
                           ].reshape(n, NPOL, 2)], dim=1)       # (n, 5, 2)
        f0 = torch.cat([_take(vals_l, k_l)[:, None],
                        _take(vals_p, k_p).reshape(n, NPOL)], dim=1)
        traj = win.repeat_interleave(P)

        def mm_fn(x, traj=traj):
            return prob.mm(*spectrum(x), traj)

        x, fx = _newton_polish(mm_fn, seeds.reshape(n * P, 2),
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
            g = _grad(lambda x: prob.mm(*spectrum(x), win), x)
            oks.append(torch.linalg.vector_norm(g, dim=1) < 1e-7)
    x, = _scatter(dd, mesh, n_win, torch.cat(xs))
    eps = np.sqrt((x[:, 0] - Mf) ** 2 + (x[:, 1] - chif) ** 2)
    out = (eps, x[:, 0], x[:, 1]) if return_remnant else (eps,)
    if return_mismatch:
        out += tuple(_scatter(dd, mesh, n_win, torch.cat(fxs),
                              torch.cat(oks)))
    return out if len(out) > 1 else eps
