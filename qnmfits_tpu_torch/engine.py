"""Spectrum evaluation and the complex fit cores (port of
qnmfits_tpu/engine.py).

The JAX main path evaluates the spectrum splines eagerly on the host
(``batched._on_host``) before the sweep; the port does the same in NumPy.
``fit_core`` is the Gram-assembly weighted least-squares fit with its
trapezoid mismatch, and ``dynamic_fit_systems`` its time-dependent-spectrum
twin, both batched over leading axes (the JAX vmap); their solve is
``ops/solve.gram_cholesky``, the CUDA kernel on the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .engine_real import join_groups
from .ops.cmath import damped_phase
from .ops.solve import gram_cholesky
from .ops.windows import trapz_weights, window_closest, window_geq
from .spectrum.tables import (ModeIndexSet, SpectrumTables, default_tables,
                              eval_spline_np)

__all__ = ["SpectrumEvaluator", "cached_evaluator", "check_spin",
           "chunk_bounds", "dynamic_fit_core", "dynamic_fit_systems",
           "fit_core", "fit_systems", "fit_mismatch", "solve_fits"]


def _raise_if_bad_spin(c: float, hi: float) -> None:
    # Negated form so NaN (all comparisons False) also raises.
    if not (0.0 <= c <= hi):
        raise ValueError(
            f"chif must be in [0, {hi}] (got {c}); retrograde modes "
            f"are selected by the mode's m/sign, not a negative spin")


def check_spin(chif, tables: SpectrumTables | None = None) -> None:
    """Validate a concrete scalar remnant spin against the table grid
    (spin arrays are exempt, as in the JAX package)."""
    if chif is None or np.ndim(chif) != 0:
        return
    t = tables if tables is not None else default_tables()
    _raise_if_bad_spin(float(chif), float(t.chi[-1]))


def cached_evaluator(modes, sph=None):
    """A shared SpectrumEvaluator keyed by canonical (modes, sph) tuples
    (engine.py:65); instances hold no state after construction."""
    return _cached_evaluator(tuple(tuple(int(x) for x in m) for m in modes),
                             None if sph is None
                             else tuple(tuple(int(x) for x in m)
                                        for m in sph))


@lru_cache(maxsize=256)
def _cached_evaluator(modes, sph):
    return SpectrumEvaluator(list(modes), list(sph) if sph else None)


class SpectrumEvaluator:
    """Packed spline coefficients for one mode set; ``omega`` and ``mu``
    evaluate them in NumPy at a scalar spin or a (Q,) array of spins, and
    ``omega_t`` / ``mu_t`` in torch at a tensor of spins, differentiably
    (the JAX evaluator's jitted form, engine.py:125-183)."""

    def __init__(self, modes, spherical_modes=None,
                 tables: SpectrumTables | None = None):
        t = tables if tables is not None else default_tables()
        self.tables = t
        self.mode_set: ModeIndexSet = t.compile_modes(modes)
        self.signs = self.mode_set.signs_np()                   # (J, Kc)
        self.mask = self.mode_set.mask_np()                     # (J, Kc)
        self.chi_grid = t.chi
        self.omega_coeffs = t.omega_coeffs(self.mode_set.rows_np())

        if spherical_modes is not None:
            for mode in self.mode_set.modes:
                if len(mode) != 4:
                    raise ValueError(
                        "multimode fits require linear (l,m,n,sign) modes; "
                        f"got {mode}")
            indices = [tuple(lm) + mode for lm in spherical_modes
                       for mode in self.mode_set.modes]
            r, comp, sgn, par, nz = t.compile_mu_indices(indices)
            I, J = len(spherical_modes), self.mode_set.J
            self.mu_coeffs = t.mu_coeffs(r, comp).reshape(I, J, -1, 4)
            self.mu_signs = sgn.reshape(I, J)
            self.mu_parity = par.reshape(I, J)
            self.mu_nonzero = nz.reshape(I, J)
        else:
            self.mu_coeffs = None
        self._on_device = {}             # (name, device) -> tensor

    def _const(self, name, device):
        """The NumPy constant ``name`` as a tensor on ``device``, made once."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(
                np.asarray(getattr(self, name)), device=device)
        return self._on_device[key]

    def _spline_t(self, name, chif, order=0):
        """Packed coefficients ``name`` (..., P-1, 4) at spins chif (N,):
        the segment searchsorted(grid, chif, side='right') - 1, clipped to
        the table, and Horner's rule in dx = chif - grid[i], so the
        derivative is the cubic's on that segment.  Returns (..., N); with
        ``order`` 1 or 2 also that cubic's first ``order`` derivatives in
        chif, stacked on a new leading axis: (order + 1, ..., N)."""
        grid = self._const("chi_grid", chif.device)
        i = torch.clamp(torch.searchsorted(grid, chif.detach(), right=True)
                        - 1, 0, grid.shape[0] - 2)
        dx = chif - grid[i]
        c = self._const(name, chif.device)[..., i, :]
        v = ((c[..., 0] * dx + c[..., 1]) * dx + c[..., 2]) * dx + c[..., 3]
        if not order:
            return v
        dx = dx.to(c.dtype)
        parts = [v, (3.0 * c[..., 0] * dx + 2.0 * c[..., 1]) * dx + c[..., 2]]
        if order == 2:
            parts.append(6.0 * c[..., 0] * dx + 2.0 * c[..., 1])
        return torch.stack(parts)

    def _omega_of(self, w, delta_factor):
        """The mirror, nonlinear-sum and (J,) perturbation-factor logic on
        spline values w (..., J, Kc, N) -> (..., J, N); linear in w, so it
        maps the spline's chif-derivatives to omega's."""
        dev = w.device
        w = torch.where(self._const("signs", dev)[..., None] > 0, w,
                        -w.conj())
        w = torch.where(self._const("mask", dev)[..., None], w,
                        torch.zeros((), dtype=w.dtype, device=dev)).sum(dim=-2)
        if delta_factor is not None:
            df = torch.as_tensor(np.asarray(delta_factor, float), device=dev)
            w = w * (df[:, None] if df.ndim else df)
        return w

    def _mu_of(self, mu):
        """The sign, parity and structural-zero logic of ``mu`` on spline
        values mu (..., I, J, N); linear in mu."""
        dev = mu.device
        mu = torch.where(self._const("mu_signs", dev)[..., None] > 0, mu,
                         self._const("mu_parity", dev)[..., None] * mu.conj())
        return torch.where(self._const("mu_nonzero", dev)[..., None], mu,
                           torch.zeros((), dtype=mu.dtype, device=dev))

    def omega_t(self, chif, Mf, delta_factor=None):
        """(N, J) frequencies at spins chif (N,) and masses Mf (N,) or a
        scalar, float64 tensors, differentiable in both; the mirror,
        nonlinear-sum and (J,) perturbation-factor logic of ``omega``.
        Spins are not range-checked (the callers clip them)."""
        w = self._spline_t("omega_coeffs", chif)                # (J, Kc, N)
        return (self._omega_of(w, delta_factor) / Mf).T

    def mu_t(self, chif):
        """(N, I, J) mixing coefficients at spins chif (N,), a float64
        tensor, differentiable; the logic of ``mu``."""
        if self.mu_coeffs is None:
            raise ValueError("no spherical_modes were compiled")
        mu = self._spline_t("mu_coeffs", chif)                  # (I, J, N)
        return self._mu_of(mu).permute(2, 0, 1)

    def omega_chi_t(self, chif, order, delta_factor=None):
        """(order + 1, N, J): the frequencies at unit mass at spins chif
        (N,) and their first ``order`` (1 or 2) derivatives in chif, the
        spline's own on its segment (``_spline_t``)."""
        w = self._spline_t("omega_coeffs", chif, order)   # (o+1, J, Kc, N)
        return self._omega_of(w, delta_factor).transpose(-2, -1)

    def mu_chi_t(self, chif, order):
        """(order + 1, N, I, J): the mixing coefficients at spins chif (N,)
        and their first ``order`` (1 or 2) derivatives in chif."""
        if self.mu_coeffs is None:
            raise ValueError("no spherical_modes were compiled")
        mu = self._spline_t("mu_coeffs", chif, order)     # (o+1, I, J, N)
        return self._mu_of(mu).permute(0, 3, 1, 2)

    def _check(self, chif):
        if np.ndim(chif) == 0:
            _raise_if_bad_spin(float(chif), float(self.chi_grid[-1]))

    def omega(self, chif, Mf=1.0, delta_factor=None):
        """(J,) frequencies at scalar chif, or (J, Q) at chif (Q,), with
        mirror symmetry, nonlinear-mode sums and the (J,) perturbation
        factor 1 + delta applied (reference qnmfits.py:253-274)."""
        self._check(chif)
        w = eval_spline_np(self.chi_grid, self.omega_coeffs, chif)
        signs, mask = self.signs, self.mask
        if np.ndim(chif):
            signs, mask = signs[..., None], mask[..., None]
        w = np.where(signs > 0, w, -np.conj(w))
        w = np.where(mask, w, 0.0).sum(axis=1)
        if delta_factor is not None:
            df = np.asarray(delta_factor)
            w = w * (df if np.ndim(chif) == 0 else df[..., None])
        return w / Mf

    def mu(self, chif):
        """(I, J) mixing coefficients at scalar chif, or (I, J, Q)."""
        if self.mu_coeffs is None:
            raise ValueError("no spherical_modes were compiled")
        self._check(chif)
        mu = eval_spline_np(self.chi_grid, self.mu_coeffs, chif)
        sgn, par, nz = self.mu_signs, self.mu_parity, self.mu_nonzero
        if np.ndim(chif):
            sgn, par, nz = sgn[..., None], par[..., None], nz[..., None]
        mu = np.where(sgn > 0, mu, par * np.conj(mu))
        return np.where(nz, mu, 0.0)


# ---------------------------------------------------------------------------
# Fit core (engine.py:190-259)
# ---------------------------------------------------------------------------

def _window(times, t0, T, t0_method: str):
    if t0_method == "geq":
        return window_geq(times, t0, T)
    if t0_method == "closest":
        return window_closest(times, t0, T)
    raise ValueError("t0_method must be 'geq' or 'closest'")


def _masked(G, rhs, col_mask):
    """Identity Gram rows and zero right-hand sides in the padding slots
    (col_mask False), so their amplitudes are exactly zero."""
    if col_mask is None:
        return G, rhs
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    G = torch.where(col_mask[..., :, None] & col_mask[..., None, :], G, eye)
    rhs = torch.where(col_mask, rhs, torch.zeros((), dtype=rhs.dtype,
                                                 device=rhs.device))
    return G, rhs


def _expanded(G, rhs, G_tau, r_tau, data_norm):
    batch = rhs.shape[:-1]
    return (G.expand(*batch, *G.shape[-2:]), rhs,
            G_tau.expand(*batch, *G_tau.shape[-2:]),
            r_tau.expand(*batch, r_tau.shape[-1]), data_norm.expand(batch))


def fit_systems(times, data, omega, mu, t0, w, col_mask=None):
    """The pieces of ``fit_core`` before and after its solve, batched over
    leading axes that broadcast together.

    times (K,) real; data (..., I, K) complex; omega (..., J); mu
    (..., I, J); t0 (...) real tensor; w (..., K) {0,1} window weights;
    col_mask (..., J) bool marking real (True) vs padding slots, which get
    identity Gram rows and a zero right-hand side.  The complex128 form of
    engine_real.fit_core_real with its summed Grams.
    Returns G (..., J, J), rhs (..., J): the masked normal equations; and
    G_tau, r_tau, data_norm: the trapezoid-weighted Gram, projections and
    data norm of the mismatch.
    """
    tau = trapz_weights(times, w)
    # Window-clamped phase (w binary): no backward-in-time overflow, even
    # for a growing free mode; products with w and tau are unchanged.
    phi = damped_phase(omega[..., None, :],
                       ((times - t0[..., None]) * w)[..., :, None])
    phiw = phi * w[..., :, None]                               # (..., K, J)
    phit = phi * tau[..., :, None]
    Mmu = mu.mH @ mu                                           # (..., J, J)
    Gt, Gt_tau = phiw.mH @ phiw, phit.mH @ phi
    pd = (data * w[..., None, :]).to(phi.dtype) @ phiw.conj()  # (..., I, J)
    G, rhs = _masked(Mmu * Gt, (mu.conj() * pd).sum(dim=-2), col_mask)
    r_tau = (mu.conj() * (data.to(phi.dtype) @ phit.conj())).sum(dim=-2)
    data_norm = (tau[..., None, :] * (data.real ** 2 + data.imag ** 2)).sum(
        dim=(-2, -1))
    return _expanded(G, rhs, Mmu * Gt_tau, r_tau, data_norm)


def dynamic_fit_systems(times, data, omega_t, mu_t, t0, w, col_mask=None):
    """``fit_systems`` with a time-dependent spectrum (engine.py:262,
    engine_real.dynamic_fit_core_real): design entries a^i_kj =
    mu^i_kj exp(-i omega_kj (t_k - t0)) (reference qnmfits.py:438-444,
    863-864), batched over leading axes that broadcast together.

    times (K,); data (I, K); omega_t (..., K, J); mu_t (..., I, K, J);
    t0 (...); w (..., K) {0,1}; col_mask (..., J) bool.  The per-sample
    mixing does not factor out of the design, so the Grams contract over
    the flattened (I * K) axis; the window-weighted and the trapezoid-
    weighted copies of the design are made one after the other, never
    both at once.  Returns what ``fit_systems`` returns.
    """
    tau = trapz_weights(times, w)
    phi = damped_phase(omega_t, ((times - t0[..., None]) * w)[..., :, None])
    E = mu_t * phi[..., None, :, :]                         # (..., I, K, J)
    I, K, J = E.shape[-3:]
    lead = E.shape[:-3]
    Ef = E.reshape(*lead, I * K, J)
    d = data.to(E.dtype)

    Ew = (E * w[..., None, :, None]).reshape(*lead, I * K, J)
    G = Ew.mH @ Ew
    dw = (d * w[..., None, :]).expand(*lead, I, K)
    rhs = (Ew.mH @ dw.reshape(*lead, I * K, 1))[..., 0]
    del Ew
    G, rhs = _masked(G, rhs, col_mask)

    Et = (E * tau[..., None, :, None]).reshape(*lead, I * K, J)
    G_tau = Et.mH @ Ef
    r_tau = (Et.mH @ d.reshape(I * K, 1))[..., 0]
    del Et
    data_norm = (tau[..., None, :] * (data.real ** 2 + data.imag ** 2)).sum(
        dim=(-2, -1))
    return _expanded(G, rhs, G_tau, r_tau, data_norm)


def fit_mismatch(C, G_tau, r_tau, data_norm):
    """Sky-averaged trapezoid mismatch of the fitted model (reference
    qnmfits.py:73-139) from the trapezoid-weighted contractions."""
    num = (C * r_tau.conj()).sum(dim=-1).real
    model_norm = (C.conj() * (G_tau @ C[..., None])[..., 0]).sum(dim=-1).real
    return 1.0 - num / torch.sqrt(model_norm * data_norm)


def fit_core(times, data, omega, mu, t0, w, col_mask=None, solve=None):
    """Weighted multimode least-squares fit and its mismatch
    (engine.py:198), batched over leading axes of (t0, w), (omega, mu) or
    both; see ``fit_systems`` for the shapes.  Returns C (..., J) and
    mm (...)."""
    G, rhs, G_tau, r_tau, data_norm = fit_systems(times, data, omega, mu,
                                                  t0, w, col_mask)
    C = gram_cholesky(G, rhs, solve)
    return C, fit_mismatch(C, G_tau, r_tau, data_norm)


def dynamic_fit_core(times, data, omega_t, mu_t, t0, w, col_mask=None,
                     solve=None):
    """Fit with a time-dependent Kerr spectrum and its mismatch
    (engine.py:262): one window of ``dynamic_fit_systems``, solved by
    ``gram_cholesky``.  times (K,); data (I, K); omega_t (K, J); mu_t
    (I, K, J) (ones for a single series); t0 a number or a 0-d tensor; w
    (K,) {0,1}; col_mask (J,) bool (padding slots: exactly-zero
    amplitudes).  Returns C (J,) and mm (a 0-d tensor)."""
    t0 = torch.as_tensor(t0, dtype=torch.float64, device=data.device)
    G, rhs, G_tau, r_tau, data_norm = dynamic_fit_systems(
        times, data, omega_t, mu_t, t0, w, col_mask)
    C = gram_cholesky(G, rhs, solve)
    return C, fit_mismatch(C, G_tau, r_tau, data_norm)


def chunk_bounds(n, chunk):
    """[(lo, hi)] runs of ``chunk`` items covering 0..n in order."""
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def solve_fits(bounds, item_bytes, systems, solve=None):
    """Fits of the items of ``bounds`` (consecutive (lo, hi) runs, e.g.
    ``chunk_bounds``) built run by run and solved in few calls.

    ``systems(lo, hi)`` returns the ``fit_systems`` tuple of items lo:hi
    with the item axis last among the batch axes (the JAX lax.map with
    batch_size=chunk, which never holds every item's (K, J) basis at
    once).  Consecutive runs are joined while their G and G_tau stay
    within ``engine_real.JOIN_BYTES`` (``item_bytes`` a joined item), and
    each group is solved by one ``gram_cholesky`` call.  Returns C
    (..., n, J) and mm (..., n).
    """
    Cs, mms = [], []
    for g0, g1 in join_groups([hi - lo for lo, hi in bounds], item_bytes):
        parts = list(zip(*(systems(lo, hi) for lo, hi in bounds[g0:g1])))
        # The item axis: -3 of the Grams, -2 of the vectors, -1 of the norm.
        G, rhs, G_tau, r_tau, dn = (torch.cat(p, dim=axis) for p, axis in
                                    zip(parts, (-3, -2, -3, -2, -1)))
        C = gram_cholesky(G, rhs, solve)
        Cs.append(C)
        mms.append(fit_mismatch(C, G_tau, r_tau, dn))
    return torch.cat(Cs, dim=-2), torch.cat(mms, dim=-1)
