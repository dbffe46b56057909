"""Spectrum evaluation for fixed mode sets (port of the spectrum part of
qnmfits_tpu/engine.py).

The JAX main path evaluates the spectrum splines eagerly on the host
(``batched._on_host``) before the sweep; the port does the same in NumPy.
"""

from __future__ import annotations

import numpy as np

from .spectrum.tables import (ModeIndexSet, SpectrumTables, default_tables,
                              eval_spline_np)

__all__ = ["SpectrumEvaluator", "check_spin"]


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


class SpectrumEvaluator:
    """Packed spline coefficients for one mode set; ``omega`` and ``mu``
    evaluate them at a scalar spin or a (Q,) array of spins."""

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

    def _check(self, chif):
        if np.ndim(chif) == 0:
            _raise_if_bad_spin(float(chif), float(self.chi_grid[-1]))

    def omega(self, chif, Mf=1.0):
        """(J,) frequencies at scalar chif, or (J, Q) at chif (Q,), with
        mirror symmetry and nonlinear-mode sums applied."""
        self._check(chif)
        w = eval_spline_np(self.chi_grid, self.omega_coeffs, chif)
        signs, mask = self.signs, self.mask
        if np.ndim(chif):
            signs, mask = signs[..., None], mask[..., None]
        w = np.where(signs > 0, w, -np.conj(w))
        w = np.where(mask, w, 0.0).sum(axis=1)
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
