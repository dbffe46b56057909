"""Kerr-spectrum tables: QNM frequencies and mixing coefficients as
cubic splines in the remnant spin (port of qnmfits_tpu/spectrum/tables.py).

The artifacts are the JAX package's tracked ``qnm_tables_s{s}.npz`` (spin
weights s = -2, -1 and 0), read in place with ``np.load`` -- the port
keeps no copy of them.  Splines are fitted in memory, only for the table
rows that requested modes use, and cached on the ``SpectrumTables``
instance; nothing is written to disk (the JAX package's ``.spl.npz``
sidecars are neither read nor written).  A mode missing from the table
raises (the JAX package solves such modes on demand; that solver is not
ported).

Semantics kept from the reference (qnm.py file:line as in the JAX module):
mirror modes (sign=-1) look up m -> -m and map omega -> -conj(omega),
mu -> (-1)^(l+l') conj(mu); nonlinear modes sum their constituent
frequencies; mu is zero when the spherical and spheroidal m differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[2] / "qnmfits_tpu" / "data"
DEFAULT_TABLE = DATA_DIR / "qnm_tables_s-2.npz"


def table_path(s: int) -> Path:
    """The tracked artifact of spin weight s."""
    return DATA_DIR / f"qnm_tables_s{int(s)}.npz"


def _fit_cubic_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Not-a-knot interpolating cubic spline coefficients.

    y: (..., P) complex.  Returns (..., P-1, 4) coefficients ordered
    [c3, c2, c1, c0] for c3*dx^3 + c2*dx^2 + c1*dx + c0 with
    dx = chi - x[i] on interval i.
    """
    from scipy.interpolate import CubicSpline
    y2 = y.reshape(-1, y.shape[-1])
    cs = CubicSpline(x, y2, axis=-1)          # cs.c: (4, P-1, N)
    out = np.ascontiguousarray(np.moveaxis(cs.c, (0, 1, 2), (2, 1, 0)))
    return out.reshape(y.shape[:-1] + (y.shape[-1] - 1, 4))


def eval_spline_np(x_grid: np.ndarray, coeffs: np.ndarray, x) -> np.ndarray:
    """Piecewise-cubic evaluation.  coeffs (..., P-1, 4); x scalar or
    (Q,).  Returns (...,) or (..., Q)."""
    x = np.asarray(x, dtype=np.float64)
    scalar = x.ndim == 0
    xq = np.atleast_1d(x)
    i = np.clip(np.searchsorted(x_grid, xq, side="right") - 1,
                0, len(x_grid) - 2)
    dx = xq - x_grid[i]
    c = coeffs[..., i, :]                      # (..., Q, 4)
    val = ((c[..., 0] * dx + c[..., 1]) * dx + c[..., 2]) * dx + c[..., 3]
    return val[..., 0] if scalar else val


def split_nonlinear(mode: tuple) -> list[tuple]:
    """Chunk a flat nonlinear mode tuple into (l, m, n, sign) quadruples."""
    if len(mode) % 4 != 0:
        raise ValueError(f"mode tuple length must be a multiple of 4: {mode}")
    return [tuple(mode[i:i + 4]) for i in range(0, len(mode), 4)]


@dataclass(frozen=True)
class ModeIndexSet:
    """Index arrays for a list of (possibly nonlinear) QNMs: for mode j,
    the table rows of its Kmax constituent linear modes (padded), their
    mirror signs and a validity mask, each (J, Kmax)."""
    modes: tuple
    rows: tuple
    signs: tuple
    mask: tuple

    @property
    def J(self) -> int:
        return len(self.rows)

    def rows_np(self):
        return np.array(self.rows, dtype=np.int64)

    def signs_np(self):
        return np.array(self.signs, dtype=np.float64)

    def mask_np(self):
        return np.array(self.mask, dtype=bool)


class SpectrumTables:
    """Spectrum artifact plus lazily fitted spline coefficients."""

    def __init__(self, path: str | Path = DEFAULT_TABLE):
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"QNM table artifact not found at {path}")
        with np.load(path) as z:
            self._set(z["chi"], z["keys"], z["omega"], z["mu"],
                      int(z["s"]), int(z["n_mu"]))

    @classmethod
    def from_arrays(cls, chi, keys, omega, mu, s, n_mu) -> "SpectrumTables":
        """Tables from in-memory arrays: chi (P,), keys (M, 3) of
        (l, m, n), omega (M, P), mu (M, P, n_mu), spin weight s."""
        self = cls.__new__(cls)
        self._set(chi, keys, omega, mu, int(s), int(n_mu))
        return self

    def _set(self, chi, keys, omega, mu, s, n_mu):
        self.chi = np.asarray(chi, dtype=np.float64)
        self.keys = [tuple(int(x) for x in k) for k in keys]
        self.omega = np.asarray(omega, dtype=np.complex128)   # (M, P)
        self.mu = np.asarray(mu, dtype=np.complex128)         # (M, P, K)
        self.s = s
        self.n_mu = n_mu
        self.row = {k: i for i, k in enumerate(self.keys)}
        self._omega_c: dict[int, np.ndarray] = {}     # row -> (P-1, 4)
        self._mu_c: dict[int, np.ndarray] = {}        # row -> (K, P-1, 4)

    def _row_for(self, key: tuple) -> int:
        if key not in self.row:
            raise KeyError(
                f"mode (l, m, n) = {key} is not in the spectrum table "
                f"(s={self.s}); on-demand solving of modes outside the "
                f"table is not available in qnmfits_tpu_torch")
        return self.row[key]

    def _fit_rows(self, rows) -> None:
        """Fit (once, in one batched call) the splines of table rows."""
        new = sorted({int(r) for r in np.ravel(rows)} - self._omega_c.keys())
        if not new:
            return
        oc = _fit_cubic_coeffs(self.chi, self.omega[new])
        mc = _fit_cubic_coeffs(self.chi, np.moveaxis(self.mu[new], 2, 1))
        for r, o, m in zip(new, oc, mc):
            self._omega_c[r] = o
            self._mu_c[r] = m

    def omega_coeffs(self, rows: np.ndarray) -> np.ndarray:
        """Spline coefficients (..., P-1, 4) of omega at table rows (...)."""
        self._fit_rows(rows)
        flat = [self._omega_c[int(r)] for r in np.ravel(rows)]
        return np.stack(flat).reshape(np.shape(rows) + flat[0].shape)

    def mu_coeffs(self, rows: np.ndarray, comps: np.ndarray) -> np.ndarray:
        """Spline coefficients (N, P-1, 4) of mixing component comps[i]
        at table row rows[i]."""
        if len(rows) == 0:
            return np.zeros((0, len(self.chi) - 1, 4), complex)
        self._fit_rows(rows)
        return np.stack([self._mu_c[int(r)][int(c)]
                         for r, c in zip(rows, comps)])

    def compile_modes(self, modes) -> ModeIndexSet:
        """Compile a list of (possibly nonlinear) mode tuples to index
        arrays."""
        modes = [tuple(int(x) for x in mode) for mode in modes]
        parts = [split_nonlinear(m) for m in modes]
        Kmax = max(len(p) for p in parts)
        rows, signs, mask = [], [], []
        for p in parts:
            r, sg, mk = [], [], []
            for (l, m, n, sign) in p:
                r.append(self._row_for((l, m * sign, n)))
                sg.append(sign)
                mk.append(True)
            while len(r) < Kmax:
                r.append(0); sg.append(1); mk.append(False)
            rows.append(tuple(r)); signs.append(tuple(sg))
            mask.append(tuple(mk))
        return ModeIndexSet(tuple(modes), tuple(rows), tuple(signs),
                            tuple(mask))

    def compile_mu_indices(self, indices):
        """Compile (l, m, l', m', n', sign) tuples to (rows, comps, signs,
        parity, nonzero) arrays (reference qnm.py:293-361)."""
        rows, comps, signs, parity, nonzero = [], [], [], [], []
        for (ell, m, ellp, mp, nprime, sign) in indices:
            if mp != m:
                rows.append(0); comps.append(0); signs.append(1)
                parity.append(1.0); nonzero.append(False)
                continue
            m_l, mp_l = m * sign, mp * sign
            comp = ell - max(abs(m_l), abs(self.s))
            key = (ellp, mp_l, nprime)
            row = self._row_for(key)
            if not (0 <= comp < self.n_mu):
                raise KeyError(
                    f"mixing component l={ell} out of stored range for "
                    f"spheroidal {key} (have {self.n_mu} components)")
            rows.append(row)
            comps.append(comp)
            signs.append(sign)
            parity.append((-1.0) ** (ell + ellp) if sign == -1 else 1.0)
            nonzero.append(True)
        return (np.array(rows, np.int64), np.array(comps, np.int64),
                np.array(signs, np.float64), np.array(parity, np.float64),
                np.array(nonzero, bool))


    def _check_chif(self, chif):
        """Spins outside the table grid [0, chi_max] raise (tables.py:
        219): cubic extrapolation past the grid is silently unphysical."""
        c = np.asarray(chif, float)
        hi = float(self.chi[-1])
        # Negated form so NaN (all comparisons False) also raises.
        if c.size and not (float(np.min(c)) >= 0.0
                           and float(np.max(c)) <= hi
                           and not np.any(np.isnan(c))):
            raise ValueError(
                f"chif must be in [0, {hi}] (got range "
                f"[{float(np.min(c))}, {float(np.max(c))}]); retrograde "
                f"modes are selected by the mode's m/sign, not a "
                f"negative spin")

    def omega_np(self, mode_set: ModeIndexSet, chif, Mf=1.0):
        """Frequencies of a compiled mode set at spin(s) chif (tables.py:
        239): (J,) for scalar chif, (J, Q) for chif (Q,); an array Mf with
        a scalar chif broadcasts to (J, Q)."""
        self._check_chif(chif)
        rows = mode_set.rows_np()            # (J, Kmax)
        signs = mode_set.signs_np()
        mask = mode_set.mask_np()
        w = eval_spline_np(self.chi, self.omega_coeffs(rows), chif)
        if w.ndim == 3:
            signs = signs[..., None]
            mask = mask[..., None]
        w = np.where(signs > 0, w, -np.conj(w))
        w = np.where(mask, w, 0.0).sum(axis=1)
        Mf = np.asarray(Mf)
        if Mf.ndim and w.ndim == 1:
            return w[:, None] / Mf[None, :]
        return w / Mf

    def mu_np(self, indices, chif):
        """Mixing coefficients of (l, m, l', m', n', sign) tuples at spin(s)
        chif (tables.py:266): (N,) or (N, Q)."""
        self._check_chif(chif)
        rows, comps, signs, parity, nonzero = self.compile_mu_indices(indices)
        mu = eval_spline_np(self.chi, self.mu_coeffs(rows, comps), chif)
        if mu.ndim == 2:
            signs = signs[:, None]; parity = parity[:, None]
            nonzero = nonzero[:, None]
        mu = np.where(signs > 0, mu, parity * np.conj(mu))
        return np.where(nonzero, mu, 0.0)


@lru_cache(maxsize=1)
def default_tables() -> SpectrumTables:
    """The s=-2 tables, loaded once per process."""
    return SpectrumTables()
