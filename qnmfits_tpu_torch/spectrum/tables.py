"""Kerr-spectrum tables: QNM frequencies and mixing coefficients as
cubic splines in the remnant spin (port of qnmfits_tpu/spectrum/tables.py).

The artifacts are the JAX package's tracked ``qnm_tables_s{s}.npz`` (spin
weights s = -2, -1 and 0), read in place with ``np.load`` -- the port
keeps no copy of them.  Splines are fitted in memory, only for the table
rows that requested modes use, and cached on the ``SpectrumTables``
instance (the JAX package's ``.spl.npz`` sidecars are neither read nor
written).  A mode missing from the table is solved on demand
(``spectrum/solver.py``, the CF on the card) on the device of the call
that asked for it, as the JAX package does (its tables.py:182-250); the
track is cached outside the repository, under ``track_cache_dir()``, with
the spin grid it was solved on (a cached track serves only that grid).

Semantics kept from the reference (qnm.py file:line as in the JAX module):
mirror modes (sign=-1) look up m -> -m and map omega -> -conj(omega),
mu -> (-1)^(l+l') conj(mu); nonlinear modes sum their constituent
frequencies; mu is zero when the spherical and spheroidal m differ.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
import os
import sys
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parents[2] / "qnmfits_tpu" / "data"
DEFAULT_TABLE = DATA_DIR / "qnm_tables_s-2.npz"

# Where solved tracks are cached (best-effort): None means
# $XDG_CACHE_HOME/qnmfits_tpu_torch/track_cache, else
# ~/.cache/qnmfits_tpu_torch/track_cache.  Never inside the repository.
TRACK_CACHE: Path | None = None

# The device on-demand solves run on when the call gives none: set for
# the duration of an entry point by ``solves_on_device``.
_SOLVE_DEVICE = contextvars.ContextVar("qnmfits_tpu_torch_solve_device",
                                       default=None)


def track_cache_dir() -> Path:
    """The directory of the on-demand solver's track cache."""
    if TRACK_CACHE is not None:
        return Path(TRACK_CACHE)
    root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(root) / "qnmfits_tpu_torch" / "track_cache"


def load_track(path: Path, chi) -> dict | None:
    """The arrays of the cached track at ``path`` if it was solved on the
    spin grid ``chi``, else None (a file from another grid of as many
    points is not this grid's track)."""
    if not path.exists():
        return None
    with np.load(path) as z:
        if "chi" not in z.files or not np.array_equal(z["chi"], chi):
            return None
        return {k: z[k] for k in z.files if k != "chi"}


@contextlib.contextmanager
def solve_on(device):
    """Solve modes missing from the tables on ``device`` inside the block
    (None keeps the surrounding setting)."""
    if device is None:
        yield
        return
    token = _SOLVE_DEVICE.set(device)
    try:
        yield
    finally:
        _SOLVE_DEVICE.reset(token)


def solves_on_device(fn):
    """Decorate an entry point with a ``device`` argument: the modes it
    compiles that the tables lack are solved on that device."""
    sig = inspect.signature(fn)
    default = sig.parameters["device"].default

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        device = sig.bind_partial(*args, **kwargs).arguments.get(
            "device", default)
        with solve_on(device):
            return fn(*args, **kwargs)
    return wrapper


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
        """Table row of (l, m_lookup, n), solving the mode on demand when
        the table lacks it (the reference's `qnm` package solves any mode
        lazily, qnm.py:124-160)."""
        if key not in self.row:
            self._solve_missing(key)
        return self.row[key]

    def _solve_missing(self, key: tuple) -> None:
        """Track the mode over the table's spin grid (tables.py:196 of the
        JAX package), cache the track, and append its row.  The solve runs
        on the device set by ``solve_on`` (the entry point's), else the
        card."""
        l, m, n = key
        if l < abs(self.s) or abs(m) > l or n < 0:
            raise KeyError(f"invalid mode {key} for spin weight s={self.s}")
        cache_dir = track_cache_dir()
        try:
            cache_dir.mkdir(parents=True, exist_ok=True)
        except OSError:         # read-only: the cache is best-effort
            pass
        cache = cache_dir / f"s{self.s}_l{l}_m{m}_n{n}_P{len(self.chi)}.npz"
        track = load_track(cache, self.chi)
        if track is not None:
            w, C = track["w"], track["C"]
        else:
            from .. import resolve_device
            from .solver import SolveError, schwarzschild_seeds, track_mode

            device = _SOLVE_DEVICE.get()
            dev = resolve_device("cuda" if device is None else device)
            print(f"qnmfits_tpu_torch: solving QNM ({l},{m},{n}) s={self.s} "
                  f"on demand on {dev.type} (not in the tables; the track is "
                  f"cached in {cache_dir})...", file=sys.stderr, flush=True)
            try:
                # l_max is the requested l, so ITS ladder is solved to n;
                # the lower ladders (only for the n = 0 extrapolation
                # chain) stop at n = 0, short of the l = 2 algebraically
                # special point.
                seeds = schwarzschild_seeds(l_max=l, n_max=n, s=self.s,
                                            n_max_low_l=0, device=dev)
                w, A, C = track_mode(l, m, n, seeds[(l, n)], self.chi,
                                     s=self.s, device=dev)
            except (SolveError, KeyError) as e:
                raise KeyError(
                    f"mode {key} is outside the baked tables and the "
                    f"on-demand solve failed ({e}).  Deep overtone ladders "
                    f"past the algebraically special frequency need the "
                    f"multiplet machinery: build tables with `python -m "
                    f"qnmfits_tpu_torch.spectrum.build_tables` and load "
                    f"them with SpectrumTables(path).") from e
            try:
                np.savez(cache, chi=self.chi, w=w, A=A, C=C)
            except OSError:     # read-only: the cache is best-effort
                pass
        mu = np.zeros((len(self.chi), self.n_mu), complex)
        Kc = min(self.n_mu, C.shape[1])
        mu[:, :Kc] = C[:, :Kc]
        self.keys.append(key)
        self.row[key] = len(self.keys) - 1
        self.omega = np.concatenate([self.omega, w[None]], axis=0)
        self.mu = np.concatenate([self.mu, mu[None]], axis=0)
        self._fit_rows([self.row[key]])

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
        arrays; missing modes are solved on demand (``_row_for``)."""
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
        parity, nonzero) arrays (reference qnm.py:293-361); missing modes
        are solved on demand."""
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
        rows, comps, signs, parity, nonzero = self.compile_mu_indices(
            indices)
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
