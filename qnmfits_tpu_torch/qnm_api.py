"""Reference-compatible spectrum API: the `qnm` class (port of
qnmfits_tpu/qnm_api.py:30-98).

The reference's qnmfits.qnm instance (qnm.py:36-393), backed by the
port's spectrum tables (``spectrum.tables``): methods take scalar or
array chif/Mf as the reference's do, and the spin weight s picks the
table (s = -2 gravitational; s = 0, scalar, for the Qmu_B quadratic
mixing prediction, reference spatial_mapping_functions.py:787-799; and
s = -1).  Everything here is host NumPy but the on-demand solve of a mode
the tables lack, which runs on the instance's ``device`` (the card unless
given "cpu").  ``download_cook_data`` is the JAX package's no-download
shim (qnm_api.py:19-27).
"""

from __future__ import annotations

import numpy as np

from .spectrum.tables import (SpectrumTables, default_tables, solve_on,
                              table_path)

__all__ = ["qnm", "get_qnm", "download_cook_data"]


def download_cook_data():
    """Reference-API shim (the reference's qnm.py:11-33, which downloads
    the n = 8, 9 multiplet data from Zenodo).  Nothing is downloaded: the
    port reads the tracked tables, and this checks that they load."""
    default_tables()
    print("qnmfits_tpu_torch reads multiplet data from its local tables; "
          "nothing to download.")


class qnm:
    """Kerr QNM frequencies and spherical-spheroidal mixing coefficients,
    as spline evaluations of the tables (reference qnm.py:36-393)."""

    def __init__(self, tables: SpectrumTables | None = None, device=None):
        # Where modes the tables lack are solved: ``device``, else the
        # calling entry point's, else the card.
        self.device = device
        self._tables = {}
        if tables is not None:
            self._tables[tables.s] = tables
        # Known (l, m, n, s) multiplets, kept for API compatibility
        # (reference qnm.py:67).
        self.multiplet_list = [(2, 0, 8, -2), (2, 1, 8, -2), (2, 2, 8, -2)]

    def _t(self, s: int) -> SpectrumTables:
        """The tables of spin weight s, loaded once (qnm_api.py:45)."""
        if s not in self._tables:
            if s == -2:
                self._tables[s] = default_tables()
            else:
                path = table_path(s)
                if not path.exists():
                    raise FileNotFoundError(
                        f"no spectrum tables for spin weight s={s} at "
                        f"{path}; the JAX package builds them with `python "
                        f"-m qnmfits_tpu.spectrum.build_tables --s {s}`")
                self._tables[s] = SpectrumTables(path)
        return self._tables[s]

    # -- frequencies -----------------------------------------------------
    def omega(self, ell, m, n, sign, chif, Mf=1, s=-2):
        """omega_{lmn}(Mf, chif); mirror modes via sign=-1
        (reference qnm.py:162-235)."""
        t = self._t(s)
        with solve_on(self.device):
            ms = t.compile_modes([(ell, m, n, sign)])
        w = t.omega_np(ms, chif, Mf)[0]
        return w if np.ndim(chif) or np.ndim(Mf) else complex(w)

    def omega_list(self, modes, chif, Mf=1, s=-2):
        """Frequencies for a list of (possibly nonlinear) mode tuples
        (reference qnm.py:237-291): nonlinear tuples sum their constituent
        linear frequencies."""
        if len(modes) == 0:
            return []
        t = self._t(s)
        with solve_on(self.device):
            ms = t.compile_modes(modes)
        w = t.omega_np(ms, chif, Mf)
        if np.ndim(chif) or np.ndim(Mf):
            return list(w)
        return [complex(x) for x in w]

    # -- mixing coefficients ----------------------------------------------
    def mu(self, ell, m, ellp, mp, nprime, sign, chif, s=-2):
        """Spherical-spheroidal mixing mu_{lm,l'm'n'}(chif)
        (reference qnm.py:293-361)."""
        if mp != m:
            return 0
        t = self._t(s)
        with solve_on(self.device):
            out = t.mu_np([(ell, m, ellp, mp, nprime, sign)], chif)[0]
        return out if np.ndim(chif) else complex(out)

    def mu_list(self, indices, chif, s=-2):
        """Mixing coefficients for (l,m,l',m',n',sign) tuples
        (reference qnm.py:363-393)."""
        t = self._t(s)
        with solve_on(self.device):
            out = t.mu_np(indices, chif)
        if np.ndim(chif):
            return [row for row in out]
        return [complex(x) for x in out]


_qnm = None


def get_qnm() -> qnm:
    """The process's shared ``qnm`` instance (ref_impl.py:24)."""
    global _qnm
    if _qnm is None:
        _qnm = qnm()
    return _qnm
