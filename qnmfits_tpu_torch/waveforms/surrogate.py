"""Surrogate-model waveform containers (port of
qnmfits_tpu/waveforms/surrogate.py; the reference's NRSur7dq4 and
NRHybSur3dq8 classes, qnmfits/Waveforms/Surrogate.py:7-198, 201-407).

Both need the optional `gwsurrogate` and `surfinBH` packages (optional
installs in the reference too); construction raises an informative
ImportError when they are absent.
"""

from __future__ import annotations

import numpy as np

from .base import BaseWaveform


def _require_surrogate_deps():
    try:
        import gwsurrogate  # noqa: F401
        import surfinBH  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "surrogate waveforms require the optional `gwsurrogate` and "
            "`surfinBH` packages (same optional dependency as the "
            "reference package)") from e


class _SurrogateBase(BaseWaveform):
    def _common_init(self, q, chi1, chi2, f_ref, ellMax, zero_time):
        self.q = q
        self.chi1 = chi1
        self.chi2 = chi2
        self.f_ref = f_ref
        self.ellMax = ellMax
        self.zero_time = zero_time
        self.m1 = q / (1 + q)
        self.m2 = 1 / (1 + q)
        self.M = self.m1 + self.m2

    def _finish_init(self, transform):
        chif_norm = self.chif / self.chif_mag
        self.thetaf = np.arccos(chif_norm[2])
        self.phif = np.arctan2(chif_norm[1], chif_norm[0])
        self._process(transform)


class NRSur7dq4(_SurrogateBase):
    """Precessing surrogate (Varma et al. 2019, arXiv:1905.09300);
    reference Surrogate.py:7-198."""

    def __init__(self, q=1, chi1=[0, 0, 0], chi2=[0, 0, 0], f_ref=0.01,
                 ellMax=None, zero_time=0, transform=None):
        _require_surrogate_deps()
        import gwsurrogate as gws
        import surfinBH

        self._common_init(q, chi1, chi2, f_ref, ellMax, zero_time)

        if "NRSur7dq4" not in dir(gws):
            gws.catalog.pull("NRSur7dq4")
        sur = gws.LoadSurrogate("NRSur7dq4")
        self.times, self.h, self.dyn = sur(
            q=q, chiA0=chi1, chiB0=chi2, f_low=0, f_ref=f_ref,
            ellMax=ellMax, precessing_opts={"return_dynamics": True})
        if self.ellMax is None:
            self.ellMax = 4

        surrem = surfinBH.LoadFits("NRSur7dq4Remnant")
        self.Mf, self.Mf_err = surrem.mf(
            q, self.chi1, self.chi2, omega0=np.pi * self.f_ref)
        self.chif, self.chif_err = surrem.chif(
            q, self.chi1, self.chi2, omega0=np.pi * self.f_ref)
        self.chif_mag = np.linalg.norm(self.chif)

        self._finish_init(transform)


class NRHybSur3dq8(_SurrogateBase):
    """Aligned-spin hybridised surrogate (Varma et al. 2018,
    arXiv:1812.07865); reference Surrogate.py:201-407.

    Negative-m modes are filled by the aligned-spin symmetry
    h_{l,-m} = (-1)^l conj(h_{l,m}) and the absent (4,0) mode is zeroed
    (Surrogate.py:330-340)."""

    def __init__(self, q=1, chi1=[0, 0, 0], chi2=[0, 0, 0], f_ref=0.01,
                 ellMax=None, zero_time=None, inclination=None, phi_ref=0,
                 transform=None):
        _require_surrogate_deps()
        import gwsurrogate as gws
        import surfinBH

        self._common_init(q, chi1, chi2, f_ref, ellMax, zero_time)

        if "NRHybSur3dq8" not in dir(gws):
            gws.catalog.pull("NRHybSur3dq8")
        sur = gws.LoadSurrogate("NRHybSur3dq8")
        self.times, self.h, self.dyn = sur(
            q=q, chiA0=chi1, chiB0=chi2, f_low=0, f_ref=f_ref,
            ellMax=ellMax)
        if self.ellMax is None:
            self.ellMax = 4

        # The surrogate models (2,2),(2,1),(2,0),(3,3),(3,2),(3,1),
        # (3,0),(4,4),(4,3),(4,2),(5,5) -- NOT (4,1)/(4,0) (Varma et
        # al. 2018 Table I).  The reference zero-fills only (4,0) and
        # would KeyError on (4,-1) via the missing (4,1)
        # (Surrogate.py:336-340); here EVERY absent positive-m mode is
        # zero-filled and m<0 filled by the aligned-spin symmetry
        # (PARITY.md known delta).
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                if (l, m) in self.h:
                    continue
                if m < 0 and (l, -m) in self.h:
                    self.h[l, m] = (-1) ** l * np.conjugate(self.h[l, -m])
                else:
                    self.h[l, m] = np.zeros_like(self.times,
                                                 dtype=complex)

        surrem = surfinBH.LoadFits("NRSur3dq8Remnant")
        self.Mf, self.Mf_err = surrem.mf(q, self.chi1, self.chi2)
        self.chif, self.chif_err = surrem.chif(q, self.chi1, self.chi2)
        self.chif_mag = np.linalg.norm(self.chif)

        self._finish_init(transform)
