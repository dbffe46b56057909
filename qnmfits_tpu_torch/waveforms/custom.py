"""User-supplied waveform container (port of
qnmfits_tpu/waveforms/custom.py; the reference's Custom class,
qnmfits/Waveforms/Custom.py:7-173).

Wraps (times, data_dict, metadata) and runs the standard processing
pipeline (fluxes -> time shift -> optional frame transforms -> frequency
evolution).  Metadata is read by explicit attribute assignment instead of
the reference's exec() (Custom.py:151-153).
"""

from __future__ import annotations

import numpy as np

from .base import BaseWaveform

_REF_KEYS = {
    "reference_time": "reference_time",
    "reference_mass1": "m1",
    "reference_mass2": "m2",
    "reference_dimensionless_spin1": "chi1",
    "reference_dimensionless_spin2": "chi2",
}


class Custom(BaseWaveform):
    """Container for any spherical-harmonic-decomposed waveform.

    Parameters mirror the reference (Custom.py:14-67): times, a
    {(l, m): complex array} data_dict, a metadata dict with required keys
    'remnant_mass' and 'remnant_dimensionless_spin', optional ellMax
    truncation, zero_time anchor, and frame transform list.
    """

    def __init__(self, times, data_dict, metadata, ellMax=None, zero_time=0,
                 transform=None):
        self.times = np.asarray(times, dtype=float).copy()
        self.metadata = metadata
        self.ellMax = ellMax
        self.zero_time = zero_time

        self.load_metadata()

        if self.ellMax is None:
            self.ellMax = max(l for (l, m) in data_dict.keys())
        self.h = {lm: np.asarray(d) for lm, d in data_dict.items()
                  if lm[0] <= self.ellMax}
        self._process(transform)

    def load_metadata(self):
        """Store useful metadata as attributes (reference
        Custom.py:136-173, without exec)."""
        for key, attr in _REF_KEYS.items():
            if key in self.metadata:
                setattr(self, attr, self.metadata[key])
        if "reference_mass1" in self.metadata \
                and "reference_mass2" in self.metadata:
            self.M = self.m1 + self.m2

        if "remnant_mass" not in self.metadata \
                or "remnant_dimensionless_spin" not in self.metadata:
            raise KeyError(
                "metadata must contain 'remnant_mass' and "
                "'remnant_dimensionless_spin'")
        self.Mf = self.metadata["remnant_mass"]
        self.chif = np.asarray(self.metadata["remnant_dimensionless_spin"],
                               dtype=float)
        self.chif_mag = np.linalg.norm(self.chif)

        if self.chif_mag > 0:
            chif_norm = self.chif / self.chif_mag
            self.thetaf = np.arccos(chif_norm[2])
            self.phif = np.arctan2(chif_norm[1], chif_norm[0])
        else:
            self.thetaf = 0.0
            self.phif = 0.0

        if "remnant_velocity" in self.metadata:
            self.vf = np.asarray(self.metadata["remnant_velocity"])
