"""SXS catalog waveform loader (port of qnmfits_tpu/waveforms/sxs.py; the
reference's SXS class, qnmfits/Waveforms/Simulation.py:12-307).

Loading strategy, in order:

1. the `sxs` package, if installed (it downloads and caches as the
   reference does, Simulation.py:85-106);
2. a local cache of SXS-format files (metadata.json +
   rhOverM_Asymptotic_GeometricUnits_CoM.h5), searched under
   $SXS_CACHE_DIR, then ~/.cache/sxs, so that pre-downloaded catalogs
   work on machines without network access.  Nothing here downloads.

Metadata extraction (masses, spins, q, chi_eff, chi_p, L, kick,
common-horizon time), level selection relative to the highest available,
and the last-~10-orbits truncation via the 20th pre-merger peak of
Re h22 (Simulation.py:248-270) all follow the reference.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
from scipy import signal as _signal

from .base import BaseWaveform


def _cache_dirs():
    dirs = []
    if os.environ.get("SXS_CACHE_DIR"):
        dirs.append(Path(os.environ["SXS_CACHE_DIR"]))
    dirs.append(Path.home() / ".cache" / "sxs")
    return dirs


class SXS(BaseWaveform):
    """Container for a simulation from the SXS catalog.

    Parameters mirror the reference (Simulation.py:16-68): ID, ellMax,
    zero_time, transform, lev_minus_highest, extrapolation_order.  The
    host seconds of reading the files and the metadata are
    ``stage_seconds['load']``.
    """

    def __init__(self, ID, ellMax=None, zero_time=0, transform=None,
                 lev_minus_highest=0, extrapolation_order=2):
        self.ID = f"{int(ID):04d}"
        self.ellMax = ellMax
        self.zero_time = zero_time
        self.lev_minus_highest = lev_minus_highest
        self.extrapolation_order = extrapolation_order

        self._stage("load", self._load)
        self._process(transform)

    def _load(self):
        self._load_catalog_files()
        self.load_metadata()
        self.load_data()

    # -- data acquisition ---------------------------------------------------

    def _load_catalog_files(self):
        """Populate self.metadata (dict) and self._modes/self._times from
        the sxs package or a local cache."""
        try:
            import sxs as _sxs
            metadata = _sxs.load(f"SXS:BBH:{self.ID}/Lev/metadata.json")
            self.highest_lev = int(metadata["simulation_name"][-1])
            self.level = self.highest_lev + self.lev_minus_highest
            if self.level != self.highest_lev:
                metadata = _sxs.load(
                    f"SXS:BBH:{self.ID}/Lev{self.level}/metadata.json")
            self.metadata = dict(metadata)
            data = _sxs.load(
                f"SXS:BBH:{self.ID}/Lev{self.level}/rhOverM",
                extrapolation_order=self.extrapolation_order)
            self._times = np.asarray(data.t)
            self._modes = {
                (l, m): np.asarray(data[:, data.index(l, m)])
                for l in range(2, data.ell_max + 1)
                for m in range(-l, l + 1)}
            self._ell_max_avail = data.ell_max
            return
        except ImportError:
            pass

        # Local-cache path (no network).
        import h5py

        def _lev_of(p):
            """Lev number from any path component (LevN), else None."""
            for part in p.parts:
                if part.startswith("Lev") and part[3:].lstrip("-").isdigit():
                    return int(part[3:])
            return None

        # Collect every cached metadata.json for this ID, then select
        # the level like the reference (Simulation.py:88-97): highest
        # available Lev plus lev_minus_highest -- NOT whichever sorts
        # first lexicographically.
        candidates = []
        for root in _cache_dirs():
            if not root.exists():
                continue
            candidates.extend(root.rglob(f"*{self.ID}*/**/metadata.json"))
            if candidates:
                break
        found = None
        scanned_highest = None
        if candidates:
            levs = {p: _lev_of(p) for p in candidates}
            if any(v is not None for v in levs.values()):
                scanned_highest = max(v for v in levs.values()
                                      if v is not None)
                want = scanned_highest + self.lev_minus_highest
                for p in sorted(candidates):
                    if levs[p] == want:
                        found = p
                        break
                if found is None:
                    raise FileNotFoundError(
                        f"SXS:BBH:{self.ID}: requested Lev{want} "
                        f"(highest {scanned_highest} + lev_minus_highest "
                        f"{self.lev_minus_highest}) not in cache; "
                        f"available: "
                        f"{sorted(v for v in levs.values() if v is not None)}")
            else:
                found = sorted(candidates)[0]   # no Lev structure
        if not found:
            raise FileNotFoundError(
                f"SXS:BBH:{self.ID} not found: the `sxs` package is not "
                f"installed and no local cache entry exists under "
                f"{[str(d) for d in _cache_dirs()]}. Either install `sxs` "
                f"or place the simulation's metadata.json and rhOverM h5 "
                f"files in the cache.")

        self.metadata = json.loads(found.read_text())
        # highest_lev comes from the cache SCAN when the cache has Lev
        # structure (the loaded file may deliberately be a lower level);
        # the loaded simulation_name is only a fallback.
        self.highest_lev = (scanned_highest if scanned_highest is not None
                            else int(self.metadata.get(
                                "simulation_name", "Lev0")[-1]))
        self.level = self.highest_lev + self.lev_minus_highest

        h5_candidates = list(found.parent.glob("rhOverM*.h5"))
        if not h5_candidates:
            raise FileNotFoundError(
                f"no rhOverM h5 next to {found}")
        ext = ("Extrapolated_N%d.dir" % self.extrapolation_order
               if self.extrapolation_order != -1 else "OutermostExtraction.dir")
        self._modes = {}
        with h5py.File(h5_candidates[0], "r") as f:
            if ext in f:
                grp = f[ext]
            elif any(k.startswith("Y_l") for k in f):
                grp = f                    # flat file: datasets at root
            else:
                raise KeyError(
                    f"{h5_candidates[0]}: extrapolation group {ext!r} "
                    f"not found and no Y_l* datasets at the root; "
                    f"available groups: {sorted(f.keys())}")
            for key in grp:
                if not key.startswith("Y_l"):
                    continue
                l = int(key.split("_")[1][1:])
                m = int(key.split("_")[2][1:].replace(".dat", ""))
                arr = np.asarray(grp[key])
                self._times = arr[:, 0]
                self._modes[(l, m)] = arr[:, 1] + 1j * arr[:, 2]
        self._ell_max_avail = max(l for (l, m) in self._modes)

    # -- reference-equivalent steps -------------------------------------------

    def load_metadata(self):
        """Extract simulation metadata (reference Simulation.py:155-241)."""
        md = self.metadata
        self.reference_time = md["reference_time"]
        self.m1 = md["reference_mass1"]
        self.m2 = md["reference_mass2"]
        self.M = self.m1 + self.m2
        if abs(self.M - 1) >= 1e-3:
            raise ValueError("total mass M not close to one")

        self.chi1 = np.array(md["reference_dimensionless_spin1"])
        self.chi2 = np.array(md["reference_dimensionless_spin2"])
        self.r1 = np.array(md["reference_position1"])
        self.r1_mag = np.linalg.norm(self.r1)
        self.r2 = np.array(md["reference_position2"])
        self.r2_mag = np.linalg.norm(self.r2)
        self.omega_ref = np.array(md["reference_orbital_frequency"])
        self.common_horizon_time = md["common_horizon_time"]
        self.Norbits = md["number_of_orbits"]

        self.Mf = md["remnant_mass"]
        self.chif = np.array(md["remnant_dimensionless_spin"])
        self.chif_mag = np.linalg.norm(self.chif)
        # Zero-magnitude remnant spin: the reference divides 0/0 and
        # NaNs thetaf/phif (Simulation.py:178-181); use the same
        # already-aligned convention as rotate_modes (base.py).
        if self.chif_mag > 0:
            chif_norm = self.chif / self.chif_mag
            self.thetaf = np.arccos(chif_norm[2])
            self.phif = np.arctan2(chif_norm[1], chif_norm[0])
        else:
            self.thetaf = 0.0
            self.phif = 0.0
        self.vf = np.array(md["remnant_velocity"])

        # Derived properties (Simulation.py:202-241).
        self.com = self.m1 * self.r1 + self.m2 * self.r2
        self.q = self.m1 / self.m2
        A1 = 2 + 3 / (2 * self.q)
        A2 = 2 + 1.5 * self.q
        self.L = (self.m1 * self.r1_mag ** 2
                  + self.m2 * self.r2_mag ** 2) * self.omega_ref
        self.L_norm = self.L / np.linalg.norm(self.L)
        self.S1_perp = self.m1 ** 2 * np.linalg.norm(
            np.cross(self.chi1, self.L_norm))
        self.S2_perp = self.m2 ** 2 * np.linalg.norm(
            np.cross(self.chi2, self.L_norm))
        self.chi1_para = np.dot(self.chi1, self.L_norm)
        self.chi2_para = np.dot(self.chi2, self.L_norm)
        self.chi_eff = (self.m1 * self.chi1_para
                        + self.m2 * self.chi2_para) / self.M
        self.Sp = 0.5 * (A1 * self.S1_perp + A2 * self.S2_perp
                         + abs(A1 * self.S1_perp - A2 * self.S2_perp))
        self.chip = self.Sp / (A1 * self.m1 ** 2)
        self.Sf = self.chif * self.Mf ** 2

    def load_data(self):
        """Truncate to the last ~10 orbits and fill the mode dictionary
        (reference Simulation.py:244-290)."""
        h22 = self._modes[(2, 2)]
        if self.Norbits > 10:
            peak_region = h22.real[: np.argmax(np.abs(h22))]
            peak_indices = _signal.find_peaks(peak_region)[0]
            mask_start = peak_indices[-20:][0]
        else:
            mask_start = 0

        self.times = self._times[mask_start:].copy()
        if self.ellMax is None:
            self.ellMax = self._ell_max_avail
        self.h = {}
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                self.h[l, m] = self._modes[(l, m)][mask_start:]

    def print_metadata(self):
        """Tabulated summary (reference Simulation.py:293-306)."""
        from tabulate import tabulate
        print(tabulate([
            ["chi1", self.chi1], ["chi2", self.chi2], ["Mf", self.Mf],
            ["chif", self.chif], ["vf", self.vf], ["q", self.q],
            ["chi_eff", self.chi_eff], ["chip", self.chip]]))
