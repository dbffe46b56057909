"""Waveform base class: fluxes, frame transforms, time evolution (port of
qnmfits_tpu/waveforms/base.py; host NumPy and scipy, as there).

The reference's L2 base machinery (qnmfits/Waveforms/Base.py) on the
port's own harmonics (``qnmfits_tpu_torch.harmonics``), with the same
``scipy.interpolate`` calls as the JAX package, so the arrays agree with
it to rounding:

* hdot via interpolating-spline derivatives (Base.py:18-36);
* energy/angular-momentum fluxes from arXiv:0707.4654 Eqs. (3.8),
  (3.22-3.24), integrated BACKWARD from the final (Mf, chif)
  (Base.py:52-134);
* time_shift anchors (float / mode-peak / 'norm' / 'Edot' /
  'common_horizon', Base.py:140-176);
* static and time-dependent Wigner-D mode rotations (Base.py:179-263);
* frequency evolution by phase derivative or zero crossings
  (Base.py:269-349);
* sky projection h(theta, phi) = sum h_lm sYlm (Base.py:355-389).

Every container runs the same pipeline (``_process``) and keeps the host
seconds of each of its stages in ``stage_seconds``.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.interpolate import InterpolatedUnivariateSpline as _spline

from ..harmonics import (
    quat_from_axis_angle,
    quat_from_spherical,
    rotate_mode_dict,
    sYlm,
)

_TRANSFORMS = {"rotation": "rotate_modes",
               "dynamic_rotation": "rotate_modes_over_time"}


class BaseWaveform:
    """Shared methods for all waveform containers."""

    # -- pipeline ------------------------------------------------------------

    def _stage(self, name, fn):
        """fn(), its host seconds added to ``stage_seconds[name]``."""
        t = time.perf_counter()
        fn()
        seconds = self.__dict__.setdefault("stage_seconds", {})
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t

    def _process(self, transform):
        """The standard processing (reference Custom.py:69-103): the
        frame-independent fluxes, the time shift, the frame transforms in
        order ('rotation', 'dynamic_rotation'; None and 'boost' do
        nothing), then the frequency evolution."""
        self._stage("hdot", self.calculate_hdot)
        self._stage("Moft", self.calculate_Moft)
        self._stage("chioft", self.calculate_chioft)
        self._stage("time_shift", self.time_shift)
        if not isinstance(transform, list):
            transform = [transform]
        for transformation in transform:
            if transformation in _TRANSFORMS:
                self._stage(transformation,
                            getattr(self, _TRANSFORMS[transformation]))
            elif transformation not in (None, "boost"):
                raise ValueError(
                    f"unknown transformation: {transformation!r}")
        self._stage("foft", self.calculate_foft)

    # -- flux quantities ---------------------------------------------------

    def calculate_hdot(self):
        """Mode time-derivatives via spline differentiation
        (reference Base.py:18-36)."""
        self.hdot = {}
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                data = self.h[l, m]
                self.hdot[l, m] = (
                    _spline(self.times, data.real).derivative()(self.times)
                    + 1j * _spline(self.times,
                                   data.imag).derivative()(self.times))

    def hdot_lm(self, l, m):
        """Zero-safe mode-derivative accessor (reference Base.py:39-49)."""
        if l < 2 or l > self.ellMax or m < -l or m > l:
            return np.zeros_like(self.times, dtype=complex)
        return self.hdot[l, m]

    def calculate_Moft(self):
        """Remnant mass evolution from the energy flux, integrated
        backward from Mf (arXiv:0707.4654 Eq. 3.8; reference
        Base.py:52-72)."""
        self.Edot = np.zeros_like(self.times)
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                self.Edot += np.abs(self.hdot[l, m]) ** 2 / (16 * np.pi)
        Eint = _spline(self.times, self.Edot).antiderivative()
        self.Moft = self.Mf + (Eint(self.times[-1]) - Eint(self.times))

    def calculate_chioft(self):
        """Remnant spin evolution from the angular-momentum flux
        (arXiv:0707.4654 Eqs. 3.22-3.24; reference Base.py:75-134)."""
        def flm(l, m):
            return np.sqrt(l * (l + 1) - m * (m + 1))

        Jxdot = np.zeros_like(self.times)
        Jydot = np.zeros_like(self.times)
        Jzdot = np.zeros_like(self.times)
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                h = self.h[l, m]
                term_p = flm(l, m) * np.conj(self.hdot_lm(l, m + 1))
                term_m = flm(l, -m) * np.conj(self.hdot_lm(l, m - 1))
                Jxdot += np.imag(h * (term_p + term_m)) / (32 * np.pi)
                Jydot += -np.real(h * (term_p - term_m)) / (32 * np.pi)
                Jzdot += np.imag(m * h * np.conj(self.hdot_lm(l, m))) \
                    / (16 * np.pi)

        self.Jdot = np.stack([Jxdot, Jydot, Jzdot], axis=1)
        chidot = self.Jdot / (self.Moft ** 2)[:, None]
        chioft = []
        for i in range(3):
            chiint = _spline(self.times, chidot[:, i]).antiderivative()
            chioft.append(self.chif[i]
                          + (chiint(self.times[-1]) - chiint(self.times)))
        self.chioft = np.stack(chioft, axis=1)
        self.chioft_mag = np.linalg.norm(self.chioft, axis=1)

    # -- frame handling ------------------------------------------------------

    def time_shift(self):
        """Anchor t=0 by the requested method (reference Base.py:140-176).

        zero_time=None means no shift (the reference would crash on
        `times - None`, a fall-through for NRHybSur3dq8's default
        arguments, Surrogate.py:288; PARITY.md lists the delta)."""
        if self.zero_time is None:
            self.zero_time = 0.0
            self.zero_time_method = "Simulation default"
        elif (isinstance(self.zero_time, (int, float))
              and not isinstance(self.zero_time, bool)):
            # int included: the classes' default zero_time=0 is an int,
            # which the reference's `type(...) is float` check misses,
            # leaving zero_time_method unset on the most common path.
            self.zero_time_method = ("Simulation default"
                                     if self.zero_time == 0
                                     else "User defined")
        elif isinstance(self.zero_time, tuple):
            self.zero_time_method = f"{self.zero_time} peak"
            amp = np.abs(self.h[self.zero_time])
            self.zero_time = self.times[np.argmax(amp)]
        elif self.zero_time == "norm":
            self.zero_time_method = "Norm peak"
            amp2 = np.zeros_like(self.times)
            for l in range(2, self.ellMax + 1):
                for m in range(-l, l + 1):
                    amp2 += np.abs(self.h[l, m]) ** 2
            self.zero_time = self.times[np.argmax(np.sqrt(amp2))]
        elif self.zero_time == "Edot":
            self.zero_time_method = "Edot peak"
            self.zero_time = self.times[np.argmax(self.Edot)]
        elif self.zero_time == "common_horizon":
            self.zero_time_method = "Common horizon"
            self.zero_time = self.common_horizon_time
        self.times = self.times - self.zero_time

    def rotate_modes(self):
        """Rotate to the frame with z parallel to the final spin, via a
        single axis-angle rotation (reference Base.py:179-222).

        A spin exactly along +/-z makes cross([0,0,1], chif) vanish;
        the reference then divides 0/0 and silently NaNs every mode.
        Here +z is a no-op and -z rotates by pi about x."""
        rot = np.cross([0, 0, 1], self.chif)
        nrm = np.linalg.norm(rot)
        # max(chif_mag, 1) keeps the guard live for a zero-magnitude
        # spin (nrm == chif_mag == 0 would otherwise fall through to
        # 0/0); zero spin counts as already aligned.
        if nrm <= 1e-14 * max(self.chif_mag, 1.0):
            if self.chif[2] >= 0:         # already aligned (or zero spin)
                self.chif = np.array([0, 0, self.chif_mag])
                return
            rot = np.array([np.pi, 0.0, 0.0])   # anti-aligned: flip
            nrm = np.pi
        rot = self.thetaf * rot / nrm
        q = quat_from_axis_angle(rot)
        self.h = rotate_mode_dict(self.h, q, self.ellMax)
        self.chif = np.array([0, 0, self.chif_mag])
        self.calculate_hdot()

    def rotate_modes_over_time(self):
        """Rotate to the frame with z parallel to the instantaneous spin
        (reference Base.py:225-263).

        Samples with (numerically) zero spin magnitude get the identity
        rotation instead of the reference's 0/0 NaN (same guard family
        as rotate_modes' aligned-spin fix)."""
        mag = self.chioft_mag[:, None]
        safe = np.where(mag > 1e-14, mag, 1.0)
        chin = np.where(mag > 1e-14, self.chioft / safe,
                        np.array([0.0, 0.0, 1.0]))
        theta_t = np.arccos(np.clip(chin[:, 2], -1.0, 1.0))
        phi_t = np.arctan2(chin[:, 1], chin[:, 0])
        q_t = quat_from_spherical(theta_t, phi_t)   # (K, 4)
        self.h = rotate_mode_dict(self.h, q_t, self.ellMax)
        self.calculate_hdot()

    # -- time evolution -------------------------------------------------------

    def calculate_foft(self, method="phase_derivative"):
        """Per-mode frequency evolution in cycles/M
        (reference Base.py:269-349)."""
        self.foft = {}
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                data = self.h[l, m]
                if method == "phase_derivative":
                    phase = np.unwrap(np.angle(data))
                    phasedot = _spline(self.times,
                                       phase).derivative()(self.times)
                    self.foft[l, m] = np.abs(phasedot) / (2 * np.pi)
                elif method == "zero_crossings":
                    self.foft[l, m] = {}
                    for name, comp in (("plus", data.real),
                                       ("cross", -data.imag)):
                        roots = _spline(self.times, comp).roots()
                        Toft = 2 * np.diff(roots)
                        mids = 0.5 * (roots[:-1] + roots[1:])
                        self.foft[l, m][name] = np.stack(
                            [mids, 1.0 / Toft], axis=1)
                else:
                    raise ValueError(f"unknown foft method: {method}")

    # -- helpers -----------------------------------------------------------

    def project_signal(self, theta, phi):
        """h(theta, phi) = sum_lm h_lm sYlm (reference Base.py:355-389)."""
        signal = np.zeros_like(self.times, dtype=complex)
        for l in range(2, self.ellMax + 1):
            for m in range(-l, l + 1):
                signal += self.h[l, m] * sYlm(-2, l, m, theta, phi)
        return signal
