"""Spin-weighted spherical harmonics, Wigner D matrices and 3j symbols
(port of qnmfits_tpu/harmonics.py; NumPy and scipy, as there).

Self-contained replacements for the `spherical` + `quaternionic` packages
the reference depends on (used in the reference's qnmfits/Waveforms/
Base.py:179-263, 355-389 and spatial_mapping_functions.py:659-725).

Conventions (the JAX package's tests/test_harmonics.py validates them,
and tests/test_torch_spatial.py holds this copy to that module):
* Wigner d via the standard explicit sum (log-factorial form, stable for
  the l <= ~16 used here);
* D^l_{m',m}(R) = exp(-i m' alpha) d^l_{m',m}(beta) exp(-i m gamma) for
  the z-y-z Euler angles of the rotor R;
* sYlm (Goldberg et al.):
      sYlm(theta, phi) = (-1)^s sqrt((2l+1)/4pi) d^l_{m,-s}(theta)
                          e^{i m phi};
* mode rotation: h'_{lm} = sum_{m'} D^l_{m',m}(R) h_{lm'} such that the
  projected strain transforms as a scalar field on the sphere (the same
  contraction as reference Base.py:206-213).

All evaluators are host NumPy: the spatial mapping contracts their sky
grids with one matrix product (spatial_engine.sky_sum).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy.special import gammaln


def _logfact(n):
    return gammaln(np.asarray(n, dtype=float) + 1.0)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) -- minimal rotor utilities
# ---------------------------------------------------------------------------

def quat_from_spherical(theta, phi):
    """Rotor R = Rz(phi) Ry(theta) mapping z-hat to the direction
    (theta, phi); matches quaternionic.array.from_spherical_coordinates."""
    theta = np.asarray(theta, float)
    phi = np.asarray(phi, float)
    ct, st = np.cos(theta / 2), np.sin(theta / 2)
    cp, sp = np.cos(phi / 2), np.sin(phi / 2)
    # q_z(phi) * q_y(theta)
    return np.stack([cp * ct, -sp * st, cp * st, sp * ct], axis=-1)


def quat_from_axis_angle(vec):
    """Rotor for rotation by |vec| about vec/|vec| (axis-angle), matching
    quaternionic.array.from_axis_angle."""
    vec = np.asarray(vec, float)
    angle = np.linalg.norm(vec)
    if angle == 0:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = vec / angle
    return np.concatenate([[np.cos(angle / 2)],
                           np.sin(angle / 2) * axis])


def quat_to_euler_zyz(q):
    """z-y-z Euler angles (alpha, beta, gamma) of rotor(s) q (..., 4)."""
    q = np.asarray(q, float)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    beta = 2.0 * np.arctan2(np.hypot(x, y), np.hypot(w, z))
    a_plus = np.arctan2(z, w)
    a_minus = np.arctan2(-x, y)
    alpha = a_plus + a_minus
    gamma = a_plus - a_minus
    return alpha, beta, gamma


# ---------------------------------------------------------------------------
# Wigner d / D
# ---------------------------------------------------------------------------

@lru_cache(maxsize=4096)
def _d_terms(l: int, mp: int, m: int):
    """Precompute the k-sum terms of d^l_{mp,m}: (signs*weights, powers)."""
    k_min = max(0, m - mp)
    k_max = min(l + m, l - mp)
    ks = np.arange(k_min, k_max + 1)
    logw = 0.5 * (_logfact(l + m) + _logfact(l - m)
                  + _logfact(l + mp) + _logfact(l - mp))
    logden = (_logfact(l + m - ks) + _logfact(ks)
              + _logfact(l - mp - ks) + _logfact(mp - m + ks))
    w = (-1.0) ** (mp - m + ks) * np.exp(logw - logden)
    cos_pow = 2 * l + m - mp - 2 * ks
    sin_pow = mp - m + 2 * ks
    return w, cos_pow, sin_pow


def wigner_d(l: int, mp: int, m: int, beta):
    """Wigner small-d matrix element d^l_{mp,m}(beta); beta array-ok."""
    beta = np.asarray(beta, float)
    w, cos_pow, sin_pow = _d_terms(l, mp, m)
    c = np.cos(beta / 2.0)[..., None]
    s = np.sin(beta / 2.0)[..., None]
    return np.sum(w * c ** cos_pow * s ** sin_pow, axis=-1)


def wigner_D(l: int, mp: int, m: int, q):
    """Wigner D^l_{mp,m}(R) for rotor(s) q (..., 4)."""
    alpha, beta, gamma = quat_to_euler_zyz(q)
    return (np.exp(-1j * mp * alpha) * wigner_d(l, mp, m, beta)
            * np.exp(-1j * m * gamma))


def sYlm(s: int, l: int, m: int, theta, phi):
    """Spin-weighted spherical harmonic (Goldberg convention)."""
    if l < max(abs(s), abs(m)):
        return np.zeros(np.broadcast(np.asarray(theta),
                                     np.asarray(phi)).shape)
    theta = np.asarray(theta, float)
    phi = np.asarray(phi, float)
    pref = (-1.0) ** s * np.sqrt((2 * l + 1) / (4 * np.pi))
    return pref * wigner_d(l, m, -s, theta) * np.exp(1j * m * phi)


def sYlm_matrix(s: int, l_max: int, theta, phi, l_min: int | None = None):
    """All sYlm for l in [l_min, l_max], m in [-l, l], stacked on the last
    axis in (l, m) lexicographic order.  For batched sky-grid einsums."""
    if l_min is None:
        l_min = abs(s)
    cols = [sYlm(s, l, m, theta, phi)
            for l in range(l_min, l_max + 1) for m in range(-l, l + 1)]
    return np.stack(cols, axis=-1)


def Yindex(l: int, m: int, l_min: int) -> int:
    """Column index of (l, m) in sYlm_matrix."""
    return sum(2 * lp + 1 for lp in range(l_min, l)) + (m + l)


def rotate_mode_dict(h: dict, q, ellMax: int) -> dict:
    """Rotate a {(l, m): h_lm} dictionary by rotor q:

        h'_{lm} = sum_{m'} conj(D^l_{m',m}(q)) h_{lm'},

    which satisfies h'(n) = sum h'_lm sYlm(n) = h(R n): the new frame's
    z-axis points along R(z-hat), matching the reference's rotate_modes
    semantics ("z parallel to the remnant spin", Base.py:179-222; the
    conjugation absorbs the `spherical` package's D convention).  q may
    be a single rotor or per-time rotors (K, 4)."""
    out = {}
    for l in range(2, ellMax + 1):
        D = np.stack([[wigner_D(l, mp, m, q) for m in range(-l, l + 1)]
                      for mp in range(-l, l + 1)])   # (2l+1, 2l+1[, K])
        D = np.conj(D)
        for mi, m in enumerate(range(-l, l + 1)):
            acc = 0
            for mpi, mp in enumerate(range(-l, l + 1)):
                acc = acc + D[mpi, mi] * h[l, mp]
            out[l, m] = acc
    return out


# ---------------------------------------------------------------------------
# Wigner 3j
# ---------------------------------------------------------------------------

@lru_cache(maxsize=65536)
def wigner_3j(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """Wigner 3j symbol via the Racah sum (exact to double precision for
    the moderate j used here).  Replaces spherical.Wigner3j
    (reference spatial_mapping_functions.py:15)."""
    if m1 + m2 + m3 != 0:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0

    log_delta = 0.5 * (_logfact(j1 + j2 - j3) + _logfact(j1 - j2 + j3)
                       + _logfact(-j1 + j2 + j3)
                       - _logfact(j1 + j2 + j3 + 1))
    log_pref = 0.5 * (_logfact(j1 + m1) + _logfact(j1 - m1)
                      + _logfact(j2 + m2) + _logfact(j2 - m2)
                      + _logfact(j3 + m3) + _logfact(j3 - m3))

    k_min = max(0, j2 - j3 - m1, j1 - j3 + m2)
    k_max = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    total = 0.0
    for k in range(k_min, k_max + 1):
        log_den = (_logfact(k) + _logfact(j1 + j2 - j3 - k)
                   + _logfact(j1 - m1 - k) + _logfact(j2 + m2 - k)
                   + _logfact(j3 - j2 + m1 + k) + _logfact(j3 - j1 - m2 + k))
        total += (-1.0) ** k * np.exp(log_delta + log_pref - log_den)
    return float((-1.0) ** (j1 - j2 - m3) * total)
