"""NumPy oracle for multimode ringdown fits (port of the multimode part of
qnmfits_tpu/ref_impl.py).

Masked design matrices a[k, j] = exp(-i w_j (t_k - t0)), LAPACK SVD least
squares (np.linalg.lstsq, rcond=None) and trapezoid mismatches, as the
reference fitting engine computes them (qnmfits.py:478-673).  Frequencies
and mixing coefficients come from ``engine.SpectrumEvaluator``.  It shares
no code with the sweep it checks beyond the spectrum.
"""

from __future__ import annotations

import numpy as np

from .engine import SpectrumEvaluator

__all__ = ["multimode_ringdown_fit", "multimode_mismatch"]


def _trapz(y, x):
    return np.trapezoid(y, x=x)


def multimode_mismatch(times, wf_dict_1, wf_dict_2):
    """Sky-averaged mismatch over the keys of wf_dict_1
    (reference qnmfits.py:100-139)."""
    keys = list(wf_dict_1.keys())
    num = np.real(sum(_trapz(wf_dict_1[k] * np.conj(wf_dict_2[k]), times)
                      for k in keys))
    n1 = sum(_trapz(np.real(wf_dict_1[k] * np.conj(wf_dict_1[k])), times)
             for k in keys)
    n2 = sum(_trapz(np.real(wf_dict_2[k] * np.conj(wf_dict_2[k])), times)
             for k in keys)
    return 1 - num / np.sqrt(n1 * n2)


def mask_times(times, t0, T, t0_method):
    """Index selection of the analysis window (reference
    qnmfits.py:230-248)."""
    times = np.asarray(times)
    if t0_method == "geq":
        return np.where((times >= t0) & (times < t0 + T))[0]
    if t0_method == "closest":
        start = int(np.argmin((times - t0) ** 2))
        end = int(np.argmin((times - t0 - T) ** 2))
        return np.arange(start, end)
    raise ValueError(
        "t0_method must be 'geq' or 'closest', got " + repr(t0_method))


def _design_matrix(times, t0, frequencies):
    """a[k, j] = exp(-i w_j (t_k - t0)) (reference qnmfits.py:280-283)."""
    dt = np.asarray(times)[:, None] - t0
    return np.exp(-1j * np.asarray(frequencies)[None, :] * dt)


def _lstsq(a, d):
    C, res, rank, sv = np.linalg.lstsq(a, d, rcond=None)
    return C, res, rank, sv


def multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                           t0_method="geq", T=100, spherical_modes=None):
    """Joint fit across spherical-harmonic modes with shared amplitudes
    weighted by mixing coefficients (reference qnmfits.py:478-673)."""
    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())
    idx = mask_times(times, t0, T, t0_method)
    tm = np.asarray(times)[idx]
    masked = {lm: np.asarray(data_dict[lm])[idx] for lm in spherical_modes}
    d = np.concatenate([masked[lm] for lm in spherical_modes])

    ev = SpectrumEvaluator(modes, spherical_modes)
    frequencies = ev.omega(chif, Mf)
    mu_rows = ev.mu(chif)                                # (I, J)

    decay = _design_matrix(tm, t0, frequencies)          # (K, J)
    a = np.concatenate([mu[None, :] * decay for mu in mu_rows])

    C, res, rank, sv = _lstsq(a, d)
    model = a @ C

    K = len(tm)
    model_dict = {lm: model[i * K:(i + 1) * K]
                  for i, lm in enumerate(spherical_modes)}
    return {
        "residual": res,
        "mismatch": multimode_mismatch(tm, model_dict, masked),
        "C": C, "data": masked, "model": model_dict, "model_times": tm,
        "t0": t0, "modes": modes, "frequencies": frequencies,
    }
