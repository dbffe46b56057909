"""Amplitude-stability diagnostics over the fit start time (port of
qnmfits_tpu/stability.py).

A QNM present in ringdown data has a fit amplitude that, rephased to a
common reference time, is constant in the start time t0: the per-window
amplitude C_j(t0), anchored at its own t0, satisfies A_j = C_j(t0)
e^{i w_j (t0 - t_ref)}.  The sweep runs on the port's start-time sweep
(``batched.batch_mismatch_t0`` with amplitudes and window dedup, one
solve launch on the card); the statistics are O(B J) host algebra.

Rephasing to t_ref multiplies C_j(t0) by e^{|Im w_j| (t0 - t_ref)}, so a
decayed mode's fit noise grows late in the ringdown: read the scatter
statistics over the plateau where the mode is live.
"""

from __future__ import annotations

import numpy as np

from .spectrum.tables import solves_on_device

__all__ = ["amplitude_stability"]


@solves_on_device
def amplitude_stability(times, data, modes, Mf, chif, t0_array,
                        t_ref=None, *, t0_method="geq", T_array=100,
                        spherical_modes=None, delta=0.0,
                        precision="x64", dedup=True, device="cuda",
                        solve=None):
    """Rephased QNM amplitudes and their stability over a t0 sweep
    (stability.py:35).

    times/data/modes/Mf/chif/t0_method/T_array/spherical_modes/delta: as
    ``mismatch_t0_array`` (array data one series, dict data multimode).
    The spectrum must be static (scalar Mf/chif).  t_ref is the common
    reference time, min(t0_array) by default.  ``solve`` substitutes the
    batched Hermitian solve.

    Returns a dict: omega (J,), modes (canonical), t0s (B,), mm (B,), C
    (B, J) raw amplitudes each anchored at its own t0, A (B, J) = C
    exp(i w (t0 - t_ref)), mean_A (J,), rel_std (J,) = std|A_j| /
    mean|A_j|, scatter (J,) = sqrt(mean |A_j - mean_A_j|^2) / |mean_A_j|,
    phase_std (J,), the circular standard deviation of arg A_j.  A mode
    with zero amplitude everywhere reads inf in the relative measures.
    """
    if np.ndim(Mf) != 0 or np.ndim(chif) != 0:
        raise ValueError(
            "amplitude_stability needs a static (scalar Mf/chif) "
            "spectrum: a time-dependent w_j(t) admits no exact "
            "amplitude rephasing between start times")
    from .batched import _canon, _spectrum, batch_mismatch_t0
    from .engine import check_spin
    from .fitting import _check_precision

    _check_precision(precision)
    check_spin(chif)
    t0s = np.asarray(t0_array, float)
    if t0s.ndim != 1 or t0s.size == 0:
        raise ValueError("t0_array must be a non-empty 1-D array")
    canon = list(_canon(modes))

    mm, C = batch_mismatch_t0(
        times, data, canon, Mf, chif, t0s, t0_method=t0_method,
        T_array=T_array, spherical_modes=spherical_modes, delta=delta,
        return_amplitudes=True, dedup=dedup, device=device, solve=solve)

    sph = (None if spherical_modes is None
           else tuple(tuple(m) for m in spherical_modes))
    omega, _ = _spectrum(canon, sph, Mf, chif, delta)

    if t_ref is None:
        t_ref = float(t0s.min())
    A = C * np.exp(1j * omega[None, :] * (t0s[:, None] - float(t_ref)))

    mean_A = A.mean(axis=0)
    absA = np.abs(A)
    mean_abs = absA.mean(axis=0)
    wander = np.sqrt(np.mean(np.abs(A - mean_A[None, :]) ** 2, axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_std = np.where(mean_abs > 0, absA.std(axis=0) / mean_abs,
                           np.inf)
        scatter = np.where(np.abs(mean_A) > 0, wander / np.abs(mean_A),
                           np.inf)
        # Zero-amplitude rows carry no phase: average the unit phasors
        # over the nonzero rows only.
        nz = absA > 0
        unit = np.where(nz, A / np.where(nz, absA, 1.0), 0.0 + 0.0j)
        n_nz = nz.sum(axis=0)
        resultant = np.where(
            n_nz > 0,
            np.abs(unit.sum(axis=0)) / np.maximum(n_nz, 1), 0.0)
        phase_std = np.where(resultant > 0,
                             np.sqrt(-2.0 * np.log(
                                 np.minimum(resultant, 1.0))),
                             np.inf)
    return {
        "omega": omega,
        "modes": canon,
        "t0s": t0s,
        "mm": np.asarray(mm),
        "C": C,
        "A": A,
        "mean_A": mean_A,
        "rel_std": rel_std,
        "scatter": scatter,
        "phase_std": phase_std,
    }
