"""Public fitting entry points (port of qnmfits_tpu/fitting.py; this slice
ports ``mismatch_t0_mode_sets``)."""

from __future__ import annotations

from .batched import batch_mismatch_t0_modesets

__all__ = ["mismatch_t0_mode_sets"]


def mismatch_t0_mode_sets(times, data, mode_sets, Mf, chif, t0_array,
                          T_array=100, *, t0_method="geq",
                          spherical_modes=None, return_amplitudes=False,
                          dedup=True, device="cuda"):
    """Mismatch vs start time for many mode sets in one sweep
    (fitting.py:309): the reference's doubly nested loop over mode sets
    and start times (qnmfits.py:1183-1301 per set).

    mode_sets: list of mode lists (ragged lengths are padded with
    exact-zero amplitude slots); t0_array sorted ascending; scalar Mf and
    chif; t0_method='geq'.  dedup=True solves each distinct window once
    (exact for static spectra).  Runs on ``device`` ("cuda" by default,
    raising when there is none; "cpu" runs the plain PyTorch path).
    Returns mm (S, B); with return_amplitudes=True also a list of
    per-set complex (B, len(mode_set)) amplitude arrays.
    """
    return batch_mismatch_t0_modesets(
        times, data, mode_sets, Mf, chif, t0_array, T_array=T_array,
        spherical_modes=spherical_modes, return_amplitudes=return_amplitudes,
        t0_method=t0_method, dedup=dedup, device=device)
