"""Analysis windows as {0,1} weights on the full time grid, and their
trapezoid weights (port of qnmfits_tpu/ops/windows.py).

All three broadcast: ``times`` may be (K,) against t0/T of shape (B, 1)
to give (B, K) windows, and ``trapz_weights`` works along the last axis.
"""

from __future__ import annotations

import torch

__all__ = ["window_geq", "window_closest", "trapz_weights"]


def window_geq(times, t0, T):
    """{0,1} weights for t0_method='geq': t0 <= t < t0 + T
    (reference qnmfits.py:233)."""
    return ((times >= t0) & (times < t0 + T)).to(times.dtype)


def window_closest(times, t0, T):
    """{0,1} weights for t0_method='closest': sample index closest to t0
    up to (exclusive) the index closest to t0 + T, first index winning
    ties (reference qnmfits.py:240-243).  times (K,), t0/T scalars or
    (..., 1).  The scores keep the association fl((fl(t - t0) - T)^2),
    which the dedup keys of ``batched._window_dedup_closest`` reproduce."""
    k0 = torch.argmin((times - t0) ** 2, dim=-1, keepdim=True)
    k1 = torch.argmin((times - t0 - T) ** 2, dim=-1, keepdim=True)
    idx = torch.arange(times.shape[0], device=times.device)
    return ((idx >= k0) & (idx < k1)).to(times.dtype)


def trapz_weights(times, w):
    """Trapezoid weights of the masked contiguous subarray: sum_k
    tau_k y_k equals np.trapezoid(y[sel], times[sel]) for a contiguous
    {0,1} mask w (..., K)."""
    dt = times[1:] - times[:-1]
    seg = w[..., :-1] * w[..., 1:] * dt * 0.5
    zero = torch.zeros(seg.shape[:-1] + (1,), dtype=seg.dtype,
                       device=seg.device)
    return torch.cat([seg, zero], dim=-1) + torch.cat([zero, seg], dim=-1)
