"""Complex exponentials from real primitives (port of
qnmfits_tpu/ops/cmath.py).

The JAX module builds them from real exp/cos/sin because its TPU backend
had no complex transcendentals; the port keeps the same formulas so the
two packages round alike.  Callers pass the window-clamped time offset
(t - t0) * w, so a sample outside the window gets phase 1 and a
backward-in-time exponential never overflows.
"""

from __future__ import annotations

import torch

__all__ = ["cexp", "damped_phase"]


def cexp(z):
    """exp(z) for complex z via real exp/cos/sin."""
    mag = torch.exp(z.real)
    return torch.complex(mag * torch.cos(z.imag), mag * torch.sin(z.imag))


def damped_phase(omega, dt):
    """exp(-i omega dt) for complex omega and real dt (broadcasting):
    e^{Im(omega) dt} (cos(Re(omega) dt) - i sin(Re(omega) dt))."""
    mag = torch.exp(omega.imag * dt)
    ph = omega.real * dt
    return torch.complex(mag * torch.cos(ph), -mag * torch.sin(ph))
