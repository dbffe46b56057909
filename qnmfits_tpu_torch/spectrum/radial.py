"""Leaver continued-fraction solver for Kerr quasinormal frequencies, on
complex128 tensors (port of qnmfits_tpu/spectrum/radial.py).

Solves the radial Teukolsky equation's QNM boundary-value problem with
Leaver's (1985) three-term-recurrence continued fraction; the angular
separation constant A comes from the spectral solver
(``spectrum/angular.py``, batched in ``spectrum/solver.py``).

Units: the public API uses M = 1 (spin chi in [0, 1), frequency M omega);
the CF uses Leaver's 2M = 1 convention, a_L = chi / 2, omega_L =
2 M omega.

The tail is started at depth N from the Nollert (1993)-style expansion of
the minimal-solution ratio r_n = a_{n+1} / a_n ~ 1 + u n^{-1/2} + v n^{-1},
u = -sqrt(-2 i b omega_L) (Re u <= 0), v = (u^2 + 1/2 + G1 - A1) / 2, and
recursed downward.

The CF itself is ``ops/cf_cuda.leaver_cf``: the CUDA kernel
``csrc/leaver_cf.cu`` for tensors on the card, its plain versions
(``cf_parts``, with ``leaver_coeffs``, and ``cf_dd``) for tensors on the
CPU; in double-double beyond chi = ``cf_cuda.CHI_EXTENDED``.
"""

from __future__ import annotations

import torch

from ..ops.cf_cuda import leaver_cf, leaver_coeffs  # noqa: F401

__all__ = ["leaver_coeffs", "radial_cf", "solve_omega"]


def radial_cf(omega, a: float, A, s: int, m: int, n_inv: int,
              N: int = 4000):
    """The n_inv-times-inverted Leaver continued fraction at a scalar spin
    ``a`` (Leaver units); ``omega``/``A`` complex tensors of one shape,
    recursed in lockstep on their device (one kernel launch on the card).
    A zero in omega is the QNM of overtone n_inv."""
    omega = torch.as_tensor(omega, dtype=torch.complex128)
    shape = omega.shape
    A = torch.as_tensor(A, dtype=torch.complex128, device=omega.device)
    f = leaver_cf(omega.reshape(-1).contiguous(), float(a),
                  A.broadcast_to(shape).reshape(-1), s, m, n_inv, N)
    return f.reshape(shape)


def solve_omega(omega_guess, a: float, s: int, m: int, n_inv: int,
                A_fn, N: int = 4000, tol: float = 1e-12, maxiter: int = 50,
                device="cuda"):
    """Newton-solve the radial CF for omega (Leaver units) on ``device``,
    with A re-evaluated each step by ``A_fn(omega)`` (a tensor of omega's
    shape).  ``omega_guess`` a complex or a (B,) tensor, each element
    frozen once its step is below tol.  Returns (omega, A, converged)."""
    scalar_in = not torch.is_tensor(omega_guess) or omega_guess.dim() == 0
    omega = torch.atleast_1d(torch.as_tensor(
        omega_guess, dtype=torch.complex128,
        device=torch.device(device))).clone()
    active = torch.ones(omega.shape, dtype=torch.bool, device=omega.device)
    A = A_fn(omega)

    h = 1e-8
    for _ in range(maxiter):
        f0 = radial_cf(omega, a, A, s, m, n_inv, N)
        # The CF is analytic: one real-direction difference gives the
        # complex derivative.
        f1 = radial_cf(omega + h, a, A_fn(omega + h), s, m, n_inv, N)
        df = (f1 - f0) / h
        step = torch.where(df != 0, f0 / torch.where(df != 0, df, 1.0), 0.0)
        # Cap steps to avoid jumping basins.
        step_mag = step.abs()
        cap = 0.1 * torch.clamp(omega.abs(), min=0.1)
        step = torch.where(step_mag > cap, step * cap / torch.where(
            step_mag == 0, 1.0, step_mag), step)
        omega = torch.where(active, omega - step, omega)
        A = A_fn(omega)
        active &= ~(step.abs() < tol * torch.clamp(omega.abs(), min=1.0))
        if not bool(active.any()):
            break

    converged = ~active
    if scalar_in:
        return complex(omega[0]), complex(A.reshape(-1)[0]), \
            bool(converged[0])
    return omega, A, converged
