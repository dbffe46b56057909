"""Orthonormal-mode ringdown analysis (port of qnmfits_tpu/orthonormal.py).

Orthonormalising the mode functions over the fit window, in the
trapezoid-weighted inner product of the mismatch (reference
qnmfits.py:73-139), gives projection coefficients whose squared
magnitudes add up: |b_j|^2 is the data power mode j explains beyond the
modes listed before it.  Gram-Schmidt in a Hermitian inner product is
the Cholesky factor of the Gram: with G = L L^H, b = L^-1 r for the data
projections r_j = <phi_j, d>.

G, r and the data norm are the trapezoid-weighted Gram, projections and
norm that ``engine.fit_systems`` builds for the mismatch (G_tau, r_tau,
data_norm), so both functions take them from there; the factor is
``torch.linalg.cholesky_ex`` and the projections a triangular solve.  No
batched regularised solve is made, so nothing here launches the CUDA
solve kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .spectrum.tables import solves_on_device

__all__ = ["orthonormal_decomposition", "orthonormal_t0_sweep"]

_DEGENERATE = (
    "the mode set is numerically degenerate on this window "
    "(tau-weighted Gram is at the f64 singularity floor); drop "
    "duplicated modes or the most-damped overtones, or widen the "
    "window")


def _systems(times, data, modes, Mf, chif, t0s, Ts, t0_method,
             spherical_modes, dev):
    """omega (J,) NumPy and the fit_systems pieces G_tau (B, J, J), r_tau
    (B, J), data_norm (B,) of the windows (t0s, Ts), built in chunks whose
    (chunk, K, J) basis stays within the port's basis budget."""
    from .batched import _BASIS_BYTES, _cplx, _prep, _real, _spectrum
    from .engine import _window, check_spin, chunk_bounds, fit_systems

    times, rows, sph = _prep(times, data, spherical_modes)
    check_spin(chif)
    omega, mu = _spectrum(modes, sph, Mf, chif, 0.0)
    if rows.shape[0] != mu.shape[0]:
        raise ValueError(
            f"data has {rows.shape[0]} spherical-mode rows but the "
            f"mixing matrix expects {mu.shape[0]}")
    tt, dd = _real(times, dev), _cplx(rows, dev)
    om, mu_t = _cplx(omega, dev), _cplx(mu, dev)
    t0_t, T_t = _real(t0s, dev), _real(Ts, dev)
    chunk = max(1, _BASIS_BYTES // (len(times) * omega.shape[0] * 16))
    parts = []
    for lo, hi in chunk_bounds(len(t0s), chunk):
        w = _window(tt, t0_t[lo:hi, None], T_t[lo:hi, None], t0_method)
        parts.append(fit_systems(tt, dd, om, mu_t, t0_t[lo:hi], w)[2:])
    G, r, dn = (torch.cat(p) for p in zip(*parts))
    return omega, G, r, dn


def _project(G, r):
    """b = L^-1 r (B, J) with L L^H = G (B, J, J); L is NaN where the
    factorisation fails, as jnp.linalg.cholesky gives."""
    L, info = torch.linalg.cholesky_ex(G)
    L = torch.where((info > 0)[:, None, None],
                    torch.full((), float("nan"), dtype=L.dtype,
                               device=L.device), L)
    return torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]


@solves_on_device
def orthonormal_decomposition(times, data, modes, Mf, chif, t0,
                              t0_method="geq", T=100,
                              spherical_modes=None, device="cuda"):
    """Project ringdown data onto window-orthonormalised QNM modes, in the
    order given (orthonormal.py:32): |b_j|^2 is the power mode j explains
    beyond modes 0..j-1.

    Arguments as ``multimode_ringdown_fit`` (dict data) /
    ``ringdown_fit`` (array data).  Returns a dict: omega (J,), C (J,) the
    least-squares amplitudes in the tau-weighted inner product, b (J,),
    power (J,) = |b_j|^2, data_norm, explained_fraction =
    sum(power) / data_norm, cumulative_explained (J,), and mismatch = 1 -
    sqrt(explained_fraction).  Raises ValueError on an empty window or a
    numerically degenerate mode set.
    """
    dev = resolve_device(device)
    omega, G, r, dn = _systems(times, data, modes, Mf, chif,
                               np.array([float(t0)]), np.array([float(T)]),
                               t0_method, spherical_modes, dev)
    data_norm = float(dn[0])
    if data_norm <= 0.0:
        raise ValueError("empty fit window: no data power under the "
                         "trapezoid weights (check t0/T)")
    L, info = torch.linalg.cholesky_ex(G)
    if int(info[0]) != 0:
        raise ValueError(_DEGENERATE)
    d = torch.diagonal(L[0]).real
    # potrf can pass an exactly singular Gram on rounding noise; a
    # diag(L) ratio of 1e-7 is a Gram condition of ~1e14.
    if not bool(torch.all(d > 1e-7 * d.max())):
        raise ValueError(_DEGENERATE)
    b = torch.linalg.solve_triangular(L[0], r[0, :, None], upper=False)
    C = torch.linalg.solve_triangular(L[0].mH, b, upper=True)[:, 0]
    b = b[:, 0].cpu().numpy()
    power = np.abs(b) ** 2
    cum = np.cumsum(power) / data_norm
    explained = float(cum[-1])
    return {
        "omega": omega,
        "C": C.cpu().numpy(),
        "b": b,
        "power": power,
        "data_norm": data_norm,
        "explained_fraction": explained,
        "cumulative_explained": cum,
        "mismatch": 1.0 - float(np.sqrt(max(explained, 0.0))),
    }


@solves_on_device
def orthonormal_t0_sweep(times, data, modes, Mf, chif, t0_array,
                         t0_method="geq", T_array=100,
                         spherical_modes=None, device="cuda"):
    """``orthonormal_decomposition``'s per-mode powers over a t0 axis
    (orthonormal.py:172), every window's factor in one batched call.

    Returns a dict of arrays over the (B,) axis: power (B, J),
    cumulative_explained (B, J), explained_fraction (B,), mismatch (B,),
    data_norm (B,), and ok (B,), False where the mode set is numerically
    degenerate on that window (the factor is NaN there instead of the
    single-shot form's ValueError).
    """
    dev = resolve_device(device)
    t0s = np.asarray(t0_array, float)
    Ts = np.broadcast_to(np.asarray(T_array, float), t0s.shape)
    _, G, r, dn = _systems(times, data, modes, Mf, chif, t0s, Ts, t0_method,
                           spherical_modes, dev)
    power = (_project(G, r).abs() ** 2).cpu().numpy()
    dn = dn.cpu().numpy()
    cum = np.cumsum(power, axis=1) / dn[:, None]
    explained = cum[:, -1]
    return {
        "power": power,
        "data_norm": dn,
        "cumulative_explained": cum,
        "explained_fraction": explained,
        "mismatch": 1.0 - np.sqrt(np.maximum(explained, 0.0)),
        "ok": np.all(np.isfinite(power), axis=1),
    }
