"""The t0 x mode-set sweep: host-side preparation, window dedup and the
public batched entry (port of the main-path part of
qnmfits_tpu/batched.py).

Host preparation (spectrum splines, dedup keys, chunk sizing) is NumPy,
as in the JAX package; the sweep itself runs in torch on the requested
device (``engine_real.sweep_t0_modesets_factored_real``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import CDTYPE, RDTYPE, resolve_device
from .engine import SpectrumEvaluator, check_spin
from .engine_real import sweep_t0_modesets_factored_real

__all__ = ["batch_mismatch_t0_modesets"]


def _canon(modes):
    return tuple(tuple(int(x) for x in m) for m in modes)


def _prep(times, data, spherical_modes):
    """Stack dict data to (I, K) rows; a single series -> (1, K)."""
    if isinstance(data, dict):
        if spherical_modes is None:
            spherical_modes = list(data.keys())
        rows = np.stack([np.asarray(data[lm]) for lm in spherical_modes])
        sph = tuple(tuple(lm) for lm in spherical_modes)
    else:
        rows = np.asarray(data)[None, :]
        sph = None
    return np.asarray(times, float), rows, sph


_SPAN_EXP_LIMIT = 18.0   # |Im w| * chunk-span accuracy budget


def _safe_chunk(t0s, wi_max, chunk):
    """Largest chunk <= `chunk` whose t0 span keeps the factored kernel
    accurate.  Every window of a chunk is fitted in a basis referenced to
    the chunk start, so a mode's Gram diagonal carries e^{-2 |Im w|
    delta} (delta <= chunk span) on top of its own conditioning;
    |Im w| * span <= 18 keeps that factor above f64 eps (batched.py:377,
    PERF.md section 2 of the JAX rounds)."""
    span = float(t0s[-1] - t0s[0]) if len(t0s) > 1 else 0.0
    if span <= 0 or wi_max <= 0:
        return chunk
    per_step = span / max(len(t0s) - 1, 1)
    max_chunk = max(int(_SPAN_EXP_LIMIT / wi_max / max(per_step, 1e-30)), 1)
    c = min(chunk, max_chunk)
    for size in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if size <= c:
            return size
    return 1


def _uniform_spacing(times):
    """True when `times` is a uniform grid to a few ulps of its own dtype:
    the gate for the closed-form Grams (batched.py:405).  For sub-f64
    storage the grid must be the storage rounding of a uniform grid
    (compared at 4 ulps); f64 grids are compared at 16 ulps."""
    t_raw = np.asarray(times)
    floating = np.issubdtype(t_raw.dtype, np.floating)
    eps = np.finfo(t_raw.dtype).eps if floating else np.finfo(float).eps
    t = np.asarray(t_raw, float)
    K = t.shape[0]
    if K < 2 or not t[-1] > t[0]:
        return False
    step = (t[-1] - t[0]) / (K - 1)
    ideal = t[0] + step * np.arange(K)
    if floating and eps > np.finfo(float).eps:
        ideal = np.asarray(ideal.astype(t_raw.dtype), float)
        tol = 4 * eps * max(abs(t[0]), abs(t[-1]))
    else:
        tol = 16 * eps * max(abs(t[0]), abs(t[-1]))
    return bool(np.max(np.abs(t - ideal)) <= tol)


def _window_dedup(times, t0s, Ts):
    """Distinct windows of a static-spectrum 'geq' t0 sweep
    (batched.py:441).

    Start times whose windows hold the same samples pose the same
    least-squares problem up to a per-column phase, so each distinct
    window is solved once and the amplitudes rephased.  Keys are (first
    in-window index, first past-end index) from the kernels' own
    comparisons.  Returns (rep, inverse) with t0s[rep] the first start
    time of each group, ascending, or None when every window is distinct.
    """
    t = np.asarray(times, float)
    t0v = np.asarray(t0s, float)
    a_w = np.searchsorted(t, t0v, side="left")         # first t >= t0
    e_w = np.searchsorted(t, t0v + np.asarray(Ts, float), side="left")
    keys = a_w * (len(t) + 1) + e_w
    uniq, rep, inverse = np.unique(keys, return_index=True,
                                   return_inverse=True)
    if len(uniq) == len(t0v):
        return None
    return _ascending_reps(t0v, rep, inverse)


def _ascending_reps(t0v, rep, inverse):
    """Reorder the window groups by representative start time (np.unique
    orders them by key, which a per-t0 T can make non-ascending); the
    factored sweep needs ascending t0s.  Membership is unchanged."""
    order = np.argsort(t0v[rep], kind="stable")
    ranks = np.empty(len(order), dtype=inverse.dtype)
    ranks[order] = np.arange(len(order), dtype=inverse.dtype)
    return rep[order], ranks[inverse]


def _dedup_rephase(C, omegas, delta):
    """C(t0) = C(t0_rep) exp(-i w (t0 - t0_rep)).  C (..., B, J) gathered
    to the full sweep, omegas (..., J), delta (B,) >= 0."""
    wr = omegas.real[..., None, :]
    wi = omegas.imag[..., None, :]
    d = delta[:, None]
    g = np.exp(wi * d)
    c, s = np.cos(wr * d), np.sin(wr * d)
    return g * (C.real * c + C.imag * s) + 1j * g * (C.imag * c - C.real * s)


def _dedup_scatter(dd, t0s_full, mm, C=None, omegas=None):
    """Scatter distinct-window results back over the full t0 axis (the
    last axis of mm, second-to-last of C) and rephase the amplitudes.
    Returns (mm, C)."""
    rep, inverse = dd
    mm = np.asarray(mm)[..., inverse]
    if C is not None:
        delta = t0s_full - t0s_full[rep][inverse]
        C = _dedup_rephase(np.asarray(C)[..., inverse, :], omegas, delta)
    return mm, C


@lru_cache(maxsize=32)
def _modesets_spectrum_fn(sets_key, sph):
    """Padded spectrum of a mode-set list (batched.py:855): returns
    (eval_all, masks) with eval_all(chif, Mf) -> omegas (S, J), mus
    (S, I, J) complex, zero in the padded slots, and masks (S, J)."""
    evs = [SpectrumEvaluator(list(ms), list(sph) if sph else None)
           for ms in sets_key]
    J = max(len(ms) for ms in sets_key)
    masks = np.zeros((len(sets_key), J), bool)
    for si, ms in enumerate(sets_key):
        masks[si, :len(ms)] = True

    def eval_all(chif, Mf):
        I = 1 if sph is None else len(sph)
        omegas = np.zeros((len(sets_key), J), complex)
        mus = np.zeros((len(sets_key), I, J), complex)
        for si, (ev, ms) in enumerate(zip(evs, sets_key)):
            omegas[si, :len(ms)] = ev.omega(chif, Mf)
            mus[si, :, :len(ms)] = 1.0 if sph is None else ev.mu(chif)
        return omegas, mus

    return eval_all, masks


def batch_mismatch_t0_modesets(times, data, mode_sets, Mf, chif, t0_array,
                               T_array=100, spherical_modes=None,
                               return_amplitudes=False, chunk=256,
                               t0_method="geq", dedup=True, device="cuda",
                               solve=None):
    """The t0 x mode-set sweep (batched.py:910) for a scalar remnant and
    'geq' windows: every (mode set, start time) pair on the factored
    kernel, with the mode sets as a batch dimension.

    mode_sets is a list of mode lists ((l, m, n, sign) tuples, ragged
    lengths padded to a common J with identity Gram rows: padded
    amplitudes are exactly zero).  t0_array must be sorted ascending.
    dedup=True solves each distinct window once and scatters the results
    (exact for static spectra, see _window_dedup).  ``device`` is where
    the sweep runs ("cuda" by default; "cpu" runs the plain PyTorch
    solve); ``solve`` overrides the batched Hermitian solve
    (engine_real._regularised_solve by default).

    Returns mm (S, B); with return_amplitudes=True also a list of S
    complex (B, len(mode_sets[s])) amplitude arrays.
    """
    if t0_method == "closest":
        raise NotImplementedError(
            "t0_method='closest' is not ported to qnmfits_tpu_torch yet")
    if t0_method != "geq":
        raise ValueError("t0_method must be 'geq' or 'closest'")
    if np.ndim(Mf) != 0 or np.ndim(chif) != 0:
        raise NotImplementedError(
            "a remnant axis (array Mf/chif) is not ported to "
            "qnmfits_tpu_torch yet; pass scalars")
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    t0s = np.asarray(t0_array, float)
    if np.any(np.diff(t0s) < 0):
        raise ValueError("t0_array must be sorted ascending")
    Ts = np.ascontiguousarray(
        np.broadcast_to(np.asarray(T_array, float), t0s.shape))
    check_spin(float(chif))

    sets = [list(_canon(ms)) for ms in mode_sets]
    eval_all, masks = _modesets_spectrum_fn(
        tuple(tuple(ms) for ms in sets), sph)
    omegas, mus = eval_all(float(chif), float(Mf))

    dd = _window_dedup(times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]
    ck = _safe_chunk(t0s, float(np.max(np.abs(omegas.imag))), chunk)

    def real(a):
        return torch.tensor(np.asarray(a, float), dtype=RDTYPE, device=dev)

    def cplx(a):
        return torch.tensor(np.asarray(a, complex), dtype=CDTYPE, device=dev)

    C, mm = sweep_t0_modesets_factored_real(
        real(times), cplx(rows), cplx(omegas), cplx(mus), real(t0s),
        real(Ts), torch.as_tensor(masks, device=dev), chunk=ck,
        analytic=_uniform_spacing(times), solve=solve)
    mm = mm.cpu().numpy()
    C = C.cpu().numpy() if return_amplitudes else None
    if dd is not None:
        mm, C = _dedup_scatter(dd, t0s_full, mm, C, omegas)
    if not return_amplitudes:
        return mm
    return mm, [C[si, :, :len(ms)] for si, ms in enumerate(sets)]
