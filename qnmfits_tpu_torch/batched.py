"""Batched ringdown sweeps over start times, mode sets, remnant spins,
frequency grids and catalog events, static or with time-dependent
spectra (port of qnmfits_tpu/batched.py).

Host preparation (spectrum splines, dedup keys, chunk sizing) is NumPy,
as in the JAX package; the sweeps run in torch on the requested device.
Sweep engines: the factored kernel
(``engine_real.sweep_t0_modesets_factored_real``; 'geq' windows, start
times sorted); the complex window sweep over ``engine.fit_core`` (any
window method, and the spectrum-batched grids' 'batched' engine); the
stacked spectrum sweep (``engine_real.sweep_spectra_stacked_real``, the
grids' 'fast' and 'fast-full' engines); the dynamic-spectrum sweep
(``sweep_t0_modesets_dynamic_real``) and the event batch
(``sweep_events_real``), both over the complex fit cores of ``engine``.
Each builds its systems chunk
by chunk and solves them in as few calls of the batched Hermitian solve
as the join budget allows (``engine_real.JOIN_BYTES``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import CDTYPE, RDTYPE, resolve_device
from .engine import (SpectrumEvaluator, _window, cached_evaluator,
                     check_spin, chunk_bounds, dynamic_fit_systems,
                     fit_systems, solve_fits)
from .engine_real import (sweep_omega_grid_bordered_real,
                          sweep_spectra_stacked_real, sweep_t0_factored_real,
                          sweep_t0_modesets_factored_real)
from .ref_impl import _delta_factor
from .spectrum.tables import solves_on_device

__all__ = [
    "batch_fit_events", "batch_mismatch_t0", "batch_mismatch_t0_dynamic",
    "batch_mismatch_t0_fast", "batch_mismatch_t0_modesets",
    "batch_mismatch_t0_modesets_dynamic", "batch_mismatch_M_chi",
    "batch_mismatch_M_chi_fast", "batch_mismatch_omega",
    "batch_mismatch_omega_bordered", "batch_mismatch_omega_fast",
    "batch_mismatch_t0_sharded", "sweep_events_real", "sweep_t0_core",
    "sweep_t0_modesets", "sweep_t0_modesets_dynamic_real",
]

_CHUNK = 64      # start times (or grid points) a chunk of the complex sweep
# Most bytes of one chunk's complex basis: (S, chunk, K, J) in the complex
# sweep, where a wide set axis (a remnant axis folded in) shrinks its
# chunk of start times instead (the JAX package maps over the sets one at
# a time); (chunk, I, K, J) in the dynamic sweep; (chunk, K, J) in the
# event batch.
_BASIS_BYTES = 1 << 28


def _canon(modes):
    return tuple(tuple(int(x) for x in m) for m in modes)


def _real(a, dev):
    return torch.tensor(np.asarray(a, float), dtype=RDTYPE, device=dev)


def _cplx(a, dev):
    return torch.tensor(np.asarray(a, complex), dtype=CDTYPE, device=dev)


def _mesh_for(mesh, dev):
    """``parallel.mesh.resolve_mesh``, imported on first use: the mesh
    subpackage loads torch.distributed."""
    from .parallel.mesh import resolve_mesh
    return resolve_mesh(mesh, dev)


def _check_t0_method(t0_method):
    if t0_method not in ("geq", "closest"):
        raise ValueError("t0_method must be 'geq' or 'closest'")


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


def _single_row(rows, fn_name):
    """The free-frequency grid fits one data series (the reference's
    mismatch_omega_grid takes one waveform array, qnmfits.py:1679): dict
    data with several spherical modes raises (batched.py:151)."""
    if rows.shape[0] != 1:
        raise ValueError(
            f"{fn_name} fits a single data series; got {rows.shape[0]} "
            "spherical-mode rows.  Pass one waveform array (or a dict "
            "with exactly one entry).")


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


def _window_dedup_closest(times, t0s, Ts):
    """``_window_dedup`` for t0_method='closest' windows [k0, k1), k0/k1
    the sample indices closest to t0 and t0 + T, first index winning ties
    (batched.py:495).

    The keys reproduce ``ops.windows.window_closest``'s argmin bit for
    bit: it scores sample j by fl((fl(t_j - t0) - T)^2), which is not the
    distance to fl(t0 + T), and a key that groups two windows the device
    windows differently would scatter a wrong mismatch.  So the device's
    own expression is evaluated on a 5-sample bracket around
    searchsorted(t, t0 + T): fl(t_j - t0) is weakly monotone in j and
    subtracting T keeps that, so the first global argmin of fl(d^2) lies
    in any bracket holding the sign change; +-2 covers the <= 1-ulp skew
    between fl(t0 + T) and the device's association.
    """
    t = np.asarray(times, float)
    n = len(t)
    off = np.arange(-2, 3)

    def device_argmin(t0v, Tv):
        j = np.clip(np.searchsorted(t, t0v + Tv)[:, None] + off, 0, n - 1)
        d = (t[j] - t0v[:, None]) - Tv[:, None]
        return j[np.arange(len(t0v)), np.argmin(d * d, axis=1)]

    t0v = np.asarray(t0s, float)
    Tv = np.broadcast_to(np.asarray(Ts, float), t0v.shape)
    keys = device_argmin(t0v, np.zeros_like(t0v)) * (n + 1) \
        + device_argmin(t0v, Tv)
    uniq, rep, inverse = np.unique(keys, return_index=True,
                                   return_inverse=True)
    if len(uniq) == len(t0v):
        return None
    return _ascending_reps(t0v, rep, inverse)


def _dedup_for(t0_method, times, t0s, Ts):
    return (_window_dedup(times, t0s, Ts) if t0_method == "geq"
            else _window_dedup_closest(times, t0s, Ts))


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
    (S, I, J) complex, zero in the padded slots, at a scalar remnant, or
    (R, S, J) and (R, S, I, J) at (R,) arrays of spins and masses (the
    JAX vmap over the remnant axis); masks (S, J)."""
    evs = [SpectrumEvaluator(list(ms), list(sph) if sph else None)
           for ms in sets_key]
    J = max(len(ms) for ms in sets_key)
    masks = np.zeros((len(sets_key), J), bool)
    for si, ms in enumerate(sets_key):
        masks[si, :len(ms)] = True

    def eval_all(chif, Mf):
        lead = np.shape(chif)
        I = 1 if sph is None else len(sph)
        omegas = np.zeros(lead + (len(sets_key), J), complex)
        mus = np.zeros(lead + (len(sets_key), I, J), complex)
        for si, (ev, ms) in enumerate(zip(evs, sets_key)):
            n = len(ms)
            omegas[..., si, :n] = np.moveaxis(ev.omega(chif, Mf), 0, -1)
            mus[..., si, :, :n] = 1.0 if sph is None else (
                np.moveaxis(ev.mu(chif), -1, 0) if lead else ev.mu(chif))
        return omegas, mus

    return eval_all, masks


def _modesets_spectrum_dynamic_fn(sets_key, sph):
    """The padded time-track spectra of a mode-set list (batched.py:1130):
    returns (eval_all, masks) with eval_all(chif_t, Mf_t) -> omegas_t
    (S, K, J), mus_t (S, I, K, J) complex, zero in the padded slots, at
    (K,) tracks (``_modesets_spectrum_fn`` at K remnants, with the track
    axis moved inside the set axis); masks (S, J)."""
    eval_all, masks = _modesets_spectrum_fn(sets_key, sph)

    def eval_tracks(chif_t, Mf_t):
        omegas, mus = eval_all(chif_t, Mf_t)      # (K, S, J), (K, S, I, J)
        return np.moveaxis(omegas, 0, 1), np.moveaxis(mus, 0, 2)

    return eval_tracks, masks


# ---------------------------------------------------------------------------
# The complex window sweep (fit_core over a batch of windows)
# ---------------------------------------------------------------------------

def sweep_t0_modesets(times, data, omegas, mus, t0s, Ts, col_masks=None,
                      t0_method="geq", chunk=None, solve=None):
    """Every (mode set, window) pair on the complex fit core
    (batched.py:77), any window method, t0s in any order.

    times (K,), data (I, K), omegas (S, J), mus (S, I, J), t0s/Ts (B,),
    col_masks (S, J) bool or None: tensors on one device.  Chunks of
    ``chunk`` start times are built in turn (the JAX lax.map) and solved
    in as few calls as the join budget allows; by default a chunk is
    _CHUNK start times, fewer where the sets' basis would pass
    _BASIS_BYTES.  Returns C (S, B, J) and mm (S, B).
    """
    S, J = omegas.shape
    if chunk is None:
        per_t0 = S * times.shape[0] * J * 16
        chunk = max(1, min(_CHUNK, _BASIS_BYTES // per_t0))
    om, mu = omegas[:, None], mus[:, None]
    mask = None if col_masks is None else col_masks[:, None]

    def systems(lo, hi):
        t0c = t0s[lo:hi]
        w = _window(times, t0c[:, None], Ts[lo:hi, None], t0_method)
        return fit_systems(times, data, om, mu, t0c, w, mask)

    return solve_fits(chunk_bounds(t0s.shape[0], chunk), 2 * S * J * J * 16,
                      systems, solve)


def sweep_t0_core(times, data, omega, mu, t0s, Ts, t0_method="geq",
                  col_mask=None, chunk=None, solve=None):
    """``sweep_t0_modesets`` for one mode set (batched.py:59): omega (J,),
    mu (I, J), col_mask (J,) or None.  Returns C (B, J) and mm (B,)."""
    C, mm = sweep_t0_modesets(
        times, data, omega[None], mu[None], t0s, Ts,
        None if col_mask is None else col_mask[None], t0_method, chunk,
        solve)
    return C[0], mm[0]


def _t0_grid(t0_array, T_array, ascending):
    """Start times and their (broadcast) window lengths; the factored
    sweeps (``ascending``) need the start times sorted."""
    t0s = np.asarray(t0_array, float)
    if ascending and np.any(np.diff(t0s) < 0):
        raise ValueError("t0_array must be sorted ascending")
    Ts = np.ascontiguousarray(
        np.broadcast_to(np.asarray(T_array, float), t0s.shape))
    return t0s, Ts


def _no_delta(delta):
    """The reference's dynamic fits take no delta (qnmfits.py:318-475)."""
    if np.any(np.asarray(delta)):
        raise ValueError("delta is not supported for dynamic-spectrum "
                         "fits (time-dependent Mf/chif)")


def _spectrum(modes, sph, Mf, chif, delta):
    """omega (J,) and mu (I, J) of one mode set at a scalar remnant."""
    ev = cached_evaluator(_canon(modes), sph)
    df = np.asarray(_delta_factor(delta, len(modes)))
    omega = ev.omega(float(chif), float(Mf), df)
    mu = (np.ones((1, omega.shape[0]), complex) if sph is None
          else ev.mu(float(chif)))
    return omega, mu


def _scatter(dd, t0s_full, mm, C, omegas, return_amplitudes):
    mm = mm.cpu().numpy()
    C = C.cpu().numpy() if return_amplitudes else None
    if dd is not None:
        mm, C = _dedup_scatter(dd, t0s_full, mm, C, omegas)
    return mm, C


@solves_on_device
def batch_mismatch_t0(times, data, modes, Mf, chif, t0_array,
                      t0_method="geq", T_array=100, spherical_modes=None,
                      delta=0.0, return_amplitudes=False, dedup=True,
                      device="cuda", solve=None):
    """All start times of one mode set on the complex fit core
    (batched.py:192; the reference's loop at qnmfits.py:1183-1301), any
    window method.  dedup=True solves each distinct window once (exact
    for static spectra).  Array Mf/chif (time tracks) route to
    ``batch_mismatch_t0_dynamic`` (batched.py:206-215).  ``solve``
    substitutes the batched Hermitian solve.  Returns mm (B,), with
    return_amplitudes=True also C (B, J).
    """
    if np.ndim(Mf) != 0 or np.ndim(chif) != 0:
        _no_delta(delta)
        return batch_mismatch_t0_dynamic(
            times, data, modes, Mf, chif, t0_array, t0_method=t0_method,
            T_array=T_array, spherical_modes=spherical_modes,
            return_amplitudes=return_amplitudes, device=device, solve=solve)
    _check_t0_method(t0_method)
    check_spin(chif)
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    t0s, Ts = _t0_grid(t0_array, T_array, ascending=False)
    omega, mu = _spectrum(modes, sph, Mf, chif, delta)
    dd = _dedup_for(t0_method, times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]
    C, mm = sweep_t0_core(_real(times, dev), _cplx(rows, dev),
                          _cplx(omega, dev), _cplx(mu, dev), _real(t0s, dev),
                          _real(Ts, dev), t0_method, solve=solve)
    mm, C = _scatter(dd, t0s_full, mm, C, omega, return_amplitudes)
    return (mm, C) if return_amplitudes else mm


# ---------------------------------------------------------------------------
# The factored sweeps ('geq' windows, start times sorted)
# ---------------------------------------------------------------------------

@solves_on_device
def batch_mismatch_t0_fast(times, data, modes, Mf, chif, t0_array,
                           T_array=100, spherical_modes=None, delta=0.0,
                           return_amplitudes=False, chunk=128, dedup=True,
                           device="cuda", solve=None):
    """The start-time sweep of one mode set on the factored kernel
    (batched.py:600; t0_method='geq', t0_array sorted ascending), the same
    results as ``batch_mismatch_t0``.  Returns mm (B,), with
    return_amplitudes=True also C (B, J)."""
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    t0s, Ts = _t0_grid(t0_array, T_array, ascending=True)
    omega, mu = _spectrum(modes, sph, Mf, chif, delta)
    dd = _window_dedup(times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]
    ck = _safe_chunk(t0s, float(np.max(np.abs(omega.imag))), chunk)
    C, mm = sweep_t0_factored_real(
        _real(times, dev), _cplx(rows, dev), _cplx(omega, dev),
        _cplx(mu, dev), _real(t0s, dev), _real(Ts, dev), chunk=ck,
        analytic=_uniform_spacing(times), solve=solve)
    mm, C = _scatter(dd, t0s_full, mm, C, omega, return_amplitudes)
    return (mm, C) if return_amplitudes else mm


def _bucket_width(n, J):
    """Padded width of an n-mode set under bucket=True: the power of two
    >= max(n, 4), capped at J."""
    b = 4
    while b < n:
        b *= 2
    return min(b, J)


@solves_on_device
def batch_mismatch_t0_modesets(times, data, mode_sets, Mf, chif, t0_array,
                               T_array=100, spherical_modes=None,
                               return_amplitudes=False, chunk=256,
                               t0_method="geq", bucket=False, dedup=True,
                               mesh=None, device="cuda", solve=None):
    """The t0 x mode-set sweep (batched.py:910): every (mode set, start
    time) pair, with the mode sets as a batch dimension.

    mode_sets is a list of mode lists ((l, m, n, sign) tuples, ragged
    lengths padded to a common J with identity Gram rows: padded
    amplitudes are exactly zero).  t0_method='geq' runs the factored
    kernel and needs t0_array sorted ascending; 'closest' runs the complex
    window sweep.  chif and/or Mf may be 1-D arrays, a remnant axis R
    (broadcast together): the per-spin spectra fold into the set axis, row
    r * S + s.  bucket=True ('geq' only) groups the sets by padded width
    (powers of two >= 4, capped at J) and runs one factored sweep per
    width, each with its own chunk budget.  dedup=True solves each
    distinct window once and scatters the results (exact for static
    spectra).  ``mesh`` (a ``parallel.mesh.sweep_mesh``, or 'auto')
    shards the distinct start times over its 'sweep' ranks ('geq' only;
    every rank calls with the same arguments and gets the whole result).
    ``device`` is where the sweep runs ("cuda" by default;
    "cpu" runs the plain PyTorch solve); ``solve`` overrides the batched
    Hermitian solve (engine_real._regularised_solve by default).

    Returns mm (S, B), or (S, R, B) with a remnant axis; with
    return_amplitudes=True also a list of S complex (B, len(mode_sets[s]))
    (or (R, B, len)) amplitude arrays.
    """
    _check_t0_method(t0_method)
    if bucket and t0_method != "geq":
        raise ValueError("bucket=True requires t0_method='geq' (the "
                         "width-bucketed factored kernel)")
    if np.ndim(Mf) > 1 or np.ndim(chif) > 1:
        raise ValueError("Mf/chif must be scalars or 1-D remnant arrays")
    dev = resolve_device(device)
    if mesh is not None:
        if t0_method != "geq":
            raise ValueError("mesh sharding of the mode-set sweep needs "
                             "t0_method='geq'")
        mesh = _mesh_for(mesh, dev)
    times, rows, sph = _prep(times, data, spherical_modes)
    t0s, Ts = _t0_grid(t0_array, T_array, ascending=t0_method == "geq")
    scalar_remnant = np.ndim(Mf) == 0 and np.ndim(chif) == 0
    chif_arr, Mf_arr = np.broadcast_arrays(
        np.atleast_1d(np.asarray(chif, float)),
        np.atleast_1d(np.asarray(Mf, float)))
    for c in chif_arr:
        check_spin(float(c))
    R = len(chif_arr)

    sets = [list(_canon(ms)) for ms in mode_sets]
    S = len(sets)
    eval_all, masks = _modesets_spectrum_fn(
        tuple(tuple(ms) for ms in sets), sph)
    if scalar_remnant:
        omegas, mus = eval_all(float(chif), float(Mf))
    else:
        omegas, mus = eval_all(chif_arr, Mf_arr)
        omegas = omegas.reshape(R * S, omegas.shape[-1])
        mus = mus.reshape((R * S,) + mus.shape[-2:])
    masks_run = masks if scalar_remnant else np.tile(masks, (R, 1))

    dd = _dedup_for(t0_method, times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]

    args = (_real(times, dev), _cplx(rows, dev))
    t0_t, T_t = _real(t0s, dev), _real(Ts, dev)
    if t0_method == "closest":
        C, mm = sweep_t0_modesets(*args, _cplx(omegas, dev),
                                  _cplx(mus, dev), t0_t, T_t,
                                  torch.as_tensor(masks_run, device=dev),
                                  t0_method="closest", solve=solve)
    else:
        analytic = _uniform_spacing(times)

        def run_group(o, m, mk):
            ck = _safe_chunk(t0s, float(np.max(np.abs(o.imag))), chunk)
            a = (*args, _cplx(o, dev), _cplx(m, dev), t0_t, T_t,
                 torch.as_tensor(mk, device=dev))
            if mesh is not None:
                from .parallel.mesh import sharded_t0_sweep_modesets_factored
                return sharded_t0_sweep_modesets_factored(
                    *a, mesh, chunk=ck, analytic=analytic, solve=solve)
            return sweep_t0_modesets_factored_real(
                *a, chunk=ck, analytic=analytic, solve=solve)

        if bucket:
            J = omegas.shape[1]
            widths = np.array([_bucket_width(len(sets[i % S]), J)
                               for i in range(omegas.shape[0])])
            C = torch.zeros((omegas.shape[0], len(t0s), J), dtype=CDTYPE,
                            device=dev)
            mm = torch.empty((omegas.shape[0], len(t0s)), dtype=RDTYPE,
                             device=dev)
            for bw in sorted(set(widths)):
                idx = np.nonzero(widths == bw)[0]
                C_b, mm_b = run_group(omegas[idx][:, :bw],
                                      mus[idx][:, :, :bw],
                                      masks_run[idx][:, :bw])
                ti = torch.as_tensor(idx, device=dev)
                mm[ti] = mm_b
                C[ti, :, :bw] = C_b
        else:
            C, mm = run_group(omegas, mus, masks_run)
    mm, C = _scatter(dd, t0s_full, mm, C, omegas, return_amplitudes)
    if scalar_remnant:
        if not return_amplitudes:
            return mm
        return mm, [C[si, :, :len(ms)] for si, ms in enumerate(sets)]
    B = mm.shape[-1]
    mm = np.moveaxis(mm.reshape(R, S, B), 0, 1)          # (S, R, B)
    if not return_amplitudes:
        return mm
    C = C.reshape(R, S, B, -1)
    return mm, [C[:, si, :, :len(ms)] for si, ms in enumerate(sets)]


@solves_on_device
def batch_mismatch_t0_sharded(times, data, modes, Mf, chif, t0_array,
                              T_array=100, spherical_modes=None, delta=0.0,
                              return_amplitudes=False, chunk=64, mesh=None,
                              dedup=True, device="cuda", solve=None):
    """The start-time sweep of one mode set on the factored kernel with
    the start times sharded over a mesh's 'sweep' ranks (batched.py:1089;
    'geq' windows, t0_array sorted ascending).  mesh is a
    ``parallel.mesh.sweep_mesh`` or 'auto' (the default, None, means
    'auto': every rank of the initialised process group).  dedup=True
    shards only the distinct windows.  Every rank calls it with the same
    arguments and gets the whole result: mm (B,), with
    return_amplitudes=True also C (B, J)."""
    from .parallel.mesh import sharded_t0_sweep_factored
    dev = resolve_device(device)
    mesh = _mesh_for("auto" if mesh is None else mesh, dev)
    times, rows, sph = _prep(times, data, spherical_modes)
    t0s, Ts = _t0_grid(t0_array, T_array, ascending=True)
    omega, mu = _spectrum(modes, sph, Mf, chif, delta)
    dd = _window_dedup(times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]
    ck = _safe_chunk(t0s, float(np.max(np.abs(omega.imag))), chunk)
    C, mm = sharded_t0_sweep_factored(
        _real(times, dev), _cplx(rows, dev), _cplx(omega, dev),
        _cplx(mu, dev), _real(t0s, dev), _real(Ts, dev), mesh, chunk=ck,
        analytic=_uniform_spacing(times), solve=solve)
    mm, C = _scatter(dd, t0s_full, mm, C, omega, return_amplitudes)
    return (mm, C) if return_amplitudes else mm


# ---------------------------------------------------------------------------
# Time-dependent spectra and catalog event batches
# ---------------------------------------------------------------------------

def _window_spans(times, t0s, Ts):
    """Per start time, a sample range [lo, hi) holding its window, 'geq'
    or 'closest', with two samples to spare on each side: fits restricted
    to it are exact, since the window and trapezoid weights vanish
    outside.  Host int64 tensors (B,)."""
    t = times.cpu()
    t0 = t0s.cpu()
    K = t.shape[0]
    lo = torch.clamp(torch.searchsorted(t, t0) - 2, 0, K)
    hi = torch.clamp(torch.searchsorted(t, t0 + Ts.cpu()) + 2, 0, K)
    return lo, hi


def sweep_t0_modesets_dynamic_real(times, data, omegas_t, mus_t, t0s, Ts,
                                   col_masks, t0_method="geq", chunk=32,
                                   solve=None):
    """t0 x mode-set sweep with time-dependent spectra (the port of
    engine_real.sweep_t0_modesets_dynamic_real, engine_real.py:344; with
    S = 1 also sweep_t0_dynamic_real, :323): every (set, window) pair an
    ``engine.dynamic_fit_systems`` fit, the reference loop
    qnmfits.py:1286-1299 over sets.

    times (K,), data (I, K), omegas_t (S, K, J), mus_t (S, I, K, J), t0s
    and Ts (B,) in any order, col_masks (S, J) bool.  Each set's start
    times are built ``chunk`` at a time on the sample range the chunk's
    windows touch (``_window_spans``); the chunks are joined while their G
    and G_tau stay within ``JOIN_BYTES`` and each group is solved by one
    call of ``solve``.  No window dedup: t0 enters the design per row.
    Returns C (S, B, J) and mm (S, B).
    """
    S, _, J = omegas_t.shape
    B = t0s.shape[0]
    lo_k, hi_k = _window_spans(times, t0s, Ts)

    def systems(lo, hi):
        s, b0, b1 = lo // B, lo % B, lo % B + hi - lo
        a, e = int(lo_k[b0:b1].min()), int(hi_k[b0:b1].max())
        t0c, tt = t0s[b0:b1], times[a:e]
        w = _window(tt, t0c[:, None], Ts[b0:b1, None], t0_method)
        return dynamic_fit_systems(tt, data[:, a:e], omegas_t[s, a:e],
                                   mus_t[s, :, a:e], t0c, w, col_masks[s])

    bounds = [(s * B + lo, s * B + min(lo + chunk, B)) for s in range(S)
              for lo in range(0, B, chunk)]
    C, mm = solve_fits(bounds, 2 * J * J * 16, systems, solve)
    return C.reshape(S, B, J), mm.reshape(S, B)


def sweep_events_real(times, data, omegas, t0s, Ts, chunk=64,
                      t0_method="geq", solve=None):
    """Per-event fit batch (the port of engine_real.sweep_events_real,
    engine_real.py:1167, with its summed Grams): each event has its own
    data row, spectrum and window, and is one single-series fit
    (``engine.fit_systems``, the complex128 form of fit_core_real).

    times (K,); data (E, K); omegas (E, J); t0s/Ts (E,).  ``chunk``
    events are built at a time, joined while their G and G_tau stay
    within ``JOIN_BYTES``, one ``solve`` call a group.  Returns C (E, J)
    and mm (E,).
    """
    E, J = omegas.shape
    ones = torch.ones((1, J), dtype=omegas.dtype, device=omegas.device)

    def systems(lo, hi):
        t0c = t0s[lo:hi]
        w = _window(times, t0c[:, None], Ts[lo:hi, None], t0_method)
        return fit_systems(times, data[lo:hi, None, :], omegas[lo:hi], ones,
                           t0c, w)

    return solve_fits(chunk_bounds(E, chunk), 2 * J * J * 16, systems,
                      solve)


def _tracks(K, Mf, chif):
    """(K,) Mf and chif tracks from scalars or (K,) arrays."""
    Mf_t = np.full(K, float(Mf)) if np.ndim(Mf) == 0 \
        else np.asarray(Mf, float)
    chif_t = np.full(K, float(chif)) if np.ndim(chif) == 0 \
        else np.asarray(chif, float)
    if Mf_t.shape != (K,) or chif_t.shape != (K,):
        raise ValueError("dynamic Mf/chif must be scalars or (K,) tracks")
    return Mf_t, chif_t


def _dynamic_sweep(times, data, mode_sets, Mf, chif, t0_array, t0_method,
                   T_array, spherical_modes, return_amplitudes, device,
                   solve, mesh=None):
    """Every (mode set, window) fit with the spectrum of the (Mf(t),
    chif(t)) tracks, the start times sharded over ``mesh``'s 'sweep'
    ranks where one is given.  Returns mm (S, B), C (S, B, J) or None, and
    the canonical sets."""
    _check_t0_method(t0_method)
    check_spin(chif)          # a scalar, before it is expanded to a track
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _mesh_for(mesh, dev)
    times, rows, sph = _prep(times, data, spherical_modes)
    K = len(times)
    Mf_t, chif_t = _tracks(K, Mf, chif)
    t0s, Ts = _t0_grid(t0_array, T_array, ascending=False)
    sets = [list(_canon(ms)) for ms in mode_sets]
    eval_tracks, masks = _modesets_spectrum_dynamic_fn(
        tuple(tuple(ms) for ms in sets), sph)
    omegas_t, mus_t = eval_tracks(chif_t, Mf_t)
    chunk = max(1, _BASIS_BYTES // (mus_t[0].size * 16))
    args = (_real(times, dev), _cplx(rows, dev), _cplx(omegas_t, dev),
            _cplx(mus_t, dev), _real(t0s, dev), _real(Ts, dev),
            torch.as_tensor(masks, device=dev))
    if mesh is not None:
        from .parallel.mesh import sharded_t0_sweep_modesets_dynamic
        C, mm = sharded_t0_sweep_modesets_dynamic(
            *args, mesh, t0_method, chunk=chunk, solve=solve)
    else:
        C, mm = sweep_t0_modesets_dynamic_real(*args, t0_method, chunk=chunk,
                                               solve=solve)
    return (mm.cpu().numpy(), C.cpu().numpy() if return_amplitudes
            else None, sets)


@solves_on_device
def batch_mismatch_t0_dynamic(times, data, modes, Mf, chif, t0_array,
                              t0_method="geq", T_array=100,
                              spherical_modes=None, return_amplitudes=False,
                              engine="batched", mesh=None, device="cuda",
                              solve=None):
    """Start-time sweep with a time-dependent spectrum (batched.py:316):
    Mf/chif scalars or (K,) tracks, any window method, start times in any
    order, never deduplicated (t0 enters the design per row).  engine
    'batched' and 'fast' are one sweep here
    (``sweep_t0_modesets_dynamic_real`` with one set).  ``mesh`` (or
    'auto') shards the start times over its 'sweep' ranks.
    Returns mm (B,), with return_amplitudes=True also C (B, J)."""
    if engine not in ("batched", "fast"):
        raise ValueError(f"unknown engine {engine!r}")
    mm, C, _ = _dynamic_sweep(times, data, [modes], Mf, chif, t0_array,
                              t0_method, T_array, spherical_modes,
                              return_amplitudes, device, solve, mesh)
    return (mm[0], C[0]) if return_amplitudes else mm[0]


@solves_on_device
def batch_mismatch_t0_modesets_dynamic(times, data, mode_sets, Mf, chif,
                                       t0_array, t0_method="geq",
                                       T_array=100, spherical_modes=None,
                                       return_amplitudes=False, mesh=None,
                                       device="cuda", solve=None):
    """The t0 x mode-set sweep with a time-dependent spectrum
    (batched.py:1186): every (mode set, start time) pair a dynamic fit.
    Mf/chif are scalars or (K,) time tracks (not a remnant axis); ragged
    sets are padded with exact-zero amplitude slots.  ``mesh`` (or 'auto')
    shards the start times over its 'sweep' ranks, any window method (the
    tracks do not depend on t0: every rank holds them).  Returns mm
    (S, B); with return_amplitudes=True also a list of S (B, len(set))
    arrays."""
    mm, C, sets = _dynamic_sweep(times, data, mode_sets, Mf, chif, t0_array,
                                 t0_method, T_array, spherical_modes,
                                 return_amplitudes, device, solve, mesh)
    if not return_amplitudes:
        return mm
    return mm, [C[si, :, :len(ms)] for si, ms in enumerate(sets)]


@solves_on_device
def batch_fit_events(times, data, modes, Mf, chif, t0, T=100,
                     t0_method="geq", precision="x64", mesh=None,
                     engine="batched", chunk=None, device="cuda",
                     solve=None):
    """One mode model fitted to many events (batched.py:1291): E series on
    a shared time grid, each with its own remnant (Mf_e, chif_e) and
    window (t0_e, T_e); the reference fits them one call at a time
    (qnmfits.py:142-315).

    times (K,); data (E, K) complex; Mf/chif/t0/T scalars or (E,) arrays.
    engine 'batched' (any window method) or 'fast' ('geq' windows only);
    both take the summed Grams (``sweep_events_real``): a closed-form
    Gram branch like the JAX package's 'fast' one measured slower on the
    H100 (PERF.md, section 6).
    ``chunk`` events are built at a time (by default as many as
    _BASIS_BYTES of basis hold).  ``mesh`` (or 'auto') shards the events
    over its 'sweep' ranks ('geq' windows only, as in the JAX package).
    precision='x64' is the only precision
    (``fitting._check_precision``).  Returns mm (E,) and C (E, J) complex.
    """
    from .fitting import _check_precision
    _check_t0_method(t0_method)
    _check_precision(precision)
    if engine not in ("batched", "fast"):
        raise ValueError(f"unknown engine {engine!r}")
    times = np.asarray(times, float)
    rows = np.asarray(data, complex)
    if rows.ndim != 2:
        raise ValueError("data must be (E, K): one series per event")
    E = rows.shape[0]

    def per_event(x):
        return np.ascontiguousarray(np.broadcast_to(np.asarray(x, float),
                                                    (E,)))

    chifs = per_event(chif)
    for c in chifs:
        check_spin(float(c))
    if (engine == "fast" or mesh is not None) and t0_method != "geq":
        raise ValueError("engine='fast'/mesh event batches support "
                         "t0_method='geq' only")
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _mesh_for(mesh, dev)
    omegas = cached_evaluator(_canon(modes)).omega(chifs, per_event(Mf)).T
    if chunk is None:
        chunk = max(1, _BASIS_BYTES // (omegas.size // E * len(times) * 16))
    args = (_real(times, dev), _cplx(rows, dev), _cplx(omegas, dev),
            _real(per_event(t0), dev), _real(per_event(T), dev))
    if mesh is not None:
        from .parallel.mesh import sharded_event_batch
        C, mm = sharded_event_batch(*args, mesh, chunk=chunk,
                                    t0_method=t0_method, solve=solve)
    else:
        C, mm = sweep_events_real(*args, chunk=chunk, t0_method=t0_method,
                                  solve=solve)
    return mm.cpu().numpy(), C.cpu().numpy()


# ---------------------------------------------------------------------------
# Spectrum-batched grids (one window, many spectra)
# ---------------------------------------------------------------------------

def _grid_sweep(times, rows, omegas, mus, t0, T, t0_method, dev, solve):
    """C (Q, J) and mm (Q,) of the fits of Q spectra, omegas (Q, J) and
    mus (Q, I, J), on one window: chunks of _CHUNK grid points (the JAX
    lax.map), solved in as few calls as the join budget allows."""
    times_t, rows_t = _real(times, dev), _cplx(rows, dev)
    om, mu = _cplx(omegas, dev), _cplx(mus, dev)
    t0_t = torch.tensor(float(t0), dtype=RDTYPE, device=dev)
    w = _window(times_t, t0_t, float(T), t0_method)
    J = omegas.shape[-1]

    def systems(lo, hi):
        return fit_systems(times_t, rows_t, om[lo:hi], mu[lo:hi], t0_t, w)

    C, mm = solve_fits(chunk_bounds(omegas.shape[0], _CHUNK), 2 * J * J * 16,
                       systems, solve)
    return C.cpu().numpy(), mm.cpu().numpy()


def _run_spectra_sweep(times, rows, omegas, mus, t0, T, t0_method, dev,
                       solve=None, chunk=None):
    """C (Q, J) and mm (Q,) of the fits of Q spectra on one window
    (batched.py:666).

    On a uniform time grid with a contiguous window the data is sliced to
    the window on the host and the stacked engine
    (``engine_real.sweep_spectra_stacked_real``: closed-form Grams and one
    solve for the whole grid) runs; ``chunk`` grid points' phases at a
    time, by default as many as _BASIS_BYTES of (chunk, K, J) phases
    hold.  Elsewhere the summed-Gram sweep ``_grid_sweep`` runs, which is
    what the JAX package's per-item fallback computes with
    ``sweep_spectra_real(analytic=False)``: its per-item closed form is
    taken only on an accelerator there, and the port has none (a per-item
    closed form measured slower on the H100, PERF.md section 6)."""
    w = _window(torch.as_tensor(times), float(t0), float(T),
                t0_method).numpy()
    idx = np.nonzero(w > 0.5)[0]
    contiguous = idx.size > 0 and idx[-1] - idx[0] + 1 == idx.size
    if not (_uniform_spacing(times) and contiguous):
        return _grid_sweep(times, rows, omegas, mus, t0, T, t0_method, dev,
                           solve)
    sl = slice(int(idx[0]), int(idx[-1]) + 1)
    if chunk is None:
        chunk = max(1, _BASIS_BYTES // (idx.size * omegas.shape[1] * 16))
    C, mm = sweep_spectra_stacked_real(
        _real(times[sl], dev), _cplx(rows[:, sl], dev), _cplx(omegas, dev),
        _cplx(mus, dev), float(t0), chunk=chunk, solve=solve)
    return C.cpu().numpy(), mm.cpu().numpy()


def _M_chi_spectra(modes, sph, Mf_minmax, chif_minmax, res, delta):
    """omegas (res^2, J) and mus (res^2, I, J) of the (Mf, chif) grid,
    row-major over Mf rows and chif columns (qnmfits.py:1413)."""
    check_spin(float(chif_minmax[0]))
    check_spin(float(chif_minmax[1]))
    MM, CC = np.meshgrid(np.linspace(*Mf_minmax, res),
                         np.linspace(*chif_minmax, res), indexing="ij")
    ev = cached_evaluator(_canon(modes), sph)
    df = np.asarray(_delta_factor(delta, len(modes)))
    omegas = ev.omega(CC.ravel(), MM.ravel(), df).T           # (Q, J)
    mus = (np.ones((omegas.shape[0], 1, omegas.shape[1]), complex)
           if sph is None else np.moveaxis(ev.mu(CC.ravel()), -1, 0))
    return omegas, mus


@solves_on_device
def batch_mismatch_M_chi(times, data, modes, Mf_minmax, chif_minmax, t0,
                         t0_method="geq", T=100, res=50,
                         spherical_modes=None, delta=0.0, device="cuda",
                         solve=None):
    """The (Mf, chif) grid as one batched sweep (batched.py:247):
    res x res fits, row-major over Mf rows and chif columns like the
    reference (qnmfits.py:1413)."""
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    omegas, mus = _M_chi_spectra(modes, sph, Mf_minmax, chif_minmax, res,
                                 delta)
    mm = _grid_sweep(times, rows, omegas, mus, t0, T, t0_method, dev,
                     solve)[1]
    return mm.reshape(res, res)


@solves_on_device
def batch_mismatch_M_chi_fast(times, data, modes, Mf_minmax, chif_minmax, t0,
                              t0_method="geq", T=100, res=50,
                              spherical_modes=None, delta=0.0, chunk=None,
                              mesh=None, device="cuda", solve=None):
    """The (Mf, chif) grid on the stacked engine (batched.py:710): the
    spectrum of every grid point evaluated on the host at once, then
    ``_run_spectra_sweep``, one solve launch for the grid.  The layout of
    ``batch_mismatch_M_chi``.  ``mesh`` (or 'auto') shards the grid points
    over its 'sweep' ranks (``parallel.mesh.sharded_spectra_sweep``)."""
    _check_t0_method(t0_method)
    dev = resolve_device(device)
    times, rows, sph = _prep(times, data, spherical_modes)
    omegas, mus = _M_chi_spectra(modes, sph, Mf_minmax, chif_minmax, res,
                                 delta)
    mm = _spectra_grid(times, rows, omegas, mus, t0, T, t0_method, dev,
                       solve, chunk, mesh)
    return mm.reshape(res, res)


def _spectra_grid(times, rows, omegas, mus, t0, T, t0_method, dev, solve,
                  chunk, mesh):
    """mm (Q,) of ``_run_spectra_sweep``, sharded over ``mesh`` where one
    is given."""
    if mesh is None:
        return _run_spectra_sweep(times, rows, omegas, mus, t0, T, t0_method,
                                  dev, solve, chunk)[1]
    from .parallel.mesh import sharded_spectra_sweep
    return sharded_spectra_sweep(times, rows, omegas, mus, t0, T,
                                 _mesh_for(mesh, dev), t0_method, chunk,
                                 dev, solve)[1]


def _omega_fixed(modes, Mf, chif):
    """The fixed QNM frequencies of the free-frequency grids and fits
    (batched.py:747): Mf = 1 and chif = 0 where None."""
    if not len(modes):
        return np.zeros(0, complex)
    return cached_evaluator(_canon(modes)).omega(
        float(chif) if chif is not None else 0.0,
        float(Mf) if Mf is not None else 1.0)


def _omega_spectra(modes, Mf, chif, re_minmax, im_minmax, res):
    """omegas (res^2, J) and mus (res^2, 1, J) of the free-frequency grid:
    the fixed QNMs, then the free frequency of each grid point, in
    meshgrid(re, im, indexing='ij') order."""
    RE, IM = np.meshgrid(np.linspace(*re_minmax, res),
                         np.linspace(*im_minmax, res), indexing="ij")
    wf = (RE + 1j * IM).ravel()
    fixed = _omega_fixed(modes, Mf, chif)
    omegas = np.concatenate(
        [np.broadcast_to(fixed, (wf.shape[0], fixed.shape[0])), wf[:, None]],
        axis=1)
    return omegas, np.ones((wf.shape[0], 1, omegas.shape[1]), complex)


@solves_on_device
def batch_mismatch_omega(times, data, modes, Mf, chif, re_minmax, im_minmax,
                         t0, t0_method="geq", T=100, res=50, device="cuda",
                         solve=None):
    """The free complex-frequency grid as one batched sweep
    (batched.py:266): fixed QNMs plus one free frequency per grid point,
    transposed like the reference (qnmfits.py:1825)."""
    check_spin(chif)
    dev = resolve_device(device)
    times, rows, _ = _prep(times, data, None)
    _single_row(rows, "batch_mismatch_omega")
    omegas, mus = _omega_spectra(modes, Mf, chif, re_minmax, im_minmax, res)
    mm = _grid_sweep(times, rows, omegas, mus, t0, T, t0_method, dev,
                     solve)[1]
    return mm.reshape(res, res).T


@solves_on_device
def batch_mismatch_omega_fast(times, data, modes, Mf, chif, re_minmax,
                              im_minmax, t0, t0_method="geq", T=100, res=50,
                              chunk=None, mesh=None, device="cuda",
                              solve=None):
    """The free complex-frequency grid on the stacked engine
    (batched.py:765): fixed QNMs plus one free frequency per grid point,
    every grid point a full fit, one solve launch for the grid
    (``_run_spectra_sweep``).  Transposed like the reference
    (qnmfits.py:1825).  ``mesh`` (or 'auto') shards the grid points over
    its 'sweep' ranks."""
    _check_t0_method(t0_method)
    check_spin(chif)
    dev = resolve_device(device)
    times, rows, _ = _prep(times, data, None)
    _single_row(rows, "batch_mismatch_omega_fast")
    omegas, mus = _omega_spectra(modes, Mf, chif, re_minmax, im_minmax, res)
    mm = _spectra_grid(times, rows, omegas, mus, t0, T, t0_method, dev,
                       solve, chunk, mesh)
    return mm.reshape(res, res).T


@solves_on_device
def batch_mismatch_omega_bordered(times, data, modes, Mf, chif, re_minmax,
                                  im_minmax, t0, t0_method="geq", T=100,
                                  res=50, a_chunk=8, mesh=None,
                                  return_amplitudes=False, device="cuda"):
    """The free complex-frequency grid through the bordered fixed block
    (batched.py:799): the fixed QNMs' Gram block is factored once and
    each grid point is a bordered solve through L^-1, with closed-form
    cross Grams on uniform time grids.  It solves no batched system, so
    it launches no solve kernel.  mm is (res, res) indexed [im, re] like
    the reference (qnmfits.py:1825); with return_amplitudes=True also C
    (res, res, Jf + 1) in the same layout (fixed modes first, the free
    mode last).  ``mesh`` (or 'auto') shards the Re axis over its 'sweep'
    ranks (``parallel.mesh.sharded_omega_grid_bordered``)."""
    check_spin(chif)
    _check_t0_method(t0_method)
    dev = resolve_device(device)
    if mesh is not None:
        mesh = _mesh_for(mesh, dev)
    times, rows, _ = _prep(times, data, None)
    _single_row(rows, "batch_mismatch_omega_bordered")
    times_t = _real(times, dev)
    t0_t = torch.tensor(float(t0), dtype=RDTYPE, device=dev)
    w = _window(times_t, t0_t, float(T), t0_method)
    args = (times_t, _cplx(rows[0], dev),
            _cplx(_omega_fixed(modes, Mf, chif), dev),
            _real(np.linspace(*re_minmax, res), dev),
            _real(np.linspace(*im_minmax, res), dev), t0_t, w)
    if mesh is not None:
        from .parallel.mesh import sharded_omega_grid_bordered
        C, mm = sharded_omega_grid_bordered(*args, mesh, a_chunk=a_chunk,
                                            analytic=_uniform_spacing(times))
    else:
        C, mm = sweep_omega_grid_bordered_real(
            *args, a_chunk=a_chunk, analytic=_uniform_spacing(times))
    mm = mm.cpu().numpy().reshape(res, res).T
    if return_amplitudes:
        # Kernel order is q = re_idx * res + im_idx; realign to mm's
        # [im, re] layout.
        return mm, C.cpu().numpy().reshape(res, res, -1).transpose(1, 0, 2)
    return mm
