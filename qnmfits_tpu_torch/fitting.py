"""Public fitting entry points (port of qnmfits_tpu/fitting.py): the
single fits, their dynamic forms, the start-time, mode-set, (Mf, chif)
and free-frequency sweeps, static or with time-dependent spectra, the
optimisers and the rational filter.

Every entry point takes ``device=`` ("cuda" by default, raising when
there is none; "cpu" runs the plain PyTorch path).  The single fits solve
by SVD least squares (``ops/solve.svd_lstsq``) so their result dicts carry
'residual', 'rank' and 's' like np.linalg.lstsq; every sweep solves its
batched normal equations with the CUDA kernel on the card.  The sweeps
take ``mesh=`` (engine='sharded'): a ``parallel.mesh.sweep_mesh`` of
torch.distributed ranks, or 'auto' for every rank of the initialised
process group, over whose 'sweep' ranks the start times or grid points
are sharded; every rank calls with the same arguments and gets the whole
result.  precision='x64' is the only precision: the JAX package's f32
path is a TPU workaround.
"""

from __future__ import annotations

import numpy as np
import torch

from . import CDTYPE, RDTYPE, resolve_device
from . import batched, ref_impl
from .engine import _window, cached_evaluator, check_spin
from .ops.cmath import damped_phase
from .ops.solve import svd_lstsq
from .ref_impl import (  # noqa: F401  (re-exported reference primitives)
    mask_times,
    mismatch,
    multimode_mismatch,
    ringdown,
)
from .spectrum.tables import solves_on_device

__all__ = [
    "ringdown", "mismatch", "multimode_mismatch",
    "ringdown_fit", "dynamic_ringdown_fit",
    "multimode_ringdown_fit", "dynamic_multimode_ringdown_fit",
    "mismatch_t0_array", "mismatch_t0_mode_sets",
    "mismatch_M_chi_grid", "mismatch_omega_grid", "rational_filter",
    "calculate_epsilon", "free_frequency_fit",
]


def _canon_modes(modes):
    return tuple(tuple(int(x) for x in m) for m in modes)


def _check_precision(precision):
    if precision != "x64":
        raise NotImplementedError(
            f"precision={precision!r}: qnmfits_tpu_torch computes in "
            "float64/complex128 only ('x64'); the JAX package's f32 path is "
            "a TPU workaround")


# ---------------------------------------------------------------------------
# Single fits (fitting.py:57-244; reference qnmfits.py:142-911)
# ---------------------------------------------------------------------------

def _masked_to_np(arr, sel):
    return np.asarray(arr)[..., sel]


def _run_fit(times, data_rows, modes, Mf, chif, t0, t0_method, T,
             spherical_modes, delta, precision, dynamic, device):
    """Shared single-fit driver (fitting.py:97): the windowed design
    matrix, its SVD least squares and the model, on ``device``.  Returns
    the reference-style dict pieces as NumPy arrays."""
    _check_precision(precision)
    check_spin(chif)
    dev = resolve_device(device)
    modes = _canon_modes(modes)
    sph = (tuple(tuple(lm) for lm in spherical_modes)
           if spherical_modes is not None else None)
    ev = cached_evaluator(modes, sph)
    times_np = np.asarray(times, float)
    t = torch.tensor(times_np, dtype=RDTYPE, device=dev)
    data = torch.tensor(np.asarray(data_rows, complex), dtype=CDTYPE,
                        device=dev)                          # (I, K)
    w = _window(t, float(t0), float(T), t0_method)
    dt = (t - float(t0)) * w                                 # window-clamped

    if dynamic:
        omega = ev.omega(np.asarray(chif, float), np.asarray(Mf, float)).T
        mu = (np.ones((1,) + omega.shape, complex) if sph is None
              else np.moveaxis(ev.mu(np.asarray(chif, float)), -1, 1))
        phi = damped_phase(torch.tensor(omega, dtype=CDTYPE, device=dev),
                           dt[:, None])                      # (K, J)
        blocks = torch.tensor(mu, dtype=CDTYPE, device=dev) * phi[None]
    else:
        df = np.asarray(ref_impl._delta_factor(delta, len(modes)))
        omega = ev.omega(chif, Mf, df)                       # (J,)
        mu = (np.ones((1, omega.shape[0]), complex) if sph is None
              else ev.mu(chif))                              # (I, J)
        phi = damped_phase(torch.tensor(omega, dtype=CDTYPE, device=dev)
                           [None, :], dt[:, None])
        blocks = torch.tensor(mu, dtype=CDTYPE, device=dev)[:, None, :] \
            * phi[None]                                      # (I, K, J)

    I, K, J = blocks.shape
    a = (blocks * w[None, :, None]).reshape(I * K, J)
    d = (data * w[None, :]).reshape(I * K)
    C, res, rank, sv = svd_lstsq(a, d)
    model = (blocks.reshape(I * K, J) @ C).reshape(I, K)

    sel = w.cpu().numpy().astype(bool)
    return dict(C=C.cpu().numpy(), residual=res.cpu().numpy(),
                rank=int(rank), s=sv.cpu().numpy(),
                model=_masked_to_np(model.cpu().numpy(), sel),
                data=_masked_to_np(np.asarray(data_rows), sel),
                model_times=times_np[sel], omega=np.asarray(omega),
                mu=np.asarray(mu), w=w.cpu().numpy())


def _tracks(times, Mf, chif):
    K = len(np.asarray(times))
    Mf_t = np.full(K, Mf) if np.ndim(Mf) == 0 else np.asarray(Mf)
    chif_t = np.full(K, chif) if np.ndim(chif) == 0 else np.asarray(chif)
    return Mf_t, chif_t


@solves_on_device
def ringdown_fit(times, data, modes, Mf, chif, t0, t0_method="geq", T=100,
                 delta=0.0, precision="x64", device="cuda"):
    """Least-squares ringdown fit to a single complex series
    (reference qnmfits.py:142-315)."""
    r = _run_fit(times, np.asarray(data)[None, :], modes, Mf, chif, t0,
                 t0_method, T, None, delta, precision, False, device)
    tm, model, dm = r["model_times"], r["model"][0], r["data"][0]
    return {
        "residual": r["residual"], "rank": r["rank"], "s": r["s"],
        "mismatch": mismatch(tm, model, dm),
        "C": r["C"], "data": dm, "model": model, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(tuple(m)) for m in modes],
        "frequencies": r["omega"],
    }


@solves_on_device
def dynamic_ringdown_fit(times, data, modes, Mf, chif, t0, t0_method="geq",
                         T=100, precision="x64", device="cuda"):
    """Single-series fit with time-dependent (Mf(t), chif(t)) given per
    sample (reference qnmfits.py:318-475)."""
    Mf_t, chif_t = _tracks(times, Mf, chif)
    r = _run_fit(times, np.asarray(data)[None, :], modes, Mf_t, chif_t, t0,
                 t0_method, T, None, 0.0, precision, True, device)
    tm, model, dm = r["model_times"], r["model"][0], r["data"][0]
    sel = r["w"].astype(bool)
    return {
        "residual": r["residual"],
        "mismatch": mismatch(tm, model, dm),
        "C": r["C"], "data": dm, "model": model, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(tuple(m)) for m in modes],
        "frequencies": r["omega"][sel].T,
    }


def _stack_rows(data_dict, spherical_modes):
    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())
    rows = np.stack([np.asarray(data_dict[lm]) for lm in spherical_modes])
    return rows, spherical_modes


@solves_on_device
def multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                           t0_method="geq", T=100, spherical_modes=None,
                           precision="x64", device="cuda"):
    """Joint fit across spherical-harmonic modes with mixing-weighted
    shared amplitudes (reference qnmfits.py:478-673)."""
    rows, spherical_modes = _stack_rows(data_dict, spherical_modes)
    r = _run_fit(times, rows, modes, Mf, chif, t0, t0_method, T,
                 spherical_modes, 0.0, precision, False, device)
    tm = r["model_times"]
    model_dict = {lm: r["model"][i] for i, lm in enumerate(spherical_modes)}
    data_mask = {lm: r["data"][i] for i, lm in enumerate(spherical_modes)}
    weighted_C = {lm: r["mu"][i] * r["C"]
                  for i, lm in enumerate(spherical_modes)}
    return {
        "residual": r["residual"],
        "mismatch": multimode_mismatch(tm, model_dict, data_mask),
        "C": r["C"], "weighted_C": weighted_C,
        "data": data_mask, "model": model_dict, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(tuple(m)) for m in modes],
        "frequencies": r["omega"],
    }


@solves_on_device
def dynamic_multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                                   t0_method="geq", T=100,
                                   spherical_modes=None, precision="x64",
                                   device="cuda"):
    """Multimode fit with a time-dependent spectrum
    (reference qnmfits.py:676-911)."""
    rows, spherical_modes = _stack_rows(data_dict, spherical_modes)
    Mf_t, chif_t = _tracks(times, Mf, chif)
    r = _run_fit(times, rows, modes, Mf_t, chif_t, t0, t0_method, T,
                 spherical_modes, 0.0, precision, True, device)
    tm = r["model_times"]
    sel = r["w"].astype(bool)
    model_dict = {lm: r["model"][i] for i, lm in enumerate(spherical_modes)}
    data_mask = {lm: r["data"][i] for i, lm in enumerate(spherical_modes)}
    mu_masked = r["mu"][:, sel, :]             # (I, Km, J)
    weighted_C = {lm: mu_masked[i] * r["C"][None, :]
                  for i, lm in enumerate(spherical_modes)}
    freqs = r["omega"][sel]                    # (Km, J)
    return {
        "residual": r["residual"],
        "mismatch": multimode_mismatch(tm, model_dict, data_mask),
        "C": r["C"], "weighted_C": weighted_C,
        "data": data_mask, "model": model_dict, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(tuple(m)) for m in modes],
        "frequencies": np.vstack(len(spherical_modes) * [freqs]),
    }


# ---------------------------------------------------------------------------
# Sweeps (fitting.py:247-423)
# ---------------------------------------------------------------------------

@solves_on_device
def mismatch_t0_array(times, data, modes, Mf, chif, t0_array,
                      t0_method="geq", T_array=100, spherical_modes=None,
                      delta=0.0, engine="batched", precision="x64",
                      mesh=None, dedup=True, device="cuda"):
    """Mismatch vs ringdown start time (reference qnmfits.py:1183-1301).

    engine: 'batched' (default) -- all start times on the complex fit core,
    any window method; 'fast' -- the factored kernel ('geq', t0_array
    sorted ascending); 'sharded' -- the factored kernel with the start
    times sharded over ``mesh``'s 'sweep' ranks ('auto' when None: every
    rank of the initialised torch.distributed process group; each rank
    calls with the same arguments and gets the whole result); 'loop' --
    the reference-style serial NumPy loop (``ref_impl``, on the host).  A
    ``mesh`` given to 'batched' or 'fast' runs 'sharded'.  With (K,)
    Mf/chif time tracks 'batched' and 'fast' run the dynamic-spectrum
    sweep (any window method, any order), over ``mesh`` where one is
    given.  dedup=True solves each distinct window once (exact for
    static spectra); 'loop' and the dynamic sweep always run per t0.
    """
    _check_precision(precision)
    if engine == "loop":
        return ref_impl.mismatch_t0_array(
            times, data, modes, Mf, chif, t0_array, t0_method, T_array,
            spherical_modes, delta)
    if engine not in ("batched", "fast", "sharded"):
        raise ValueError(f"unknown engine {engine!r}")
    if np.ndim(Mf) != 0 or np.ndim(chif) != 0:
        if engine == "sharded":
            raise ValueError(
                "engine='sharded' needs a static spectrum; use "
                "engine='batched' or 'fast' for time-dependent Mf/chif")
        batched._no_delta(delta)
        return batched.batch_mismatch_t0_dynamic(
            times, data, modes, Mf, chif, t0_array, t0_method=t0_method,
            T_array=T_array, spherical_modes=spherical_modes, engine=engine,
            mesh=mesh, device=device)
    if engine == "sharded" or mesh is not None:
        if t0_method != "geq":
            raise ValueError("engine='sharded' supports t0_method='geq' only")
        return batched.batch_mismatch_t0_sharded(
            times, data, modes, Mf, chif, t0_array, T_array=T_array,
            spherical_modes=spherical_modes, delta=delta, mesh=mesh,
            dedup=dedup, device=device)
    if engine == "fast":
        if t0_method != "geq":
            raise ValueError("engine='fast' supports t0_method='geq' only")
        return batched.batch_mismatch_t0_fast(
            times, data, modes, Mf, chif, t0_array, T_array=T_array,
            spherical_modes=spherical_modes, delta=delta, dedup=dedup,
            device=device)
    return batched.batch_mismatch_t0(
        times, data, modes, Mf, chif, t0_array, t0_method=t0_method,
        T_array=T_array, spherical_modes=spherical_modes, delta=delta,
        dedup=dedup, device=device)


@solves_on_device
def mismatch_t0_mode_sets(times, data, mode_sets, Mf, chif, t0_array,
                          T_array=100, *, t0_method="geq",
                          spherical_modes=None, return_amplitudes=False,
                          mesh=None, dynamic=False, bucket=False,
                          dedup=True, device="cuda"):
    """Mismatch vs start time for many mode sets in one sweep
    (fitting.py:309): the reference's doubly nested loop over mode sets
    and start times (qnmfits.py:1183-1301 per set).

    mode_sets: list of mode lists (ragged lengths are padded with
    exact-zero amplitude slots).  t0_method='geq' (default; t0_array
    sorted ascending, the factored kernel) or 'closest' (the complex
    window sweep).  chif and/or Mf may be 1-D arrays, a remnant axis R
    folded into the set axis.  bucket=True runs one factored sweep per
    padded width.  dedup=True solves each distinct window once (exact
    for static spectra).  With dynamic=True, Mf/chif are instead scalars
    or (K,) time tracks and every (set, t0) pair is a dynamic-spectrum fit
    (any window method and order, never deduplicated).  Runs on
    ``device``.  Returns mm (S, B), or (S, R, B) with a remnant axis; with
    return_amplitudes=True also a list of per-set complex (B,
    len(mode_set)) (or (R, B, len)) arrays.  ``mesh`` (a
    ``parallel.mesh.sweep_mesh``, or 'auto': every rank of the initialised
    torch.distributed process group) shards the start times over its
    'sweep' ranks: 'geq' windows for a static spectrum, any window method
    with dynamic=True; every rank calls with the same arguments and gets
    the whole result.
    """
    if dynamic:
        if bucket:
            raise ValueError("bucket=True is not supported for the "
                             "dynamic mode-set sweep")
        return batched.batch_mismatch_t0_modesets_dynamic(
            times, data, mode_sets, Mf, chif, t0_array, t0_method=t0_method,
            T_array=T_array, spherical_modes=spherical_modes,
            return_amplitudes=return_amplitudes, mesh=mesh, device=device)
    return batched.batch_mismatch_t0_modesets(
        times, data, mode_sets, Mf, chif, t0_array, T_array=T_array,
        spherical_modes=spherical_modes, return_amplitudes=return_amplitudes,
        t0_method=t0_method, bucket=bucket, dedup=dedup, mesh=mesh,
        device=device)


def _grid_engine(engine, mesh, engines):
    """The grid's engine, and its mesh: 'sharded' runs 'fast' over
    ``mesh`` ('auto' when None); a mesh is taken by the engines that
    shard ('fast', 'fast-full'), and refused by the others."""
    if engine not in engines + ("sharded",):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "sharded":
        return "fast", "auto" if mesh is None else mesh
    if mesh is not None and engine not in ("fast", "fast-full"):
        raise ValueError(f"engine={engine!r} takes no mesh; use "
                         "engine='sharded'")
    return engine, mesh


@solves_on_device
def mismatch_M_chi_grid(times, data, modes, Mf_minmax, chif_minmax, t0,
                        t0_method="geq", T=100, res=50,
                        spherical_modes=None, delta=0.0, engine="batched",
                        precision="x64", mesh=None, device="cuda"):
    """Mismatch over an (Mf, chif) grid (reference qnmfits.py:1304-1415),
    row-major over Mf rows and chif columns.  engine: 'batched' (default;
    chunks of summed-Gram fits, one launch of the CUDA solve), 'fast' (the
    stacked engine: closed-form Grams on the shared window and one solve
    for the whole grid, on uniform time grids) or 'loop' (the
    reference-style NumPy loop).  engine='sharded' runs 'fast' with the
    grid points sharded over ``mesh``'s 'sweep' ranks ('auto' when None:
    every rank of the initialised torch.distributed process group); a
    mesh given to 'fast' does the same."""
    _check_precision(precision)
    engine, mesh = _grid_engine(engine, mesh, ("batched", "fast", "loop"))
    if engine == "loop":
        return ref_impl.mismatch_M_chi_grid(
            times, data, modes, Mf_minmax, chif_minmax, t0, t0_method, T,
            res, spherical_modes, delta)
    kw = dict(t0_method=t0_method, T=T, res=res,
              spherical_modes=spherical_modes, delta=delta, device=device)
    if engine == "fast":
        return batched.batch_mismatch_M_chi_fast(
            times, data, modes, Mf_minmax, chif_minmax, t0, mesh=mesh, **kw)
    return batched.batch_mismatch_M_chi(times, data, modes, Mf_minmax,
                                        chif_minmax, t0, **kw)


@solves_on_device
def mismatch_omega_grid(times, data, modes, Mf, chif, re_minmax, im_minmax,
                        t0, t0_method="geq", T=100, res=50,
                        engine="batched", precision="x64", mesh=None,
                        device="cuda"):
    """Mismatch over a complex-frequency grid for one free mode on top of
    fixed QNMs (reference qnmfits.py:1679-1827), transposed like the
    reference.  engine: 'batched' (default; one batched sweep through the
    CUDA solve), 'fast' (the bordered fixed block, factored once, with a
    bordered solve per grid point), 'fast-full' (the stacked engine of
    the (Mf, chif) grid, every grid point a full fit) or 'loop'.
    engine='sharded' runs 'fast' with the Re axis sharded over ``mesh``'s
    'sweep' ranks ('auto' when None); a mesh given to 'fast' or
    'fast-full' shards their grid the same way."""
    _check_precision(precision)
    engine, mesh = _grid_engine(engine, mesh,
                                ("batched", "fast", "fast-full", "loop"))
    if engine == "loop":
        return ref_impl.mismatch_omega_grid(
            times, data, modes, Mf, chif, re_minmax, im_minmax, t0,
            t0_method, T, res)
    kw = dict(t0_method=t0_method, T=T, res=res, device=device)
    if engine != "batched":
        kw["mesh"] = mesh
    grid = {"fast": batched.batch_mismatch_omega_bordered,
            "fast-full": batched.batch_mismatch_omega_fast,
            "batched": batched.batch_mismatch_omega}[engine]
    return grid(times, data, modes, Mf, chif, re_minmax, im_minmax, t0,
                **kw)


@solves_on_device
def rational_filter(times, data, modes, Mf, chif, t_start=-300, t_end=None,
                    dt=None, t_taper=100, align_inspiral=True,
                    engine="torch", device="cuda"):
    """Frequency-domain removal of QNM content, Ma et al. arXiv:2207.10870
    (reference qnmfits.py:2046-2152).  engine='torch' (default) runs the
    taper, FFT, filter and inverse FFT in torch on ``device``
    (``filters.rational_filter_torch``); engine='numpy' is the NumPy
    oracle on the host.  Both agree to <= 1e-12 of max |data|.  Returns
    (uniform_times, filtered_data)."""
    if engine == "numpy":
        return ref_impl.rational_filter(
            times, data, modes, Mf, chif, t_start, t_end, dt, t_taper,
            align_inspiral)
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} ('torch' or 'numpy')")
    from .filters import rational_filter_torch
    return rational_filter_torch(
        times, data, modes, Mf, chif, t_start, t_end, dt, t_taper,
        align_inspiral, device=device)


# ---------------------------------------------------------------------------
# Optimisers (fitting.py:426-479)
# ---------------------------------------------------------------------------

@solves_on_device
def calculate_epsilon(times, data, modes, Mf, chif, t0, t0_method="geq",
                      T=100, spherical_modes=None, min_method="gradient",
                      delta=0.0, x0=None, device="cuda"):
    """Best-fit remnant (Mf, chif) and its distance epsilon from the given
    one (reference qnmfits.py:1418-1594).  min_method='gradient'
    (default) runs L-BFGS-B on the differentiable mismatch on ``device``
    (``optimize.calculate_epsilon_gradient``); any scipy method name runs
    the NumPy oracle (``ref_impl.calculate_epsilon``) on the host."""
    if min_method == "gradient":
        from .optimize import calculate_epsilon_gradient
        return calculate_epsilon_gradient(
            times, data, modes, Mf, chif, t0, t0_method, T,
            spherical_modes, delta, x0, device=device)
    return ref_impl.calculate_epsilon(
        times, data, modes, Mf, chif, t0, t0_method, T, spherical_modes,
        min_method, delta, x0)


@solves_on_device
def free_frequency_fit(times, data, t0, modes=[], Mf=None, chif=None,
                       t0_method="geq", T=100, min_method="gradient",
                       device="cuda"):
    """Best free complex frequency on top of fixed QNMs (reference
    qnmfits.py:1905-2043).  min_method='gradient' (default) runs L-BFGS-B
    on the differentiable mismatch on ``device``; any scipy method name
    runs the NumPy oracle on the host."""
    if min_method == "gradient":
        from .optimize import free_frequency_fit_gradient
        return free_frequency_fit_gradient(
            times, data, t0, modes, Mf, chif, t0_method, T, device=device)
    return ref_impl.free_frequency_fit(
        times, data, t0, modes, Mf, chif, t0_method, T, min_method)
