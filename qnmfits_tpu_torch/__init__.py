"""qnmfits_tpu_torch: the PyTorch/CUDA port of qnmfits_tpu.

Each module is named after the qnmfits_tpu module it ports, which stays
the reference the port is tested against.  The port covers the fitting
surface: the single fits (``ringdown_fit``, ``multimode_ringdown_fit``
and their dynamic forms), ``mismatch_t0_array`` (static or with Mf/chif
time tracks), ``mismatch_t0_mode_sets`` (windows 'geq' or 'closest', a
remnant axis, width buckets, ``dynamic=True``), the (Mf, chif) and
free-frequency grids ('batched', the stacked 'fast' / 'fast-full', the
bordered 'fast'), the catalog event batch ``fit_events``, the optimisers
(``calculate_epsilon``, ``free_frequency_fit`` and their every-start-time
forms ``calculate_epsilon_array`` and ``free_frequency_fit_array``), and
the diagnostics: ``rational_filter``, ``amplitude_stability``,
``orthonormal_decomposition``, ``orthonormal_t0_sweep``,
``amplitude_uncertainty`` and ``mode_selection`` (with ``mapping_modes=``
too); and the spatial mapping of linear and quadratic QNMs, the submodule
``spatial`` (the mapping fit ``mapping_multimode_ringdown_fit``, its
start-time sweep ``mapping_mismatch_t0_array``, the Qmu predictions A-D,
the sky predictions and spatial mismatches), with what it needs:
``harmonics``, ``spectrum.angular``, the s = 0 and s = -1 tables and the
``qnm`` class (``qnm_api``); and the host layers around the fits: the
waveform containers ``Custom``, ``SXS``, ``NRSur7dq4`` and ``NRHybSur3dq8``
(``waveforms``, loaded lazily, as is the module-level ``qnm``), the six
plotting functions, ``download_cook_data`` and ``utils`` (``timed``,
``debug_nans``, ``sweep_progress``, ``resumable_sweep``); and the
multi-device sweeps, ``parallel`` (loaded lazily): every ``mesh=`` and
engine='sharded' shards a sweep over a ('sweep', 'time')
``torch.distributed`` DeviceMesh of ranks, each rank calling with the
same arguments and getting the whole result; ``mesh='auto'`` needs an
initialised process group (``parallel.mesh.sweep_mesh``).  That is the
whole surface of qnmfits_tpu; its f32 precision, a TPU workaround, is
not ported.  Every batched Hermitian solve runs in the hand-written FP64
CUDA kernels (``ops/chol_cuda.py``, ``csrc/chol_solve.cu``), forward and,
for the optimisers, backward, on every rank of a mesh.

Device and dtype policy:

* entry points take ``device=``, default ``"cuda"``; without CUDA they
  raise unless the caller asks for ``device="cpu"`` -- never a silent
  fallback;
* every tensor is float64 or complex128, created with an explicit dtype
  (torch's default dtype is float32).
"""

import torch

RDTYPE = torch.float64
CDTYPE = torch.complex128

# On the CPU, torch's float64 exp, expm1, sin and cos call MKL's vector
# math library, which sets itself up on its first call.  When several
# threads make that first call at once, one of them has been seen to
# return exp to only ~3e-9 relative, enough to move a sweep's mismatch by
# 2.4e-10.  One single-element call here makes the set-up on one thread.
for _fn in (torch.exp, torch.expm1, torch.sin, torch.cos):
    _fn(torch.zeros(1, dtype=RDTYPE))
del _fn


def resolve_device(device="cuda") -> torch.device:
    """The torch device for an entry point; raises when CUDA is asked
    for (the default) and unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qnmfits_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


from .fitting import (  # noqa: E402
    calculate_epsilon,
    dynamic_multimode_ringdown_fit,
    free_frequency_fit,
    dynamic_ringdown_fit,
    mismatch,
    mismatch_M_chi_grid,
    mismatch_omega_grid,
    mismatch_t0_array,
    mismatch_t0_mode_sets,
    multimode_mismatch,
    multimode_ringdown_fit,
    rational_filter,
    ringdown,
    ringdown_fit,
)
from .batched import batch_fit_events as fit_events  # noqa: E402
from .optimize import (  # noqa: E402
    calculate_epsilon_array,
    free_frequency_fit_array,
)
from .stability import amplitude_stability  # noqa: E402
from .orthonormal import (  # noqa: E402
    orthonormal_decomposition,
    orthonormal_t0_sweep,
)
from .uncertainty import amplitude_uncertainty, mode_selection  # noqa: E402
from .plotting import (  # noqa: E402
    plot_amplitude_stability,
    plot_mismatch_M_chi_grid,
    plot_mismatch_omega_grid,
    plot_mode_amplitudes,
    plot_ringdown,
    plot_ringdown_modes,
)
from .qnm_api import download_cook_data  # noqa: E402
from . import spatial, utils  # noqa: E402

_WAVEFORMS = ("Custom", "SXS", "NRSur7dq4", "NRHybSur3dq8")


def __getattr__(name):
    # The module-level spectrum instance of the reference
    # (qnmfits/__init__.py:5-6) and the waveform classes, made on first
    # use as qnmfits_tpu/__init__.py:104-119 makes them: importing the
    # package reads no table.
    if name == "qnm":
        from .qnm_api import get_qnm
        return get_qnm()
    if name in _WAVEFORMS:
        from . import waveforms
        return getattr(waveforms, name)
    if name == "parallel":
        import importlib
        return importlib.import_module(".parallel", __name__)
    raise AttributeError(
        f"module 'qnmfits_tpu_torch' has no attribute {name!r}")


__all__ = [
    "CDTYPE", "RDTYPE", "resolve_device",
    "ringdown", "mismatch", "multimode_mismatch",
    "ringdown_fit", "dynamic_ringdown_fit",
    "multimode_ringdown_fit", "dynamic_multimode_ringdown_fit",
    "mismatch_t0_array", "mismatch_t0_mode_sets",
    "mismatch_M_chi_grid", "mismatch_omega_grid", "fit_events",
    "calculate_epsilon", "free_frequency_fit", "calculate_epsilon_array",
    "free_frequency_fit_array", "rational_filter", "amplitude_stability",
    "orthonormal_decomposition", "orthonormal_t0_sweep",
    "amplitude_uncertainty", "mode_selection", "spatial",
    "plot_ringdown", "plot_ringdown_modes", "plot_mode_amplitudes",
    "plot_mismatch_M_chi_grid", "plot_mismatch_omega_grid",
    "plot_amplitude_stability", "download_cook_data", "utils", "qnm",
    "parallel", *_WAVEFORMS,
]
