"""Window moments of damped phases as a hand-written FP64 CUDA kernel
(``csrc/window_moments.cu``) for Hopper.

For trajectory m on window n = win[m] (start time t0 = t0s[n], {0,1}
weights w_k, the window's trapezoid weights tau_k, offsets s_k = (t_k -
t0) w_k and phases phi_jk = exp(-i omega_mj s_k)), and for v in {w, tau}
and p = 0 .. order::

    S[m, v, p, j, l] = sum_k v_k s_k^p conj(phi_jk) phi_lk     (Hermitian)
    P[m, v, p, i, j] = sum_k v_k s_k^p conj(phi_jk) h_ik

At order 0 these are the Grams and projections of ``engine.fit_systems``
before the mixing; the x-derivatives of a fit need the orders 1 and 2
(``optimize._fit_derivs``).  The kernel replaces no Pallas kernel: it
replaces the (M, K, J) designs that the JAX package's ``jax.grad`` /
``jax.hessian`` of ``engine.fit_core`` leave to XLA
(``qnmfits_tpu/optimize.py:177-209`` over ``engine.py:198``).  Its plain
PyTorch version is ``window_moments_plain``; ``window_moments`` takes it
for tensors on the CPU, launches the kernel for CUDA tensors, and raises
on anything else.  Nothing falls back.  tau is always the trapezoid
weights of w (``ops/windows.trapz_weights``), so neither function takes
it.

The kernel has two variants: on a uniform grid (``moments_grid``, the
port's gate ``batched._uniform_spacing`` with the grid's fitted step)
each phase is a tile's anchor times a step from a table made once a
trajectory, and the tau moments follow from the w moments and the
window's two end samples, tau unread; on any other grid each phase is
its own sincos and exp and the tau moments are summed.  Both sum on the
FP64 tensor cores.  ``plan`` reads a launch's shape from the source
(``qnm_window_moments_plan``); ``last_plan`` is the last launch's.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags), as ``ops/chol_cuda.py`` builds
the solve, and bound with ctypes.  ``phase_cycles`` builds it with
``-DQNM_MOMENTS_PHASES`` and reads a warp's cycles by phase.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc
from .cmath import damped_phase
from .sweep_cuda import _check_nans
from .windows import trapz_weights

__all__ = ["KERNEL", "PHASES", "VARIANTS", "bind_plan", "build", "last_plan",
           "launches",
           "moments_grid", "phase_cycles", "plan", "ptxas_report",
           "window_bounds", "window_moments", "window_moments_plain"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "window_moments.cu"
BUILD_LOG = BUILD_DIR / "window_moments_build.log"
KERNEL = "window_moments_kernel"
ORDERS = (0, 1, 2)
# The kernel's variants: the uniform grid's (anchors and a step table, the
# tau moments from the w moments) and any grid's; the template's second
# argument is the number of weights summed, 1 or 2.
VARIANTS = ("uniform", "general")
# The phases build (``phase_cycles``): its flag, its counters by index
# (then the warps that added theirs).
PHASE_FLAGS = ("-DQNM_MOMENTS_PHASES",)
PHASES = ("set-up", "anchors", "operands", "mma", "epilogue")
# Most bytes of one (chunk, K, J) complex128 phase basis of the plain
# version: it runs its trajectories in chunks within it.
PLAIN_BYTES = 1 << 28

# Kernel launches since the last reset (callers set it to 0 and read it),
# and the last launch's ``plan``.
launches = 0
last_plan = None


def build(phases: bool = False) -> Path:
    """Compile the kernel library if this source has not been built so
    yet; returns its path.  ``phases`` adds the clock64 counters
    (``phase_cycles``).  ptxas's register and spill report is kept in
    ``BUILD_LOG`` (the phases build's beside it).  Raises RuntimeError
    without nvcc."""
    extra = PHASE_FLAGS if phases else ()
    all_flags = (*NVCC_FLAGS, *extra)
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(all_flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libwindow_moments_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *all_flags, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log = _build_log(phases, tag)
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _build_log(phases: bool, tag: str) -> Path:
    """The build log: ``BUILD_LOG`` for the plain build, one named by the
    library's tag for the phases build."""
    return BUILD_LOG.with_name(f"window_moments_build_{tag}.log") \
        if phases else BUILD_LOG


def ptxas_report(phases: bool = False) -> dict:
    """ptxas's report of a build (``build``'s argument):
    {"<variant>_order<p>": dict(registers=, spill_stores=, spill_loads=)}
    for each of ``VARIANTS`` and p = 0, 1, 2, spills in bytes.  Raises
    when the log is not that of the library ``build`` returns."""
    lib = build(phases)
    log = _build_log(phases, lib.stem.rsplit("_", 1)[1])
    text = log.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{log} is not the build log of {lib.name}")
    report = {}
    for block in text.split("Compiling entry function")[1:]:
        name = re.search(rf"{KERNEL}ILi(\d)ELi(\d)E", block.splitlines()[0])
        if name is None:
            raise RuntimeError(f"unknown kernel in {log}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[f"{VARIANTS[int(name[2]) - 1]}_order{name[1]}"] = dict(
            registers=int(regs[1]), spill_stores=int(spill[1]),
            spill_loads=int(spill[2]))
    want = {f"{v}_order{p}" for v in VARIANTS for p in ORDERS}
    if set(report) != want:
        raise RuntimeError(f"{log} reports kernels {sorted(report)}")
    return report


def bind_plan(lib):
    """Declare the source's ``qnm_window_moments_plan`` on a ctypes
    library of it (this module's build, or a host build of the source);
    returns the library."""
    lib.qnm_window_moments_plan.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.qnm_window_moments_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _lib(phases: bool = False):
    lib = bind_plan(ctypes.CDLL(str(build(phases))))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qnm_window_moments.argtypes = ([ptr] * 10 + [i32] * 3 + [i64]
                                       + [i32] * 2 + [ctypes.c_double, ptr])
    lib.qnm_window_moments.restype = ctypes.c_int
    if phases:
        lib.qnm_moments_phases.argtypes = [ptr, i32]
        lib.qnm_moments_phases.restype = ctypes.c_int
    return lib


def plan(I: int, J: int, order: int, uniform: bool, M: int,
         lib=None) -> dict:
    """The kernel's launch for M trajectories, I data rows, J modes and
    the order, on a uniform grid or any grid, as the source makes it
    (``qnm_window_moments_plan`` of ``lib``, a library with it bound by
    ``bind_plan``; this module's build by default): the variant, the
    units a trajectory (a row mode group of 8 modes with one column mode
    group of the Gram's upper block triangle and up to ``h_per_unit`` of
    the ``h_frags`` data column fragments, then units of data fragments
    only where those have no room), warps a block, samples a tile between
    anchors, warps a unit (``split``: a block a unit for small launches,
    its warps sharing the window's tiles; else a warp) and dynamic shared
    bytes a block.  Raises ValueError for an order outside 0-2, I or J <
    1, or more shared bytes than a block can have."""
    if order not in ORDERS or I < 1 or J < 1:
        raise ValueError(f"window_moments: no plan for I={I}, J={J}, "
                         f"order {order}")
    out = (ctypes.c_longlong * 8)()
    (lib or _lib()).qnm_window_moments_plan(M, I, J, order, int(uniform), out)
    units, warps, tile, smem, h_frags, nh, split, smem_max = out
    variant = VARIANTS[0 if uniform else 1]
    if smem > smem_max:
        raise ValueError(f"window_moments: {I} data rows need {smem} bytes "
                         f"of shared memory a block in the {variant} "
                         f"variant (at most {smem_max})")
    return dict(variant=variant, units=units, warps=warps, tile=tile,
                split=split, smem_bytes=smem, h_frags=h_frags,
                h_per_unit=nh)


def moments_grid(times) -> tuple:
    """(uniform, dlt) of a times tensor, from one copy of it to the host:
    the port's uniform-grid gate ``batched._uniform_spacing`` and, where
    it passes, the grid's fitted step ``engine_real._fitted_step`` (else
    0).  The kernel's variant and step; a caller with many launches on one
    grid makes it once (``optimize._Problem``)."""
    from ..batched import _uniform_spacing
    from ..engine_real import _fitted_step
    host = np.asarray(times.detach().cpu())
    uniform = bool(_uniform_spacing(host))
    return uniform, float(_fitted_step(host)) if uniform else 0.0


def window_bounds(w):
    """The first index and the sample count (N,) of each window of {0,1}
    weights w (N, K), one contiguous run each (every window of the
    package is); a window of no sample has count 0."""
    return w.argmax(dim=-1), w.sum(dim=-1).round().to(torch.int64)


def _shapes(times, rows, omega, t0s, w, win, order):
    if order not in ORDERS:
        raise ValueError(f"window_moments: order {order} (0, 1 or 2)")
    if times.dim() != 1 or rows.dim() != 2 or omega.dim() != 2:
        raise ValueError("window_moments: times (K,), rows (I, K) and "
                         "omega (M, J)")
    K, (I, J), M = times.shape[0], (rows.shape[0], omega.shape[1]), \
        omega.shape[0]
    N = t0s.shape[0] if t0s.dim() == 1 else -1
    if (rows.shape[1] != K or N < 0 or w.shape != (N, K)
            or win.shape != (M,)):
        raise ValueError(
            f"window_moments: shapes times {tuple(times.shape)}, rows "
            f"{tuple(rows.shape)}, omega {tuple(omega.shape)}, t0s "
            f"{tuple(t0s.shape)}, w {tuple(w.shape)}, win "
            f"{tuple(win.shape)} are not (K,), (I, K), (M, J), (N,), "
            "(N, K), (M,)")
    if K < 1 or I < 1 or J < 1:
        raise ValueError("window_moments: K, I and J must be at least 1")
    return K, I, J, M


def window_moments_plain(times, rows, omega, t0s, w, win, order):
    """The plain PyTorch version of the kernel, on any device: the sums of
    the module docstring over every sample, weighted by w and by its
    trapezoid weights, with the phases of ``ops/cmath.damped_phase`` at
    the window-clamped offsets (the formulas of ``engine.fit_systems``),
    in chunks of trajectories within ``PLAIN_BYTES`` of phases.  Returns S
    (M, 2, order + 1, J, J) and P (M, 2, order + 1, I, J) complex128."""
    K, I, J, M = _shapes(times, rows, omega, t0s, w, win, order)
    tau = trapz_weights(times, w)
    S = torch.empty((M, 2, order + 1, J, J), dtype=torch.complex128,
                    device=omega.device)
    P = torch.empty((M, 2, order + 1, I, J), dtype=torch.complex128,
                    device=omega.device)
    h = rows.to(torch.complex128)
    chunk = max(1, PLAIN_BYTES // (K * J * 16))
    for lo in range(0, M, chunk):
        hi = min(lo + chunk, M)
        n = win[lo:hi]
        wm = w[n]
        s = (times - t0s[n][:, None]) * wm                       # (m, K)
        phi = damped_phase(omega[lo:hi, None, :], s[..., None])  # (m, K, J)
        powers = [torch.ones_like(s), s, s * s][:order + 1]
        for v, vw in enumerate((wm, tau[n])):
            for p, sp in enumerate(powers):
                a = phi * (vw * sp)[..., None]
                S[lo:hi, v, p] = a.mH @ phi
                P[lo:hi, v, p] = h @ a.conj()
    return S, P


def window_moments(times, rows, omega, t0s, w, win, order, *, grid=None):
    """S (M, 2, order + 1, J, J) and P (M, 2, order + 1, I, J) complex128,
    the window moments of the module docstring.

    times (K,) float64; rows (I, K) complex128; omega (M, J) complex128;
    t0s (N,) float64; w (N, K) float64, each window one contiguous run of
    ones (``window_bounds``); win (M,) int64 window indices; order 0, 1
    or 2; grid ``moments_grid(times)``, which picks the kernel's variant
    (None: made here, one copy of times to the host a call).  CPU tensors
    take ``window_moments_plain``; CUDA tensors, contiguous, on one
    device, launch the kernel (one launch, counted in ``launches``; under
    ``utils.debug_nans`` its outputs are checked for NaN).  Anything else
    raises."""
    global launches
    tensors = dict(times=(times, torch.float64), rows=(rows, torch.complex128),
                   omega=(omega, torch.complex128), t0s=(t0s, torch.float64),
                   w=(w, torch.float64), win=(win, torch.int64))
    devices = {t.device for t, _ in tensors.values()}
    if len(devices) != 1:
        raise ValueError("window_moments: tensors on "
                         f"{sorted(map(str, devices))}")
    device, = devices
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"window_moments: {name} is {t.dtype}, not "
                            f"{dtype}")
    K, I, J, M = _shapes(times, rows, omega, t0s, w, win, order)
    if device.type == "cpu":
        return window_moments_plain(times, rows, omega, t0s, w, win, order)
    if device.type != "cuda":
        raise ValueError(f"window_moments: no kernel for device {device}")
    for name, (t, _) in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"window_moments: {name} is not contiguous")
    first, count = (b.to(torch.int32) for b in window_bounds(w))
    S = torch.empty((M, 2, order + 1, J, J), dtype=torch.complex128,
                    device=device)
    P = torch.empty((M, 2, order + 1, I, J), dtype=torch.complex128,
                    device=device)
    if M:
        if grid is None:
            grid = moments_grid(times)
        tau = None if grid[0] else trapz_weights(times, w)
        _launch(times, rows, omega, t0s, tau, first, count, win, S, P, order,
                grid)
        launches += 1
        _check_nans("window_moments", (S, P))
    return S, P


def _launch(times, rows, omega, t0s, tau, first, count, win, S, P, order,
            grid, lib=None):
    """One launch of the kernel on checked tensors (``window_moments``;
    first and count (N,) int32 from ``window_bounds``) into S and P, on
    the current stream, in the variant of ``grid`` = (uniform, dlt):
    ``moments_grid``'s, or (False, 0) for the general variant on any grid.
    tau, the windows' trapezoid weights (N, K), is read by the general
    variant only (None in the uniform one).  Sets ``last_plan``; raises on
    a launch error.  Not counted: the wrapper counts its launches, and
    checks time the kernel through this function (``lib``: another
    build's library, ``_lib``'s by default)."""
    global last_plan
    uniform, dlt = grid
    if not uniform and tau is None:
        raise ValueError("window_moments: the general variant reads tau")
    I, K = rows.shape
    M, J = omega.shape
    lib = lib or _lib()
    last_plan = plan(I, J, order, uniform, M, lib)
    with torch.cuda.device(omega.device):
        stream = torch.cuda.current_stream(omega.device).cuda_stream
        err = lib.qnm_window_moments(
            times.data_ptr(), rows.data_ptr(), omega.data_ptr(),
            t0s.data_ptr(), None if uniform else tau.data_ptr(),
            first.data_ptr(), count.data_ptr(), win.data_ptr(), S.data_ptr(),
            P.data_ptr(), K, I, J, M, order, int(uniform), float(dlt),
            stream)
    if err != 0:
        raise RuntimeError(f"window_moments kernel launch failed: CUDA "
                           f"error {err}")


def phase_cycles(times, rows, omega, t0s, w, win, order, grid=None) -> dict:
    """A warp's clock64 cycles by phase (``PHASES``; lane 0 of each warp
    that runs the epilogue, one a unit, summed over one launch of the
    phases build on these CUDA inputs and divided by those warps, whose
    count is ``warps``) and the variant run (``grid`` as ``_launch``
    takes it; None: ``moments_grid(times)``).  The clock reads slow what
    they time."""
    lib = _lib(True)
    first, count = (b.to(torch.int32) for b in window_bounds(w))
    M, J = omega.shape
    I = rows.shape[0]
    S = torch.empty((M, 2, order + 1, J, J), dtype=torch.complex128,
                    device=omega.device)
    P = torch.empty((M, 2, order + 1, I, J), dtype=torch.complex128,
                    device=omega.device)
    if grid is None:
        grid = moments_grid(times)
    tau = None if grid[0] else trapz_weights(times, w)
    args = (times, rows, omega, t0s, tau, first, count, win, S, P, order,
            grid)
    _launch(*args, lib=lib)
    out = (ctypes.c_ulonglong * 6)()
    if lib.qnm_moments_phases(out, 1):
        raise RuntimeError("window_moments: resetting the phase counters "
                           "failed")
    _launch(*args, lib=lib)
    torch.cuda.synchronize(omega.device)
    if lib.qnm_moments_phases(out, 0):
        raise RuntimeError("window_moments: reading the phase counters "
                           "failed")
    n = max(out[5], 1)
    per = {name: out[i] / n for i, name in enumerate(PHASES)}
    per.update(warps=out[5], variant=last_plan["variant"])
    return per
