"""Window moments of damped phases as a hand-written FP64 CUDA kernel
(``csrc/window_moments.cu``) for Hopper.

For trajectory m on window n = win[m] (start time t0 = t0s[n], {0,1}
weights w_k, trapezoid weights tau_k, offsets s_k = (t_k - t0) w_k and
phases phi_jk = exp(-i omega_mj s_k)), and for v in {w, tau} and p = 0 ..
order::

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
on anything else.  Nothing falls back.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags), as ``ops/chol_cuda.py`` builds
the solve, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from pathlib import Path

import torch

from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc
from .cmath import damped_phase
from .sweep_cuda import _check_nans

__all__ = ["KERNEL", "build", "ptxas_report", "window_bounds",
           "window_moments", "window_moments_plain", "launches"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "window_moments.cu"
BUILD_LOG = BUILD_DIR / "window_moments_build.log"
KERNEL = "window_moments_kernel"
ORDERS = (0, 1, 2)
THREADS = 256
# Samples a tile: the tile's phases, data and weights stay within this
# many bytes of static-size dynamic shared memory (no opt-in needed).
TILE_MAX = 64
SMEM_BYTES = 44 * 1024
# Most bytes of one (chunk, K, J) complex128 phase basis of the plain
# version: it runs its trajectories in chunks within it.
PLAIN_BYTES = 1 << 28

# Kernel launches since the last reset (callers set it to 0 and read it).
launches = 0


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ptxas's register and spill report is kept in
    ``BUILD_LOG``.  Raises RuntimeError without nvcc."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libwindow_moments_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """ptxas's report of the last build: {"order<p>": dict(registers=,
    spill_stores=, spill_loads=)} for p = 0, 1, 2, spills in bytes.
    Raises when the log is not that of the library ``build()`` returns."""
    lib = build()
    text = BUILD_LOG.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{BUILD_LOG} is not the build log of {lib.name}")
    report = {}
    for block in text.split("Compiling entry function")[1:]:
        order = re.search(rf"{KERNEL}ILi(\d)E", block.splitlines()[0])
        if order is None:
            raise RuntimeError(f"unknown kernel in {BUILD_LOG}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[f"order{order[1]}"] = dict(registers=int(regs[1]),
                                          spill_stores=int(spill[1]),
                                          spill_loads=int(spill[2]))
    if set(report) != {f"order{p}" for p in ORDERS}:
        raise RuntimeError(f"{BUILD_LOG} reports kernels {sorted(report)}")
    return report


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qnm_window_moments.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.qnm_window_moments.restype = ctypes.c_int
    return lib


def tile(I: int, J: int, order: int) -> int:
    """Samples a tile of the kernel for I data rows and J modes: as many as
    fit ``SMEM_BYTES`` with their phases, data and weights, at most
    ``TILE_MAX``.  Raises ValueError where not one sample fits."""
    per = 16 * (I + J) + 8 * 2 * (order + 1)
    t = min(TILE_MAX, SMEM_BYTES // per)
    if t < 1:
        raise ValueError(f"window_moments: I={I}, J={J} need {per} bytes "
                         f"of shared memory a sample (at most {SMEM_BYTES})")
    return t


def window_bounds(w):
    """The first index and the sample count (N,) of each window of {0,1}
    weights w (N, K), one contiguous run each (every window of the
    package is); a window of no sample has count 0."""
    return w.argmax(dim=-1), w.sum(dim=-1).round().to(torch.int64)


def _shapes(times, rows, omega, t0s, w, tau, win, order):
    if order not in ORDERS:
        raise ValueError(f"window_moments: order {order} (0, 1 or 2)")
    if times.dim() != 1 or rows.dim() != 2 or omega.dim() != 2:
        raise ValueError("window_moments: times (K,), rows (I, K) and "
                         "omega (M, J)")
    K, (I, J), M = times.shape[0], (rows.shape[0], omega.shape[1]), \
        omega.shape[0]
    N = t0s.shape[0] if t0s.dim() == 1 else -1
    if (rows.shape[1] != K or N < 0 or w.shape != (N, K)
            or tau.shape != (N, K) or win.shape != (M,)):
        raise ValueError(
            f"window_moments: shapes times {tuple(times.shape)}, rows "
            f"{tuple(rows.shape)}, omega {tuple(omega.shape)}, t0s "
            f"{tuple(t0s.shape)}, w {tuple(w.shape)}, tau "
            f"{tuple(tau.shape)}, win {tuple(win.shape)} are not (K,), "
            "(I, K), (M, J), (N,), (N, K), (N, K), (M,)")
    if K < 1 or I < 1 or J < 1:
        raise ValueError("window_moments: K, I and J must be at least 1")
    return K, I, J, M


def window_moments_plain(times, rows, omega, t0s, w, tau, win, order):
    """The plain PyTorch version of the kernel, on any device: the sums of
    the module docstring over every sample, weighted by w and tau, with the
    phases of ``ops/cmath.damped_phase`` at the window-clamped offsets (the
    formulas of ``engine.fit_systems``), in chunks of trajectories within
    ``PLAIN_BYTES`` of phases.  Returns S (M, 2, order + 1, J, J) and P
    (M, 2, order + 1, I, J) complex128."""
    K, I, J, M = _shapes(times, rows, omega, t0s, w, tau, win, order)
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


def window_moments(times, rows, omega, t0s, w, tau, win, order):
    """S (M, 2, order + 1, J, J) and P (M, 2, order + 1, I, J) complex128,
    the window moments of the module docstring.

    times (K,) float64; rows (I, K) complex128; omega (M, J) complex128;
    t0s (N,) float64; w, tau (N, K) float64, each window one contiguous
    run of w (``window_bounds``) with its trapezoid weights; win (M,)
    int64 window indices; order 0, 1 or 2.  CPU tensors take
    ``window_moments_plain``; CUDA tensors, contiguous, on one device,
    launch the kernel (one launch, counted in ``launches``; under
    ``utils.debug_nans`` its outputs are checked for NaN).  Anything else
    raises."""
    global launches
    tensors = dict(times=(times, torch.float64), rows=(rows, torch.complex128),
                   omega=(omega, torch.complex128), t0s=(t0s, torch.float64),
                   w=(w, torch.float64), tau=(tau, torch.float64),
                   win=(win, torch.int64))
    devices = {t.device for t, _ in tensors.values()}
    if len(devices) != 1:
        raise ValueError("window_moments: tensors on "
                         f"{sorted(map(str, devices))}")
    device, = devices
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"window_moments: {name} is {t.dtype}, not "
                            f"{dtype}")
    K, I, J, M = _shapes(times, rows, omega, t0s, w, tau, win, order)
    if device.type == "cpu":
        return window_moments_plain(times, rows, omega, t0s, w, tau, win,
                                    order)
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
        _launch(times, rows, omega, t0s, tau, first, count, win, S, P, order)
        launches += 1
        _check_nans("window_moments", (S, P))
    return S, P


def _launch(times, rows, omega, t0s, tau, first, count, win, S, P, order):
    """One launch of the kernel on checked tensors (``window_moments``;
    first and count (N,) int32 from ``window_bounds``) into S and P, on
    the current stream; raises on a launch error.  Not counted: the
    wrapper counts its launches, and checks time the kernel through this
    function."""
    I, K = rows.shape
    M, J = omega.shape
    with torch.cuda.device(omega.device):
        stream = torch.cuda.current_stream(omega.device).cuda_stream
        err = _lib().qnm_window_moments(
            times.data_ptr(), rows.data_ptr(), omega.data_ptr(),
            t0s.data_ptr(), tau.data_ptr(), first.data_ptr(),
            count.data_ptr(), win.data_ptr(), S.data_ptr(), P.data_ptr(),
            K, I, J, M, order, tile(I, J, order), stream)
    if err != 0:
        raise RuntimeError(f"window_moments kernel launch failed: CUDA "
                           f"error {err}")
