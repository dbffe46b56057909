"""The factored start-time sweep's systems and its mismatch epilogue as
hand-written FP64 CUDA kernels (``csrc/factored_sweep.cu``) for Hopper.

``factored_systems`` computes, for every mode set and every window of a
join group of chunks, what the JAX package computes up to the solve in
``qnmfits_tpu/engine_real.py::_chunk_sweep_factored(analytic=True)`` (the
phase basis, the trapezoid data projections, the closed-form Grams and the
mixing); ``mismatch_rephase`` computes what it computes after the solve
(the mismatch and the amplitudes rephased to each start time).  Neither
replaces a Pallas kernel: the JAX package leaves them to XLA.  Their plain
PyTorch versions are ``factored_systems_plain`` and
``mismatch_rephase_plain`` (``engine_real._chunk_systems`` and
``_mismatch_rephase`` over a join group); a wrapper takes the plain version for
tensors on the CPU, launches its kernel for CUDA tensors, and raises on
anything else.  Nothing falls back.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags), as ``ops/chol_cuda.py`` builds
the solve, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import subprocess
from pathlib import Path

import torch

from . import chol_cuda
from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc

__all__ = ["build", "ptxas_report", "factored_systems",
           "factored_systems_plain", "mismatch_rephase",
           "mismatch_rephase_plain",
           "systems_launches", "epilogue_launches", "KERNELS"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "factored_sweep.cu"
# No fused multiply-adds: the closed forms then round as the plain version
# does, and a window of one sample (no trapezoid weight) gives exactly the
# zero G2, rt and dnorm that the plain version gives.
FLAGS = (*NVCC_FLAGS, "-fmad=false")
BUILD_LOG = BUILD_DIR / "factored_sweep_build.log"
KERNELS = ("factored_systems_kernel", "mismatch_rephase_kernel")

# Kernel launches since the last reset (callers set them to 0 and read
# them), one counter a kernel.
systems_launches = 0
epilogue_launches = 0


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ptxas's register and spill report is kept in
    ``BUILD_LOG``.  Raises RuntimeError without nvcc."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfactored_sweep_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """ptxas's report of the last build: {kernel name: dict(registers=,
    spill_stores=, spill_loads=)}, spills in bytes.  Raises when the log
    is not that of the library ``build()`` returns."""
    lib = build()
    text = BUILD_LOG.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{BUILD_LOG} is not the build log of {lib.name}")
    report = {}
    for block in text.split("Compiling entry function")[1:]:
        name = next((k for k in KERNELS if k in block.splitlines()[0]), None)
        if name is None:
            raise RuntimeError(f"unknown kernel in {BUILD_LOG}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[name] = dict(registers=int(regs[1]),
                            spill_stores=int(spill[1]),
                            spill_loads=int(spill[2]))
    if set(report) != set(KERNELS):
        raise RuntimeError(f"{BUILD_LOG} reports kernels {sorted(report)}")
    return report


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.qnm_factored_systems.argtypes = (
        [ptr] * 12 + [i64] + [i32] * 6 + [ptr])
    lib.qnm_mismatch_rephase.argtypes = [ptr] * 8 + [i64, i32, i32, i32, ptr]
    lib.qnm_factored_systems.restype = ctypes.c_int
    lib.qnm_mismatch_rephase.restype = ctypes.c_int
    return lib


def _nbits(K: int) -> int:
    """Levels of the expm1 ladder: the bits of a sample count up to K."""
    return max(1, int(math.ceil(math.log2(K + 1))))


def _check(name, tensors, device):
    """The kernels take contiguous tensors on one CUDA device, each
    aligned to its element (16 bytes for complex128, which they read as
    double2), and checked for the dtype given beside it."""
    out = []
    for key, (t, dtype) in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {dtype}")
        if t.requires_grad:
            raise RuntimeError(f"{name} writes through raw pointers, "
                               f"outside the autograd graph: {key} "
                               "requires grad")
        t = t.contiguous()
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name}: {key} starts at address "
                             f"{t.data_ptr():#x}, which is not aligned to "
                             f"its {t.element_size()}-byte elements")
        out.append(t)
    return out


def _check_nans(name, outs):
    """While ``chol_cuda.check_nans`` is on (``utils.debug_nans``), raise
    on a NaN in a kernel's outputs: they are written through raw
    pointers, which no torch function mode sees."""
    if chol_cuda.check_nans and any(bool(torch.isnan(t).any())
                                    for t in outs):
        raise FloatingPointError(f"NaN in the outputs of the {name} "
                                 "kernel")


def factored_systems_plain(times, data, omegas, mus, t0s, Ts, col_masks,
                           chunk):
    """The plain PyTorch version of ``factored_systems``:
    ``engine_real._chunk_systems(analytic=True)`` on each chunk of
    ``chunk`` windows, concatenated along the window axis."""
    from ..engine_real import _group_systems
    return _group_systems(times, data, omegas, mus, t0s, Ts, col_masks,
                          chunk, analytic=True)


def mismatch_rephase_plain(C0, G2, rt, dnorm, omegas, t0s, chunk):
    """The plain PyTorch version of ``mismatch_rephase``:
    ``engine_real._mismatch_rephase``, each window in its chunk's basis."""
    from ..engine_real import _group_mismatch_rephase
    return _group_mismatch_rephase(C0, G2, rt, dnorm, omegas, t0s, chunk)


def factored_systems(times, data, omegas, mus, t0s, Ts, col_masks, chunk):
    """The systems of a join group of windows on a uniform ascending grid:
    times (K,) float64, data (I, K), omegas (S, J), mus (S, I, J)
    complex128, t0s / Ts (B,) float64 ('geq' windows t0 <= t < t0 + T),
    col_masks (S, J) bool; windows lo..lo+chunk-1 (lo a multiple of
    ``chunk``) share the basis referenced to t0s[lo].  Returns G, G2
    (S, B, J, J), rhs, rt (S, B, J) and dnorm (B,), as
    ``engine_real._chunk_systems`` (G masked for the solve, G2, rt and
    dnorm for the mismatch).  CPU tensors: the plain version; CUDA
    tensors: one launch of ``factored_systems_kernel``."""
    global systems_launches
    if times.device.type == "cpu":
        return factored_systems_plain(times, data, omegas, mus, t0s, Ts,
                                      col_masks, chunk)
    if not times.is_cuda:
        raise ValueError(f"factored_systems: no kernel for device "
                         f"{times.device}")
    K, (I, Kd), (S, J), B = times.shape[0], data.shape, omegas.shape, \
        t0s.shape[0]
    if Kd != K or mus.shape != (S, I, J) or col_masks.shape != (S, J) \
            or Ts.shape != (B,) or times.dim() != 1:
        raise ValueError("factored_systems: shapes times "
                         f"{tuple(times.shape)}, data {tuple(data.shape)}, "
                         f"omegas {tuple(omegas.shape)}, mus "
                         f"{tuple(mus.shape)}, masks "
                         f"{tuple(col_masks.shape)}, t0s {tuple(t0s.shape)}, "
                         f"Ts {tuple(Ts.shape)} do not agree")
    if I < 1 or K < 2 or S > 65535 or chunk < 1:
        raise ValueError(f"factored_systems: I={I}, K={K}, S={S}, "
                         f"chunk={chunk} (I >= 1, K >= 2, S <= 65535, "
                         "chunk >= 1)")
    dev = times.device
    times, data, omegas, mus, masks, t0s, Ts = _check("factored_systems", dict(
        times=(times, torch.float64), data=(data, torch.complex128),
        omegas=(omegas, torch.complex128), mus=(mus, torch.complex128),
        col_masks=(col_masks, torch.bool), t0s=(t0s, torch.float64),
        Ts=(Ts, torch.float64)), dev)
    G = torch.empty((S, B, J, J), dtype=torch.complex128, device=dev)
    G2 = torch.empty_like(G)
    rhs = torch.empty((S, B, J), dtype=torch.complex128, device=dev)
    rt = torch.empty_like(rhs)
    dnorm = torch.empty(B, dtype=torch.float64, device=dev)
    if B == 0 or J == 0:
        return G, G2, rhs, rt, dnorm
    err = _lib().qnm_factored_systems(
        times.data_ptr(), data.data_ptr(), omegas.data_ptr(), mus.data_ptr(),
        masks.data_ptr(), t0s.data_ptr(), Ts.data_ptr(), G.data_ptr(),
        G2.data_ptr(), rhs.data_ptr(), rt.data_ptr(), dnorm.data_ptr(), B, K, I, J, S, chunk, _nbits(K),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"factored_systems kernel launch failed: CUDA "
                           f"error {err}")
    systems_launches += 1
    _check_nans("factored_systems", (G, G2, rhs, rt, dnorm))
    return G, G2, rhs, rt, dnorm


def mismatch_rephase(C0, G2, rt, dnorm, omegas, t0s, chunk):
    """The epilogue after the solve over a join group: C0 (S, B, J), G2
    (S, B, J, J), rt (S, B, J), omegas (S, J) complex128, dnorm and t0s
    (B,) float64, each window's amplitudes C0 in the basis of its chunk of
    ``chunk`` windows (chunks start at 0).  Returns C (S, B, J), the
    amplitudes referenced to each t0, and the mismatch mm (S, B), as
    ``engine_real._mismatch_rephase``.  CPU tensors: the plain version
    ``mismatch_rephase_plain``;
    CUDA tensors: one launch of ``mismatch_rephase_kernel``."""
    global epilogue_launches
    if C0.device.type == "cpu":
        return mismatch_rephase_plain(C0, G2, rt, dnorm, omegas, t0s, chunk)
    if not C0.is_cuda:
        raise ValueError(f"mismatch_rephase: no kernel for device "
                         f"{C0.device}")
    S, B, J = C0.shape
    if G2.shape != (S, B, J, J) or rt.shape != (S, B, J) \
            or dnorm.shape != (B,) or omegas.shape != (S, J) \
            or t0s.shape != (B,) or chunk < 1:
        raise ValueError("mismatch_rephase: shapes C0 "
                         f"{tuple(C0.shape)}, G2 {tuple(G2.shape)}, rt "
                         f"{tuple(rt.shape)}, dnorm {tuple(dnorm.shape)}, "
                         f"omegas {tuple(omegas.shape)}, t0s "
                         f"{tuple(t0s.shape)} (chunk {chunk}) do not agree")
    dev = C0.device
    C0, G2, rt, dnorm, omegas, t0s = _check("mismatch_rephase", dict(
        C0=(C0, torch.complex128), G2=(G2, torch.complex128),
        rt=(rt, torch.complex128), dnorm=(dnorm, torch.float64),
        omegas=(omegas, torch.complex128), t0s=(t0s, torch.float64)), dev)
    C = torch.empty_like(C0)
    mm = torch.empty((S, B), dtype=torch.float64, device=dev)
    if S * B == 0:
        return C, mm
    err = _lib().qnm_mismatch_rephase(
        C0.data_ptr(), G2.data_ptr(), rt.data_ptr(), dnorm.data_ptr(),
        omegas.data_ptr(), t0s.data_ptr(), C.data_ptr(), mm.data_ptr(), B, S,
        J, chunk, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mismatch_rephase kernel launch failed: CUDA "
                           f"error {err}")
    epilogue_launches += 1
    _check_nans("mismatch_rephase", (C, mm))
    return C, mm
