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

The systems kernel runs one thread-block cluster of 1 to ``CLUSTER_MAX``
blocks a (mode set, chunk), which share the chunk's tile sums through
distributed shared memory; where those would take more than
``SMEM_BYTES_MAX`` of a block's shared memory (a long grid), they go to a
global workspace the wrapper allocates (``plan``, ``last_plan``).

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

__all__ = ["build", "ptxas_report", "plan", "factored_systems",
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
CLUSTER_MAX = 8             # blocks a cluster (portable clusters)
# A cluster's blocks take at least this many of its chunk's windows each.
CLUSTER_WINDOWS = 8
# The systems kernel's blocks an SM (256 threads of 64 registers).
BLOCKS_PER_SM = 4
# A block's dynamic shared memory at most with the tile sums in it; past
# it they go to the global workspace.  The card's limit a block.
SMEM_BYTES_MAX = 100 * 1024
SMEM_BYTES_LIMIT = 232448

# Kernel launches since the last reset (callers set them to 0 and read
# them), one counter a kernel.
systems_launches = 0
epilogue_launches = 0
# The systems kernel's last launch plan (``plan``).
last_plan = None


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
        [ptr] * 13 + [i64] + [i32] * 7 + [ptr])
    lib.qnm_mismatch_rephase.argtypes = [ptr] * 8 + [i64, i32, i32, i32, ptr]
    lib.qnm_factored_plan.argtypes = [i32] * 5 + [ptr]
    lib.qnm_factored_systems.restype = ctypes.c_int
    lib.qnm_factored_plan.restype = ctypes.c_int
    lib.qnm_mismatch_rephase.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nbits(K: int) -> int:
    """Levels of the expm1 ladder: the bits of a sample count up to K."""
    return max(1, int(math.ceil(math.log2(K + 1))))


def cluster_size(S, nchunk, chunk, sms):
    """Blocks a cluster for S sets of nchunk chunks of ``chunk`` windows on
    a card of ``sms`` SMs: a power of two up to CLUSTER_MAX that leaves
    each block CLUSTER_WINDOWS windows or more; within that, the largest
    whose S * nchunk clusters fit on the card at once (BLOCKS_PER_SM), but
    not under 4 (grids that take several waves; measured on the main
    path's inputs by scripts/torch_factored_variants.py)."""
    cap = 1
    while cap < CLUSTER_MAX and chunk >= 2 * cap * CLUSTER_WINDOWS:
        cap *= 2
    fit = 1
    while fit < CLUSTER_MAX and S * nchunk * 2 * fit <= sms * BLOCKS_PER_SM:
        fit *= 2
    return min(cap, max(fit, 4))


def plan(K, J, B, S, chunk, sms, variant=None, cluster=None) -> dict:
    """The systems kernel's launch on B windows of a K-sample grid, J
    modes, S sets, chunks of ``chunk``, on a card of ``sms`` SMs:
    ``variant`` "shared" (the tile sums in shared memory) or "global" (in
    a workspace of ``workspace_bytes``), by default "shared" while its
    ``smem_bytes`` a block stay within ``SMEM_BYTES_MAX``; ``cluster``
    blocks a (set, chunk) (by default ``cluster_size``), ``blocks`` in
    all, ``tiles_per_block`` tile sums a block holds at most.  Raises
    ValueError where a block would need more shared memory than the
    card has (J in the thousands)."""
    nchunk = -(-B // chunk)
    cluster = cluster or cluster_size(S, nchunk, chunk, sms)
    out = (ctypes.c_longlong * 3)()

    def layout(glob):
        _lib().qnm_factored_plan(K, J, _nbits(K), cluster, int(glob), out)
        return list(out)

    shared = layout(False)
    if variant is None:
        variant = "shared" if shared[0] <= SMEM_BYTES_MAX else "global"
    if variant not in ("shared", "global"):
        raise ValueError(f"factored_systems: variant {variant!r}")
    smem, ws, tiles = shared if variant == "shared" else layout(True)
    if smem > SMEM_BYTES_LIMIT:
        raise ValueError(f"factored_systems: J={J} needs {smem} bytes of "
                         f"shared memory a block (at most "
                         f"{SMEM_BYTES_LIMIT})")
    return dict(variant=variant, cluster=cluster, smem_bytes=smem,
                workspace_bytes=16 * ws * nchunk * S,
                tiles_per_block=tiles, blocks=nchunk * cluster * S)


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
    tensors: one launch of ``factored_systems_kernel`` (``plan``)."""
    return _factored_systems(times, data, omegas, mus, t0s, Ts, col_masks,
                             chunk)


def _factored_systems(times, data, omegas, mus, t0s, Ts, col_masks, chunk,
                      variant=None, cluster=None):
    """``factored_systems``; checks and scripts may force the ``plan``'s
    variant ("shared" or "global") and cluster size."""
    global systems_launches, last_plan
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
    pl = plan(K, J, B, S, chunk, _sms(dev), variant, cluster)
    ws = (torch.empty(pl["workspace_bytes"], dtype=torch.uint8, device=dev)
          if pl["variant"] == "global" else None)
    err = _lib().qnm_factored_systems(
        times.data_ptr(), data.data_ptr(), omegas.data_ptr(), mus.data_ptr(),
        masks.data_ptr(), t0s.data_ptr(), Ts.data_ptr(), G.data_ptr(),
        G2.data_ptr(), rhs.data_ptr(), rt.data_ptr(), dnorm.data_ptr(),
        None if ws is None else ws.data_ptr(), B, K, I, J, S, chunk,
        _nbits(K), pl["cluster"], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"factored_systems kernel launch failed: CUDA "
                           f"error {err}")
    systems_launches += 1
    last_plan = pl
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
