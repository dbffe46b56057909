"""The batched equilibrated Hermitian solve as hand-written FP64 CUDA
kernels (``csrc/chol_solve.cu``) for Hopper.

It replaces the Pallas TPU kernel
``qnmfits_tpu/ops/chol_pallas.py::complex_cholesky_solve_ds`` and fuses
the regularisation of ``qnmfits_tpu/engine_real.py::_regularised_solve``
around it, so one launch computes what ``engine_real._regularised_solve``
computes (its plain PyTorch version is
``engine_real._regularised_solve_plain``).  The system size alone picks
the kernel: the team kernel for n = 1..16, the wide kernel for every
n >= 17 (a block per system; its arena in shared memory, or above the
card's shared memory a global workspace that this wrapper allocates).

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags, so an edit rebuilds) and bound
with ctypes: the library includes no PyTorch header, which keeps the build
to seconds.  A failed build or launch, or an input that is not 16-byte
aligned (the kernel's bulk copies need it), raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["build", "ptxas_report", "regularised_solve", "wide_plan",
           "launches", "wide_launches"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "chol_solve.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qnmfits_tpu_torch"
BUILD_LOG = BUILD_DIR / "chol_solve_build.log"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TEAM_MAX_N = 16          # the team kernel takes n <= 16, the wide kernel more
# The wide kernel's instantiations: threads a block, and whether its arena
# is the global workspace.
WIDE_KERNELS = ("wide<32>", "wide<128>", "wide<256>", "wide_global<256>")

# Kernel launches since the last reset (callers set them to 0 and read
# them): ``launches`` counts both kernels, ``wide_launches`` the wide
# kernel's alone.
launches = 0
wide_launches = 0
# Set by ``utils.debug_nans``: the kernels write through raw pointers,
# which no torch function mode sees, so the wrapper checks their output
# for NaN itself while this is on.
check_nans = False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), str(Path(home) / "bin" / "nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA solve kernel cannot be built")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ptxas's register and spill report is kept in
    ``BUILD_LOG`` (``build/qnmfits_tpu_torch/chol_solve_build.log``)."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libchol_solve_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_LOG.write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """ptxas's report of the last build, per kernel: {"team<n>" for
    n = 1..16, and each name of ``WIDE_KERNELS``: dict(registers=,
    spill_stores=, spill_loads=)} in bytes for the spills.  Raises when
    the log is not that of the library ``build()`` returns."""
    lib = build()
    text = BUILD_LOG.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{BUILD_LOG} is not the build log of {lib.name}")
    report = {}
    # ptxas prints, per kernel: "Compiling entry function '<mangled>'",
    # then "N bytes spill stores, M bytes spill loads" and "Used R
    # registers"; template arguments are mangled as ILi<n>E (the team
    # kernel's n) and ILi<T>ELb<0|1>E (the wide kernel's threads, and 1
    # for the global workspace).
    for block in text.split("Compiling entry function")[1:]:
        team = re.search(r"regularised_solve_kernelILi(\d+)E", block)
        wide = re.search(r"regularised_solve_wide_kernelILi(\d+)ELb([01])E",
                         block)
        if team:
            name = f"team<{team[1]}>"
        elif wide:
            name = f"{'wide_global' if wide[2] == '1' else 'wide'}<{wide[1]}>"
        else:
            raise RuntimeError(f"unknown kernel in {BUILD_LOG}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[name] = dict(registers=int(regs[1]),
                            spill_stores=int(spill[1]),
                            spill_loads=int(spill[2]))
    expected = ({f"team<{n}>" for n in range(1, TEAM_MAX_N + 1)}
                | set(WIDE_KERNELS))
    if set(report) != expected:
        raise RuntimeError(f"{BUILD_LOG} reports kernels {sorted(report)}")
    return report


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build()))
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.qnm_regularised_solve.argtypes = args
    lib.qnm_regularised_solve_wide.argtypes = args + [ctypes.c_void_p,
                                                      ctypes.c_longlong]
    lib.qnm_wide_plan.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.qnm_regularised_solve, lib.qnm_regularised_solve_wide,
               lib.qnm_wide_plan):
        fn.restype = ctypes.c_int
    return lib


def wide_plan(n: int, batch: int, device: int) -> dict:
    """The wide kernel's launch for ``batch`` systems of size n >= 17 on
    CUDA device ``device``: threads a block, stages (2 where two copies of
    a system fit the card's shared memory a block and leave as many
    blocks resident as the batch can use, else 1), ``global`` (the arena
    lies in a global workspace: above n = 167 on an H100), grid, dynamic
    shared bytes and workspace bytes."""
    out = (ctypes.c_longlong * 6)()
    err = _lib().qnm_wide_plan(n, batch, device, out)
    if err != 0:
        raise RuntimeError(f"chol_solve wide plan for n={n} failed: CUDA "
                           f"error {err}")
    keys = ("threads", "stages", "global", "grid", "smem_bytes", "work_bytes")
    return dict(zip(keys, (int(v) for v in out)))


@functools.lru_cache(maxsize=None)
def _wide_global(n: int, device: int) -> bool:
    return bool(wide_plan(n, 1, device)["global"])


def regularised_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch a kernel: G (B, n, n) and b (B, n) complex128 on one CUDA
    device, any n >= 1 (the team kernel up to n = 16, the wide kernel
    above).  Returns x (B, n), the equilibrated, dead-column masked,
    floored solution of G x = b (``_regularised_solve``).  Tensors that
    require grad raise: the result would be cut from the graph
    (``engine_real.RegularisedSolve`` differentiates the solve)."""
    global launches, wide_launches
    if G.requires_grad or b.requires_grad:
        raise RuntimeError(
            "regularised_solve writes its result through raw pointers, "
            "outside the autograd graph: call it through "
            "engine_real.RegularisedSolve (engine_real._regularised_solve) "
            "with tensors that require grad")
    if not (G.is_cuda and b.is_cuda and G.device == b.device):
        raise ValueError("regularised_solve takes CUDA tensors on one device")
    if G.dtype != torch.complex128 or b.dtype != torch.complex128:
        raise TypeError("regularised_solve takes complex128 tensors")
    if G.dim() != 3 or G.shape[1] != G.shape[2] or b.shape != G.shape[:2]:
        raise ValueError(f"shapes G {tuple(G.shape)} and b {tuple(b.shape)} "
                         "are not (B, n, n) and (B, n)")
    n = G.shape[-1]
    if n < 1:
        raise ValueError(f"system size n={n}: the solve takes n >= 1")
    G = G.contiguous()
    b = b.contiguous()
    for name, t in (("G", G), ("b", b)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"regularised_solve: {name} starts at address "
                f"{t.data_ptr():#x}, which is not 16-byte aligned; the "
                "kernel's bulk copies need 16-byte aligned tensors")
    x = torch.empty_like(b)
    if G.shape[0] == 0:
        return x
    wide = n > TEAM_MAX_N
    dev = G.device.index
    stream = torch.cuda.current_stream(G.device).cuda_stream
    if wide:
        # Only an arena past the card's shared memory needs a workspace.
        # It lives on the launch's stream; the caching allocator hands it
        # out again only to work queued after the kernel.
        work, work_bytes = None, 0
        if _wide_global(n, dev):
            work_bytes = wide_plan(n, G.shape[0], dev)["work_bytes"]
            work = torch.empty(work_bytes, dtype=torch.uint8,
                               device=G.device)
        err = _lib().qnm_regularised_solve_wide(
            G.data_ptr(), b.data_ptr(), x.data_ptr(), G.shape[0], n, dev,
            stream, None if work is None else work.data_ptr(), work_bytes)
    else:
        err = _lib().qnm_regularised_solve(
            G.data_ptr(), b.data_ptr(), x.data_ptr(), G.shape[0], n, dev,
            stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error {err}")
    launches += 1
    wide_launches += wide
    if check_nans and bool(torch.isnan(x).any()):
        raise FloatingPointError(
            f"NaN in the solution of the CUDA solve kernel (B={G.shape[0]}, "
            f"n={n})")
    return x
