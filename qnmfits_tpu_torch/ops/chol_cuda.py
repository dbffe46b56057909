"""The batched equilibrated Hermitian solve as hand-written FP64 CUDA
kernels (``csrc/chol_solve.cu``) for Hopper.

It replaces the Pallas TPU kernel
``qnmfits_tpu/ops/chol_pallas.py::complex_cholesky_solve_ds`` and fuses
the regularisation of ``qnmfits_tpu/engine_real.py::_regularised_solve``
around it, so one launch computes what ``engine_real._regularised_solve``
computes (its plain PyTorch version is
``engine_real._regularised_solve_plain``).  The system size alone picks
the kernel: the team kernel for n = 1..16, the warp kernel for
n = 17..64; larger systems raise.

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

__all__ = ["build", "ptxas_report", "regularised_solve", "launches",
           "wide_launches"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "chol_solve.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qnmfits_tpu_torch"
BUILD_LOG = BUILD_DIR / "chol_solve_build.log"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MIN_N, MAX_N = 1, 64
TEAM_MAX_N = 16          # the team kernel takes n <= 16, the warp kernel more

# Kernel launches since the last reset (callers set them to 0 and read
# them): ``launches`` counts both kernels, ``wide_launches`` the warp
# kernel's alone.
launches = 0
wide_launches = 0


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
    n = 1..16, and "wide": dict(registers=, spill_stores=, spill_loads=)}
    in bytes for the spills.  Raises when the log is not that of the
    library ``build()`` returns."""
    lib = build()
    text = BUILD_LOG.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{BUILD_LOG} is not the build log of {lib.name}")
    report = {}
    # ptxas prints, per kernel: "Compiling entry function '<mangled>'",
    # then "N bytes spill stores, M bytes spill loads" and "Used R
    # registers"; the team kernel's template argument n is mangled as
    # ILi<n>E.
    for block in text.split("Compiling entry function")[1:]:
        team = re.search(r"regularised_solve_kernelILi(\d+)E", block)
        name = f"team<{team[1]}>" if team else "wide"
        if not team and "regularised_solve_wide_kernel" not in block:
            raise RuntimeError(f"unknown kernel in {BUILD_LOG}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[name] = dict(registers=int(regs[1]),
                            spill_stores=int(spill[1]),
                            spill_loads=int(spill[2]))
    expected = {f"team<{n}>" for n in range(1, TEAM_MAX_N + 1)} | {"wide"}
    if set(report) != expected:
        raise RuntimeError(f"{BUILD_LOG} reports kernels {sorted(report)}")
    return report


@functools.lru_cache(maxsize=None)
def _entry(wide: bool):
    lib = ctypes.CDLL(str(build()))
    fn = lib.qnm_regularised_solve_wide if wide else lib.qnm_regularised_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def regularised_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch a kernel: G (B, n, n) and b (B, n) complex128 on one CUDA
    device, 1 <= n <= 64 (the team kernel up to n = 16, the warp kernel
    above).  Returns x (B, n), the equilibrated, dead-column masked,
    floored solution of G x = b (``_regularised_solve``)."""
    global launches, wide_launches
    if not (G.is_cuda and b.is_cuda and G.device == b.device):
        raise ValueError("regularised_solve takes CUDA tensors on one device")
    if G.dtype != torch.complex128 or b.dtype != torch.complex128:
        raise TypeError("regularised_solve takes complex128 tensors")
    if G.dim() != 3 or G.shape[1] != G.shape[2] or b.shape != G.shape[:2]:
        raise ValueError(f"shapes G {tuple(G.shape)} and b {tuple(b.shape)} "
                         "are not (B, n, n) and (B, n)")
    n = G.shape[-1]
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"system size n={n} outside [{MIN_N}, {MAX_N}]: "
                         f"the CUDA solve kernels take at most {MAX_N} modes")
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
    stream = torch.cuda.current_stream(G.device).cuda_stream
    err = _entry(wide)(G.data_ptr(), b.data_ptr(), x.data_ptr(), G.shape[0],
                       n, G.device.index, stream)
    if err != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: CUDA error {err}")
    launches += 1
    wide_launches += wide
    return x
