"""The on-demand solver's angular eigenproblem as a hand-written CUDA kernel
(``csrc/angular_eig.cu``) for Hopper: one warp a matrix, Householder to
Hessenberg form, then single-shift complex QR (LAPACK zlahqr's shifts,
deflation test and iteration cap), and in vectors mode the selected
eigenvector by inverse iteration.

It replaces the host eig of the JAX package's solver
(``qnmfits_tpu/spectrum/solver.py::_batched_angular_eig`` with
``_select_eig``, ``np.linalg.eig``) for the port's solver
(``spectrum/solver.py``, ``spectrum/multiplets.py``).  The matrices are
the angular spectral matrices M(c) = diag(lam0) + 2 c s X - c^2 X^2 at a
(B,) batch of complex oblateness c, complex pentadiagonal of order nl; the
kernel builds each from the c-independent bands (``bands``) in shared
memory.  Two modes, as the solver uses them:

* ``angular_eigvals``: every eigenvalue, (B, nl), unsorted;
* ``angular_eigpair``: the eigenvalue nearest a guess and its right
  eigenvector, entry l - lmin real and positive, unit norm.

CPU tensors run the plain versions ``eigvals_plain`` and ``eigpair_plain``
(torch.linalg.eig on the materialised matrices, the JAX package's
selection); CUDA tensors launch the kernel.  A failed build or launch, a
matrix whose QR iteration passes its cap (zlahqr's 30 max(10, nl) an
eigenvalue) or a non-finite matrix raises; nothing falls back, and no CUDA
tensor reaches torch.linalg.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags, so an edit rebuilds) and bound
with ctypes, as ``ops/cf_cuda.py`` does; without contraction
(``-fmad=false``), so the host build of the same source (``g++
-ffp-contract=off``, the CPU tests) rounds as the card does.
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

from ..spectrum.angular import lmin, spectral_parts
from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc

__all__ = ["angular_eigpair", "angular_eigvals", "angular_matrices", "bands",
           "build", "check_info", "eigpair_plain", "eigvals_plain", "launches",
           "last_info", "last_plan", "plan", "ptxas_report",
           "select_nearest"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "angular_eig.cu"
BUILD_LOG = BUILD_DIR / "angular_eig_build.log"
FLAGS = (*NVCC_FLAGS, "-fmad=false")
KERNELS = ("angular_eig_kernel",)
# Matrices a block (a warp each), and a block's opt-in shared memory on
# the card: past it a warp's matrix goes to a global workspace.
WARPS = 4
SMEM_BYTES_LIMIT = 232448

# Kernel launches since the last reset (callers set it to 0 and read it);
# the last launch's plan, and its (B, 2) int64 info on the card: per
# matrix the QR sweeps run and the FP64 operations of the kernel's loops
# (the reduction's reflectors, the sweeps' rotations, the inverse
# iteration; csrc/angular_eig.cu counts them, set-up steps left out).
launches = 0
last_plan = None
last_info = None


def bands(s: int, m: int, nl: int) -> np.ndarray:
    """The c-independent bands of the angular matrix, (9, nl) float64:
    row 0 lam0; rows 1-3 X(r, r + d), d = -1, 0, 1; rows 4-8 X^2(r, r +
    d), d = -2..2 (zero past the matrix's edge)."""
    lam0, X = spectral_parts(s, m, nl)
    X2 = X @ X
    out = np.zeros((9, nl))
    out[0] = lam0
    r = np.arange(nl)
    for row, (mat, d) in enumerate([(X, -1), (X, 0), (X, 1)]
                                   + [(X2, d) for d in range(-2, 3)], 1):
        ok = (r + d >= 0) & (r + d < nl)
        out[row, ok] = mat[r[ok], r[ok] + d]
    return out


@functools.lru_cache(maxsize=64)
def _bands_t(s: int, m: int, nl: int, device: torch.device):
    return torch.as_tensor(bands(s, m, nl), device=device)


@functools.lru_cache(maxsize=64)
def _parts_t(s: int, m: int, nl: int, device: torch.device):
    lam0, X = spectral_parts(s, m, nl)
    return (torch.as_tensor(np.diag(lam0).astype(complex), device=device),
            torch.as_tensor(X, device=device),
            torch.as_tensor(X @ X, device=device))


def angular_matrices(s: int, m: int, c, nl: int):
    """The angular matrices at every c of a (B,) complex tensor,
    diag(lam0) + 2 c s X - c^2 X^2, (B, nl, nl)."""
    D, X, X2 = _parts_t(s, m, nl, c.device)
    c = c[:, None, None]
    return (D + 2.0 * c * s * X) - (c * c) * X2


def _nearest(A_all, guess):
    """Per batch element, the index of the eigenvalue of A_all (B, n)
    nearest guess (B,), the first on a tie, and the batch's indices."""
    return (torch.arange(A_all.shape[0], device=A_all.device),
            torch.argmin((A_all - guess[:, None]).abs(), dim=1))


def select_nearest(A_all, guess):
    """Per batch element, the eigenvalue of A_all (B, n) nearest guess
    (B,), the first on a tie."""
    return A_all[_nearest(A_all, guess)]


def eigvals_plain(s: int, m: int, c, nl: int):
    """The plain version of values mode: torch.linalg.eigvals of the
    materialised matrices, (B, nl)."""
    return torch.linalg.eigvals(angular_matrices(s, m, c, nl))


def eigpair_plain(s: int, l: int, m: int, c, nl: int, guess):
    """The plain version of vectors mode: per element the eigenpair of
    torch.linalg.eig nearest guess, the vector's entry l - lmin made real
    and positive, then unit norm.  Returns A (B,) and C (B, nl)."""
    A_all, C_all = torch.linalg.eig(angular_matrices(s, m, c, nl))
    rows, k = _nearest(A_all, guess)
    A, C = A_all[rows, k], C_all[rows, :, k]
    diag = C[:, l - lmin(s, m)]
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    phase = torch.where(diag != 0,
                        diag.abs() / torch.where(diag == 0, one, diag), one)
    C = C * phase[:, None]
    C = C / torch.sqrt(torch.sum(C.abs() ** 2, dim=1))[:, None]
    return A, C


def angular_eigvals(s: int, m: int, c, nl: int):
    """Every eigenvalue of the angular matrix at each c of a (B,)
    complex128 tensor, (B, nl), unsorted.  CPU: ``eigvals_plain``; CUDA:
    one launch of the kernel."""
    if c.device.type == "cpu":
        return eigvals_plain(s, m, c, nl)
    return _launch(s, m, c, nl)[0]


def angular_eigpair(s: int, l: int, m: int, c, nl: int, guess):
    """The eigenvalue nearest ``guess`` (B,) and its unit right
    eigenvector, entry l - lmin real and positive, at each c: A (B,), C
    (B, nl).  CPU: ``eigpair_plain``; CUDA: one launch of the kernel."""
    if c.device.type == "cpu":
        return eigpair_plain(s, l, m, c, nl, guess)
    _, A, C = _launch(s, m, c, nl, guess, l - lmin(s, m))
    return A, C


def warp_bytes(nl: int) -> int:
    """A warp's memory for one matrix: H (nl rows of nl | 1 entries), the
    eigenvalues, the iterate and the pivots, 16 bytes an entry."""
    return 16 * (nl * (nl | 1) + 3 * nl)


def plan(nl: int, B: int, variant: str | None = None) -> dict:
    """The launch of B matrices of order nl: WARPS matrices a block (fewer
    where a block's shared memory cannot hold them), each in shared memory
    ("shared") or, past ``SMEM_BYTES_LIMIT`` a matrix or where ``variant``
    asks, in a global workspace ("global")."""
    per = warp_bytes(nl)
    if variant is None:
        variant = "shared" if per <= SMEM_BYTES_LIMIT else "global"
    if variant not in ("shared", "global"):
        raise ValueError(f"angular_eig: no variant {variant!r}")
    if variant == "shared":
        if per > SMEM_BYTES_LIMIT:
            raise ValueError(f"angular_eig: nl = {nl} needs {per} bytes of "
                             f"shared memory a matrix, over "
                             f"{SMEM_BYTES_LIMIT}")
        warps = min(WARPS, SMEM_BYTES_LIMIT // per)
        smem, ws = warps * per, 0
    else:
        warps, smem, ws = WARPS, 0, B * per
    return dict(variant=variant, warps=warps, smem_bytes=smem,
                workspace_bytes=ws, blocks=-(-B // warps))


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ptxas's report is kept in ``BUILD_LOG``.  Raises
    RuntimeError without nvcc or when nvcc fails."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libangular_eig_{tag}.so"
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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qnm_angular_eig.argtypes = ([ctypes.c_longlong] + [i32] * 5
                                    + [ptr] * 8 + [i32, ptr])
    lib.qnm_angular_eig.restype = ctypes.c_int
    return lib


def max_iterations(nl: int) -> int:
    """zlahqr's cap on the QR iterations of one eigenvalue."""
    return 30 * max(10, nl)


def _launch(s, m, c, nl, guess=None, sel=0, variant=None, max_its=None):
    """One launch of the kernel on the (B,) complex128 CUDA tensor c:
    values mode, or with ``guess`` vectors mode (``sel`` the entry made
    real and positive).  Returns (eigenvalues (B, nl), A (B,) or None, C
    (B, nl) or None).  Checks and scripts may force the ``plan``'s variant
    and the iteration cap.  Raises when the launch fails, or when a matrix
    is not finite or an eigenvalue passes the cap (the info is read back:
    one synchronisation)."""
    global launches, last_plan, last_info
    if not c.is_cuda:
        raise ValueError(f"angular_eig: no kernel for device {c.device}")
    if c.dtype != torch.complex128 or c.dim() != 1:
        raise TypeError("angular_eig takes a (B,) complex128 c")
    if nl < 1 or not 0 <= sel < nl:
        raise ValueError(f"angular_eig: nl = {nl}, sel = {sel}")
    dev, B = c.device, c.shape[0]
    c = c.contiguous()
    vectors = guess is not None
    if vectors:
        guess = torch.broadcast_to(guess.to(device=dev, dtype=c.dtype),
                                   (B,)).contiguous()
    for name, t in (("c", c), ("guess", guess)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"angular_eig: {name} starts at address "
                             f"{t.data_ptr():#x}, not aligned to its "
                             "16-byte elements")
    eig = torch.empty((B, nl), dtype=torch.complex128, device=dev)
    A = torch.empty(B, dtype=torch.complex128, device=dev) if vectors else None
    C = torch.empty((B, nl), dtype=torch.complex128, device=dev) \
        if vectors else None
    if B == 0:
        return eig, A, C
    pl = plan(nl, B, variant)
    ws = (torch.empty(pl["workspace_bytes"] // 8, dtype=torch.float64,
                      device=dev) if pl["variant"] == "global" else None)
    info = torch.empty((B, 2), dtype=torch.int64, device=dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    band = _bands_t(s, m, nl, dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib().qnm_angular_eig(
        B, nl, int(s), int(sel), int(max_iterations(nl) if max_its is None
                                     else max_its), pl["warps"],
        c.data_ptr(), ptr(guess), band.data_ptr(), eig.data_ptr(), ptr(A),
        ptr(C), info.data_ptr(), ptr(ws), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"angular_eig kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    last_plan, last_info = pl, info
    check_info(info, c, s, m, nl, max_iterations(nl) if max_its is None
               else max_its)
    return eig, A, C


def check_info(info, c, s, m, nl, cap):
    """Raise when a matrix of a launch failed: info (B, 2) the kernel's
    (QR sweeps, FP64 operations) a matrix, sweeps -1 where an eigenvalue passed
    ``cap`` iterations and -2 where the matrix is not finite."""
    worst = int(info[:, 0].min()) if info.shape[0] else 0
    if worst >= 0:
        return
    bad = int(torch.argmin(info[:, 0]))
    why = ("is not finite" if worst == -2 else
           f"did not converge within {cap} QR iterations an eigenvalue")
    raise RuntimeError(f"angular_eig: the matrix at c = {complex(c[bad])} "
                       f"(s = {s}, m = {m}, nl = {nl}) {why}")
