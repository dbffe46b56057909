"""The on-demand solver's angular eigenproblem as a hand-written CUDA kernel
(``csrc/angular_eig.cu``) for Hopper: one warp a matrix (a team of two
warps for launches of at most ``TEAM_MAX_B`` matrices, whose QR
iterations chase two bulges, a warp each), Householder to Hessenberg form,
then complex QR (LAPACK zlahqr's shifts, deflation test and iteration
cap), and in vectors mode the selected eigenvector by inverse
iteration.

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
           "build", "check_info", "eigpair_plain", "eigvals_plain",
           "launches", "last_info", "last_plan", "phase_cycles", "plan",
           "ptxas_report", "select_nearest"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "angular_eig.cu"
BUILD_LOG = BUILD_DIR / "angular_eig_build.log"
FLAGS = (*NVCC_FLAGS, "-fmad=false")
# The kernels: a matrix in shared memory, or in the global workspace.
KERNELS = ("angular_eig_kernel", "angular_eig_ws_kernel")
# Warps a block, and a block's opt-in shared memory on the card: past it a
# matrix goes to a global workspace.
WARPS = 4
SMEM_BYTES_LIMIT = 232448
# Launches of at most TEAM_MAX_B matrices of order below 64 take a team of
# two warps a matrix (one matrix a block): its QR iterations chase two
# bulges, a warp each.  Larger batches keep a warp a matrix, the card's
# SMs being full of them.
TEAM_MAX_B = 128
# The phases build (``phase_cycles``): its flag, its counters by index.
PHASE_FLAGS = ("-DQNM_EIG_PHASES",)
PHASES = ("hessenberg", "qr sweeps", "split tests", "shifts", "solve",
          "rotations", "ticks", "-", "step: loads, rotation",
          "step: left, barrier", "step: right, barrier")

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


def matrix_bytes(nl: int, team: int = 1) -> int:
    """A matrix's memory: a warp's (``warp_bytes``), and a team's word (two
    entries) after it where two warps take the matrix."""
    return warp_bytes(nl) + (32 if team > 1 else 0)


@functools.lru_cache(maxsize=1024)
def plan(nl: int, B: int, variant: str | None = None,
         team: int | None = None) -> dict:
    """The launch of B matrices of order nl: ``team`` warps a matrix (2,
    one matrix a block, for at most TEAM_MAX_B matrices of order below 64;
    else 1, WARPS matrices a block, fewer where a block's shared memory
    cannot hold them), each in shared memory ("shared",
    ``angular_eig_kernel``) or, past ``SMEM_BYTES_LIMIT`` a matrix or where
    ``variant`` asks, in a global workspace ("global",
    ``angular_eig_ws_kernel``).  Cached: the dict is shared, not to be
    changed."""
    if team is None:
        team = 2 if B <= TEAM_MAX_B and nl < 64 else 1
    if team not in (1, 2):
        raise ValueError(f"angular_eig: no team of {team} warps")
    per = matrix_bytes(nl, team)
    if variant is None:
        variant = "shared" if per <= SMEM_BYTES_LIMIT else "global"
    if variant not in ("shared", "global"):
        raise ValueError(f"angular_eig: no variant {variant!r}")
    most = 1 if team > 1 else WARPS
    if variant == "shared":
        if per > SMEM_BYTES_LIMIT:
            raise ValueError(f"angular_eig: nl = {nl} needs {per} bytes of "
                             f"shared memory a matrix, over "
                             f"{SMEM_BYTES_LIMIT}")
        warps = min(most, SMEM_BYTES_LIMIT // per)
        smem, ws = warps * per, 0
    else:
        warps, smem, ws = most, 0, B * per
    return dict(variant=variant, team=team, warps=warps, smem_bytes=smem,
                workspace_bytes=ws, blocks=-(-B // warps))


def build(phases: bool = False) -> Path:
    """Compile the kernel library (with ``phases``, the build that counts
    cycles by phase, ``phase_cycles``) if this source has not been built
    so yet; returns its path.  ptxas's report is kept in ``BUILD_LOG`` (the
    phases build's beside it).  Raises RuntimeError without nvcc or when
    nvcc fails."""
    flags = (*FLAGS, *PHASE_FLAGS) if phases else FLAGS
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libangular_eig_{tag}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *flags, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log = (BUILD_LOG.with_name("angular_eig_phases_build.log") if phases
           else BUILD_LOG)
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
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
def _lib(phases: bool = False):
    lib = ctypes.CDLL(str(build(phases)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qnm_angular_eig.argtypes = ([ctypes.c_longlong] + [i32] * 6
                                    + [ptr] * 8 + [i32, ptr])
    lib.qnm_angular_eig.restype = ctypes.c_int
    if phases:
        lib.qnm_eig_phases.argtypes = [ptr, i32]
        lib.qnm_eig_phases.restype = ctypes.c_int
    return lib


def max_iterations(nl: int) -> int:
    """zlahqr's cap on the QR iterations of one eigenvalue."""
    return 30 * max(10, nl)


def _launch(s, m, c, nl, guess=None, sel=0, variant=None, max_its=None,
            team=None, phases=False):
    """One launch of the kernel on the (B,) complex128 CUDA tensor c:
    values mode, or with ``guess`` vectors mode (``sel`` the entry made
    real and positive).  Returns (eigenvalues (B, nl), A (B,) or None, C
    (B, nl) or None).  Checks and scripts may force the ``plan``'s variant
    and team, the iteration cap, and the phases build.  Raises when the
    launch fails, or when a matrix is not finite or an eigenvalue passes
    the cap (the info is copied to the host: one synchronisation)."""
    global launches, last_plan, last_info
    call, out, info, pl, cap = _prepared(s, m, c, nl, guess, sel, variant,
                                         max_its, team, phases)
    if call is None:
        return out
    err = call()
    if err != 0:
        raise RuntimeError(f"angular_eig kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    last_plan, last_info = pl, info.cpu()
    check_info(last_info, c, s, m, nl, cap)
    return out


def launch_ms(s, m, c, nl, guess=None, sel=0, reps=20) -> float:
    """The kernel's device ms a launch, by CUDA events around reps
    back-to-back launches of its C entry on the plan and buffers of one
    ``_launch`` of the same arguments (no read-back or check between them,
    so the launches queue and the events time the kernels; the call's
    host work is left out).  Counts its launches; their results are not
    read (the same arguments' ``_launch`` checks them)."""
    global launches
    call = _prepared(s, m, c, nl, guess, sel, None, None, None, False)[0]
    if call is None:
        return 0.0
    for _ in range(3):
        if call():
            raise RuntimeError("angular_eig kernel launch failed")
        launches += 1
    torch.cuda.synchronize(c.device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    errs = 0
    for _ in range(reps):
        errs += call() != 0
        launches += 1
    end.record()
    torch.cuda.synchronize(c.device)
    if errs:
        raise RuntimeError("angular_eig kernel launch failed")
    return start.elapsed_time(end) / reps


def _prepared(s, m, c, nl, guess, sel, variant, max_its, team, phases):
    """``_launch``'s checks, outputs and plan: (call, (eig, A, C), info,
    plan, cap), ``call()`` the C entry's launch on them (returning its
    CUDA error), None for an empty batch."""
    if not c.is_cuda:
        raise ValueError(f"angular_eig: no kernel for device {c.device}")
    if c.dtype != torch.complex128 or c.dim() != 1:
        raise TypeError("angular_eig takes a (B,) complex128 c")
    if nl < 1 or not 0 <= sel < nl:
        raise ValueError(f"angular_eig: nl = {nl}, sel = {sel}")
    dev, B = c.device, c.shape[0]
    if not c.is_contiguous():
        c = c.contiguous()
    vectors = guess is not None
    if vectors:
        guess = guess.to(device=dev, dtype=c.dtype)
        if guess.shape != (B,) or not guess.is_contiguous():
            guess = torch.broadcast_to(guess, (B,)).contiguous()
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
        return None, (eig, A, C), None, None, None
    pl = plan(nl, B, variant, team)
    ws = (torch.empty(pl["workspace_bytes"] // 8, dtype=torch.float64,
                      device=dev) if pl["variant"] == "global" else None)
    info = torch.empty((B, 2), dtype=torch.int64, device=dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    band = _bands_t(s, m, nl, dev)
    cap = max_iterations(nl) if max_its is None else max_its

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib(phases)
    args = (B, nl, int(s), int(sel), int(cap), pl["warps"], pl["team"],
            c.data_ptr(), ptr(guess), band.data_ptr(), eig.data_ptr(),
            ptr(A), ptr(C), info.data_ptr(), ptr(ws), index,
            torch.cuda.current_stream(dev).cuda_stream)

    def call(_alive=(c, guess, band, ws, eig, A, C, info)):
        return lib.qnm_angular_eig(*args)

    return call, (eig, A, C), info, pl, cap


def phase_cycles(s, m, c, nl, team=None) -> dict:
    """A matrix's clock64 cycles by phase (``PHASES``; lane 0 of each warp,
    summed over one values-mode launch on the CUDA c, divided by its
    matrices) from the phases build, with its rotations, a rotation's
    cycles (``per_rotation``) and an iteration's split test and shift
    (``per_sweep_split_shift``).  The clock reads slow what they time.  A
    launch with ``team`` 2 counts its leader's phases, both warps'
    rotations, and the ticks of its iterations on two bulges (``per_tick``:
    the sweeps' cycles a tick, single-bulge sweeps included)."""
    lib = _lib(True)
    _launch(s, m, c, nl, team=team, phases=True)
    out = (ctypes.c_ulonglong * 16)()
    if lib.qnm_eig_phases(out, 1):
        raise RuntimeError("angular_eig: resetting the phase counters failed")
    _launch(s, m, c, nl, team=team, phases=True)
    torch.cuda.synchronize(c.device)
    if lib.qnm_eig_phases(out, 0):
        raise RuntimeError("angular_eig: reading the phase counters failed")
    B, sweeps = c.shape[0], int(last_info[:, 0].sum())
    per = {p: out[i] / B for i, p in enumerate(PHASES) if p != "-"}
    per.update(per_rotation=out[1] / max(out[5], 1),
               per_tick=out[1] / out[6] if out[6] else None,
               per_sweep_split_shift=(out[2] + out[3]) / max(sweeps, 1))
    return per


def check_info(info, c, s, m, nl, cap):
    """Raise when a matrix of a launch failed: info (B, 2) the kernel's
    (QR iterations, FP64 operations) a matrix on the host, iterations -1
    where an eigenvalue passed ``cap`` iterations and -2 where the matrix
    is not finite."""
    sweeps = info[:, 0].numpy()
    if not sweeps.size or sweeps.min() >= 0:
        return
    bad = int(np.argmin(sweeps))
    worst = int(sweeps[bad])
    why = ("is not finite" if worst == -2 else
           f"did not converge within {cap} QR iterations an eigenvalue")
    raise RuntimeError(f"angular_eig: the matrix at c = {complex(c[bad])} "
                       f"(s = {s}, m = {m}, nl = {nl}) {why}")
