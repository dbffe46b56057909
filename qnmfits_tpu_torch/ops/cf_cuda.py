"""The batched Leaver continued fraction as a hand-written FP64 CUDA kernel
(``csrc/leaver_cf.cu``) for Hopper: a team of threads on each element, the
backward recursion as a segmented product of 2 x 2 matrices.

It replaces the JAX package's native CPU kernel
``qnmfits_tpu/spectrum/csrc/cf_kernel.cpp::radial_cf_batch`` (80-bit, bound
by ``cf_native.py``), the hot loop of the on-demand spectrum solver
(``spectrum/solver.py``, ``spectrum/radial.py``).  Its plain PyTorch
version is ``cf_parts`` here: ``leaver_cf`` runs it for tensors on the CPU
and launches the kernel for tensors on a CUDA device.

``cf_parts`` forms the recurrence coefficients of a block of depths in one
vectorised step, with the formulas and the order of operations of the JAX
package (its spectrum/radial.py:40-119), and loops only the two operations
of the backward recursion.  Leaver's 2M = 1 units: spin a in [0, 0.5),
omega_L = 2 M omega.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags, so an edit rebuilds) and bound
with ctypes, as ``ops/chol_cuda.py`` does; without contraction
(``-fmad=false``): its hot loop writes its fused multiply-adds out, so the
host build of the same source (``g++ -ffp-contract=off``, the CPU tests)
rounds as the card does.  ``plan`` picks the team for a launch.  A failed
build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import numbers
import os
import re
import subprocess
from pathlib import Path

import torch

from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc

__all__ = ["build", "cf_parts", "last_plan", "leaver_cf", "leaver_coeffs",
           "launches", "plan", "ptxas_report"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "leaver_cf.cu"
BUILD_LOG = BUILD_DIR / "leaver_cf_build.log"
CF_FLAGS = (*NVCC_FLAGS, "-fmad=false")
# The kernel's instantiations by their block: teams of 1..128 threads run
# in blocks of 128, a team of 256 in its own block.
KERNELS = ("block<128>", "block<256>")
# Teams are powers of two up to a block; the card's depth limit
# (csrc/leaver_cf.cu, kMaxN).
TEAMS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MAX_N = 1 << 20
# plan(): the threads a launch should give each SM (~7.5 warps hide a
# step's latency; smaller teams share a warp's setup and finish among more
# elements), and the fewest steps a thread's segment keeps; both from
# scripts/torch_cf_teams.py's times of every team on an H100.
THREADS_PER_SM = 240
MIN_SEGMENT = 16

# Kernel launches since the last reset (callers set it to 0 and read it),
# and the (team, segment length) of the last launch.
launches = 0
last_plan = None


# Depths whose recurrence coefficients are formed at once in the tail: the
# (block, B) complex temporaries stay small at any batch.
_BLOCK = 1024


def _sqrt_b(a):
    """b = sqrt(1 - 4 a^2) for a float or a float64 tensor of spins."""
    if torch.is_tensor(a):
        return torch.sqrt(1.0 - 4.0 * a * a)
    return math.sqrt(1.0 - 4.0 * a * a)


def leaver_coeffs(s: int, m: int, a, omega, A):
    """Leaver's c0..c4 for the Kerr radial recurrence (2M = 1 units).

    ``a`` (a float or a float64 tensor) in [0, 0.5); ``omega`` = omega_L
    and ``A`` complex tensors that broadcast with it.
    """
    b = _sqrt_b(a)
    phi = omega / 2.0 - a * m  # recurring combination (omega/2 - a m)

    c0 = 1.0 - s - 1j * omega - (2j / b) * phi
    c1 = -4.0 + 2j * omega * (2.0 + b) + (4j / b) * phi
    c2 = s + 3.0 - 3j * omega - (2j / b) * phi
    c3 = (
        omega * omega * (4.0 + 2.0 * b - a * a)
        - 2.0 * a * m * omega
        - s
        - 1.0
        + (2.0 + b) * 1j * omega
        - A
        + ((4.0 * omega + 2j) / b) * phi
    )
    c4 = s + 1.0 - 2.0 * (omega * omega) - (2.0 * s + 3.0) * 1j * omega \
        - ((4.0 * omega + 2j) / b) * phi
    return c0, c1, c2, c3, c4


def _alpha_beta_gamma(n, c0, c1, c2, c3, c4):
    """Three-term recurrence coefficients at index n (a float, or a real
    tensor that broadcasts with the c's)."""
    alpha = n * n + (c0 + 1.0) * n + c0
    beta = -2.0 * n * n + (c1 + 2.0) * n + c3
    gamma = n * n + (c2 - 3.0) * n + c4 - c2 + 2.0
    return alpha, beta, gamma


def cf_parts(omega, a, A, s: int, m: int, n_inv, N: int):
    """The two parts of the n_inv-times-inverted Leaver CF, U and T, with
    U - T the CF residual (``radial_cf``).

    ``omega``, ``A``: (B,) complex128 tensors (Leaver units); ``a``: a
    float or a (B,) float64 tensor; ``n_inv``: an int or a (B,) integer
    tensor; N the tail's depth.  Near a root U - T cancels, so residuals
    are compared relative to |U| + |T|.
    """
    omega = torch.as_tensor(omega, dtype=torch.complex128)
    A = torch.broadcast_to(torch.as_tensor(A, dtype=torch.complex128,
                                           device=omega.device), omega.shape)
    c0, c1, c2, c3, c4 = leaver_coeffs(s, m, a, omega, A)
    b = _sqrt_b(a)
    ragged = torch.is_tensor(n_inv) and n_inv.numel() > 1
    if ragged:
        n_inv = n_inv.to(omega.device)
        n_lo, n_hi = int(n_inv.min()), int(n_inv.max())
    else:
        n_lo = n_hi = int(n_inv)

    # Upward (finite) part: U_k = beta_k - alpha_{k-1} gamma_k / U_{k-1}.
    U = alpha_prev = None
    for k in range(n_hi + 1):
        al, be, ga = _alpha_beta_gamma(float(k), c0, c1, c2, c3, c4)
        new = be if k == 0 else be - alpha_prev * ga / U
        U = torch.where(k <= n_inv, new, U) if ragged and k else new
        alpha_prev = al

    # Downward tail: T_k = alpha_k gamma_{k+1} / (beta_{k+1} - T_{k+1}),
    # from T_N = -alpha_N r_N on the decaying branch Re(u) <= 0.
    u = -torch.sqrt(-2j * b * omega)
    u = torch.where(u.real > 0, -u, u)
    A1 = c0 + 1.0   # linear coefficient of alpha_n
    G1 = c2 - 3.0   # linear coefficient of gamma_n
    v = (u * u + 0.5 + G1 - A1) / 2.0
    alpha_N, _, _ = _alpha_beta_gamma(float(N), c0, c1, c2, c3, c4)
    T = -alpha_N * (1.0 + u / math.sqrt(N) + v / N)

    coeffs = [c[None] for c in (c0, c1, c2, c3, c4)]
    for hi in range(N - 1, n_lo - 1, -_BLOCK):
        lo = max(n_lo, hi - _BLOCK + 1)
        ks = torch.arange(hi, lo - 1, -1, dtype=torch.float64,
                          device=omega.device)[:, None]
        al, _, _ = _alpha_beta_gamma(ks, *coeffs)
        _, be1, ga1 = _alpha_beta_gamma(ks + 1.0, *coeffs)
        num = (al * ga1).unbind(0)
        den = be1.unbind(0)
        for i in range(len(num)):
            new = num[i] / (den[i] - T)
            T = torch.where(hi - i >= n_inv, new, T) if ragged else new
    return U, T


def plan(B: int, N: int, sm_count: int) -> tuple[int, int]:
    """(team, segment length) of a launch of B elements at depth N on a
    card of sm_count SMs: the smallest team of ``TEAMS`` whose B x team
    threads give each SM ``THREADS_PER_SM``, or the largest that keeps
    ``MIN_SEGMENT`` steps a thread where none does; the segment is
    ceil(N / team)."""
    want = THREADS_PER_SM * sm_count
    team = TEAMS[0]
    for t in TEAMS[1:]:
        if B * team >= want or -(-N // t) < MIN_SEGMENT:
            break
        team = t
    return team, -(-N // team)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def build() -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ptxas's report is kept in ``BUILD_LOG``."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CF_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libleaver_cf_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *CF_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    BUILD_LOG.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """ptxas's report of the last build, per kernel of ``KERNELS``:
    dict(registers=, spill_stores=, spill_loads=), the spills in bytes.
    Raises when the log is not that of the library ``build()`` returns."""
    lib = build()
    text = BUILD_LOG.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{BUILD_LOG} is not the build log of {lib.name}")
    report = {}
    # The template argument (the block) is mangled as ILi<n>E.
    for block in text.split("Compiling entry function")[1:]:
        threads = re.search(r"leaver_cf_kernelILi(\d+)E", block)
        if not threads:
            raise RuntimeError(f"unknown kernel in {BUILD_LOG}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        report[f"block<{threads[1]}>"] = dict(registers=int(regs[1]),
                                              spill_stores=int(spill[1]),
                                              spill_loads=int(spill[2]))
    return report


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(str(build()))
    ptr = ctypes.c_void_p
    lib.qnm_leaver_cf.argtypes = [ctypes.c_longlong, ptr, ptr, ptr, ptr, ptr,
                                  ptr, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ptr, ptr, ptr,
                                  ctypes.c_int, ptr]
    lib.qnm_leaver_cf.restype = ctypes.c_int
    return lib


def _per_element(x, B, dtype, device):
    """x (a number or a tensor that broadcasts to (B,)) as a contiguous
    (B,) tensor of dtype on device; a number is filled in on the device
    (no host-to-device copy, which would wait for the card)."""
    if isinstance(x, numbers.Number):
        return torch.full((B,), x, dtype=dtype, device=device)
    return torch.broadcast_to(torch.as_tensor(x, dtype=dtype, device=device),
                              (B,)).contiguous()


def _split(z):
    """A (B,) complex tensor as one contiguous (2, B) float64 tensor: its
    real parts, then its imaginary parts (one copy)."""
    return torch.view_as_real(z).T.contiguous()


def leaver_cf(omega, a, A, s: int, m: int, n_inv, N: int,
              with_scale: bool = False):
    """The residual U - T of the n_inv-times-inverted Leaver CF at depth N
    for a batch: ``omega``, ``A`` (B,) complex128 (Leaver units), ``a`` a
    float or (B,) float64 spins, ``n_inv`` an int or (B,) integers.  With
    ``with_scale`` also |U| + |T|, the scale its cancellation is judged
    against.  CUDA tensors launch the kernel, with ``plan``'s team; CPU
    tensors run the plain version."""
    if not omega.is_cuda:
        U, T = cf_parts(omega, a, A, s, m, n_inv, N)
        return (U - T, U.abs() + T.abs()) if with_scale else U - T
    if omega.dtype != torch.complex128 or omega.dim() != 1:
        raise TypeError("leaver_cf takes a (B,) complex128 omega")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"leaver_cf takes depths 1..{MAX_N}, not {N}")
    team, _ = plan(omega.shape[0], N, _sm_count(_index(omega.device)))
    f, scale = _launch(omega, a, A, s, m, n_inv, N, team)
    return (f, scale) if with_scale else f


def _index(dev) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def _launch(omega, a, A, s, m, n_inv, N, team):
    """One launch of the kernel on a (B,) complex128 CUDA ``omega``, with
    ``team`` threads an element: (U - T, |U| + |T|).  ``leaver_cf`` passes
    ``plan``'s team; checks and scripts force others.  Raises when the
    launch fails (the C entry refuses a team that is not a power of two
    of 1..256)."""
    global launches, last_plan
    dev = omega.device
    B = omega.shape[0]
    w_ri = _split(omega)
    A_ri = _split(_per_element(A, B, torch.complex128, dev))
    args = [w_ri[0], w_ri[1], _per_element(a, B, torch.float64, dev),
            A_ri[0], A_ri[1], _per_element(n_inv, B, torch.int32, dev)]
    out = torch.empty((3, B), dtype=torch.float64, device=dev)
    if B:
        index = _index(dev)
        err = _lib().qnm_leaver_cf(
            B, *(t.data_ptr() for t in args), int(s), int(m), int(N),
            int(team), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"leaver_cf kernel launch failed: CUDA error "
                               f"{err}")
        launches += 1
        last_plan = (int(team), -(-N // int(team)))
    return torch.complex(out[0], out[1]), out[2]
