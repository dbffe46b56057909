"""The batched Leaver continued fraction as a hand-written CUDA kernel
(``csrc/leaver_cf.cu``) for Hopper: a team of threads on each element, the
backward recursion as a segmented product of 2 x 2 matrices, in FP64 or,
for spins beyond ``CHI_EXTENDED``, in double-double.

It replaces the JAX package's native CPU kernel
``qnmfits_tpu/spectrum/csrc/cf_kernel.cpp::radial_cf_batch`` (80-bit, bound
by ``cf_native.py``), the hot loop of the on-demand spectrum solver
(``spectrum/solver.py``, ``spectrum/radial.py``).  ``leaver_cf`` holds the
rule every caller follows: elements whose spin chi = 2a exceeds
``CHI_EXTENDED`` (0.985) are evaluated in double-double (about 106 bits,
where an FP64 CF's rounding noise over |f'| can pass the step the solver's
Newton accepts and leave points on the coarse track), the others in FP64,
bit for bit as an FP64-only batch.  The plain PyTorch versions are
``cf_parts`` (FP64) and ``cf_dd`` (double-double, on ``ops/dd.py``):
``leaver_cf`` runs them for tensors on the CPU and launches the kernel's
two variants for tensors on a CUDA device.

``cf_parts`` forms the recurrence coefficients of a block of depths in one
vectorised step, with the formulas and the order of operations of the JAX
package (its spectrum/radial.py:40-119), and loops only the two operations
of the backward recursion.  ``cf_dd`` forms the kernel's product of 2 x 2
matrices by a pairwise tree over the depth.  Leaver's 2M = 1 units: spin a
in [0, 0.5), omega_L = 2 M omega.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/qnmfits_tpu_torch/``
(named by a hash of the source and flags, so an edit rebuilds) and bound
with ctypes, as ``ops/chol_cuda.py`` does; without contraction
(``-fmad=false``): its hot loop writes its fused multiply-adds out, so the
host build of the same source (``g++ -ffp-contract=off``, the CPU tests)
rounds as the card does.  ``plan`` picks the team of an FP64 launch,
``plan_dd`` the team and the blocks an element of a double-double one
(its elements spread over many blocks, the near-extremal launches being a
few elements deep).  A failed build or launch raises; nothing falls back.
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

from . import dd
from .chol_cuda import BUILD_DIR, NVCC_FLAGS, _nvcc

__all__ = ["CHI_EXTENDED", "PHASES", "build", "cf_dd", "cf_parts",
           "dd_launches", "dd_plans", "last_dd_plan", "last_plan",
           "leaver_cf", "leaver_coeffs", "launches", "phase_cycles", "plan",
           "plan_dd", "ptxas_report"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "leaver_cf.cu"
BUILD_LOG = BUILD_DIR / "leaver_cf_build.log"
CF_FLAGS = (*NVCC_FLAGS, "-fmad=false")
# The kernel's instantiations by their block, FP64 and double-double: teams
# of 1..128 threads run in blocks of 128, a team of 256 in its own block.
KERNELS = ("block<128>", "block<256>", "dd block<128>", "dd block<256>")
# Elements whose spin chi = 2a exceeds this take the double-double variant:
# beyond it the FP64 CF's rounding noise over |f'| can exceed the step
# (1e-9 |omega|) the solver's lockstep Newton accepts (PERF.md, section 6).
CHI_EXTENDED = 0.985
# Teams are powers of two up to a block; the card's depth limit
# (csrc/leaver_cf.cu, kMaxN).
TEAMS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MAX_N = 1 << 20
# plan(): the threads a launch should give each SM (~7.5 warps hide a
# step's latency; smaller teams share a warp's setup and finish among more
# elements), and the fewest steps a thread's segment keeps; both from
# scripts/torch_cf_teams.py's times of every team on an H100, where the
# same rule also picks the double-double variant's fastest team at each of
# its shapes (--extended).
THREADS_PER_SM = 240
MIN_SEGMENT = 16
# plan_dd(): the double-double variant's element spreads over T = team x
# blocks segments, to the same THREADS_PER_SM, keeping this many steps a
# segment (a tree level costs about one step), the blocks beyond one of
# teams of DD_TEAM (up to DD_TEAM of them, then of 256); from
# scripts/torch_cf_teams.py --extended's sweep of (team, blocks) on an
# H100.
DD_MIN_SEGMENT = 8
DD_TEAM = 128
MAX_BLOCKS = 256
# The phases build (``phase_cycles``): its flag, and the counters its
# phases are divided by (csrc/leaver_cf.cu's enum, in order).
PHASE_FLAGS = ("-DQNM_CF_PHASES",)
PHASES = (("coefficients", "segment blocks"), ("segments", "warps"),
          ("in-block tree", "segment blocks"), ("arrival", "segment blocks"),
          ("cross-block combine", "last blocks"), ("finish", "last blocks"),
          ("terms", "terms"), ("block", "segment blocks"))
_COUNTS = ("segment blocks", "warps", "last blocks", "terms")

# Kernel launches since the last reset (callers set them to 0 and read
# them), FP64 and double-double; the (team, segment length) of the last
# FP64 launch and the (team, blocks, segment length) of the last
# double-double one.
launches = 0
dd_launches = 0
last_plan = None
last_dd_plan = None


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


# cf_dd: the steps x elements whose matrices are formed and multiplied out
# at once (a pairwise tree within the block, at most 2^14 steps), which
# bounds its temporaries; and the upward recurrence's rescale cadence, the
# kernel's kRescale.
_DD_BLOCK = 1 << 21
_RESCALE = 8
# The identity, as a matrix of _dd_matmul's layout.
_EYE = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def _dd_rec(s, m, a, w, A):
    """The double-double coefficients of ``csrc/leaver_cf.cu``'s
    ``leaver_rec_dd``, in its order of operations, from (B,) float64 spins
    and complex128 omega and A: a dict of complex double-doubles."""
    one = torch.ones_like(a)
    b = dd.sqrt(dd.sub(dd.of(one), dd.scaled(dd.two_prod(a, a), 4.0)))
    q = dd.div(dd.of(2.0 * one), b)
    wz = dd.zof(w)
    iw = dd.ztimes_i(wz)
    phi = (dd.sub(dd.of(0.5 * w.real), dd.two_prod(a, float(m) * one)),
           dd.of(0.5 * w.imag))
    iq_phi = dd.ztimes_i(dd.zmul_r(phi, q))
    tail = dd.zmul(dd.zmul_r(dd.zadd(dd.zscaled(wz, 2.0),
                                     (dd.of(0.0 * one), dd.of(one))), q), phi)
    w2 = dd.zmul(wz, wz)
    c0 = dd.zadd_d(dd.zsub(dd.zneg(iw), iq_phi), 1.0 - s)
    c1 = dd.zadd_d(dd.zadd(dd.zmul_r(dd.zscaled(iw, 2.0), dd.add_d(b, 2.0)),
                           dd.zscaled(iq_phi, 2.0)), -4.0)
    c2 = dd.zadd_d(dd.zsub(dd.zneg(dd.zmul_d(iw, 3.0)), iq_phi), s + 3.0)
    c3 = dd.zmul_r(w2, dd.sub(dd.add_d(dd.scaled(b, 2.0), 4.0),
                              dd.two_prod(a, a)))
    c3 = dd.zsub(c3, dd.zmul_r(wz, dd.two_prod(a, 2.0 * m * one)))
    c3 = dd.zadd(c3, dd.zmul_r(iw, dd.add_d(b, 2.0)))
    c3 = dd.zadd_d(dd.zadd(dd.zsub(c3, dd.zof(A)), tail), -(s + 1.0))
    c4 = dd.zsub(dd.zsub(dd.zneg(dd.zscaled(w2, 2.0)),
                         dd.zmul_d(iw, 2.0 * s + 3.0)), tail)
    c4 = dd.zadd_d(c4, s + 1.0)
    G1, G0 = dd.zadd_d(c2, -3.0), dd.zadd_d(dd.zsub(c4, c2), 2.0)
    A1 = dd.zadd_d(c0, 1.0)
    g1, g0 = dd.zadd_d(G1, 2.0), dd.zadd_d(dd.zadd(G1, G0), 1.0)
    t1 = dd.zscaled(c1, 0.5)
    t0 = dd.zscaled(dd.zadd_d(dd.zadd(t1, c3), 1.0), 0.5)
    r3 = dd.zadd(dd.zadd(g1, A1), dd.zscaled(t1, 2.0))
    r2 = dd.zadd(dd.zsub(dd.zadd(dd.zadd(g0, dd.zmul(A1, g1)), c0),
                         dd.zmul(t1, t1)), dd.zscaled(t0, 2.0))
    r1 = dd.zsub(dd.zadd(dd.zmul(A1, g0), dd.zmul(c0, g1)),
                 dd.zscaled(dd.zmul(t1, t0), 2.0))
    r0 = dd.zsub(dd.zmul(c0, g0), dd.zmul(t0, t0))
    return dict(c0=c0, A1=A1, B1=dd.zadd_d(c1, 2.0), c3=c3, G1=G1, G0=G0,
                t1=t1, t0=t0, r3=r3, r2=r2, r1=r1, r0=r0, b=b)


def _dd_poly(r, n, lin, const, quad):
    """lin n + const + quad n^2 (n exact doubles, broadcast with the
    coefficients), as the kernel's alpha_dd, beta_dd, gamma_dd."""
    return dd.zadd_d(dd.zadd(dd.zmul_d(r[lin], n), r[const]), quad * n * n)


def _dd_tau(r, n):
    """tau_n = (t1 - n) n + t0."""
    return dd.zadd(dd.zmul_d(dd.zadd_d(r["t1"], -n), n), r["t0"])


# The 32 real products of a 2 x 2 complex matrix product, on matrices laid
# out as 8 reals (a, b, c, d; real then imaginary part): for each entry
# (row, col) and each k, x_re y_re, -x_im y_im (the real part's terms),
# x_re y_im, x_im y_re (the imaginary part's).
_MAT_X, _MAT_Y, _MAT_SIGN = [], [], []
for _r in (0, 1):
    for _c in (0, 1):
        for _k in (0, 1):
            _x, _y = 2 * (2 * _r + _k), 2 * (2 * _k + _c)
            _MAT_X += [_x, _x + 1, _x, _x + 1]
            _MAT_Y += [_y, _y + 1, _y + 1, _y]
            _MAT_SIGN += [1.0, -1.0, 1.0, 1.0]


def _dd_matmul(X, Y):
    """Products X_i Y_i of complex double-double 2 x 2 matrices (hi, lo),
    each (..., 8), in the kernel's order: per entry, each term's complex
    product, then their sum."""
    sign = torch.tensor(_MAT_SIGN, dtype=X[0].dtype, device=X[0].device)
    p = dd.mul((X[0][..., _MAT_X] * sign, X[1][..., _MAT_X] * sign),
               (Y[0][..., _MAT_Y], Y[1][..., _MAT_Y]))
    lead = p[0].shape[:-1]
    p = tuple(t.reshape(*lead, 4, 2, 2, 2) for t in p)
    q = dd.add((p[0][..., 0], p[1][..., 0]), (p[0][..., 1], p[1][..., 1]))
    out = dd.add((q[0][..., 0, :], q[1][..., 0, :]),
                 (q[0][..., 1, :], q[1][..., 1, :]))
    return tuple(t.reshape(*lead, 8) for t in out)


def _pow2_scale(mx):
    """The power of two that brings mx (> 0) into [1, 2); 1 where mx is
    0 (the kernel's pow2_scale)."""
    _, e = torch.frexp(mx)
    return torch.where(mx > 0, torch.ldexp(torch.ones_like(mx), 1 - e), 1.0)


def _dd_rescaled(X):
    f = _pow2_scale(X[0].abs().amax(dim=-1, keepdim=True))
    return X[0] * f, X[1] * f


def _dd_tree(X):
    """The ordered product X_0 X_1 ... X_{K-1} of (K, ..., 8) matrices by a
    pairwise tree, each level rescaled by powers of two."""
    eye = torch.tensor(_EYE, dtype=X[0].dtype, device=X[0].device)
    while X[0].shape[0] > 1:
        if X[0].shape[0] % 2:
            pad = eye.expand(1, *X[0].shape[1:])
            X = (torch.cat([X[0], pad]), torch.cat([X[1], pad * 0.0]))
        X = _dd_rescaled(_dd_matmul((X[0][0::2], X[1][0::2]),
                                    (X[0][1::2], X[1][1::2])))
    return X[0][0], X[1][0]


def _dd_where(cond, x, y):
    """Complex double-doubles x where cond, else y."""
    return tuple(tuple(torch.where(cond, p, q) for p, q in zip(xp, yp))
                 for xp, yp in zip(x, y))


def cf_dd(omega, a, A, s: int, m: int, n_inv, N: int):
    """The plain version of the kernel's double-double variant: U - T and
    |U| + |T| of the n_inv-times-inverted Leaver CF, each real carried as
    a double-double (``ops/dd.py``) from the FP64 inputs and rounded once
    at the end.  Arguments as ``cf_parts``; returns (f, scale), (B,)
    complex128 and float64.

    The backward recursion is the kernel's product of the Mh_k = [[tau_k,
    -1], [R_k, tau_k]] in the basis of their nearly double fixed point
    (``csrc/leaver_cf.cu``), formed by a pairwise tree over k: log2 N
    vectorised levels of 2 x 2 products, each rescaled by a power of two,
    in blocks of steps of at most ``_DD_BLOCK`` matrices."""
    omega = torch.as_tensor(omega, dtype=torch.complex128)
    B, dev = omega.shape[0], omega.device
    a = _per_element(a, B, torch.float64, dev)
    A = _per_element(A, B, torch.complex128, dev)
    n_inv = _per_element(n_inv, B, torch.int64, dev)
    r = _dd_rec(s, m, a, omega, A)

    # The backward product P = Mh_{n_inv} ... Mh_{N-1}, the identity below
    # each element's n_inv.
    eye = torch.tensor(_EYE, dtype=torch.float64, device=dev)
    n_lo = min(int(n_inv.min()), N) if B else N
    step = max(64, min(1 << 14, _DD_BLOCK // max(B, 1)))
    blocks = []
    for lo in range(n_lo, N, step):
        k = torch.arange(lo, min(lo + step, N), dtype=torch.float64,
                         device=dev)[:, None]
        tau = _dd_tau(r, k)
        R = r["r3"]
        for c in ("r2", "r1", "r0"):
            R = dd.zadd(dd.zmul_d(R, k), r[c])
        minus_one = torch.full_like(tau[0][0], -1.0)
        zero = torch.zeros_like(minus_one)
        hi = torch.stack([tau[0][0], tau[1][0], minus_one, zero, R[0][0],
                          R[1][0], tau[0][0], tau[1][0]], dim=-1)
        lo_ = torch.stack([tau[0][1], tau[1][1], zero, zero, R[0][1],
                           R[1][1], tau[0][1], tau[1][1]], dim=-1)
        skip = (k < n_inv[None, :])[..., None]
        blocks.append(_dd_tree((torch.where(skip, eye, hi),
                                torch.where(skip, 0.0, lo_))))
    if blocks:
        P = _dd_tree((torch.stack([b[0] for b in blocks]),
                      torch.stack([b[1] for b in blocks])))
    else:
        P = (eye.expand(B, 8), torch.zeros(B, 8, dtype=torch.float64,
                                           device=dev))

    def entry(j):
        return ((P[0][:, 2 * j], P[1][:, 2 * j]),
                (P[0][:, 2 * j + 1], P[1][:, 2 * j + 1]))

    Pa, Pb, Pc, Pd = (entry(j) for j in range(4))

    # The tail's start and T at n_inv (T_N where n_inv >= N).
    u = dd.zneg(dd.zsqrt(dd.zscaled(dd.ztimes_i(dd.zmul_r(dd.zof(omega),
                                                          r["b"])), -2.0)))
    u = _dd_where(u[0][0] > 0.0, dd.zneg(u), u)
    v = dd.zscaled(dd.zsub(dd.zadd(dd.zadd_d(dd.zmul(u, u), 0.5), r["G1"]),
                           r["A1"]), 0.5)
    dN = float(N)
    sqrt_N = dd.sqrt(dd.of(torch.full_like(a, dN)))
    N_dd = dd.of(torch.full_like(a, dN))
    TN = dd.zmul(dd.zneg(_dd_poly(r, dN, "A1", "c0", 1.0)),
                 dd.zadd_d(dd.zadd(dd.zdiv_r(u, sqrt_N), dd.zdiv_r(v, N_dd)),
                           1.0))
    xN = dd.zsub(TN, _dd_tau(r, dN))
    lo_k = torch.clamp(n_inv, max=N).to(torch.float64)
    T = dd.zadd(_dd_tau(r, lo_k), dd.zdiv(dd.zadd(Pc, dd.zmul(Pd, xN)),
                                           dd.zadd(Pa, dd.zmul(Pb, xN))))

    # U = p_{n_inv} / p_{n_inv - 1} of the forward recurrence p_k = beta_k
    # p_{k-1} - alpha_{k-1} gamma_k p_{k-2}, p_{-1} = 1, p_0 = beta_0.
    p0 = (dd.of(torch.ones_like(a)), dd.of(torch.zeros_like(a)))
    p1 = _dd_poly(r, 0.0, "B1", "c3", -2.0)
    for k in range(1, int(n_inv.max()) + 1 if B else 1):
        n = float(k)
        p2 = dd.zsub(dd.zmul(_dd_poly(r, n, "B1", "c3", -2.0), p1),
                     dd.zmul(dd.zmul(_dd_poly(r, n - 1.0, "A1", "c0", 1.0),
                                     _dd_poly(r, n, "G1", "G0", 1.0)), p0))
        new0, new1 = p1, p2
        if k % _RESCALE == 0:
            mx = torch.stack([x[0].abs() for x in (*new0, *new1)]).amax(0)
            f = _pow2_scale(mx)
            new0, new1 = dd.zscaled(new0, f), dd.zscaled(new1, f)
        live = k <= n_inv
        p0, p1 = _dd_where(live, new0, p0), _dd_where(live, new1, p1)
    U = dd.zdiv(p1, p0)
    d = dd.zsub(U, T)
    f = torch.complex(dd.rounded(d[0]), dd.rounded(d[1]))
    return f, dd.rounded(dd.add(dd.zabs(U), dd.zabs(T)))


def plan(B: int, N: int, sm_count: int) -> tuple[int, int]:
    """(team, segment length) of a launch of B elements at depth N on a
    card of sm_count SMs, for either variant: the smallest team of
    ``TEAMS`` whose B x team threads give each SM ``THREADS_PER_SM``, or
    the largest that keeps ``MIN_SEGMENT`` steps a thread where none does;
    the segment is ceil(N / team)."""
    want = THREADS_PER_SM * sm_count
    team = TEAMS[0]
    for t in TEAMS[1:]:
        if B * team >= want or -(-N // t) < MIN_SEGMENT:
            break
        team = t
    return team, -(-N // team)


def _dd_split(T: int) -> tuple[int, int]:
    """(team, blocks) of T = team x blocks segments an element: one block
    up to DD_TEAM, then blocks of DD_TEAM up to DD_TEAM of them, then of
    256."""
    if T <= DD_TEAM:
        return T, 1
    team = DD_TEAM if T <= DD_TEAM * DD_TEAM else TEAMS[-1]
    return team, T // team


def plan_dd(B: int, N: int, sm_count: int) -> tuple[int, int, int]:
    """(team, blocks, segment length) of a double-double launch of B
    elements at depth N on a card of sm_count SMs: the fewest segments T
    (a power of two, split by ``_dd_split``) whose B x T threads give each
    SM ``THREADS_PER_SM``, or the most that keep ``DD_MIN_SEGMENT`` steps
    a thread where none does; the segment is ceil(N / T)."""
    want = THREADS_PER_SM * sm_count
    T = 1
    while (B * T < want and T < TEAMS[-1] * MAX_BLOCKS
           and -(-N // (2 * T)) >= DD_MIN_SEGMENT):
        T *= 2
    return (*_dd_split(T), -(-N // T))


def dd_plans() -> list[tuple[int, int]]:
    """Every (team, blocks) the double-double kernel takes: teams of
    TEAMS in one block, and teams of 128 and 256 over up to ``team``
    blocks (powers of two)."""
    return [(team, blocks) for team in TEAMS
            for blocks in (1 << k for k in range(9))
            if blocks == 1 or team >= 128 and blocks <= team]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _build_paths(phases: bool):
    """(nvcc's flags, the library, its build log) of a build: the plain
    build's log is ``BUILD_LOG``, the phases build's beside it."""
    cf_flags = (*CF_FLAGS, *(PHASE_FLAGS if phases else ()))
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(cf_flags).encode()).hexdigest()[:16]
    log = (BUILD_LOG if cf_flags == CF_FLAGS
           else BUILD_DIR / f"leaver_cf_build_{tag}.log")
    return cf_flags, BUILD_DIR / f"libleaver_cf_{tag}.so", log


def build(phases: bool = False) -> Path:
    """Compile the kernel library (with ``phases``, the build that counts
    the double-double kernel's cycles by phase, ``phase_cycles``) if this
    source has not been built so yet; returns its path.  ptxas's report
    is kept in its build log."""
    cf_flags, out, log = _build_paths(phases)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *cf_flags, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name} "
                           f"(exit {res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def ptxas_report() -> dict:
    """ptxas's report of the build, per kernel of ``KERNELS``:
    dict(registers=, spill_stores=, spill_loads=), the spills in bytes.
    Raises when the log is not that of the library ``build()`` returns."""
    lib = build()
    log = BUILD_LOG
    text = log.read_text()
    if lib.stem not in text.splitlines()[0]:
        raise RuntimeError(f"{log} is not the build log of {lib.name}")
    report = {}
    # The template argument (the block) is mangled as ILi<n>E.
    for block in text.split("Compiling entry function")[1:]:
        threads = re.search(r"leaver_cf_(dd_)?kernelILi(\d+)E", block)
        if not threads:
            raise RuntimeError(f"unknown kernel in {log}")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          block)
        regs = re.search(r"Used (\d+) registers", block)
        name = f"{'dd ' if threads[1] else ''}block<{threads[2]}>"
        report[name] = dict(registers=int(regs[1]),
                            spill_stores=int(spill[1]),
                            spill_loads=int(spill[2]))
    return report


@functools.lru_cache(maxsize=None)
def _lib(phases: bool = False):
    lib = ctypes.CDLL(str(build(phases)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    params = [ctypes.c_longlong, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
              i32, ptr, ptr, ptr]
    lib.qnm_leaver_cf.argtypes = [*params, i32, ptr]
    lib.qnm_leaver_cf_dd.argtypes = [*params, i32, ptr, ptr, i32, ptr]
    for fn in (lib.qnm_leaver_cf, lib.qnm_leaver_cf_dd):
        fn.restype = ctypes.c_int
    if phases:
        lib.qnm_cf_phases.argtypes = [ptr, i32]
        lib.qnm_cf_phases.restype = ctypes.c_int
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
    against.

    Elements whose spin chi = 2a exceeds ``CHI_EXTENDED`` are evaluated in
    double-double, the others in FP64 (bit for bit as an FP64-only batch of
    them).  CUDA tensors launch the kernel, each arithmetic on its own
    subset with ``plan``'s team; CPU tensors run the plain versions,
    ``cf_parts`` and ``cf_dd``."""
    B = omega.shape[0]
    if omega.is_cuda:
        if omega.dtype != torch.complex128 or omega.dim() != 1:
            raise TypeError("leaver_cf takes a (B,) complex128 omega")
        if not 1 <= N <= MAX_N:
            raise ValueError(f"leaver_cf takes depths 1..{MAX_N}, not {N}")
    ext = _extended(a, B, omega.device)
    if ext is None:
        f, scale = _fp64(omega, a, A, s, m, n_inv, N)
    elif ext is True:
        f, scale = _dd(omega, a, A, s, m, n_inv, N)
    else:
        dev = omega.device
        per = [_per_element(x, B, t, dev) for x, t in
               ((a, torch.float64), (A, torch.complex128),
                (n_inv, torch.int32 if omega.is_cuda else torch.int64))]
        f = torch.empty(B, dtype=torch.complex128, device=dev)
        scale = torch.empty(B, dtype=torch.float64, device=dev)
        for idx, run in zip(ext, (_fp64, _dd)):
            a_i, A_i, n_i = (x[idx] for x in per)
            f[idx], scale[idx] = run(omega[idx], a_i, A_i, s, m, n_i, N)
    return (f, scale) if with_scale else f


def _extended(a, B, dev):
    """Which elements take the double-double arithmetic: None (none), True
    (all), or the indices (FP64's, double-double's).  A spin tensor on the
    card costs one synchronisation (two where the batch is mixed)."""
    if not torch.is_tensor(a) or a.numel() == 1:
        return True if 2.0 * float(a) > CHI_EXTENDED else None
    ext = torch.broadcast_to(2.0 * a.to(dev) > CHI_EXTENDED, (B,))
    idx = torch.nonzero(ext).flatten()
    if idx.numel() == 0:
        return None
    if idx.numel() == B:
        return True
    return torch.nonzero(~ext).flatten(), idx


def _fp64(omega, a, A, s, m, n_inv, N):
    if not omega.is_cuda:
        U, T = cf_parts(omega, a, A, s, m, n_inv, N)
        return U - T, U.abs() + T.abs()
    team, _ = plan(omega.shape[0], N, _sm_count(_index(omega.device)))
    return _launch(omega, a, A, s, m, n_inv, N, team)


def _dd(omega, a, A, s, m, n_inv, N):
    if not omega.is_cuda:
        return cf_dd(omega, a, A, s, m, n_inv, N)
    team, blocks, _ = plan_dd(omega.shape[0], N,
                              _sm_count(_index(omega.device)))
    return _launch(omega, a, A, s, m, n_inv, N, team, extended=True,
                   blocks=blocks)


def _index(dev) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


# The double-double kernel's arrival counters, by (device, stream): zeroed
# once, and left zero by every launch, so launches on one stream reuse
# them; another stream, which may run at the same time, has its own.  A
# launch that fails drops its stream's.  Zeroing counters for each launch
# instead adds a fill kernel: 0.0018-0.0024 ms a launch on the card at the
# solver's shapes, on ~0.030 ms (PERF.md section 6,
# scripts/torch_cf_teams.py --arrivals).
_ARRIVALS = {}


def _arrivals(dev, stream, B):
    key = (_index(dev), stream.cuda_stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < B:
        with torch.cuda.stream(stream):
            buf = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
        _ARRIVALS[key] = buf
    return buf


def _launch(omega, a, A, s, m, n_inv, N, team, extended=False, blocks=1,
            phases=False):
    """One launch of the kernel on a (B,) complex128 CUDA ``omega``, with
    ``team`` threads an element, in FP64 or (``extended``) double-double
    over ``blocks`` blocks an element (with a workspace and the stream's
    arrival counters): (U - T, |U| + |T|).  ``leaver_cf`` passes
    ``plan``'s team and ``plan_dd``'s (team, blocks); checks and scripts
    force others or the phases build (``phases``).  Raises when the
    launch fails (the C entries refuse a team that is not a power of two
    of 1..256, and blocks beyond what ``dd_plans`` lists)."""
    global launches, dd_launches, last_plan, last_dd_plan
    dev = omega.device
    B = omega.shape[0]
    w_ri = _split(omega)
    A_ri = _split(_per_element(A, B, torch.complex128, dev))
    args = [w_ri[0], w_ri[1], _per_element(a, B, torch.float64, dev),
            A_ri[0], A_ri[1], _per_element(n_inv, B, torch.int32, dev)]
    out = torch.empty((3, B), dtype=torch.float64, device=dev)
    if B:
        index = _index(dev)
        stream = torch.cuda.current_stream(dev)
        lib = _lib(phases)
        common = (B, *(t.data_ptr() for t in args), int(s), int(m), int(N),
                  int(team), out[0].data_ptr(), out[1].data_ptr(),
                  out[2].data_ptr())
        if extended:
            ws = torch.empty(B * (16 * max(int(blocks), 1) + 14),
                             dtype=torch.float64, device=dev)
            err = lib.qnm_leaver_cf_dd(
                *common, int(blocks), ws.data_ptr(),
                _arrivals(dev, stream, B).data_ptr(), index,
                stream.cuda_stream)
        else:
            err = lib.qnm_leaver_cf(*common, index, stream.cuda_stream)
        if err != 0:
            if extended:
                _ARRIVALS.pop((index, stream.cuda_stream), None)
            raise RuntimeError(f"leaver_cf{'_dd' if extended else ''} kernel "
                               f"launch failed: CUDA error {err}")
        if extended:
            dd_launches += 1
            last_dd_plan = (int(team), int(blocks),
                            -(-N // (int(team) * int(blocks))))
        else:
            launches += 1
            last_plan = (int(team), -(-N // int(team)))
    return torch.complex(out[0], out[1]), out[2]


def phase_cycles(omega, a, A, s, m, n_inv, N, team=None, blocks=None):
    """A double-double launch's clock64 cycles by phase (``PHASES``) from
    the phases build, at ``plan_dd``'s plan unless team and blocks are
    given: per segment block its coefficients, its tree (with the wait for
    its slowest warp), its arrival and its whole span (from its thread 0),
    per warp its segments, per last block the cross-block combine and the
    finish, per element the terms; and the counts they are divided by.
    The clock reads slow what they time."""
    if team is None:
        team, blocks, _ = plan_dd(omega.shape[0], N,
                                  _sm_count(_index(omega.device)))
    lib = _lib(True)

    def run():
        return _launch(omega, a, A, s, m, n_inv, N, team, extended=True,
                       blocks=blocks, phases=True)

    run()
    out = (ctypes.c_ulonglong * 16)()
    torch.cuda.synchronize(omega.device)
    if lib.qnm_cf_phases(out, 1):
        raise RuntimeError("leaver_cf: resetting the phase counters failed")
    run()
    torch.cuda.synchronize(omega.device)
    if lib.qnm_cf_phases(out, 0):
        raise RuntimeError("leaver_cf: reading the phase counters failed")
    counts = dict(zip(_COUNTS, out[len(PHASES):len(PHASES) + len(_COUNTS)]))
    per = {name: out[k] / max(counts[by], 1)
           for k, (name, by) in enumerate(PHASES)}
    return dict(team=team, blocks=blocks, cycles=per, counts=counts)
