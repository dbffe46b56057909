"""The factored t0 sweep and its regularised Hermitian solve (port of the
main-path part of qnmfits_tpu/engine_real.py).

The JAX module carries every complex value as a (re, im) pair of real
arrays because the TPU has no complex dtype.  The H100 has native FP64
and complex128, so the port works in complex128 and keeps the split form
only where it fixes the rounding of a formula (the closed-form Grams).
The precision guards carry over unchanged: the dead-column threshold
(1e3 eps)^2, identity rows for dead columns, the 500 J eps floor, and the
chunk-span budget that the caller applies (``batched._safe_chunk``).
"""

from __future__ import annotations

import math

import torch

from .ops import chol_cuda, sweep_cuda
from .ops.chol import (complex_cholesky_factor,
                       complex_cholesky_solve_unrolled, complex_lower_inverse)
from .ops.cmath import damped_phase
from .ops.windows import trapz_weights, window_geq

__all__ = ["JOIN_BYTES", "RegularisedSolve", "join_groups",
           "sweep_omega_grid_bordered_real", "sweep_spectra_stacked_real",
           "sweep_t0_factored_real", "sweep_t0_modesets_factored_real"]

# Most bytes of G and G2 (or G and G_tau) that a sweep joins for one solve
# call: S * B systems of J^2 complex128 each would otherwise grow without
# bound with a remnant axis folded into the set axis.
JOIN_BYTES = 1 << 30


def _equilibrated(G, b):
    """Equilibrate, mask numerically dead columns, floor.

    G (..., J, J), b (..., J) complex.  Columns whose Gram diagonal
    underflows (modes invisible in the window) become identity rows with
    zero right-hand side, and a machine-epsilon floor bounds the
    equilibrated condition number (engine_real.py:52-94).  Returns the
    unit-diagonal system (A, b') and the diagonal unscaling Di.
    """
    J = G.shape[-1]
    eps = torch.finfo(G.real.dtype).eps
    diag = torch.diagonal(G, dim1=-2, dim2=-1).real
    dead = diag <= diag.amax(dim=-1, keepdim=True) * (1e3 * eps) ** 2
    kk = dead[..., :, None] | dead[..., None, :]
    eye = torch.eye(J, dtype=G.dtype, device=G.device)
    G = torch.where(kk, eye, G)
    b = torch.where(dead, torch.zeros((), dtype=b.dtype, device=b.device), b)
    d = torch.sqrt(torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1).real,
                               min=torch.finfo(G.real.dtype).tiny))
    Di = 1.0 / d
    A = G * Di[..., :, None] * Di[..., None, :]
    A = A + (500.0 * J * eps) * eye
    return A, b * Di, Di


def _regularised_solve_plain(G, b):
    """The plain PyTorch version of the CUDA solve kernel: equilibrated,
    dead-column masked, floored complex Cholesky solve, any device."""
    A, bs, Di = _equilibrated(G, b)
    return complex_cholesky_solve_unrolled(A, bs) * Di


def join_groups(sizes, item_bytes):
    """Runs of consecutive chunks whose joined systems stay within
    ``JOIN_BYTES``: ``sizes`` are the chunks' item counts and
    ``item_bytes`` the bytes one item adds.  A chunk over the budget on
    its own is a run of one.  Returns [(first, stop)] chunk index ranges
    that cover every chunk in order."""
    groups, first, used = [], 0, 0
    for i, m in enumerate(sizes):
        if i > first and used + m * item_bytes > JOIN_BYTES:
            groups.append((first, i))
            first, used = i, 0
        used += m * item_bytes
    if len(sizes):
        groups.append((first, len(sizes)))
    return groups


def _solve_detached(G, b):
    """The solve on tensors outside the autograd graph: the hand-written
    kernel on CUDA tensors, its plain version on CPU ones."""
    if G.is_cuda:
        return chol_cuda.regularised_solve(G, b)
    if G.device.type == "cpu":
        with torch.no_grad():
            return _regularised_solve_plain(G, b)
    raise ValueError(f"no solve for device {G.device}")


class RegularisedSolve(torch.autograd.Function):
    """The regularised solve as a twice-differentiable function of (G, b).

    For Hermitian G the solve computes x = M^-1 b on the live columns and
    0 on the dead ones, with M = G + f diag(Re G_jj) and f = 500 J eps
    (the equilibration cancels).  M is Hermitian, so the gradient of b is
    the same solve applied to the gradient of x, and that of G is
    -gb x^H plus f times its real diagonal; dead rows and columns come
    out zero, since x and gb are zero there.  The backward is written in
    differentiable operations and this function itself, so a second
    backward (a Hessian) launches the solve again.  Only G's lower
    triangle is read: the gradient is that of the Hermitian G.
    """

    @staticmethod
    def forward(ctx, G, b):
        x = _solve_detached(G.detach(), b.detach())
        ctx.save_for_backward(G, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        G, x = ctx.saved_tensors
        gb = RegularisedSolve.apply(G, gx)
        gM = -gb[..., :, None] * x.conj()[..., None, :]
        floor = 500.0 * G.shape[-1] * torch.finfo(G.real.dtype).eps
        diag = torch.diagonal(gM, dim1=-2, dim2=-1).real
        return gM + torch.diag_embed(floor * diag).to(gM.dtype), gb


def _regularised_solve(G, b):
    """Batched equilibrated Hermitian solve (engine_real.py:109): G
    (B, J, J), b (B, J) complex128 -> x (B, J).  CUDA tensors run the
    hand-written kernel, CPU tensors its plain version, forward and
    backward (``RegularisedSolve``)."""
    return RegularisedSolve.apply(G, b)


def _fitted_step(times):
    """The least-drift uniform step (t[-1] - t[0]) / (K - 1)."""
    return (times[-1] - times[0]) / (times.shape[0] - 1)


def _analytic_grams(times, wr, wi, t0c, a, m):
    """Closed-form window Grams on a uniform time grid (geq windows),
    engine_real.py:516.  wr/wi (S, J); a (Bc,) first in-window index and
    m (Bc,) sample count.  Returns Gt, Gtau complex (S, Bc, J, J)."""
    K = times.shape[0]
    s_b = torch.clamp(times[torch.clamp(a, 0, K - 1)] - t0c[0], min=0.0)
    return _geom_grams_core(_fitted_step(times), K, wr, wi, s_b, m)


def _geom_grams_core(dlt, K, wr, wi, s_b, m, edge_first=None,
                     edge_last=None):
    """Pairwise-mode closed-form Grams for windows of m[b] samples whose
    first sample sits s_b[b] after the basis reference (nu from the
    conj(phi_j) phi_l inner product).  wr/wi (S, J); the edge weights
    (see ``_geom_series_eval``) broadcast against (S, Bc, J, J).  Returns
    Gt, Gtau complex (S, Bc, J, J)."""
    nu_re = (wi[:, :, None] + wi[:, None, :])[:, None]     # (S, 1, J, J)
    nu_im = (wr[:, :, None] - wr[:, None, :])[:, None]
    return _geom_series_eval(dlt, K, nu_re, nu_im, s_b[:, None, None],
                             m[:, None, None], edge_first, edge_last)


def _geom_series_eval(dlt, K, nu_re, nu_im, s, m, edge_first=None,
                      edge_last=None):
    """Closed-form windowed exponential sums (engine_real.py:600).

    With z = e^{nu dlt}: Gt = e^{nu s} (z^m - 1)/(z - 1), the sum of m
    consecutive samples of e^{nu t} starting at offset s, and Gtau the
    trapezoid-weighted sum dlt (Gt - (first + last term)/2).  z^m - 1 is
    built in expm1 form by bit decomposition of m (u(z^2p) = u^2 + 2u,
    u(z^(p+q)) = u_p u_q + u_p + u_q), so no absolute-1 cancellation; the
    leading factor is a direct exp (it needs relative precision at tiny
    magnitudes).  Split (re, im) arithmetic as in the reference.

    edge_first / edge_last (broadcastable, 1 by default) multiply the two
    half-weight edge terms of Gtau: a time-sharded caller passes 0 for a
    window edge that is only a shard boundary, where the sample keeps its
    full trapezoid weight, so the sum over shards is the global Gtau
    (engine_real.py:583-600).  Returns Gt, Gtau complex of the broadcast
    shape.
    """
    nbits = max(1, int(math.ceil(math.log2(K + 1))))
    ex = torch.exp(nu_re * dlt)
    den_re = torch.expm1(nu_re * dlt) - 2.0 * ex * torch.sin(nu_im * dlt * 0.5) ** 2
    den_im = ex * torch.sin(nu_im * dlt)

    e0 = torch.exp(nu_re * s)
    F_re = e0 * torch.cos(nu_im * s)
    F_im = e0 * torch.sin(nu_im * s)

    shape = torch.broadcast_shapes(nu_re.shape, nu_im.shape, s.shape, m.shape)
    usq_re = den_re.expand(shape)                             # u(z^(2^i))
    usq_im = den_im.expand(shape)
    um_re = torch.zeros(shape, dtype=nu_re.dtype, device=nu_re.device)
    um_im = torch.zeros_like(um_re)
    zero = torch.zeros((), dtype=nu_re.dtype, device=nu_re.device)
    for i in range(nbits):
        # where, not a multiply by the bit: a level above m's top bit can
        # overflow for growing modes, and 0 * inf would poison um.
        bit = ((m >> i) & 1) > 0
        cm_re = um_re * usq_re - um_im * usq_im + usq_re
        cm_im = um_re * usq_im + um_im * usq_re + usq_im
        um_re = um_re + torch.where(bit, cm_re, zero)
        um_im = um_im + torch.where(bit, cm_im, zero)
        if i < nbits - 1:
            usq_re, usq_im = (usq_re * usq_re - usq_im * usq_im + 2.0 * usq_re,
                              2.0 * usq_re * usq_im + 2.0 * usq_im)

    # S_m = u(z^m)/u(z); nu == 0 has the exact limit S_m = m.
    den2 = den_re * den_re + den_im * den_im
    safe = den2 > 0
    one = torch.ones((), dtype=nu_re.dtype, device=nu_re.device)
    dsr = torch.where(safe, den_re, one)
    dsi = torch.where(safe, den_im, zero)
    d2s = dsr * dsr + dsi * dsi
    S_re = (um_re * dsr + um_im * dsi) / d2s
    S_im = (um_im * dsr - um_re * dsi) / d2s
    mf = m.to(nu_re.dtype).expand(shape)
    S_re = torch.where(safe, S_re, mf)
    S_im = torch.where(safe, S_im, zero)

    Gt_re = F_re * S_re - F_im * S_im
    Gt_im = F_re * S_im + F_im * S_re

    # Last term F z^(m-1) = F (u(z^m) + 1)/z.
    zm_re, zm_im = um_re + 1.0, um_im
    z_re, z_im = den_re + 1.0, den_im
    z2 = z_re * z_re + z_im * z_im
    zb_re = (zm_re * z_re + zm_im * z_im) / z2
    zb_im = (zm_im * z_re - zm_re * z_im) / z2
    tb_re = F_re * zb_re - F_im * zb_im
    tb_im = F_re * zb_im + F_im * zb_re
    nonempty = (m > 0).to(nu_re.dtype)
    # A factor of 1.0 is exact: without edge weights nothing changes.
    ef = 1.0 if edge_first is None else edge_first
    el = 1.0 if edge_last is None else edge_last
    Gtau_re = dlt * (Gt_re - 0.5 * (ef * F_re + el * tb_re)) * nonempty
    Gtau_im = dlt * (Gt_im - 0.5 * (ef * F_im + el * tb_im)) * nonempty
    return torch.complex(Gt_re, Gt_im), torch.complex(Gtau_re, Gtau_im)


def _as_real(Z):
    """(K, ...) complex -> (K, 2 * prod(...)) real view, so a real window
    matrix multiplies it in one real matmul."""
    return torch.view_as_real(Z.contiguous()).reshape(Z.shape[0], -1)


def _as_complex(X, *shape):
    """Columns of interleaved (re, im) pairs -> complex of ``shape``."""
    return torch.view_as_complex(X.contiguous().reshape(*shape, 2))


def _chunk_systems(times, data, omegas, mus, t0c, Tc, col_masks, analytic):
    """The systems of one chunk of start times for every mode set, factored
    form (engine_real.py:717-825, up to the solve).

    times (K,), data (I, K), omegas (S, J), mus (S, I, J), t0c/Tc (Bc,),
    col_masks (S, J) bool.  Every window of the chunk is fitted in the
    basis phi0 = exp(-i w (t - tref)), tref = t0c[0]; the window matrix W is
    built once and shared by all sets.  Returns G, G2 (S, Bc, J, J), rhs,
    rt (S, Bc, J) and dnorm (Bc,): the masked Gram and right-hand side of
    the solve, and the trapezoid Gram, projections and data norm of the
    mismatch.
    """
    K = times.shape[0]
    S, J = omegas.shape
    I = data.shape[0]
    Bc = t0c.shape[0]
    tref = t0c[0]
    wr, wi = omegas.real, omegas.imag

    # Rows before tref lie outside every window of the chunk: clamp.
    dt0 = torch.clamp(times - tref, min=0.0)[None, :, None]     # (1, K, 1)
    E = torch.exp(wi[:, None, :] * dt0)
    ph = wr[:, None, :] * dt0
    phi0 = torch.complex(E * torch.cos(ph), -E * torch.sin(ph))  # (S, K, J)
    phic = phi0.conj()

    # Data projections conj(phi0_j) d_i per sample, (K, S, I, J).
    R = (phic[:, :, None, :] * data.T[None, :, :, None]).permute(1, 0, 2, 3)
    S2 = (data.real ** 2 + data.imag ** 2).sum(dim=0)[:, None]   # (K, 1)
    W = window_geq(times[None, :], t0c[:, None], Tc[:, None])    # (Bc, K)
    nR = 2 * S * I * J

    if analytic:
        a_w = (times[None, :] < t0c[:, None]).sum(dim=1)
        m_w = (W > 0.5).sum(dim=1)
        Gt, Gtau = _analytic_grams(times, wr, wi, t0c, a_w, m_w)
        # On a uniform grid the trapezoid weights are dlt * W minus dlt/2
        # at the two edge samples: two row gathers replace a matmul.
        X = torch.cat([_as_real(R), S2], dim=1)                  # (K, nR+1)
        WX = W @ X
        e_w = torch.clamp(a_w + m_w - 1, 0, K - 1)
        a_w = torch.clamp(a_w, 0, K - 1)
        dlt = _fitted_step(times)
        nonempty = (m_w > 0).to(W.dtype)[:, None]
        TX = (dlt * WX - 0.5 * dlt * (X[a_w] + X[e_w])) * nonempty
    else:
        # Pairwise products conj(phi0_j) phi0_l, (K, S, J, J).
        A = (phic[:, :, :, None] * phi0[:, :, None, :]).permute(1, 0, 2, 3)
        X = torch.cat([_as_real(R), _as_real(A), S2], dim=1)
        WX = W @ X
        TX = trapz_weights(times, W) @ X
        Gt = _as_complex(WX[:, nR:-1], Bc, S, J, J).permute(1, 0, 2, 3)
        Gtau = _as_complex(TX[:, nR:-1], Bc, S, J, J).permute(1, 0, 2, 3)

    pd = _as_complex(WX[:, :nR], Bc, S, I, J)
    pdt = _as_complex(TX[:, :nR], Bc, S, I, J)
    dnorm = TX[:, -1]                                            # (Bc,)

    # Mixing: M = mu^H mu per set; G = M * Gt elementwise.
    M = torch.einsum("sij,sil->sjl", mus.conj(), mus)[:, None]
    G = M * Gt
    G2 = M * Gtau
    rhs = torch.einsum("sij,bsij->sbj", mus.conj(), pd)
    rt = torch.einsum("sij,bsij->sbj", mus.conj(), pdt)

    keep = col_masks[:, None, :]                                 # (S, 1, J)
    kk = keep[..., :, None] & keep[..., None, :]
    eye = torch.eye(J, dtype=G.dtype, device=G.device)
    G = torch.where(kk, G, eye)
    rhs = torch.where(keep, rhs, torch.zeros((), dtype=rhs.dtype,
                                             device=rhs.device))
    return G, G2, rhs, rt, dnorm


def _mismatch_rephase(C0, G2, rt, dnorm, omegas, t0s, trefs):
    """The epilogue after the solve (engine_real.py:826-842), over any run
    of start times: C0 (S, B, J) fitted in each t0's chunk basis
    referenced to trefs (B,).  Returns C (S, B, J), the amplitudes w.r.t.
    each t0, and the phase-invariant mismatch mm (S, B)."""
    num = (C0.conj() * rt).real.sum(dim=-1)
    GC = torch.einsum("sbjl,sbl->sbj", G2, C0)
    model_norm = (C0.conj() * GC).real.sum(dim=-1)
    mm = 1.0 - num / torch.sqrt(model_norm * dnorm)

    # C = C0 exp(-i w delta), |.| <= 1.
    wr, wi = omegas.real, omegas.imag
    delta = (t0s - trefs)[None, :, None]
    g = torch.exp(wi[:, None, :] * delta)
    rot = torch.complex(g * torch.cos(wr[:, None, :] * delta),
                        -g * torch.sin(wr[:, None, :] * delta))
    return C0 * rot, mm


def _group_systems(times, data, omegas, mus, t0s, Ts, col_masks, chunk,
                   analytic):
    """``_chunk_systems`` on each chunk of ``chunk`` windows of a join
    group (chunks start at 0), each in its own basis, concatenated along
    the window axis: G, G2 (S, B, J, J), rhs, rt (S, B, J), dnorm (B,)."""
    parts = [_chunk_systems(times, data, omegas, mus, t0s[lo:lo + chunk],
                            Ts[lo:lo + chunk], col_masks, analytic)
             for lo in range(0, t0s.shape[0], chunk)]
    return tuple(torch.cat([p[i] for p in parts], dim=1 if i < 4 else 0)
                 for i in range(5))


def _group_mismatch_rephase(C0, G2, rt, dnorm, omegas, t0s, chunk):
    """``_mismatch_rephase`` over a join group, each window's amplitudes
    in the basis of its chunk of ``chunk`` windows (chunks start at 0)."""
    trefs = t0s[torch.arange(t0s.shape[0], device=t0s.device)
                // chunk * chunk]
    return _mismatch_rephase(C0, G2, rt, dnorm, omegas, t0s, trefs)


def sweep_t0_modesets_factored_real(times, data, omegas, mus, t0s, Ts,
                                    col_masks, chunk: int = 64,
                                    analytic: bool = False, solve=None):
    """t0 x mode-set sweep on the factored kernel (engine_real.py:874).

    times (K,), data (I, K), omegas (S, J), mus (S, I, J), t0s/Ts (B,)
    with t0s sorted ascending, col_masks (S, J) bool.  The mode-set axis
    is a leading batch dimension (the JAX vmap).  Each chunk of start
    times builds its systems in its own basis (the JAX lax.map; the
    chunks bound the basis anchor's span, see ``batched._safe_chunk``).
    Consecutive chunks are joined while their G and G2 stay within
    ``JOIN_BYTES`` (``join_groups``), and for each such group ``solve``,
    the batched Hermitian solve (by default ``_regularised_solve``), runs
    once on all its systems, and the mismatch and rephasing once; a
    sweep under the budget makes one solve call.  With ``analytic`` (the
    closed-form Grams: uniform ascending grids) a group's systems and its
    epilogue are ``ops/sweep_cuda.factored_systems`` and
    ``mismatch_rephase``: one launch of each hand-written kernel on CUDA
    tensors, their plain versions on CPU ones.  The summation branch is
    plain PyTorch on every device.  Returns C (S, B, J) complex and
    mm (S, B).
    """
    solve = _regularised_solve if solve is None else solve
    S, J = omegas.shape
    bounds = [(lo, min(lo + chunk, t0s.shape[0]))
              for lo in range(0, t0s.shape[0], chunk)]
    Cs, mms = [], []
    for g0, g1 in join_groups([hi - lo for lo, hi in bounds],
                              2 * S * J * J * 16):
        lo, hi = bounds[g0][0], bounds[g1 - 1][1]
        args = (times, data, omegas, mus, t0s[lo:hi], Ts[lo:hi], col_masks,
                chunk)
        G, G2, rhs, rt, dnorm = (sweep_cuda.factored_systems(*args)
                                 if analytic else
                                 _group_systems(*args, analytic=False))
        B = rhs.shape[1]
        C0 = solve(G.reshape(S * B, J, J), rhs.reshape(S * B, J))
        epilogue = (sweep_cuda.mismatch_rephase if analytic
                    else _group_mismatch_rephase)
        C, mm = epilogue(C0.reshape(S, B, J), G2, rt, dnorm, omegas,
                         t0s[lo:hi], chunk)
        Cs.append(C)
        mms.append(mm)
    return torch.cat(Cs, dim=1), torch.cat(mms, dim=1)


def sweep_t0_factored_real(times, data, omega, mu, t0s, Ts, col_mask=None,
                           chunk: int = 64, analytic: bool = False,
                           solve=None):
    """Factored t0 sweep of one mode set (engine_real.py:846): omega (J,),
    mu (I, J), col_mask (J,) or None.  Returns C (B, J) and mm (B,)."""
    if col_mask is None:
        col_mask = torch.ones(omega.shape, dtype=torch.bool,
                              device=omega.device)
    C, mm = sweep_t0_modesets_factored_real(
        times, data, omega[None], mu[None], t0s, Ts, col_mask[None],
        chunk=chunk, analytic=analytic, solve=solve)
    return C[0], mm[0]


# ---------------------------------------------------------------------------
# The stacked spectrum sweep: many spectra, one window (engine_real.py:405)
# ---------------------------------------------------------------------------

def sweep_spectra_stacked_real(times, data, omegas, mus, t0, chunk: int = 64,
                               solve=None):
    """Fits of Q spectra on one pre-sliced contiguous window of a uniform
    grid (engine_real.py:405): the (Mf, chif) and free-frequency grids.

    The caller slices times (K,) and data (I, K) to the in-window samples
    (every fit quantity is a window sum, so the slice is exact); omegas
    (Q, J), mus (Q, I, J) complex; t0 a float, the amplitudes' anchor (the
    first sample may lie before it, as with 'closest' windows).  The
    window's trapezoid weights and data norm are made once; the Grams of
    every grid point come in closed form from one geometric-series
    evaluation over (Q, J, J); the projections are built ``chunk`` grid
    points at a time, as one (2I, K) @ (K, chunk J) product of the data
    rows (plain and trapezoid-weighted) with the chunk's conjugate phases;
    and the grid points are solved in one call of ``solve`` (by default
    ``_regularised_solve``) per run whose G and G_tau stay within
    ``JOIN_BYTES``.  Returns C (Q, J) complex and mm (Q,).
    """
    from .engine import fit_mismatch
    solve = _regularised_solve if solve is None else solve
    K, (Q, J), I = times.shape[0], omegas.shape, data.shape[0]
    tau = trapz_weights(times, torch.ones_like(times))
    Dstack = torch.cat([data, data * tau]).to(omegas.dtype)       # (2I, K)
    dnorm = (tau * (data.real ** 2 + data.imag ** 2)).sum()
    dt = times - t0
    s = dt[0]
    m = torch.tensor(K, device=times.device)
    dlt = _fitted_step(times)

    Cs, mms = [], []
    bounds = [(lo, min(lo + chunk, Q)) for lo in range(0, Q, chunk)]
    for g0, g1 in join_groups([hi - lo for lo, hi in bounds],
                              2 * J * J * 16):
        lo_g, hi_g = bounds[g0][0], bounds[g1 - 1][1]
        om, mu = omegas[lo_g:hi_g], mus[lo_g:hi_g]
        wr, wi = om.real, om.imag
        Gt, Gtau = _geom_series_eval(dlt, K, wi[:, :, None] + wi[:, None, :],
                                     wr[:, :, None] - wr[:, None, :], s, m)
        proj = []
        for lo, hi in bounds[g0:g1]:
            phi = damped_phase(omegas[None, lo:hi], dt[:, None, None])
            X = Dstack @ phi.reshape(K, -1).conj()           # (2I, c J)
            proj.append(X.reshape(2 * I, hi - lo, J).transpose(0, 1))
        P = torch.cat(proj)                                  # (q, 2I, J)
        M = mu.mH @ mu                                       # (q, J, J)
        rhs = (mu.conj() * P[:, :I]).sum(dim=1)
        rt = (mu.conj() * P[:, I:]).sum(dim=1)
        C = solve(M * Gt, rhs)
        Cs.append(C)
        mms.append(fit_mismatch(C, M * Gtau, rt, dnorm))
    return torch.cat(Cs), torch.cat(mms)


# ---------------------------------------------------------------------------
# The bordered free-frequency sweep (engine_real.py:1200-1501)
# ---------------------------------------------------------------------------
#
# One free complex frequency is appended to Jf fixed QNMs: the fixed
# columns are the same at every trial frequency, so each window's fixed
# Gram block is assembled, dead-masked, equilibrated, floored and
# factored once, and each trial frequency then costs its free column's
# phases, one row of a cross-Gram product and an O(Jf) bordered solve
# through the stored L^-1.  The bordered matrix [[A + floor, g~],
# [g~^H, 1 + floor]] is the one the full solve factors; the two
# deviations of the JAX kernel are kept (the dead threshold uses the
# fixed block's largest diagonal, and the Schur pivot is clamped at the
# floor).  Batched over a leading window axis N.

def _window_scalars(times, w, t0):
    """(s, m) of windows w (..., K) starting at t0 (...): the offset of
    the first in-window sample from t0 (gathered from the grid) and the
    sample count (engine_real.py:569).  Exact for 'geq' and 'closest'
    windows."""
    K = times.shape[0]
    wint = (w > 0.5).to(torch.int64)
    m = wint.sum(dim=-1)
    a = (torch.cumsum(wint, dim=-1) == 0).sum(dim=-1)     # leading zeros
    t_first = times[torch.clamp(a, 0, K - 1)]
    return torch.where(m > 0, t_first - t0, torch.zeros_like(t_first)), m


def _omega_border_prep(times, d, fixed, t0, w):
    """The fixed-block quantities of windows (t0 (N,), w (N, K) binary)
    on data d (K,) complex with fixed frequencies (Jf,) complex
    (engine_real.py:1225).  Returns a dict consumed by
    ``_omega_border_apply`` / ``_omega_border_solve``."""
    Jf = fixed.shape[-1]
    eps = torch.finfo(times.dtype).eps
    tiny = torch.finfo(times.dtype).tiny
    floor = 500.0 * (Jf + 1) * eps
    tau = trapz_weights(times, w)                           # (N, K)
    dt = (times - t0[:, None]) * w                          # clamped rows
    phi = damped_phase(fixed, dt[..., None])                # (N, K, Jf)
    phiw = phi * w[..., None]
    phit = phi * tau[..., None]
    dw = d * w                                              # (N, K)
    dtau = d * tau
    Gw = phiw.mH @ phiw                                     # (N, Jf, Jf)
    Gt = phit.mH @ phi
    rhs = (phiw.mH @ dw[..., None])[..., 0]                 # (N, Jf)
    rt = (phit.mH @ d[:, None].to(phi.dtype))[..., 0]
    data_norm = (tau * (d.real ** 2 + d.imag ** 2)).sum(dim=-1)

    # Dead-mask, equilibrate and floor the fixed block once.
    diag = torch.diagonal(Gw, dim1=-2, dim2=-1).real
    maxdiag = (diag.amax(dim=-1) if Jf
               else torch.zeros(dt.shape[0], dtype=dt.dtype, device=dt.device))
    dead = diag <= maxdiag[:, None] * (1e3 * eps) ** 2
    eye = torch.eye(Jf, dtype=Gw.dtype, device=Gw.device)
    Gw = torch.where(dead[:, :, None] | dead[:, None, :], eye, Gw)
    rhs = torch.where(dead, torch.zeros((), dtype=rhs.dtype,
                                        device=rhs.device), rhs)
    Di = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(Gw, dim1=-2, dim2=-1).real, min=tiny))
    A = Gw * Di[:, :, None] * Di[:, None, :] + floor * eye

    # The bordered solve goes through the triangular factor: its last
    # pivot (1 + floor) - ||L^-1 g~||^2 cancels when the free column nears
    # the fixed span, and the triangular route errs by sqrt(cond(A)) eps
    # where a Hermitian inverse would err by cond(A) eps.
    Linv = complex_lower_inverse(complex_cholesky_factor(A))
    e = (Linv @ (rhs * Di)[..., None])[..., 0]              # L^-1 r~
    y = (Linv.mH @ e[..., None])[..., 0]                    # A^-1 r~
    # Right factor of the cross product: for free-column phases phif
    # (N, Q, K), phif @ Mc gives the cross Grams with the window and
    # trapezoid weights and the conjugated data projections.
    Mc = torch.cat([phiw.conj(), phit.conj(), dw.conj()[..., None],
                    dtau.conj()[..., None]], dim=-1)        # (N, K, 2Jf+2)
    return dict(dt=dt, tau=tau, w=w, Mc=Mc, Di=Di, dead=dead,
                maxdiag=maxdiag, floor=floor, Linv=Linv, e=e, y=y, rt=rt,
                Gt=Gt, data_norm=data_norm)


def _omega_border_apply(prep, phif, Ef2):
    """Bordered solves and mismatches for free-column phases phif
    (N, Q, K) complex with squared magnitudes Ef2 (N, Q, K)
    (engine_real.py:1309).  Returns Cf (N, Q, Jf), c (N, Q), mm (N, Q)."""
    Jf = prep["Di"].shape[-1]
    Z = phif @ prep["Mc"]                                   # (N, Q, 2Jf+2)
    gam = (Ef2 @ prep["w"][..., None])[..., 0]
    gamt = (Ef2 @ prep["tau"][..., None])[..., 0]
    return _omega_border_solve(prep, Z[..., :Jf], Z[..., Jf:2 * Jf],
                               Z[..., 2 * Jf].conj(),
                               Z[..., 2 * Jf + 1].conj(), gam, gamt)


def _omega_border_solve(prep, g, gt, bet, btau, gam, gamt):
    """The bordered block-elimination solve and mismatch from each trial
    frequency's cross pieces (engine_real.py:1344): fixed-free cross
    Grams g / gt (N, Q, Jf) (window and trapezoid weights), the free
    column's data projections bet / btau (N, Q) and its norms gam / gamt
    (N, Q).  Returns Cf (N, Q, Jf), c (N, Q), mm (N, Q)."""
    eps = torch.finfo(gam.dtype).eps
    tiny = torch.finfo(gam.dtype).tiny
    Di, Linv, floor = prep["Di"], prep["Linv"], prep["floor"]
    sf = 1.0 / torch.sqrt(torch.clamp(gam, min=tiny))
    dead_f = gam <= prep["maxdiag"][:, None] * (1e3 * eps) ** 2
    gte = torch.where(prep["dead"][:, None, :],
                      torch.zeros((), dtype=g.dtype, device=g.device),
                      g * (Di[:, None, :] * sf[..., None]))

    # u = L^-1 g~ per trial: ||u||^2 and u^H e stand for g~^H A^-1 g~ and
    # g~^H A^-1 r~ with sqrt(cond(A)) eps error.
    u = gte @ Linv.transpose(-1, -2)
    uu = (u.real ** 2 + u.imag ** 2).sum(dim=-1)
    s = torch.clamp((1.0 + floor) - uu, min=floor)
    ue = (u.conj() * prep["e"][:, None, :]).sum(dim=-1)
    zero = torch.zeros((), dtype=bet.dtype, device=bet.device)
    ct = torch.where(dead_f, zero, (bet * sf - ue) / s)

    # v = L^-H u; C_f = (y - v c~) Di.
    v = u @ Linv.conj()
    Cf = (prep["y"][:, None, :] - v * ct[..., None]) * Di[:, None, :]
    c = ct * sf

    num = ((Cf * prep["rt"][:, None, :].conj()).real.sum(dim=-1)
           + (c * btau.conj()).real)
    GC = Cf @ prep["Gt"].transpose(-1, -2)
    t_ff = (Cf.conj() * GC).real.sum(dim=-1)
    cross = 2.0 * ((Cf.conj() * gt).sum(dim=-1) * c).real
    t_bb = (c.real ** 2 + c.imag ** 2) * gamt
    mm = 1.0 - num / torch.sqrt((t_ff + cross + t_bb)
                                * prep["data_norm"][:, None])
    return Cf, c, mm


def sweep_omega_grid_bordered_real(times, d, fixed, re_axis, im_axis, t0, w,
                                   a_chunk: int = 8, analytic: bool = False):
    """The bordered sweep of one window (t0 scalar tensor, w (K,)) over a
    separable (Re omega) x (Im omega) grid (engine_real.py:1406), in
    chunks of ``a_chunk`` Re values (the JAX lax.map).  Grid order is
    meshgrid(re, im, indexing='ij').ravel(): q = a * B + b.

    The free column factorises, e^{Im_b dt} e^{-i Re_a dt}, so the
    transcendentals are (A + B) K.  analytic=True (uniform time grids
    only) takes the cross Grams and the free column's norms in closed
    form (geometric series) and the data projections as separable
    products, so no (Q, K) free-column phases are built.
    Returns C (A * B, Jf + 1) complex (fixed modes first) and mm (A * B,).
    """
    prep = _omega_border_prep(times, d, fixed, t0.reshape(1), w[None])
    dt, tau = prep["dt"][0], prep["tau"][0]
    K, Jf, Bn = times.shape[0], fixed.shape[-1], im_axis.shape[0]
    Ef = torch.exp(im_axis[:, None] * dt[None, :])          # (B, K)
    if analytic:
        s, m = _window_scalars(times, w, t0)
        dlt = _fitted_step(times)
        gam_b, gamt_b = (x.real for x in _geom_series_eval(
            dlt, K, 2.0 * im_axis, torch.zeros_like(im_axis), s, m))
        # Data projections: rows Ef_b * (w d) and Ef_b * (tau d).
        Yw = (Ef * (d * w)).T.to(d.dtype)                  # (K, B)
        Yt = (Ef * (d * tau)).T.to(d.dtype)
    Cs, cs, mms = [], [], []
    for lo in range(0, re_axis.shape[0], a_chunk):
        ra = re_axis[lo:lo + a_chunk]
        ac = ra.shape[0]
        ph = ra[:, None] * dt[None, :]                      # (ac, K)
        if analytic:
            nu_re = (fixed.imag[None, :] + im_axis[:, None])[None]
            nu_im = fixed.real[None, None, :] - ra[:, None, None]
            g, gt = _geom_series_eval(dlt, K, nu_re, nu_im, s, m)
            eia = torch.complex(torch.cos(ph), torch.sin(ph))
            pieces = (g.reshape(1, ac * Bn, Jf), gt.reshape(1, ac * Bn, Jf),
                      (eia @ Yw).reshape(1, -1), (eia @ Yt).reshape(1, -1),
                      gam_b.expand(ac, Bn).reshape(1, -1),
                      gamt_b.expand(ac, Bn).reshape(1, -1))
            Cf, c, mm = _omega_border_solve(prep, *pieces)
        else:
            phif = torch.complex(torch.cos(ph)[:, None, :] * Ef[None],
                                 -torch.sin(ph)[:, None, :] * Ef[None])
            Ef2 = (Ef * Ef).expand(ac, Bn, K)
            Cf, c, mm = _omega_border_apply(
                prep, phif.reshape(1, ac * Bn, K), Ef2.reshape(1, ac * Bn, K))
        Cs.append(Cf[0])
        cs.append(c[0])
        mms.append(mm[0])
    C = torch.cat([torch.cat(Cs), torch.cat(cs)[:, None]], dim=1)
    return C, torch.cat(mms)
