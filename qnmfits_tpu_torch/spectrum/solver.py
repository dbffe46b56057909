"""Kerr QNM mode tracking over a spin grid, on complex128 tensors (port of
qnmfits_tpu/spectrum/solver.py).

Produces, for one mode (l, m, n), omega(chi), A(chi) and the
spherical-spheroidal mixing vector C(chi) on a spin grid: the rows the
tables solve on demand (``tables.SpectrumTables._row_for``) and
``build_tables.py`` bakes into whole tables.

Per track, in two passes:
  1. coarse: sequential continuation in chi on a subgrid, a Newton a point
     (shallow CF), guesses extrapolated from the points before;
  2. fine: the coarse track interpolated onto the whole grid, then Newton
     in lockstep over every grid point at once, in tiers of CF depth that
     grow toward extremal spin; the angular problem is one batched eig.

The angular eigenproblems go through ``ops/eig_cuda``: the CUDA kernel
``csrc/angular_eig.cu`` for tensors on the card (one launch for a Newton
step's 2B matrices, one for each vectors-mode call), torch.linalg.eig for
tensors on the CPU.

Each Newton iteration evaluates the CF at omega and omega + h in one call
of ``ops/cf_cuda.leaver_cf``: the CUDA kernel ``csrc/leaver_cf.cu`` for
tensors on the card, its plain versions for tensors on the CPU.  The CF is
FP64 up to chi = ``cf_cuda.CHI_EXTENDED`` (0.985) and double-double beyond,
where an FP64 CF's rounding noise over |f'| would keep the step above the
soft bar (1e-9 |omega|) and leave points on the coarse track; the JAX
package evaluates every CF in 80-bit long double.  The lockstep Newton
shrinks its active set each iteration, which costs one host sync an
iteration (and the CF's spin rule one more on the card).

m < 0 modes are the retrograde branch with Re(omega) > 0 (the `qnm`
package's labelling), solved directly with m < 0 from the same
Schwarzschild seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cf_cuda import leaver_cf
from ..ops.eig_cuda import angular_eigpair, angular_eigvals, select_nearest
from .angular import lmin

__all__ = ["SolveError", "default_chi_grid", "schwarzschild_seeds",
           "track_mode"]

CDTYPE = torch.complex128


class SolveError(RuntimeError):
    """The solver found no root where it needs one: a Schwarzschild seed, a
    coarse point, a fine point below chi = 0.985 or a multiplet track."""


def default_chi_grid(n_points: int = 400,
                     chi_max: float = 0.9995) -> np.ndarray:
    """Spin grid on [0, chi_max], clustered toward extremal spin."""
    u = np.linspace(0.0, 1.0, n_points)
    x = 0.5 * u + 0.5 * (1.0 - (1.0 - u) ** 2)
    return chi_max * x


def _c(x, device):
    """Complex numbers (a scalar or an array) as a (B,) complex128 tensor."""
    return torch.as_tensor(np.atleast_1d(np.asarray(x, complex)),
                           device=device)


def _angular_A_C(s, l, m, c, nl, A_guess, vectors=True):
    """Per element, the eigenvalue of the angular matrix at c nearest
    A_guess and (``vectors``) its mixing vector, entry l - lmin real and
    positive, unit norm; C is None without ``vectors``."""
    if vectors:
        return angular_eigpair(s, l, m, c, nl, A_guess)
    return select_nearest(angular_eigvals(s, m, c, nl), A_guess), None


def _angular_pair(s, l, m, c0, c1, nl, A_guess):
    """Newton's two angular solves in one batched eig: A0 nearest A_guess
    at c0, then A1 nearest A0 at c1."""
    B = c0.shape[0]
    A_all = angular_eigvals(s, m, torch.cat([c0, c1]), nl)
    A0 = select_nearest(A_all[:B], A_guess)
    return A0, select_nearest(A_all[B:], A0)


def _newton_step(omega, f, h, active=None):
    """The capped Newton step from residuals f = (f(omega), f(omega + h))
    stacked; steps are zero where ``active`` is False."""
    B = omega.shape[0]
    f0, f1 = f[:B], f[B:]
    df = (f1 - f0) / h
    ok = df != 0
    if active is not None:
        ok = ok & active
    step = torch.where(ok, f0 / torch.where(df == 0, 1.0, df), 0.0)
    mag = step.abs()
    cap = 0.05 * torch.clamp(omega.abs(), min=0.2)
    return torch.where(mag > cap, step * cap / torch.where(mag == 0, 1.0, mag),
                       step)


def _twice(a):
    return torch.cat([a, a]) if torch.is_tensor(a) else a


def schwarzschild_seeds(l_max: int = 8, n_max: int = 7, s: int = -2,
                        N: int = 6000, tol: float = 1e-13,
                        n_max_low_l: int | None = None,
                        device="cuda") -> dict:
    """Schwarzschild (chi = 0) QNM frequencies {(l, n): omega}, M = 1 units.

    Continuation in n from the n = 0 mode of each l; the n = 0 seeds for
    l >= 5 are extrapolated from lower l.  n_max_low_l caps the ladders of
    l < l_max (0 when seeding one high-l mode, so the l = 2 ladder never
    walks into the algebraically special point at n = 8).
    """
    # Published n = 0 anchors per spin weight (M = 1 units); Newton
    # polishes them to full precision.
    anchors_by_s = {
        -2: {2: 0.3736716844 - 0.0889623157j,
             3: 0.5994432884 - 0.0927030477j,
             4: 0.8091783775 - 0.0941640768j},
        0: {0: 0.110455 - 0.104896j,
            1: 0.292936 - 0.097660j,
            2: 0.483644 - 0.096759j},
        -1: {1: 0.248263 - 0.092488j,
             2: 0.457596 - 0.095004j,
             3: 0.656899 - 0.095616j},
    }
    dev = torch.device(device)
    anchors = anchors_by_s.get(s, {})
    l_start = abs(s) if s in (0, -1) else 2
    out = {}
    for l in range(l_start, l_max + 1):
        if l in anchors:
            w_guess = anchors[l]
        elif (l - 1, 0) in out and (l - 2, 0) in out and (l - 3, 0) in out:
            # Quadratic extrapolation in l of the last three n = 0 roots.
            ws = [out[(lp, 0)] for lp in (l - 3, l - 2, l - 1)]
            w_guess = 3.0 * ws[2] - 3.0 * ws[1] + ws[0]
        else:
            # Eikonal estimate (a few percent): enough for Newton.
            w_guess = ((l + 0.5) - 0.5j) / (3.0 * np.sqrt(3.0))
        A = float(l * (l + 1) - s * (s + 1))
        prev = None
        n_top = n_max if (l == l_max or n_max_low_l is None) else n_max_low_l
        for n in range(0, n_top + 1):
            if n > 0:
                w_guess = out[(l, n - 1)] + (out[(l, n - 1)] - prev
                                             if n >= 2 else -0.19j)
            w, conv = _newton_fixed_A(_c(2.0 * w_guess, dev), 0.0, A, s, l,
                                      n, N, tol)
            if not bool(conv[0]):
                raise SolveError(f"Schwarzschild seed failed for l={l} n={n}")
            prev = out.get((l, n - 1))
            out[(l, n)] = complex(w[0]) / 2.0
    return out


def _newton_fixed_A(omega_L, a, A, s, m, n_inv, N, tol, maxiter=60):
    """Newton on the radial CF with A held fixed (Schwarzschild: A does
    not depend on omega)."""
    omega = omega_L.clone()
    active = torch.ones(omega.shape, dtype=torch.bool, device=omega.device)
    h = 1e-8
    A2 = _twice(torch.broadcast_to(torch.as_tensor(
        A, dtype=CDTYPE, device=omega.device), omega.shape))
    for _ in range(maxiter):
        f = leaver_cf(torch.cat([omega, omega + h]), _twice(a), A2, s, m,
                      n_inv, N)
        step = _newton_step(omega, f, h, active)
        omega = omega - step
        active &= step.abs() >= tol * torch.clamp(omega.abs(), min=1.0)
        if not bool(active.any()):
            break
    return omega, ~active


def _newton_coupled(omega_L, aL, A_guess, s, l, m, n_inv, nl, N, tol,
                    maxiter=60):
    """Coupled Newton at a scalar spin aL: A(omega) and the CF root."""
    omega = omega_L.clone()
    A = A_guess.clone()
    active = torch.ones(omega.shape, dtype=torch.bool, device=omega.device)
    h = 1e-8
    for _ in range(maxiter):
        A, A_h = _angular_pair(s, l, m, aL * omega, aL * (omega + h), nl, A)
        f = leaver_cf(torch.cat([omega, omega + h]), aL,
                      torch.cat([A, A_h]), s, m, n_inv, N)
        step = _newton_step(omega, f, h, active)
        omega = omega - step
        last_step = step.abs()
        active &= last_step >= tol * torch.clamp(omega.abs(), min=1.0)
        if not bool(active.any()):
            break
    active &= last_step >= 1e-9 * torch.clamp(omega.abs(), min=1.0)
    A, _ = _angular_A_C(s, l, m, aL * omega, nl, A, vectors=False)
    return omega, A, ~active


def _newton_coupled_vec_a(omega_L, aL_vec, A_guess, s, l, m, n_inv, nl, N,
                          tol, maxiter=60):
    """Lockstep coupled Newton over a spin grid (aL_vec a (B,) tensor):
    only still-unconverged points are evaluated each iteration."""
    omega = omega_L.clone()
    A = A_guess.clone()
    active = torch.ones(omega.shape, dtype=torch.bool, device=omega.device)
    last_step = torch.full(omega.shape, float("inf"), dtype=torch.float64,
                           device=omega.device)
    h = 1e-8
    for _ in range(maxiter):
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        om_a, a_a = omega[idx], aL_vec[idx]
        A_a, A_h = _angular_pair(s, l, m, a_a * om_a, a_a * (om_a + h), nl,
                                 A[idx])
        f = leaver_cf(torch.cat([om_a, om_a + h]), _twice(a_a),
                      torch.cat([A_a, A_h]), s, m, n_inv, N)
        step = _newton_step(om_a, f, h)
        omega[idx] = om_a - step
        A[idx] = A_a
        done = step.abs() < tol * torch.clamp(om_a.abs(), min=1.0)
        active[idx] = ~done
        last_step[idx] = step.abs()
    # Near-extremal spin the CF noise floor exceeds tol; accept soft
    # convergence (~1e-9 step -> omega accurate to ~1e-10).
    soft = active & (last_step < 1e-9 * torch.clamp(omega.abs(), min=1.0))
    active &= ~soft
    A, C = _angular_A_C(s, l, m, aL_vec * omega, nl, A)
    return omega, A, C, ~active


def track_mode(l: int, m: int, n: int, omega0: complex,
               chi_grid: np.ndarray, s: int = -2,
               nl_extra: int = 24,
               coarse_stride: int = 8,
               N_coarse: int = 2000, N_fine: int = 6000,
               tol: float = 1e-12, device="cuda"):
    """Track one QNM from chi = 0 across the spin grid on ``device``.

    omega0: the Schwarzschild frequency (M = 1 units) of (l, n);
    chi_grid: ascending spins (chi_grid[0] may be 0).  Returns NumPy
    omega (P,) complex (M = 1 units), A (P,) and C (P, nl), the mixing
    vectors over l' = lmin .. lmin + nl - 1.
    """
    dev = torch.device(device)
    chi_grid = np.asarray(chi_grid, dtype=np.float64)
    l0 = lmin(s, m)
    nl = l - l0 + 1 + nl_extra
    P = len(chi_grid)

    # ---- coarse pass: sequential continuation --------------------------
    coarse_idx = list(range(0, P, coarse_stride))
    if coarse_idx[-1] != P - 1:
        coarse_idx.append(P - 1)
    w_coarse = np.empty(len(coarse_idx), complex)
    A_coarse = np.empty(len(coarse_idx), complex)

    def _solve_point(chi, w_guess, A_guess, chi_from, depth=0):
        """Newton at one spin, recursively substepping in chi from the last
        good point on failure (robust near extremal spin)."""
        aL = chi / 2.0
        b = np.sqrt(max(1.0 - chi * chi, 1e-12))
        N_c = max(N_coarse, int(400.0 / b))
        w, A, ok = _newton_coupled(_c(2.0 * w_guess, dev), aL,
                                   _c(A_guess, dev), s, l, m, n, nl, N_c,
                                   tol * 10)
        if bool(ok[0]):
            return complex(w[0]) / 2.0, complex(A[0])
        if depth >= 6:
            raise SolveError(
                f"coarse track failed: mode ({l},{m},{n}) chi={chi:.4f}")
        chi_mid = 0.5 * (chi_from + chi)
        w_mid, A_mid = _solve_point(chi_mid, w_guess, A_guess, chi_from,
                                    depth + 1)
        return _solve_point(chi, w_mid, A_mid, chi_mid, depth + 1)

    w_prev = omega0
    A_prev = complex(l * (l + 1) - s * (s + 1))
    chi_prev = 0.0
    coarse_fail = None
    for j, gi in enumerate(coarse_idx):
        chi = chi_grid[gi]
        # Predictor: linear extrapolation from the previous two points.
        if j >= 2:
            dchi = (chi_grid[coarse_idx[j]] - chi_grid[coarse_idx[j - 1]])
            dchi_p = (chi_grid[coarse_idx[j - 1]]
                      - chi_grid[coarse_idx[j - 2]])
            w_guess = w_coarse[j - 1] + (w_coarse[j - 1] - w_coarse[j - 2]) \
                * (dchi / max(dchi_p, 1e-30))
            A_guess = A_coarse[j - 1]
        else:
            w_guess, A_guess = w_prev, A_prev
        try:
            w_coarse[j], A_coarse[j] = _solve_point(chi, w_guess, A_guess,
                                                    chi_prev)
        except SolveError:
            # Deep-overtone tracks can defeat the CF very close to extremal
            # spin; the rest is filled by extrapolation.
            if chi < 0.985 or j < 4:
                raise
            coarse_fail = j
            break
        w_prev, A_prev = w_coarse[j], A_coarse[j]
        chi_prev = chi

    chi_reliable = np.inf
    if coarse_fail is not None:
        cidx = np.asarray(coarse_idx)
        fit = np.arange(max(0, coarse_fail - 6), coarse_fail)
        xs = chi_grid[cidx[fit]]
        for arr in (w_coarse, A_coarse):
            cr = np.polyfit(xs, arr[fit].real, 2)
            ci = np.polyfit(xs, arr[fit].imag, 2)
            xf = chi_grid[cidx[coarse_fail:]]
            arr[coarse_fail:] = (np.polyval(cr, xf)
                                 + 1j * np.polyval(ci, xf))
        chi_reliable = chi_grid[cidx[coarse_fail - 1]]

    # ---- fine pass: lockstep Newton across the whole grid ---------------
    w_fine = np.interp(chi_grid, chi_grid[coarse_idx], w_coarse.real) \
        + 1j * np.interp(chi_grid, chi_grid[coarse_idx], w_coarse.imag)
    A_fine = np.interp(chi_grid, chi_grid[coarse_idx], A_coarse.real) \
        + 1j * np.interp(chi_grid, chi_grid[coarse_idx], A_coarse.imag)

    omega = np.empty(P, complex)
    Aout = np.empty(P, complex)
    Cout = np.empty((P, nl), complex)

    # The tail error damps like exp(-2 |Re u| sqrt(N)), u ~ sqrt(b omega),
    # b = sqrt(1 - chi^2): N ~ 1/b for a fixed accuracy, in depth tiers.
    b_grid = np.sqrt(np.maximum(1.0 - chi_grid**2, 1e-12))
    N_req = np.maximum(N_fine, (800.0 / b_grid).astype(int))
    # Points past the last reliably solved coarse spin keep the
    # extrapolated track; their mixing vectors still come from the exact
    # angular problem at that omega.
    extrap = chi_grid > chi_reliable

    tier_of = np.array([int(2 ** np.ceil(np.log2(nr))) for nr in N_req])
    for Nt in sorted(set(tier_of.tolist())):
        sel = np.where((tier_of == Nt) & ~extrap)[0]
        if sel.size == 0:
            continue
        a_sel = torch.as_tensor(chi_grid[sel] / 2.0, device=dev)
        w0 = _c(2.0 * w_fine[sel], dev)
        A0 = _c(A_fine[sel], dev)
        w, A, C, ok = _newton_coupled_vec_a(w0, a_sel, A0, s, l, m, n, nl,
                                            Nt, tol)
        # Retry unconverged points with progressively deeper CF.
        for retry in range(3):
            if bool(ok.all()):
                break
            bad = torch.nonzero(~ok).flatten()
            w_b, A_b, C_b, ok_b = _newton_coupled_vec_a(
                w[bad], a_sel[bad], A[bad], s, l, m, n, nl,
                Nt * 3 ** (retry + 1), tol)
            w[bad], A[bad], C[bad] = w_b, A_b, C_b
            ok[bad] = ok_b
        if not bool(ok.all()):
            # Near-extremal stragglers keep the interpolated coarse track;
            # anything below 0.985 is a hard error.
            badchi = chi_grid[sel][~ok.cpu().numpy()]
            if np.min(badchi) < 0.985:
                raise SolveError(
                    f"fine polish failed: mode ({l},{m},{n}) "
                    f"at chi={badchi[:5]}")
            bad = torch.nonzero(~ok).flatten()
            w[bad] = w0[bad]
            A[bad] = A0[bad]
            _, C[bad] = _angular_A_C(s, l, m, a_sel[bad] * w[bad], nl,
                                     A[bad])
        omega[sel] = (w / 2.0).cpu().numpy()
        Aout[sel] = A.cpu().numpy()
        Cout[sel] = C.cpu().numpy()

    if extrap.any():
        ext = np.where(extrap)[0]
        omega[ext] = w_fine[ext]
        Aout[ext] = A_fine[ext]
        _, C_ext = _angular_A_C(
            s, l, m, _c((chi_grid[ext] / 2.0) * (2.0 * w_fine[ext]), dev), nl,
            _c(A_fine[ext], dev))
        Cout[ext] = C_ext.cpu().numpy()
    return omega, Aout, Cout
