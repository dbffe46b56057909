"""The l = 2, n = 8/9 overtone multiplets and the extended l = 2 ladder
(port of qnmfits_tpu/spectrum/multiplets.py).

At chi = 0 the l = 2, n = 8 mode sits at the algebraically special
frequency omega = -2i, where Leaver's continued fraction degenerates; for
chi > 0 two branches emerge (Cook & Zalutskiy's {8,0}/{8,1}), which the
reference labels n = 8 and 9, shifting the regular ladder up by one
(reference qnm.py:56-87, 128-132).  Seeds come from a local Newton root
sweep around -2i at chi0 = 0.02 (the branches split like sqrt(chi)); the
tracks are marched up and down the spin grid; below the lowest solved
spin they are filled by a c0 + c1 sqrt(chi) + c2 chi fit.  The extended
regular ladder is seeded in the same sweep and tracked the same way.

The Newton solves run on ``device`` (the CF kernel on the card); the
bookkeeping is host NumPy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .solver import SolveError, _angular_A_C, _c, _newton_coupled

__all__ = ["find_roots_near", "multiplet_tracks", "track_from_seed"]

_SPECIAL = -2.0j  # algebraically special l=2 frequency, M=1 units


def find_roots_near(m: int, center: complex, chi: float, s: int = -2,
                    n_inv: int = 8, spread: float = 0.25, ngrid: int = 7,
                    N: int = 40000, l: int = 2, device="cuda"):
    """Newton from a grid of guesses around ``center``; the distinct
    converged roots, M = 1 units, in the JAX package's order of first
    finding.  The guesses run as one lockstep batch: each element's Newton
    is independent of the others'."""
    dev = torch.device(device)
    A0 = complex(l * (l + 1) - s * (s + 1))
    guesses = [2.0 * (center + dre + 1j * dim)
               for dre in np.linspace(-spread / 2, spread / 2, ngrid)
               for dim in np.linspace(-spread, spread, ngrid)]
    w, _, ok = _newton_coupled(_c(guesses, dev), chi / 2.0,
                               _c([A0] * len(guesses), dev), s, l, m, n_inv,
                               29, N, 1e-11)
    found = []
    for wi, oki in zip(w.cpu().numpy(), ok.cpu().numpy()):
        if oki:
            wm = complex(wi) / 2.0
            if not any(abs(wm - f) < 1e-7 for f in found):
                found.append(wm)
    return found


def track_from_seed(l: int, m: int, seed_chi: float, seed_omega: complex,
                    chi_grid: np.ndarray, s: int = -2, n_inv: int = 8,
                    nl_extra: int = 24, chi_floor: float = 0.008,
                    device="cuda"):
    """Track a root from (seed_chi, seed_omega) over the whole grid.

    Marches up from the grid point nearest seed_chi and down toward zero
    spin with recursive substepping; grid points below ``chi_floor`` are
    filled by a c0 + c1 sqrt(chi) + c2 chi fit through the lowest solved
    points.  Returns (omega (P,), A (P,), C (P, nl)) like
    solver.track_mode.
    """
    dev = torch.device(device)
    chi_grid = np.asarray(chi_grid, dtype=np.float64)
    l0 = max(abs(s), abs(m))
    nl = l - l0 + 1 + nl_extra
    P = len(chi_grid)
    omega = np.full(P, np.nan, complex)
    Aout = np.full(P, np.nan, complex)

    def solve_at(chi, w_guess, A_guess, chi_from, depth=0):
        b = np.sqrt(max(1.0 - chi * chi, 1e-12))
        N = max(8000, int(800.0 / b),
                int(40000 * min(1.0, 0.05 / max(chi, 1e-6))))
        w, A, ok = _newton_coupled(_c(2.0 * w_guess, dev), chi / 2.0,
                                   _c(A_guess, dev), s, l, m, n_inv, nl, N,
                                   1e-11)
        w0 = complex(w[0]) / 2.0
        # Continuity guard: a converged but distant root means Newton
        # jumped tracks; substep instead of recording another mode.
        jumped = abs(w0 - w_guess) > 0.12 * max(0.2, abs(w_guess))
        if bool(ok[0]) and not jumped:
            return w0, complex(A[0])
        if depth >= 7:
            raise SolveError(
                f"multiplet track failed: ({l},{m},n_inv={n_inv}) "
                f"chi={chi:.5f}")
        mid = 0.5 * (chi_from + chi)
        wm, Am = solve_at(mid, w_guess, A_guess, chi_from, depth + 1)
        return solve_at(chi, wm, Am, mid, depth + 1)

    A_seed = complex(l * (l + 1) - s * (s + 1))
    i_start = int(np.searchsorted(chi_grid, seed_chi))

    # Upward march; past chi ~ 0.99 a failure is filled by extrapolation
    # (the reference's optimisers clamp chif at 0.99).
    w_prev, A_prev, chi_prev = seed_omega, A_seed, seed_chi
    i_fail = None
    for i in range(i_start, P):
        try:
            w_prev, A_prev = solve_at(chi_grid[i], w_prev, A_prev, chi_prev)
        except SolveError:
            if chi_grid[i] < 0.99:
                raise
            i_fail = i
            break
        omega[i], Aout[i] = w_prev, A_prev
        chi_prev = chi_grid[i]
    if i_fail is not None:
        fit = np.arange(max(i_start, i_fail - 6), i_fail)
        for arr in (omega, Aout):
            cr = np.polyfit(chi_grid[fit], arr[fit].real, 2)
            ci = np.polyfit(chi_grid[fit], arr[fit].imag, 2)
            arr[i_fail:] = (np.polyval(cr, chi_grid[i_fail:])
                            + 1j * np.polyval(ci, chi_grid[i_fail:]))

    # Downward march to chi_floor.
    w_prev, A_prev, chi_prev = seed_omega, A_seed, seed_chi
    for i in range(i_start - 1, -1, -1):
        if chi_grid[i] < chi_floor:
            break
        try:
            w_prev, A_prev = solve_at(chi_grid[i], w_prev, A_prev, chi_prev)
        except SolveError:
            break
        omega[i], Aout[i] = w_prev, A_prev
        chi_prev = chi_grid[i]

    # sqrt(chi) fill below the lowest solved point.
    solved = np.where(~np.isnan(omega))[0]
    fit_pts = solved[:6]
    X = np.stack([np.ones(len(fit_pts)), np.sqrt(chi_grid[fit_pts]),
                  chi_grid[fit_pts]], axis=1)
    for arr in (omega, Aout):
        coef, *_ = np.linalg.lstsq(X, arr[fit_pts], rcond=None)
        fill = np.where(np.isnan(arr))[0]
        Xf = np.stack([np.ones(len(fill)), np.sqrt(chi_grid[fill]),
                       chi_grid[fill]], axis=1)
        arr[fill] = Xf @ coef

    # Mixing vectors from the angular problem on the completed track.
    _, C = _angular_A_C(s, l, m, _c((chi_grid / 2.0) * (2.0 * omega), dev),
                        nl, _c(Aout, dev))
    return omega, Aout, C.cpu().numpy()


def multiplet_tracks(m: int, chi_grid: np.ndarray, s: int = -2,
                     chi0: float = 0.02, verbose: bool = True,
                     device="cuda"):
    """All l = 2 tracks above the regular n <= 7 ladder, reference
    labelling (multiplets.py:166 of the JAX package): m > 0 two branches
    near -2i (n = 8, 9 by |Im|) then the ladder from n = 10; m = 0 the
    branch with Re > 0 as n = 8, its mirror image n = 9, the ladder from
    n = 10; m < 0 one near-special branch n = 8, the ladder from n = 9.
    Returns {n_label: (omega (P,), A (P,), C (P, nl))}.
    """
    near = find_roots_near(m, _SPECIAL, chi0, s=s, n_inv=8, spread=0.3,
                           ngrid=5, device=device)
    # At chi0 = 0.02 the multiplet pair sits within ~0.1 of -2i, well
    # apart from the regular n = 7 and package n = 9 roots (~0.3).
    near_pos = sorted([r for r in near
                       if abs(r - _SPECIAL) < 0.2 and r.real > 0],
                      key=lambda r: -r.imag)

    # Walk the package ladder downward: overtones past the special point
    # are ~0.25i apart; search around each predicted position.
    ladder = []
    center = 0.065 - 2.31j
    for step in range(11):           # down to ~ -4.9i (reference n <= 20)
        n_inv = 9 + step
        found = find_roots_near(m, center, chi0, s=s, n_inv=n_inv,
                                spread=0.13, ngrid=3, device=device)
        cand = [r for r in found if r.real > 0
                and abs(r - center) < 0.2
                and all(abs(r - p) > 0.05 for p in ladder)]
        if not cand:
            break
        root = min(cand, key=lambda r: abs(r - center))
        ladder.append(root)
        center = root + (root - (ladder[-2] if len(ladder) > 1
                                 else root + 0.25j))

    out = {}

    def _trk(n_label, seed, n_inv, required=True):
        if verbose:
            print(f"  l=2 m={m} n={n_label}: seed {seed:.6f}", flush=True)
        try:
            out[n_label] = track_from_seed(2, m, chi0, seed, chi_grid, s=s,
                                           n_inv=n_inv, device=device)
        except SolveError as e:
            if required:
                raise
            # Deep m ~ 0 overtones plunge into the negative imaginary axis
            # at finite spin (Cook & Zalutskiy): no ordinary QNM there.
            if verbose:
                print(f"    skipped (track dies mid-range: {e})", flush=True)

    if m > 0:
        if len(near_pos) < 2:
            raise SolveError(
                f"expected 2 multiplet roots for m={m}, got {near_pos}")
        _trk(8, near_pos[0], 8)
        _trk(9, near_pos[1], 8)
        for k, r in enumerate(ladder):
            _trk(10 + k, r, 9 + k, required=False)
    elif m == 0:
        if not near_pos:
            raise SolveError("no m=0 multiplet root found")
        _trk(8, near_pos[0], 8)
        # n = 9 is the exact mirror image of n = 8 (Cook's i = 1 branch).
        w8, A8, C8 = out[8]
        l0 = max(abs(s), abs(m))
        lp = np.arange(C8.shape[1]) + l0
        flip = (-1.0) ** (2 + lp)
        out[9] = (-np.conj(w8), np.conj(A8), flip[None, :] * np.conj(C8))
        for k, r in enumerate(ladder):
            _trk(10 + k, r, 9 + k, required=False)
    else:
        if not near_pos:
            raise SolveError(f"no near-special root for m={m}")
        _trk(8, near_pos[0], 8)
        for k, r in enumerate(ladder):
            _trk(9 + k, r, 9 + k, required=False)
    return out
