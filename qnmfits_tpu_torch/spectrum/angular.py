"""Spin-weighted spheroidal harmonics via the spherical spectral method.

The angular Teukolsky equation for a spin-weighted spheroidal harmonic
S_{s,l,m}(x; c), x = cos(theta), with oblateness parameter c = a*omega:

    d/dx[(1-x^2) dS/dx]
      + [ (c x)^2 - 2 c s x + s + A - (m + s x)^2 / (1 - x^2) ] S = 0

is solved by expanding S in spin-weighted *spherical* harmonics sYlm.
In that basis the operator is pentadiagonal, and the separation constants
A_{slm}(c) plus the spherical-spheroidal mixing coefficients (the
eigenvector components) come from a single dense eigendecomposition.

This is the same method used by the Cook & Zalutskiy (2014) data and by the
`qnm` package the reference builds on (the reference's qnmfits/qnm.py:
124-160 consumes `modes_cache(...).C` produced this way).  Port of
qnmfits_tpu/spectrum/angular.py, host-side NumPy as there; the spatial
mapping reads its matrices (spatial_engine.spheroidal_coeffs_batched) and
its eigensystems (spatial.spheroidal_harmonic).

Conventions
-----------
* Normalisation: A(c=0) = l(l+1) - s(s+1).
* Mixing coefficients C_{l'} are the components of the unit-norm
  eigenvector, ordered from l' = lmin = max(|s|, |m|), with the phase fixed
  so that the diagonal component C_{l'=l} is real and positive
  (Cook & Zalutskiy convention, matching the `qnm` package).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "lmin",
    "cos_theta_coeffs",
    "spectral_parts",
    "angular_matrix",
    "separation_constants",
    "mode_eigensystem",
]


def lmin(s: int, m: int) -> int:
    """Smallest angular number in the sYlm basis: max(|s|, |m|)."""
    return max(abs(s), abs(m))


def _F(s: int, l: int, m: int) -> float:
    """<s,l+1,m| cos(theta) |s,l,m> ladder coefficient."""
    num = ((l + 1.0) ** 2 - m**2) * ((l + 1.0) ** 2 - s**2)
    den = (2.0 * l + 1.0) * (2.0 * l + 3.0) * (l + 1.0) ** 2
    return np.sqrt(max(num, 0.0) / den)


def _G(s: int, l: int, m: int) -> float:
    """<s,l-1,m| cos(theta) |s,l,m> ladder coefficient (= F at l-1)."""
    if l == 0:
        return 0.0
    num = (l**2 - m**2) * (l**2 - s**2)
    den = (4.0 * l**2 - 1.0) * l**2
    return np.sqrt(max(num, 0.0) / den)


def _H(s: int, l: int, m: int) -> float:
    """<s,l,m| cos(theta) |s,l,m> diagonal coefficient."""
    if l == 0 or s == 0:
        return 0.0
    return -float(m * s) / (l * (l + 1.0))


def cos_theta_coeffs(s: int, m: int, nl: int):
    """F, G, H arrays for l = lmin .. lmin + nl - 1."""
    l0 = lmin(s, m)
    ls = np.arange(l0, l0 + nl)
    F = np.array([_F(s, l, m) for l in ls])
    G = np.array([_G(s, l, m) for l in ls])
    H = np.array([_H(s, l, m) for l in ls])
    return ls, F, G, H


def spectral_parts(s: int, m: int, nl: int):
    """The c-independent parts of the spectral matrix: lam0 = l(l+1) -
    s(s+1) (nl,) and X (nl, nl), the tridiagonal matrix of cos(theta) in
    the sYlm basis from lmin."""
    ls, F, G, H = cos_theta_coeffs(s, m, nl)
    X = np.zeros((nl, nl))
    idx = np.arange(nl)
    X[idx, idx] = H
    X[idx[:-1] + 1, idx[:-1]] = F[:-1]  # <l+1| x |l>
    X[idx[1:] - 1, idx[1:]] = G[1:]     # <l-1| x |l>
    return ls * (ls + 1.0) - s * (s + 1.0), X


def angular_matrix(s: int, m: int, c: complex, nl: int) -> np.ndarray:
    """Spectral matrix M with eigenvalues A_{slm}(c).

    M = diag(l(l+1) - s(s+1)) - c^2 X^2 + 2 c s X, where X is the
    (tridiagonal) matrix of cos(theta) in the sYlm basis truncated to
    nl basis functions starting at lmin.
    """
    lam0, X = spectral_parts(s, m, nl)
    M = np.diag(lam0).astype(complex)
    M += 2.0 * c * s * X
    M -= (c * c) * (X @ X)
    return M


def separation_constants(s: int, m: int, c: complex, nl: int):
    """All eigenvalues/eigenvectors of the angular problem at oblateness c.

    Returns (A, C) with A sorted by ascending real part; C[:, k] is the
    unit-norm eigenvector for A[k] with C[k, k]-positive phase convention
    applied afterwards by the caller (phase is track-dependent).
    """
    M = angular_matrix(s, m, c, nl)
    A, C = np.linalg.eig(M)
    order = np.argsort(A.real)
    return A[order], C[:, order]


def mode_eigensystem(s: int, l: int, m: int, c: complex, nl: int | None = None,
                     A_guess: complex | None = None):
    """Separation constant and mixing vector for one (s, l, m) mode.

    If ``A_guess`` is given the eigenvalue closest to it is selected
    (continuation); otherwise the eigenvalues are sorted by real part and
    the (l - lmin)-th is taken, which is exact at c = 0 and correct for
    small |c|.

    Returns (A, C) where C has unit norm and the diagonal component
    C[l - lmin] is rotated to be real positive.
    """
    l0 = lmin(s, m)
    if nl is None:
        nl = l - l0 + 1 + 24
    A_all, C_all = separation_constants(s, m, c, nl)
    if A_guess is None:
        k = l - l0
    else:
        k = int(np.argmin(np.abs(A_all - A_guess)))
    A = A_all[k]
    C = C_all[:, k]
    # Phase convention: diagonal component real positive.
    diag = C[l - l0]
    if diag != 0:
        C = C * (np.abs(diag) / diag)
    nrm = np.sqrt(np.sum(np.abs(C) ** 2))
    return A, C / nrm
