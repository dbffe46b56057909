"""Complex least-squares solvers for ringdown design matrices (port of
qnmfits_tpu/ops/solve.py).

* ``gram_cholesky`` -- normal equations with dead-column masking,
  square-root-diagonal equilibration and the 500 J eps floor.  The JAX
  function and ``engine_real._regularised_solve`` compute the same
  regularised system (same dead threshold (1e3 eps)^2, identity rows,
  equilibration and floor), so here they are one function: the
  hand-written CUDA kernel on the card, its plain PyTorch version on the
  CPU.  A ``jitter_scale`` (the JAX function's floor in place of 500 J
  eps) goes through the same kernel, by a scaling of G's diagonal that
  the kernel's own equilibration turns into that floor.
* ``qr_solve`` -- least squares by reduced QR of the tall design matrix
  (kappa(A), not squared): ``torch.linalg.qr`` and a triangular solve, as
  the JAX function is ``jnp.linalg.qr`` outside any Pallas kernel.
* ``svd_lstsq`` -- minimum-norm least squares by SVD with
  ``jnp.linalg.lstsq``'s rcond=None semantics, the parity path of the
  single fits.  ``torch.linalg.lstsq`` is not used: on CUDA it offers only
  the full-rank ``gels`` driver and returns neither rank nor singular
  values.
"""

from __future__ import annotations

import torch

__all__ = ["gram_cholesky", "qr_solve", "svd_lstsq"]


def gram_cholesky(G, rhs, solve=None, jitter_scale: float = 0.0):
    """Solve G C = rhs for Hermitian positive (semi)definite G, regularised
    as in ``engine_real._regularised_solve``.  G (..., J, J), rhs (..., J)
    complex128; the leading axes are one batch.  ``solve`` substitutes the
    batched (B, J, J), (B, J) solve (the plain version, in checks).

    ``jitter_scale`` (0: the solve's own floor f0 = 500 J eps) is the floor
    added to the equilibrated system, as in the JAX function: G's diagonal
    is scaled by 1 + delta, delta = (jitter_scale - f0) / (1 + f0), which
    the solve's equilibration and floor turn into D^-1 G D^-1 +
    jitter_scale I, with the same solution (its dead-column test is
    relative to the largest diagonal, so it does not change)."""
    from ..engine_real import _regularised_solve
    solve = _regularised_solve if solve is None else solve
    J = G.shape[-1]
    if jitter_scale:
        f0 = 500.0 * J * torch.finfo(G.real.dtype).eps
        delta = (jitter_scale - f0) / (1.0 + f0)
        diag = torch.diagonal(G, dim1=-2, dim2=-1).real
        G = G + torch.diag_embed(delta * diag).to(G.dtype)
    lead = rhs.shape[:-1]
    x = solve(G.reshape(-1, J, J).contiguous(), rhs.reshape(-1, J).contiguous())
    return x.reshape(*lead, J)


def qr_solve(a, d):
    """Least squares a C = d by reduced QR (ops/solve.py:99 of the JAX
    package): a (..., K, J), d (..., K) -> C (..., J)."""
    Q, R = torch.linalg.qr(a, mode="reduced")
    rhs = (Q.conj() * d[..., :, None]).sum(dim=-2)
    return torch.linalg.solve_triangular(R, rhs[..., None], upper=True)[..., 0]


def svd_lstsq(a, d):
    """Least squares a C = d by SVD, as ``jnp.linalg.lstsq(a, d,
    rcond=None)``: singular values below eps * max(M, N) * s[0] (and zero
    ones) are cut.  a (M, N), d (M,).  Returns C (N,), the squared
    residual norm (1,) (always computed, as the JAX function does), the
    rank (a 0-d integer tensor) and the singular values s (min(M, N),)."""
    M, N = a.shape
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * max(M, N)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    one = torch.ones((), dtype=s.dtype, device=s.device)
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, one),
                        torch.zeros_like(s)).to(a.dtype)
    C = vh.conj().T @ (s_inv * (u.conj().T @ d))
    resid = torch.linalg.vector_norm(d - a @ C)[None] ** 2
    return C, resid, rank, s
