"""Complex least-squares solvers for ringdown design matrices (port of
qnmfits_tpu/ops/solve.py).

* ``gram_cholesky`` -- normal equations with dead-column masking,
  square-root-diagonal equilibration and the 500 J eps floor.  The JAX
  function and ``engine_real._regularised_solve`` compute the same
  regularised system (same dead threshold (1e3 eps)^2, identity rows,
  equilibration and floor; no caller passes a jitter), so here they are
  one function: the hand-written CUDA kernel on the card, its plain
  PyTorch version on the CPU.
* ``svd_lstsq`` -- minimum-norm least squares by SVD with
  ``jnp.linalg.lstsq``'s rcond=None semantics, the parity path of the
  single fits.  ``torch.linalg.lstsq`` is not used: on CUDA it offers only
  the full-rank ``gels`` driver and returns neither rank nor singular
  values.
"""

from __future__ import annotations

import torch

__all__ = ["gram_cholesky", "svd_lstsq"]


def gram_cholesky(G, rhs, solve=None):
    """Solve G C = rhs for Hermitian positive (semi)definite G, regularised
    as in ``engine_real._regularised_solve``.  G (..., J, J), rhs (..., J)
    complex128; the leading axes are one batch.  ``solve`` substitutes the
    batched (B, J, J), (B, J) solve (the plain version, in checks)."""
    from ..engine_real import _regularised_solve
    solve = _regularised_solve if solve is None else solve
    J = G.shape[-1]
    lead = rhs.shape[:-1]
    x = solve(G.reshape(-1, J, J).contiguous(), rhs.reshape(-1, J).contiguous())
    return x.reshape(*lead, J)


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
