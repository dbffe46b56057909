"""Batched small-matrix complex Cholesky solve, factor and triangular
inverse, column-unrolled (port of qnmfits_tpu/ops/chol.py).

``complex_cholesky_solve_unrolled`` is the plain PyTorch version of the
CUDA kernel in ``ops/chol_cuda.py``: the CPU path runs it, and the kernel
is held against it on the card.  ``complex_cholesky_factor`` and
``complex_lower_inverse`` serve the bordered free-frequency sweep, which
factors each window's fixed block once and applies L^-1 as matmuls.
"""

from __future__ import annotations

import torch

__all__ = ["complex_cholesky_factor", "complex_cholesky_solve_unrolled",
           "complex_lower_inverse"]


def complex_cholesky_factor(A):
    """Cholesky factor A = L L^H of Hermitian positive-definite A
    (N, n, n) complex, batched over the leading axis (chol.py:19).  Only
    the lower triangle is read; L has a real positive diagonal.  Column
    by column, with the JAX function's order of operations: each entry
    subtracts its k < j terms one after the other, then scales by
    1 / L[j, j]."""
    n = A.shape[-1]
    cols = []                          # cols[j]: L[:, j:, j], (N, n - j)
    for j in range(n):
        s = A[:, j:, j]
        for k in range(j):
            s = s - cols[k][:, j - k:] * cols[k][:, j - k, None].conj()
        d = torch.sqrt(s[:, 0].real)
        cols.append(torch.cat([d[:, None].to(A.dtype),
                               s[:, 1:] * (1.0 / d)[:, None]], dim=1))
    L = torch.zeros_like(A)
    for j in range(n):
        L[:, j:, j] = cols[j]
    return L


def complex_lower_inverse(L):
    """Explicit inverse of lower-triangular L (N, n, n) complex with a
    real diagonal, batched (chol.py:54): forward substitution against the
    identity, row by row.  Applying L^-1 and L^-H as matmuls keeps the
    error at ~cond(L) eps = sqrt(cond(A)) eps, which the bordered sweep's
    Schur pivot needs (a Hermitian inverse would cost cond(A) eps)."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    rows = []                          # rows[i]: X[:, i, :], (N, n)
    for i in range(n):
        a = eye[i].expand(L.shape[0], n)
        for k in range(i):
            a = a - L[:, i, k, None] * rows[k]
        rows.append(a * (1.0 / L[:, i, i].real)[:, None])
    if not rows:
        return torch.zeros_like(L)
    return torch.stack(rows, dim=1)


def complex_cholesky_solve_unrolled(G, b):
    """Solve the Hermitian positive-definite systems G x = b.

    G (B, n, n) complex, b (B, n) complex; only the lower triangle of G
    is read.  Left-looking LL^H Cholesky with a static column unroll,
    then forward and back substitution, all vectorised over the batch.
    The diagonal of L is real, so every division is by a real scalar.
    """
    n = G.shape[-1]
    cols = []                          # cols[j]: L[j:, j], (B, n - j)
    for j in range(n):
        s = G[:, j:, j]
        if j:
            # Subtract sum_{k<j} L[j:, k] * conj(L[j, k]).
            Lk = torch.stack([cols[k][:, j - k:] for k in range(j)], dim=-1)
            lj = torch.stack([cols[k][:, j - k] for k in range(j)], dim=-1)
            s = s - torch.einsum("bik,bk->bi", Lk, lj.conj())
        inv = 1.0 / torch.sqrt(s[:, 0].real)        # 1 / L[j, j]
        cols.append(s * inv[:, None])

    # Forward substitution: L y = b.
    y = []
    for j in range(n):
        a = b[:, j]
        if j:
            lj = torch.stack([cols[k][:, j - k] for k in range(j)], dim=-1)
            a = a - torch.einsum("bk,bk->b", lj, torch.stack(y, dim=-1))
        y.append(a * (1.0 / cols[j][:, 0].real))

    # Back substitution: L^H x = y.
    x = [None] * n
    for j in range(n - 1, -1, -1):
        a = y[j]
        if j < n - 1:
            a = a - torch.einsum("bk,bk->b", cols[j][:, 1:].conj(),
                                 torch.stack(x[j + 1:], dim=-1))
        x[j] = a * (1.0 / cols[j][:, 0].real)
    return torch.stack(x, dim=-1)
