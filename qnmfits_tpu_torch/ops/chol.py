"""Batched small-matrix complex Cholesky solve, column-unrolled (port of
qnmfits_tpu/ops/chol.py::complex_cholesky_solve_unrolled).

This is the plain PyTorch version of the CUDA kernel in
``ops/chol_cuda.py``: the CPU path runs it, and the kernel is held
against it on the card.
"""

from __future__ import annotations

import torch

__all__ = ["complex_cholesky_solve_unrolled"]


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
