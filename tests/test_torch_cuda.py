"""The port's CUDA kernel on the card (marked ``cuda``; they skip where
torch.cuda.is_available() is false).  This file imports no JAX, so on a
machine without it run it alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu_torch import engine_real
from qnmfits_tpu_torch.ops import chol_cuda
from qnmfits_tpu_torch.testing import random_hermitian_systems

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("n", list(range(2, 17)))
def test_kernel_matches_plain(cuda, n):
    G, b = random_hermitian_systems(1000, n, seed=n, n_pad=n // 4)
    G = torch.as_tensor(G, dtype=torch.complex128, device=cuda)
    b = torch.as_tensor(b, dtype=torch.complex128, device=cuda)
    before = chol_cuda.launches
    x = chol_cuda.regularised_solve(G, b)
    assert chol_cuda.launches == before + 1
    ref = engine_real._regularised_solve_plain(G, b)
    torch.cuda.synchronize()
    err = ((x - ref).abs().amax(-1) / ref.abs().amax(-1)).max()
    assert float(err) <= 1e-12


def test_kernel_rejects_bad_input(cuda):
    G = torch.eye(17, dtype=torch.complex128, device=cuda)[None]
    b = torch.zeros((1, 17), dtype=torch.complex128, device=cuda)
    with pytest.raises(ValueError, match="n=17"):
        chol_cuda.regularised_solve(G, b)
    with pytest.raises(TypeError, match="complex128"):
        chol_cuda.regularised_solve(G[:, :4, :4].to(torch.complex64),
                                    b[:, :4].to(torch.complex64))


def test_sweep_through_kernel_matches_plain(cuda):
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    chol_cuda.launches = 0
    mm = chip_smoke.sweep(problem, "cuda", dedup=True)
    assert chol_cuda.launches > 0
    mm_plain = chip_smoke.sweep(problem, "cuda", dedup=True,
                                solve=engine_real._regularised_solve_plain)
    keep = problem["t0s"] >= 0
    assert np.max(np.abs(mm - mm_plain)[:, keep]) <= 1e-11
