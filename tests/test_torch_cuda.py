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


def _rel(x, ref):
    return float(((x - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


# B = 1, 15 and 17 leave partial slabs and partial teams at every n; 1000
# spans several slabs; 131072 is the bench sweep's batch without dedup,
# more slabs than the persistent grid has blocks.
@pytest.mark.parametrize("n,B", [(n, B) for n in range(2, 17)
                                 for B in (1, 15, 17, 1000)]
                         + [(8, 131072)])
def test_kernel_matches_plain(cuda, n, B):
    G, b = random_hermitian_systems(B, n, seed=n + B, n_pad=n // 4)
    G = torch.as_tensor(G, dtype=torch.complex128, device=cuda)
    b = torch.as_tensor(b, dtype=torch.complex128, device=cuda)
    before = chol_cuda.launches
    x = chol_cuda.regularised_solve(G, b)
    assert chol_cuda.launches == before + 1
    ref = engine_real._regularised_solve_plain(G, b)
    torch.cuda.synchronize()
    assert _rel(x, ref) <= 1e-12


def test_kernel_does_not_spill(cuda):
    report = chol_cuda.ptxas_report()
    assert sorted(report) == list(range(2, 17))
    for n, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (n, r)


def test_kernel_rejects_misaligned_input(cuda):
    """A complex128 view 8 bytes into its storage cannot feed the bulk
    copies: the wrapper raises rather than launch or fall back."""
    n, B = 4, 3
    G0, b0 = random_hermitian_systems(B, n, seed=1)
    G0 = torch.as_tensor(G0, dtype=torch.complex128, device=cuda)
    b0 = torch.as_tensor(b0, dtype=torch.complex128, device=cuda)
    raw = torch.empty(G0.numel() * 16 + 8, dtype=torch.uint8, device=cuda)
    G = torch.empty(0, dtype=torch.complex128, device=cuda).set_(
        raw.untyped_storage()[8:], 0, G0.shape, G0.stride())
    G.copy_(G0)
    assert G.is_contiguous() and G.data_ptr() % 16 == 8
    before = chol_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        chol_cuda.regularised_solve(G, b0)
    assert chol_cuda.launches == before
    x = chol_cuda.regularised_solve(G.clone(), b0)
    assert _rel(x, engine_real._regularised_solve_plain(G0, b0)) <= 1e-12


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
    keep = problem["t0s"] >= 0
    for dedup in (True, False):
        chol_cuda.launches = 0
        mm = chip_smoke.sweep(problem, "cuda", dedup=dedup)
        assert chol_cuda.launches == 1           # one solve per sweep
        mm_plain = chip_smoke.sweep(
            problem, "cuda", dedup=dedup,
            solve=engine_real._regularised_solve_plain)
        assert np.max(np.abs(mm - mm_plain)[:, keep]) <= 1e-11
