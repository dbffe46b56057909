"""The port's sweep solves all of its systems in one call, on the CPU.

Each chunk of start times builds its systems in its own basis (the chunks
bound the basis anchor's span), then the batched Hermitian solve runs once
on all S * B systems of the sweep (S * distinct windows with dedup).  A
counting solve around the plain PyTorch version shows it; the results
still equal the JAX package's chunk-by-chunk sweep.
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu import batched as jb
from qnmfits_tpu import engine_real as jer
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch.testing import synthetic_multimode

SPH = [(2, 2), (3, 2)]
MODE_SETS = [[(2, 2, 0, 1), (2, 2, 1, 1)],
             [(2, 2, n, 1) for n in range(4)],
             [(2, 2, 0, 1), (3, 2, 0, 1), (3, 2, 1, 1)]]
MF, CHIF = 0.952, 0.692


class CountingSolve:
    """The plain solve, recording the batch of every call."""

    def __init__(self):
        self.batches = []

    def __call__(self, G, b):
        assert G.shape[:1] == b.shape[:1] and G.shape[1:] == 2 * b.shape[1:]
        self.batches.append(b.shape[0])
        return ter._regularised_solve_plain(G, b)


@pytest.fixture(scope="module")
def problem():
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)]
                              + [(3, 2, 0, 1)], spherical_modes=SPH,
                              times=np.arange(-5.0, 35.05, 0.1), seed=8)
    return syn["times"], syn["data_dict"]


def _spectrum():
    fn, masks = tb._modesets_spectrum_fn(
        tuple(tuple(ms) for ms in MODE_SETS), tuple(SPH))
    omegas, mus = fn(CHIF, MF)
    return omegas, mus, masks


@pytest.mark.parametrize("analytic", [True, False])
def test_engine_sweep_solves_once(problem, analytic):
    """chunk = 16 over 40 start times: chunks of 16, 16 and a tail of 8,
    one solve of S * 40 systems, and the JAX lax.map sweep's results."""
    times, data = problem
    rows = np.stack([data[lm] for lm in SPH])
    t0s = np.linspace(0.0, 12.0, 40)
    Ts = np.full_like(t0s, 20.0)
    omegas, mus, masks = _spectrum()
    solve = CountingSolve()
    C, mm = ter.sweep_t0_modesets_factored_real(
        torch.as_tensor(times), torch.as_tensor(rows),
        torch.as_tensor(omegas), torch.as_tensor(mus), torch.as_tensor(t0s),
        torch.as_tensor(Ts), torch.as_tensor(masks), chunk=16,
        analytic=analytic, solve=solve)
    assert solve.batches == [len(MODE_SETS) * len(t0s)]
    Cre, Cim, mm_j = jer.sweep_t0_modesets_factored_real(
        times, rows.real, rows.imag, omegas.real, omegas.imag, mus.real,
        mus.imag, t0s, Ts, masks, chunk=16, analytic=analytic)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cre) + 1j
                               * np.asarray(Cim), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dedup", [True, False])
def test_batched_sweep_solves_once(problem, dedup):
    """The public batched sweep with chunk = 16: one solve of S * B
    systems, or S * (distinct windows) with dedup, and the JAX sweep's
    mismatches and amplitudes."""
    times, data = problem
    t0s = np.linspace(0.0, 6.0, 90)        # finer than the 0.1 sampling
    n_windows = len(tb._window_dedup(times, t0s, np.full_like(t0s, 20.0))[0])
    assert n_windows < len(t0s)
    solve = CountingSolve()
    kw = dict(T_array=20.0, spherical_modes=SPH, return_amplitudes=True,
              chunk=16, dedup=dedup)
    mm, C = tb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF, CHIF,
                                          t0s, device="cpu", solve=solve,
                                          **kw)
    rows = n_windows if dedup else len(t0s)
    assert rows > 16 and rows % 16                   # a tail chunk
    assert solve.batches == [len(MODE_SETS) * rows]
    mm_j, C_j = jb.batch_mismatch_t0_modesets(times, data, MODE_SETS, MF,
                                              CHIF, t0s, **kw)
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=1e-13)
    for c, cj in zip(C, C_j):
        np.testing.assert_allclose(c, cj, rtol=1e-10, atol=1e-12)


def test_chunk_anchors_rephase_each_start_time(problem):
    """The joined epilogue rephases each start time from its own chunk's
    anchor: the sweep with chunk = 16 equals the sweep in one chunk (one
    anchor) to the factored form's accuracy, and any chunk size gives
    one solve."""
    times, data = problem
    rows = torch.as_tensor(np.stack([data[lm] for lm in SPH]))
    t0s = torch.as_tensor(np.linspace(0.0, 8.0, 40))
    Ts = torch.full_like(t0s, 20.0)
    omegas, mus, masks = (torch.as_tensor(a) for a in _spectrum())
    out = {}
    for chunk in (16, 64):
        solve = CountingSolve()
        out[chunk] = ter.sweep_t0_modesets_factored_real(
            torch.as_tensor(times), rows, omegas, mus, t0s, Ts, masks,
            chunk=chunk, analytic=True, solve=solve)
        assert solve.batches == [len(MODE_SETS) * 40]
    (C16, mm16), (C64, mm64) = out[16], out[64]
    np.testing.assert_allclose(mm16.numpy(), mm64.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(C16.numpy(), C64.numpy(), rtol=1e-10,
                               atol=1e-12)
