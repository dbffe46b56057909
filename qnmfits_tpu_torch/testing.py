"""Synthetic waveforms for tests and the smoke run (port of
qnmfits_tpu/testing.py::synthetic_multimode)."""

from __future__ import annotations

import numpy as np

from .engine import SpectrumEvaluator

__all__ = ["bench_mode_sets", "random_hermitian_systems",
           "synthetic_multimode"]


def default_time_grid(t_min=-50.0, t_max=150.0, dt=0.1):
    return np.arange(t_min, t_max, dt)


def synthetic_multimode(modes=None, spherical_modes=None, amplitudes=None,
                        Mf=0.952, chif=0.692, times=None, seed=0):
    """Spherical-harmonic-decomposed synthetic ringdown with mixing:
    h_lm(t) = sum_j mu_{lm,j}(chif) C_j exp(-i w_j t) for t >= 0, zero
    before -- data exactly representable by the multimode model.
    Amplitudes default to complex normals from np.random.default_rng(seed).
    """
    if modes is None:
        modes = [(2, 2, n, 1) for n in range(2)] + [(3, 2, 0, 1)]
    if spherical_modes is None:
        spherical_modes = [(2, 2), (3, 2)]
    if amplitudes is None:
        rng = np.random.default_rng(seed)
        amplitudes = (rng.standard_normal(len(modes))
                      + 1j * rng.standard_normal(len(modes)))
    amplitudes = np.asarray(amplitudes, complex)
    if times is None:
        times = default_time_grid()

    ev = SpectrumEvaluator(modes, spherical_modes)
    freqs = ev.omega(chif, Mf)
    mus = ev.mu(chif)                                    # (I, J)
    data_dict = {}
    tpos = np.where(times >= 0, times, 0.0)
    for lm, mu in zip(spherical_modes, mus):
        h = (mu[None, :] * amplitudes[None, :]
             * np.exp(-1j * freqs[None, :] * tpos[:, None])).sum(1)
        data_dict[tuple(lm)] = np.where(times >= 0, h, 0.0)
    return dict(times=times, data_dict=data_dict, modes=modes,
                spherical_modes=spherical_modes, amplitudes=amplitudes,
                frequencies=freqs, Mf=Mf, chif=chif)


def bench_mode_sets():
    """The bench's 16 mode sets (bench.py:46-58): (2,2) overtone ladders
    n < 1..8, the first four with the (2,2,0) mirror mode added, and the
    first four with (3,2,0) and (3,2,1) added; widths 1..8."""
    sets = [[(2, 2, n, 1) for n in range(nmax)] for nmax in range(1, 9)]
    sets += [[(2, 2, n, 1) for n in range(nmax)] + [(2, 2, 0, -1)]
             for nmax in range(1, 5)]
    sets += [[(2, 2, n, 1) for n in range(nmax)]
             + [(3, 2, 0, 1), (3, 2, 1, 1)] for nmax in range(1, 5)]
    return sets


def random_hermitian_systems(B, n, seed=0, n_pad=0):
    """B Hermitian positive-definite systems G x = b (complex128 numpy):
    random Grams with column scales spread over 1e-3..1e3 (what the
    equilibration undoes), a dead column (scale 1e-30) in every other
    system, and the last n_pad columns identity padding with zero rhs,
    as the sweep pads ragged mode sets."""
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((B, n, 2 * n))
         + 1j * rng.standard_normal((B, n, 2 * n)))
    G = M @ np.conj(np.swapaxes(M, -1, -2)) + np.eye(n)[None]
    b = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    scale = 10.0 ** rng.uniform(-3.0, 3.0, (B, n))
    live = n - n_pad
    scale[np.arange(0, B, 2), rng.integers(0, live, (B + 1) // 2)] = 1e-30
    G = G * scale[:, :, None] * scale[:, None, :]
    b = b * scale
    G[:, live:, :] = 0.0
    G[:, :, live:] = 0.0
    G[:, range(live, n), range(live, n)] = 1.0
    b[:, live:] = 0.0
    return G, b
