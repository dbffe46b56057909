"""Rational QNM filter (port of qnmfits_tpu/filters.py).

Frequency-domain removal of QNM content (Ma, Giesler, Varma, Scheel &
Mitman, arXiv:2207.10870) with the semantics of the reference
implementation (qnmfits.py:2046-2152): cubic interpolation onto a
uniform grid, an early-time cosine taper, the per-mode rational filter
prod_j (2 pi f + w_j) / (2 pi f + conj w_j) and the accumulated phase
and time realignment of the inspiral.

The interpolation runs on the host (scipy, as the NumPy oracle
``ref_impl.rational_filter`` does); the taper, FFT, filter product,
alignment and inverse FFT run as complex128 torch operations on the
requested device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import CDTYPE, RDTYPE, resolve_device
from .engine import SpectrumEvaluator
from .spectrum.tables import solves_on_device

__all__ = ["rational_filter_torch"]


def _filter(d_u, dt, omegas, n_taper, align):
    """The filter pipeline on d_u (N,) complex128, omegas (J,) complex128,
    on their device: taper the first n_taper samples, FFT, multiply by the
    rational filter (and the alignment factor), inverse FFT."""
    dev = d_u.device
    if n_taper:
        arg = math.pi * torch.arange(n_taper - 1, -1, -1, dtype=RDTYPE,
                                     device=dev) / n_taper
        d_u = torch.cat([d_u[:n_taper] * ((torch.cos(arg) + 1.0) / 2.0),
                         d_u[n_taper:]])
    freqs = torch.fft.fftfreq(d_u.shape[0], dtype=RDTYPE, device=dev) / dt
    tpf = 2.0 * math.pi * freqs
    spec = torch.fft.fft(d_u)
    filt = ((tpf[None, :] + omegas[:, None])
            / (tpf[None, :] + omegas.conj()[:, None])).prod(dim=0)
    spec = spec * filt
    if align:
        phase_shift = torch.angle(omegas / omegas.conj()).sum()
        time_shift = (2.0 * omegas.imag / omegas.conj() ** 2).abs().sum()
        spec = spec * torch.exp(-1j * (tpf * time_shift + phase_shift))
    return torch.fft.ifft(spec)


@solves_on_device
def rational_filter_torch(times, data, modes, Mf, chif, t_start=-300,
                          t_end=None, dt=None, t_taper=100,
                          align_inspiral=True, device="cuda"):
    """The rational filter with its FFT pipeline on ``device``
    (filters.py:56): the signature and numerics of
    ``ref_impl.rational_filter`` (<= 1e-12 of max |data|).  Returns
    (uniform_times, filtered_data) as NumPy arrays."""
    from scipy.interpolate import interp1d

    dev = resolve_device(device)
    times = np.asarray(times)
    data = np.asarray(data)
    if t_end is None:
        t_end = times[-1]
    if dt is None:
        dt = float(np.min(np.diff(times)))

    t_u = np.arange(t_start, t_end, dt)
    d_u = interp1d(times, data.real, kind="cubic")(t_u) \
        + 1j * interp1d(times, data.imag, kind="cubic")(t_u)
    omegas = (SpectrumEvaluator([tuple(m) for m in modes]).omega(chif, Mf)
              if len(modes) else np.zeros(0, complex))
    n_taper = int(np.sum(t_u < (t_start + t_taper)))
    out = _filter(torch.as_tensor(d_u, dtype=CDTYPE, device=dev), float(dt),
                  torch.as_tensor(omegas, dtype=CDTYPE, device=dev), n_taper,
                  bool(align_inspiral))
    return t_u, out.cpu().numpy()
