"""NumPy oracle for ringdown fits, static and dynamic-spectrum, and their
serial sweeps (port of qnmfits_tpu/ref_impl.py).

Masked design matrices a[k, j] = exp(-i w_j (t_k - t0)) (with a time-
dependent spectrum w_j(t_k) and mixing mu_j(t_k)), LAPACK SVD least
squares (np.linalg.lstsq, rcond=None) and trapezoid mismatches, as the
reference fitting engine computes them (qnmfits.py:142-911).  Frequencies
and mixing coefficients come from ``engine.SpectrumEvaluator``.  It shares
no code with the sweeps it checks beyond the spectrum.  The serial loops
are the ``engine='loop'`` paths of the public sweeps, and
``rational_filter`` the oracle of the torch filter.
"""

from __future__ import annotations

import numpy as np

from .engine import SpectrumEvaluator

__all__ = ["ringdown", "mismatch", "multimode_mismatch", "ringdown_fit",
           "dynamic_ringdown_fit", "multimode_ringdown_fit",
           "dynamic_multimode_ringdown_fit", "fit_dispatch",
           "mismatch_t0_array", "mismatch_M_chi_grid", "mismatch_omega_grid",
           "calculate_epsilon", "free_frequency_fit",
           "rational_filter"]


def ringdown(time, start_time, complex_amplitudes, frequencies):
    """Damped-sinusoid sum, zero before start_time
    (reference qnmfits.py:15-70)."""
    time = np.asarray(time)
    h = np.zeros(len(time), dtype=complex)
    sel = time >= start_time
    ts = time[sel] - start_time
    amps = np.asarray(complex_amplitudes, dtype=complex)
    freqs = np.asarray(frequencies, dtype=complex)
    h[sel] = (amps[:, None] * np.exp(-1j * freqs[:, None] * ts[None, :])).sum(0)
    return h


def _trapz(y, x):
    return np.trapezoid(y, x=x)


def mismatch(times, wf_1, wf_2):
    """1 - Re<w1,w2>/sqrt(<w1,w1><w2,w2>), trapezoid inner products
    (reference qnmfits.py:73-97)."""
    num = np.real(_trapz(wf_1 * np.conj(wf_2), times))
    den = np.sqrt(_trapz(np.real(wf_1 * np.conj(wf_1)), times)
                  * _trapz(np.real(wf_2 * np.conj(wf_2)), times))
    return 1 - num / den


def multimode_mismatch(times, wf_dict_1, wf_dict_2):
    """Sky-averaged mismatch over the keys of wf_dict_1
    (reference qnmfits.py:100-139)."""
    keys = list(wf_dict_1.keys())
    num = np.real(sum(_trapz(wf_dict_1[k] * np.conj(wf_dict_2[k]), times)
                      for k in keys))
    n1 = sum(_trapz(np.real(wf_dict_1[k] * np.conj(wf_dict_1[k])), times)
             for k in keys)
    n2 = sum(_trapz(np.real(wf_dict_2[k] * np.conj(wf_dict_2[k])), times)
             for k in keys)
    return 1 - num / np.sqrt(n1 * n2)


def mask_times(times, t0, T, t0_method):
    """Index selection of the analysis window (reference
    qnmfits.py:230-248)."""
    times = np.asarray(times)
    if t0_method == "geq":
        return np.where((times >= t0) & (times < t0 + T))[0]
    if t0_method == "closest":
        start = int(np.argmin((times - t0) ** 2))
        end = int(np.argmin((times - t0 - T) ** 2))
        return np.arange(start, end)
    raise ValueError(
        "t0_method must be 'geq' or 'closest', got " + repr(t0_method))


def _design_matrix(times, t0, frequencies):
    """a[k, j] = exp(-i w_j (t_k - t0)) (reference qnmfits.py:280-283)."""
    dt = np.asarray(times)[:, None] - t0
    return np.exp(-1j * np.asarray(frequencies)[None, :] * dt)


def _lstsq(a, d):
    C, res, rank, sv = np.linalg.lstsq(a, d, rcond=None)
    return C, res, rank, sv


def _delta_factor(delta, n_modes):
    """Frequency perturbation factor 1 + delta
    (reference qnmfits.py:253-274)."""
    if isinstance(delta, (list, np.ndarray)):
        delta = np.asarray(delta, dtype=float)
        if len(delta) != n_modes:
            raise ValueError("delta array must have length len(modes)")
        return delta + 1.0
    return float(delta) + 1.0


def ringdown_fit(times, data, modes, Mf, chif, t0, t0_method="geq", T=100,
                 delta=0.0):
    """Single-series least-squares ringdown fit
    (reference qnmfits.py:142-315)."""
    idx = mask_times(times, t0, T, t0_method)
    tm, dm = np.asarray(times)[idx], np.asarray(data)[idx]

    factor = _delta_factor(delta, len(modes))
    frequencies = factor * SpectrumEvaluator(modes).omega(chif, Mf)

    a = _design_matrix(tm, t0, frequencies)
    C, res, rank, sv = _lstsq(a, dm)
    model = a @ C
    return {
        "residual": res, "rank": rank, "s": sv,
        "mismatch": mismatch(tm, model, dm),
        "C": C, "data": dm, "model": model, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(m) for m in modes],
        "frequencies": frequencies,
    }


def _track(x, idx, n):
    """A remnant track at the window's samples: a scalar repeated, or the
    (K,) track's in-window samples."""
    return np.full(n, x) if np.ndim(x) == 0 else np.asarray(x)[idx]


def dynamic_ringdown_fit(times, data, modes, Mf, chif, t0, t0_method="geq",
                         T=100):
    """Fit with a time-dependent (Mf(t), chif(t)) spectrum
    (reference qnmfits.py:318-475)."""
    idx = mask_times(times, t0, T, t0_method)
    tm, dm = np.asarray(times)[idx], np.asarray(data)[idx]
    frequencies = SpectrumEvaluator(modes).omega(
        _track(chif, idx, len(tm)), _track(Mf, idx, len(tm)))    # (J, K)
    a = np.exp(-1j * frequencies * (tm - t0)).T
    C, res, rank, sv = _lstsq(a, dm)
    model = a @ C
    return {
        "residual": res, "s": sv,
        "mismatch": mismatch(tm, model, dm),
        "C": C, "data": dm, "model": model, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(m) for m in modes],
        "frequencies": frequencies,
    }


def multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                           t0_method="geq", T=100, spherical_modes=None):
    """Joint fit across spherical-harmonic modes with shared amplitudes
    weighted by mixing coefficients (reference qnmfits.py:478-673)."""
    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())
    idx = mask_times(times, t0, T, t0_method)
    tm = np.asarray(times)[idx]
    masked = {lm: np.asarray(data_dict[lm])[idx] for lm in spherical_modes}
    d = np.concatenate([masked[lm] for lm in spherical_modes])

    ev = SpectrumEvaluator(modes, spherical_modes)
    frequencies = ev.omega(chif, Mf)
    mu_rows = ev.mu(chif)                                # (I, J)

    decay = _design_matrix(tm, t0, frequencies)          # (K, J)
    a = np.concatenate([mu[None, :] * decay for mu in mu_rows])

    C, res, rank, sv = _lstsq(a, d)
    model = a @ C

    K = len(tm)
    model_dict = {lm: model[i * K:(i + 1) * K]
                  for i, lm in enumerate(spherical_modes)}
    return {
        "residual": res, "s": sv,
        "mismatch": multimode_mismatch(tm, model_dict, masked),
        "C": C, "data": masked, "model": model_dict, "model_times": tm,
        "t0": t0, "modes": modes, "frequencies": frequencies,
    }


def dynamic_multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                                   t0_method="geq", T=100,
                                   spherical_modes=None):
    """Multimode fit with a time-dependent spectrum
    (reference qnmfits.py:676-911)."""
    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())
    idx = mask_times(times, t0, T, t0_method)
    tm = np.asarray(times)[idx]
    masked = {lm: np.asarray(data_dict[lm])[idx] for lm in spherical_modes}
    d = np.concatenate([masked[lm] for lm in spherical_modes])

    chif_t = _track(chif, idx, len(tm))
    ev = SpectrumEvaluator(modes, spherical_modes)
    freqs = ev.omega(chif_t, _track(Mf, idx, len(tm))).T     # (K, J)
    mu_blocks = list(np.moveaxis(ev.mu(chif_t), -1, 1))      # I x (K, J)

    decay = np.exp(-1j * freqs * (tm[:, None] - t0))         # (K, J)
    a = np.concatenate([mu * decay for mu in mu_blocks])     # (I*K, J)

    C, res, rank, sv = _lstsq(a, d)
    model = a @ C
    weighted = np.concatenate(mu_blocks) * C

    K = len(tm)
    model_dict = {lm: model[i * K:(i + 1) * K]
                  for i, lm in enumerate(spherical_modes)}
    weighted_C = {lm: weighted[i * K:(i + 1) * K]
                  for i, lm in enumerate(spherical_modes)}
    return {
        "residual": res, "s": sv,
        "mismatch": multimode_mismatch(tm, model_dict, masked),
        "C": C, "weighted_C": weighted_C,
        "data": masked, "model": model_dict, "model_times": tm,
        "t0": t0, "modes": modes,
        "mode_labels": [str(m) for m in modes],
        "frequencies": np.vstack(len(spherical_modes) * [freqs]),
    }


def _is_static(x):
    return np.ndim(x) == 0


def fit_dispatch(times, data, modes, Mf, chif, t0, t0_method, T,
                 spherical_modes=None, delta=0.0):
    """The fit of a sweep's loop, by (dict data?, static spectrum?) like
    the reference's sweep loops (qnmfits.py:1268-1299)."""
    static = _is_static(Mf) and _is_static(chif)
    if isinstance(data, dict):
        fit = multimode_ringdown_fit if static \
            else dynamic_multimode_ringdown_fit
        return fit(times, data, modes, Mf, chif, t0, t0_method, T,
                   spherical_modes)
    if static:
        return ringdown_fit(times, data, modes, Mf, chif, t0, t0_method, T,
                            delta)
    return dynamic_ringdown_fit(times, data, modes, Mf, chif, t0, t0_method,
                                T)


def mismatch_t0_array(times, data, modes, Mf, chif, t0_array,
                      t0_method="geq", T_array=100, spherical_modes=None,
                      delta=0.0):
    """Mismatch vs ringdown start time (reference qnmfits.py:1183-1301)."""
    t0_array = np.asarray(t0_array)
    if np.ndim(T_array) == 0:
        T_array = np.full(len(t0_array), T_array)
    return [fit_dispatch(times, data, modes, Mf, chif, t0, t0_method, T,
                         spherical_modes, delta)["mismatch"]
            for t0, T in zip(t0_array, T_array)]


def mismatch_M_chi_grid(times, data, modes, Mf_minmax, chif_minmax, t0,
                        t0_method="geq", T=100, res=50,
                        spherical_modes=None, delta=0.0):
    """Mismatch over an (Mf, chif) grid (reference qnmfits.py:1304-1415),
    row-major over Mf (rows) x chif (columns) (qnmfits.py:1413)."""
    Mf_array = np.linspace(*Mf_minmax, res)
    chif_array = np.linspace(*chif_minmax, res)
    mm = np.empty(res * res)
    for i in range(res * res):
        mm[i] = fit_dispatch(times, data, modes, Mf_array[i // res],
                             chif_array[i % res], t0, t0_method, T,
                             spherical_modes, delta)["mismatch"]
    return mm.reshape(res, res)


def mismatch_omega_grid(times, data, modes, Mf, chif, re_minmax, im_minmax,
                        t0, t0_method="geq", T=100, res=50):
    """Mismatch over a complex-frequency grid for one extra free mode
    (reference qnmfits.py:1679-1827), transposed like the reference
    (qnmfits.py:1825).  The window is masked once: the reference re-masks
    inside its loop, which shrinks 'closest' windows each iteration
    (PARITY.md "Known deltas"); for 'geq' the two agree."""
    idx = mask_times(times, t0, T, t0_method)
    tm, dm = np.asarray(times)[idx], np.asarray(data)[idx]
    fixed = (SpectrumEvaluator(modes).omega(chif, Mf) if len(modes)
             else np.zeros(0, complex))
    re_array = np.linspace(*re_minmax, res)
    im_array = np.linspace(*im_minmax, res)
    mm = np.empty(res * res)
    for i in range(res * res):
        w_free = re_array[i // res] + 1j * im_array[i % res]
        a = _design_matrix(tm, t0, np.concatenate([fixed, [w_free]]))
        C, *_ = _lstsq(a, dm)
        mm[i] = mismatch(tm, a @ C, dm)
    return mm.reshape(res, res).T


def calculate_epsilon(times, data, modes, Mf, chif, t0, t0_method="geq",
                      T=100, spherical_modes=None, min_method="Nelder-Mead",
                      delta=0.0, x0=None):
    """Best-fit (Mf, chif) by mismatch minimisation with a scipy method;
    epsilon distance from the true remnant (reference
    qnmfits.py:1418-1594)."""
    from scipy.optimize import minimize

    def objective(x):
        chif_x = min(max(x[1], 0.0), 0.99)
        return fit_dispatch(times, data, modes, x[0], chif_x, t0, t0_method,
                            T, spherical_modes, delta)["mismatch"]

    res = minimize(objective, x0 if x0 is not None else [Mf, chif],
                   method=min_method, bounds=[(0, 2.0), (0, 0.99)],
                   options={"xatol": 1e-6, "disp": False})
    Mf_bf, chif_bf = res.x
    eps = np.sqrt((Mf_bf - Mf) ** 2 + (chif_bf - chif) ** 2)
    return eps, Mf_bf, chif_bf


def free_frequency_fit(times, data, t0, modes=[], Mf=None, chif=None,
                       t0_method="geq", T=100, min_method="Nelder-Mead"):
    """Best free complex frequency on top of fixed QNMs with a scipy
    method (reference qnmfits.py:1905-2043)."""
    from scipy.optimize import minimize

    idx = mask_times(times, t0, T, t0_method)
    tm, dm = np.asarray(times)[idx], np.asarray(data)[idx]
    fixed = (SpectrumEvaluator(modes).omega(chif, Mf) if len(modes)
             else np.zeros(0, complex))

    def objective(x):
        freqs = np.concatenate([fixed, [x[0] + 1j * x[1]]])
        a = _design_matrix(tm, t0, freqs)
        C, *_ = _lstsq(a, dm)
        return mismatch(tm, a @ C, dm)

    res = minimize(objective, [1, -0.5], method=min_method,
                   bounds=[(0, 2), (-1, 0)],
                   options={"xatol": 1e-8, "disp": False})
    return res.x[0] + 1j * res.x[1]


def rational_filter(times, data, modes, Mf, chif, t_start=-300, t_end=None,
                    dt=None, t_taper=100, align_inspiral=True):
    """Frequency-domain removal of QNM content, Ma et al. arXiv:2207.10870
    (reference qnmfits.py:2046-2152): cubic interpolation onto a uniform
    grid, an early-time cosine taper, the product over modes of
    (2 pi f + w) / (2 pi f + conj w) and, with align_inspiral, the
    accumulated phase and time shift.  Returns (uniform_times,
    filtered_data)."""
    from scipy.interpolate import interp1d

    times = np.asarray(times)
    data = np.asarray(data)
    if t_end is None:
        t_end = times[-1]
    if dt is None:
        dt = float(np.min(np.diff(times)))

    t_u = np.arange(t_start, t_end, dt)
    d_u = interp1d(times, data.real, kind="cubic")(t_u) \
        + 1j * interp1d(times, data.imag, kind="cubic")(t_u)

    # Cosine taper at early times.
    taper_sel = t_u < (t_start + t_taper)
    n_taper = int(taper_sel.sum())
    arg = np.pi * np.arange(n_taper)[::-1] / max(n_taper, 1)
    d_u[taper_sel] *= (np.cos(arg) + 1) / 2

    freqs = np.fft.fftfreq(len(d_u), d=dt)
    spec = np.fft.fft(d_u)

    omegas = (SpectrumEvaluator([tuple(m) for m in modes]).omega(chif, Mf)
              if len(modes) else np.zeros(0, complex))
    filt = np.ones_like(spec)
    phase_shift = 0.0
    time_shift = 0.0
    for w in omegas:
        filt *= (2 * np.pi * freqs + w) / (2 * np.pi * freqs + np.conj(w))
        phase_shift += np.angle(w / np.conj(w))
        time_shift += np.abs(2 * np.imag(w) / np.conj(w) ** 2)
    spec *= filt

    if align_inspiral:
        spec *= np.exp(-2j * np.pi * freqs * time_shift - 1j * phase_shift)

    return t_u, np.fft.ifft(spec)
