"""Statistical uncertainty of fitted QNM amplitudes and mode selection
(port of qnmfits_tpu/uncertainty.py).

Under white complex noise, d = a C + n with E|n_k|^2 = sigma^2, the
least-squares amplitudes Chat = (a^H a)^-1 a^H d have Cov(Chat) = sigma^2
(a^H a)^-1; with sigma unknown, sigma_hat^2 = ||d - a Chat||^2 /
(n_obs - J).  The design ``a`` is the one the fits solve: masked samples,
plain rows, mixing-stacked spherical modes, or the time-dependent design
of a dynamic fit.  It is built as a tensor on the requested device; the
least squares go through ``ops/solve.svd_lstsq`` (rank as
np.linalg.lstsq, rcond=None) and the covariance through a Cholesky factor
of a^H a.  The F-test p-values are scipy's, on the host.

For NR data (truncation error, junk radiation) the noise is neither
white nor Gaussian, and sigma_C is a scale of sensitivity, not a
posterior; the covariance holds the mode set, remnant and t0 fixed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import RDTYPE, resolve_device
from .spectrum.tables import solves_on_device

__all__ = ["amplitude_uncertainty", "mode_selection"]


def _masked_design(times, data, modes, Mf, chif, t0, t0_method, T,
                   spherical_modes, dev, mapping_modes=None):
    """(a (I * Km, J), d (I * Km,), omega) on ``dev``: the lstsq system one
    fit solves (uncertainty.py:40; reference design matrix
    qnmfits.py:280-283 single-mode, :628-631 multimode stacking).  Array
    Mf/chif route the dynamic design mu(t_k) exp(-i omega(t_k) (t_k - t0))
    (reference qnmfits.py:438-444, 863-864), and ``omega`` is then the
    (Km, J) frequency track over the masked window.  ``mapping_modes``
    routes the identity-block design of spatial.mapping_multimode_
    ringdown_fit (spatial_engine.mapping_design; reference
    spatial_mapping_functions.py:212-248), with ``omega`` (J,) over the
    expanded column list."""
    from .batched import _canon, _prep, _spectrum
    from .engine import _window, cached_evaluator, check_spin

    times, rows, sph = _prep(times, data, spherical_modes)
    dynamic = np.ndim(Mf) > 0 or np.ndim(chif) > 0
    mask = _window(torch.as_tensor(times), float(t0), float(T),
                   t0_method).numpy().astype(bool)
    if not np.any(mask):
        raise ValueError("empty fit window (check t0/T)")
    tm = times[mask]
    d = torch.as_tensor(rows[:, mask].reshape(-1), dtype=torch.complex128,
                        device=dev)
    canon = _canon(modes)

    if mapping_modes is not None:
        if dynamic:
            raise ValueError(
                "mapping fits take a static (scalar) remnant")
        if sph is None:
            raise ValueError(
                "mapping fits need dict data over spherical modes")
        check_spin(chif)
        from .spatial_engine import mapping_design

        _, omega, mu = mapping_design(
            list(sph), list(canon), [tuple(m) for m in mapping_modes],
            float(chif), float(Mf))
        return _static_design(omega, mu, tm, t0, d, dev)

    if dynamic:
        K = times.shape[0]
        # Validate before masking: a wrong-length track would otherwise
        # fail in the indexing.
        if np.ndim(Mf) and np.asarray(Mf).shape[0] != K:
            raise ValueError("Mf track length != times length")
        if np.ndim(chif) and np.asarray(chif).shape[0] != K:
            raise ValueError("chif track length != times length")
        Mf_t = np.asarray(Mf, float)[mask] if np.ndim(Mf) \
            else np.full(len(tm), float(Mf))
        chif_t = np.asarray(chif, float)[mask] if np.ndim(chif) \
            else np.full(len(tm), float(chif))
        ev = cached_evaluator(canon, sph)
        omega = ev.omega(chif_t, Mf_t).T                     # (Km, J)
        mu = (np.ones((1,) + omega.shape, complex) if sph is None
              else np.moveaxis(ev.mu(chif_t), -1, 1))        # (I, Km, J)
        om = torch.as_tensor(omega, device=dev)
        dt = torch.as_tensor(tm - float(t0), dtype=RDTYPE, device=dev)
        decay = torch.exp(-1j * om * dt[:, None])
        a = (torch.as_tensor(mu, device=dev) * decay).reshape(-1, om.shape[1])
        return a, d, omega

    check_spin(chif)
    omega, mu = _spectrum(canon, sph, Mf, chif, 0.0)
    if rows.shape[0] != mu.shape[0]:
        raise ValueError(
            f"data has {rows.shape[0]} spherical-mode rows but the "
            f"mixing matrix expects {mu.shape[0]}")
    return _static_design(omega, mu, tm, t0, d, dev)


def _static_design(omega, mu, tm, t0, d, dev):
    """The design a (I * Km, J) of a static spectrum, omega (J,) and mu
    (I, J), on the masked times tm; returns (a, d, omega)."""
    om = torch.as_tensor(omega, device=dev)
    dt = torch.as_tensor(tm - float(t0), dtype=RDTYPE, device=dev)
    phi = torch.exp(-1j * om[None, :] * dt[:, None])          # (Km, J)
    a = (torch.as_tensor(mu, device=dev)[:, None, :] * phi[None]).reshape(
        -1, omega.shape[0])                                   # (I * Km, J)
    return a, d, omega


def _lstsq(a, d):
    """C (J,), its rank as np.linalg.lstsq counts it, and the residual's
    squared norm, by SVD."""
    from .ops.solve import svd_lstsq
    C, _, rank, _ = svd_lstsq(a, d)
    r = d - a @ C
    return C, int(rank), float(torch.vdot(r, r).real)


@solves_on_device
def amplitude_uncertainty(times, data, modes, Mf, chif, t0,
                          t0_method="geq", T=100, spherical_modes=None,
                          sigma=None, mapping_modes=None, device="cuda"):
    """Covariance of the least-squares QNM amplitudes of one fit
    (uncertainty.py:141).

    Arguments as ``ringdown_fit`` (array data) / ``multimode_ringdown_fit``
    (dict data); array Mf/chif route the dynamic design (omega is then the
    (Km, J) track), ``mapping_modes`` the mapping fit's design (dict data,
    static remnant; omega over its expanded columns).  ``sigma``, if
    given, is the known per-sample complex noise standard deviation;
    otherwise it is estimated from the residual.

    Returns a dict: omega, C (J,) the fit's amplitudes, cov (J, J),
    sigma_C (J,) = sqrt(diag cov), corr (J, J), snr (J,) = |C| / sigma_C,
    sigma2, n_obs (I * Km), dof (n_obs - J).
    """
    dev = resolve_device(device)
    a, d, omega = _masked_design(times, data, modes, Mf, chif, t0,
                                 t0_method, T, spherical_modes, dev,
                                 mapping_modes)
    J = a.shape[1]
    C, rank, rss = _lstsq(a, d)
    if rank < J:
        # A truncated lstsq is a minimum-norm solution, while the
        # covariance below describes the full-rank estimator.
        raise ValueError(
            f"design rank {rank} < {J} modes: the lstsq amplitudes are "
            "a minimum-norm choice with no finite covariance -- drop "
            "degenerate modes or widen the window")

    n_obs = d.shape[0]
    dof = n_obs - J
    if sigma is not None:
        sigma2 = float(sigma) ** 2
    else:
        if dof <= 0:
            raise ValueError(
                f"cannot estimate the noise level: {n_obs} samples "
                f"for {J} modes leaves no residual degrees of freedom "
                "(pass sigma= explicitly)")
        sigma2 = rss / dof

    L, info = torch.linalg.cholesky_ex(a.mH @ a)
    if int(info) != 0:
        raise ValueError(
            "the mode set is numerically degenerate on this window "
            "(normal-equation Gram is singular); the lstsq amplitudes "
            "are a minimum-norm choice among exact ties and have no "
            "finite covariance -- drop duplicated modes or widen the "
            "window")
    eye = torch.eye(J, dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    cov = (sigma2 * (Linv.mH @ Linv)).cpu().numpy()
    C = C.cpu().numpy()

    sigma_C = np.sqrt(np.real(np.diag(cov)))
    denom = np.outer(sigma_C, sigma_C)
    corr = np.where(denom > 0, cov / np.where(denom > 0, denom, 1.0),
                    0.0 + 0.0j)
    with np.errstate(divide="ignore", invalid="ignore"):
        snr = np.where(sigma_C > 0, np.abs(C) / sigma_C, np.inf)
    return {
        "omega": omega,
        "C": C,
        "cov": cov,
        "sigma_C": sigma_C,
        "corr": corr,
        "snr": snr,
        "sigma2": sigma2,
        "n_obs": int(n_obs),
        "dof": int(dof),
    }


@solves_on_device
def mode_selection(times, data, models, Mf, chif, t0, t0_method="geq",
                   T=100, spherical_modes=None, mapping_modes=None,
                   device="cuda"):
    """Rank candidate QNM mode sets on one window by AIC/BIC and nested
    F-tests (uncertainty.py:234).

    Each entry of ``models`` is a mode list; all are fitted on the same
    window.  A J-mode fit has k = 2J + 1 real parameters and N = 2 n_obs
    real observations: AIC = N ln(RSS/N) + 2k, BIC = N ln(RSS/N) + k ln N.
    Consecutive candidates where the earlier set is a subset of the later
    get the extra-sum-of-squares F statistic and its p-value; other pairs
    NaN.  ``mapping_modes`` fits every candidate with the mapping
    design, as ``amplitude_uncertainty`` does.

    Returns a dict over the candidates: models, n_modes, n_params, rss,
    aic, bic, delta_aic, delta_bic, best_aic, best_bic, fstat, pvalue
    ((len(models) - 1,)), n_obs.  On noiseless data RSS is rounding noise
    and the criteria degenerate.
    """
    if len(models) < 2:
        raise ValueError("mode_selection needs at least two candidate "
                         "mode sets to compare")
    dev = resolve_device(device)
    rss, n_par, n_modes, n_obs = [], [], [], None
    for ci, modes in enumerate(models):
        a, d, _ = _masked_design(times, data, modes, Mf, chif, t0,
                                 t0_method, T, spherical_modes, dev,
                                 mapping_modes)
        J = a.shape[1]
        _, rank, r2 = _lstsq(a, d)
        if rank < J:
            raise ValueError(
                f"candidate {ci} is numerically degenerate on this "
                f"window (design rank {rank} < {J} modes); "
                "its parameter count -- and every criterion built on "
                "it -- would be fictitious.  Drop duplicated/degenerate "
                "modes or widen the window")
        rss.append(r2)
        n_modes.append(J)
        n_par.append(2 * J + 1)
        n_obs = d.shape[0]
    rss = np.asarray(rss)
    n_par = np.asarray(n_par)
    N = 2 * n_obs
    if np.any(n_par >= N):
        raise ValueError(f"a candidate has {n_par.max()} parameters for "
                         f"{N} real observations")
    # Floor RSS at a denormal so noiseless round trips stay finite.
    logterm = N * np.log(np.maximum(rss, 1e-280) / N)
    aic = logterm + 2.0 * n_par
    bic = logterm + n_par * np.log(N)

    from scipy import stats

    fstat = np.full(len(models) - 1, np.nan)
    pval = np.full(len(models) - 1, np.nan)
    for i in range(len(models) - 1):
        small = {tuple(m) for m in models[i]}
        big = {tuple(m) for m in models[i + 1]}
        if not small < big:
            continue                      # not nested: no F-test
        # The shared variance parameter cancels from df1 and is left out
        # of the residual dof (df2 = N - 2 J_big).
        df1 = 2 * (n_modes[i + 1] - n_modes[i])
        df2 = N - 2 * n_modes[i + 1]
        num = max(rss[i] - rss[i + 1], 0.0) / df1
        den = max(rss[i + 1], 1e-280) / df2
        fstat[i] = num / den
        pval[i] = float(stats.f.sf(fstat[i], df1, df2))

    return {
        "models": list(models),
        "n_modes": np.asarray(n_modes),
        "n_params": n_par,
        "rss": rss,
        "aic": aic,
        "bic": bic,
        "delta_aic": aic - aic.min(),
        "delta_bic": bic - bic.min(),
        "best_aic": int(np.argmin(aic)),
        "best_bic": int(np.argmin(bic)),
        "fstat": fstat,
        "pvalue": pval,
        "n_obs": int(n_obs),
    }
