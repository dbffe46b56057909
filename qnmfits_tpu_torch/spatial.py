"""Spatial mapping of linear and quadratic QNMs over the sky (port of
qnmfits_tpu/spatial.py; the reference's qnmfits/
spatial_mapping_functions.py):

* mapping_multimode_ringdown_fit -- multimode fit where selected modes get
  an independent amplitude per spherical mode (identity design blocks,
  reference :212-219), quadratic non-mapped modes mixed with the Qmu_B
  prediction (reference :202-210); the design is built and solved (SVD
  least squares) on the requested device;
* spatial reconstruction / predictions (linear PT mixing, quadratic Qmu
  predictions A-D, direct spheroidal-harmonic evaluation);
* spatial mismatches between fits and predictions.

The spheroidal harmonic of prediction C comes from the spectral
eigensolver (spectrum.angular) at the complex oblateness
gamma = chif * omega, and Qmu_C from its eigenvector coefficients (exact
orthonormality).  Everything but the mapping fit and its sweep
(spatial_engine.mapping_mismatch_t0_array) is host NumPy, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import CDTYPE, RDTYPE, resolve_device
from .harmonics import sYlm, wigner_3j
from .ops.solve import svd_lstsq
from .qnm_api import get_qnm
from .ref_impl import mask_times, multimode_mismatch
from .spatial_engine import (eval_qmu, eval_qmu_c, mapping_design,
                             mapping_mismatch_t0_array, sky_sum,
                             spheroidal_coeffs_batched)
from .spectrum.angular import lmin as _lmin, mode_eigensystem
from .spectrum.tables import solves_on_device

__all__ = [
    "mapping_multimode_ringdown_fit", "mapping_mismatch_t0_array",
    "spatial_reconstruction",
    "spatial_prediction_linear", "spatial_prediction_quadratic",
    "spatial_prediction_C", "spatial_mismatch_linear",
    "spatial_mismatch_quadratic", "spatial_data_mismatch", "data_mismatch",
    "sYlm", "kappa", "Qmu_A", "Qmu_B", "Qmu_C", "Qmu_D",
    "spheroidal_harmonic",
]


# ---------------------------------------------------------------------------
# Spheroidal harmonics at complex oblateness (replaces `spheroidal` pkg)
# ---------------------------------------------------------------------------

def spheroidal_harmonic(s: int, l: int, m: int, gamma: complex, nl: int = 30):
    """Return S(theta, phi): the spin-weighted spheroidal harmonic
    S_{s,l,m}(gamma), unit-normalised, as its sYlm expansion evaluated
    pointwise (used by spatial_prediction_C; reference :414-449 calls
    spheroidal.harmonic)."""
    _, C = mode_eigensystem(s, l, m, gamma, nl=nl)
    l0 = _lmin(s, m)

    def S(theta, phi):
        out = 0
        for k, c in enumerate(C):
            if abs(c) > 1e-14:
                out = out + c * sYlm(s, l0 + k, m, theta, phi)
        return out

    return S


def spheroidal_coefficients(s: int, l: int, m: int, gamma: complex,
                            nl: int = 30):
    """sYlm expansion coefficients of S_{s,l,m}(gamma): (l0, C)."""
    _, C = mode_eigensystem(s, l, m, gamma, nl=nl)
    return _lmin(s, m), C


# ---------------------------------------------------------------------------
# kappa and the Qmu quadratic-mixing predictions (reference :690-885)
# ---------------------------------------------------------------------------

def kappa(i, j, d, h, b, f, s1, s2):
    """Gaunt-type triple-sYlm integral from two Wigner 3j symbols
    (reference :690-725)."""
    return (np.sqrt((2 * d + 1) * (2 * h + 1) * (2 * i + 1) / (4 * np.pi))
            * wigner_3j(d, h, i, -s1, -s2, s1 + s2)
            * wigner_3j(d, h, i, b, f, -j)
            * (-1.0) ** (j + s1 + s2))


def _Qmu_sum_loop(indices, chif, l_max, s1, s2, extra=None):
    """Reference-shaped double-sum oracle (scalar chif only): one
    per-scalar mu-spline call per (d, h) pair, exactly the reference's
    evaluation order (:728-761).  The equality bar of the compiled einsum
    path (spatial_engine.eval_qmu)."""
    q = get_qnm()
    out = []
    for (i, j, a, b, c, sign1, e, f, g, sign2) in indices:
        total = 0.0 + 0.0j
        for d in range(max(abs(s1), abs(b)), l_max + 1):
            mu1 = q.mu(d, b, a, b, c, sign1, chif, s1)
            if mu1 == 0:
                continue
            for h in range(max(abs(s2), abs(f)), l_max + 1):
                k = kappa(i, j, d, h, b, f, s1, s2)
                if k == 0.0:
                    continue
                mu2 = q.mu(h, f, e, f, g, sign2, chif, s2)
                term = mu1 * mu2 * k
                if extra is not None:
                    term = term * extra(i)
                total += term
        out.append(total)
    return out


def Qmu_A(indices, chif, l_max, **kwargs):
    """QQNM mixing prediction A: both factors spin weight -2
    (reference :728-761).  Evaluated by the compiled einsum engine
    (spatial_engine.eval_qmu); chif may be a scalar or an array."""
    return eval_qmu(indices, chif, l_max, s1=-2, s2=-2)


def Qmu_B(indices, chif, l_max, **kwargs):
    """QQNM mixing prediction B: configurable spin weights, default
    (s1, s2) = (-2, 0) (reference :764-799; requires s=0 tables)."""
    return eval_qmu(indices, chif, l_max,
                    s1=kwargs.get("s1", -2), s2=kwargs.get("s2", 0))


def Qmu_C(indices, chif, l_max=None, method="coefficients", n_quad=64,
          **kwargs):
    """QQNM mixing prediction C: overlap of the combined-frequency
    spheroidal harmonic with the spherical harmonic (reference :802-849).

    method='coefficients' (default) reads the overlap directly from the
    spheroidal's sYlm expansion (exact orthonormality -- replaces scipy
    dblquad) via the batched eigensolve engine
    (spatial_engine.eval_qmu_c): chif may be a scalar or an array,
    matching the compiled A/B/D surfaces.  method='quadrature'
    integrates on a Gauss-Legendre x trapezoid sky grid (scalar-chif
    cross-check path).
    """
    if method == "coefficients":
        return list(eval_qmu_c(indices, chif))
    q = get_qnm()
    out = []
    for (i, j, a, b, c, sign1, e, f, g, sign2) in indices:
        L, M = a + e, b + f
        [omega] = q.omega_list([(a, b, c, sign1, e, f, g, sign2)], chif, 1)
        gamma = chif * omega
        from numpy.polynomial.legendre import leggauss
        x, wx = leggauss(n_quad)
        theta = np.arccos(x)
        phi = np.linspace(0, 2 * np.pi, 2 * n_quad, endpoint=False)
        TH, PH = np.meshgrid(theta, phi, indexing="ij")
        S = spheroidal_harmonic(-2, L, M, gamma)
        integrand = S(TH, PH) * np.conj(sYlm(-2, i, j, TH, PH))
        val = np.einsum("tp,t->", integrand, wx) \
            * (2 * np.pi / len(phi))
        out.append(val)
    return out


def Qmu_D(indices, chif, l_max, **kwargs):
    """QQNM mixing prediction D: A-type sum with the extra
    sqrt((i+4)(i-3)(i+3)(i-2)) factor (reference :852-885)."""
    return eval_qmu(indices, chif, l_max, s1=-2, s2=-2, with_extra=True)


# ---------------------------------------------------------------------------
# Mapping fit (reference :18-283)
# ---------------------------------------------------------------------------

@solves_on_device
def mapping_multimode_ringdown_fit(times, data_dict, modes, Mf, chif, t0,
                                   mapping_modes, t0_method="geq", T=100,
                                   spherical_modes=None, device="cuda"):
    """Multimode fit where the mapped modes get an independent amplitude
    per spherical mode (identity design blocks, reference :212-219);
    quadratic non-mapped modes use the Qmu_B mixing prediction (reference
    :202-210).  The design (spatial_engine.mapping_design's (omega, mu))
    is built on ``device`` and solved by SVD least squares
    (``ops/solve.svd_lstsq``, rcond=None); 'residual' has
    np.linalg.lstsq's form (empty unless the design has full column rank
    and more rows than columns).  Returns the reference's dict, as NumPy.
    """

    dev = resolve_device(device)
    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())

    idx = mask_times(times, t0, T, t0_method)
    tm = np.asarray(times, float)[idx]
    masked = {lm: np.asarray(data_dict[lm])[idx] for lm in spherical_modes}
    d = np.concatenate([masked[lm] for lm in spherical_modes])

    all_modes, frequencies, coef_matrix = mapping_design(
        spherical_modes, modes, mapping_modes, chif, Mf)
    I, J = coef_matrix.shape
    om = torch.as_tensor(frequencies, dtype=CDTYPE, device=dev)
    dt = torch.as_tensor(tm - t0, dtype=RDTYPE, device=dev)
    decay = torch.exp(-1j * om[None, :] * dt[:, None])          # (Km, J)
    a = (torch.as_tensor(coef_matrix, dtype=CDTYPE, device=dev)[:, None, :]
         * decay[None]).reshape(-1, J)                          # (I*Km, J)
    C, res, rank, _ = svd_lstsq(a, torch.as_tensor(d, dtype=CDTYPE,
                                                   device=dev))
    model = (a @ C).cpu().numpy()
    C = C.cpu().numpy()
    full = int(rank) == J and a.shape[0] > J
    res = res.cpu().numpy() if full else np.empty(0)

    K = len(tm)
    model_dict = {lm: model[i * K:(i + 1) * K]
                  for i, lm in enumerate(spherical_modes)}
    weighted_C = {lm: coef_matrix[i] * C
                  for i, lm in enumerate(spherical_modes)}

    return {
        "residual": res,
        "mismatch": multimode_mismatch(tm, model_dict, masked),
        "C": C, "weighted_C": weighted_C,
        "data": masked, "model": model_dict, "model_times": tm,
        "spherical_modes": spherical_modes,
        "t0": t0, "modes": all_modes,
        "mode_labels": [str(m) for m in all_modes],
        "frequencies": frequencies,
    }


# ---------------------------------------------------------------------------
# Reconstructions / predictions over the sky (reference :286-449)
# ---------------------------------------------------------------------------

def spatial_reconstruction(theta, phi, best_fit, map, l_max, s3=-2):
    """Sky distribution of a mapped mode from its per-spherical-mode
    amplitudes, as one stacked-harmonic contraction (reference
    :286-323)."""
    mask = np.array([mode == map for mode in best_fit["modes"]])
    amps = best_fit["C"][mask]
    ans = sky_sum(s3, best_fit["spherical_modes"], amps, theta, phi)
    return ans / np.max(np.abs(ans))


def spatial_prediction_linear(theta, phi, map, l_max, chif):
    """Predicted QNM sky pattern from first-order-PT mixing: one batched
    mu evaluation + one harmonic contraction (reference :326-361)."""
    q = get_qnm()
    l, m, n, p = map
    lps = list(range(max(2, abs(m)), l_max + 1))
    amps = np.asarray(q.mu_list([(lp, m, l, m, n, p) for lp in lps], chif))
    ans = sky_sum(-2, [(lp, m) for lp in lps], amps, theta, phi)
    return ans / np.max(np.abs(ans))


def spatial_prediction_quadratic(theta, phi, map, l_max, chif, Qmu,
                                 **kwargs):
    """Predicted QQNM sky pattern from a Qmu predictor: the whole i
    ladder in one compiled Qmu evaluation + one harmonic contraction
    (reference :364-411)."""
    s1 = kwargs.get("s1", -2)
    s2 = kwargs.get("s2", 0)
    s3 = kwargs.get("s3", -2)
    a, b, c, sign1, e, f, g, sign2 = map
    j = b + f
    lpp = max(abs(j), abs(s3))
    iis = list(range(lpp, l_max + 1))
    amps = np.asarray(Qmu([(i, j) + tuple(map) for i in iis], chif, l_max,
                          s1=s1, s2=s2))
    ans = sky_sum(s3, [(i, j) for i in iis], amps, theta, phi)
    return ans / np.max(np.abs(ans))


def spatial_prediction_C(theta, phi, map, chif):
    """QQNM sky pattern from the combined-frequency spheroidal harmonic
    (reference :414-449), evaluated as ONE stacked-harmonic contraction
    (spatial_engine.sky_sum over the spheroidal's sYlm expansion)
    instead of a pointwise Python coefficient sum."""

    a, b, c, sign1, e, f, g, sign2 = map
    L, j = a + e, b + f
    [omega] = get_qnm().omega_list([tuple(map)], chif, 1)
    l0s, C = spheroidal_coeffs_batched(-2, [L], [j], [chif * omega])
    # Same negligible-coefficient cut as spheroidal_harmonic's closure.
    keep = np.abs(C[0]) > 1e-14
    lm = [(int(l0s[0]) + k, j) for k in np.where(keep)[0]]
    ans = sky_sum(-2, lm, C[0][keep], theta, phi)
    return ans / np.max(np.abs(ans))


# ---------------------------------------------------------------------------
# Spatial mismatches (reference :452-656)
# ---------------------------------------------------------------------------

def spatial_mismatch_linear(best_fit, map, chif, l_max=8):
    """Overlap of fitted per-spherical-mode amplitudes with the linear
    PT mixing prediction, batched mu evaluations (reference :452-502)."""
    q = get_qnm()
    mask = np.array([mode == map for mode in best_fit["modes"]])
    amps = best_fit["C"][mask]
    l, m, n, p = map
    mus = np.asarray(q.mu_list(
        [(lp, mp, l, m, n, p) for (lp, mp) in best_fit["spherical_modes"]],
        chif))
    z = np.sum(amps * np.conj(mus))
    # l' starts at max(2, |m|): mu is undefined (KeyError) below |m|,
    # same guard as spatial_prediction_linear.
    lps = list(range(max(2, abs(m)), l_max + 1))
    mus_full = np.asarray(q.mu_list([(lp, m, l, m, n, p) for lp in lps],
                                    chif))
    den2 = np.sum(np.abs(mus_full) ** 2)
    den1 = np.abs(np.sum(amps * np.conj(amps)))
    sm = 1 - np.abs(z) / np.sqrt(den1 * den2)
    return sm, np.angle(z), z


def spatial_mismatch_quadratic(best_fit, map, l_max, chif, Qmu, **kwargs):
    """Overlap of fitted amplitudes with a quadratic Qmu prediction,
    batched Qmu evaluations (reference :505-564)."""
    s1 = kwargs.get("s1", -2)
    s2 = kwargs.get("s2", 0)
    a, b, c, sign1, e, f, g, sign2 = map
    j = b + f
    mask = np.array([mode == map for mode in best_fit["modes"]])
    amps = best_fit["C"][mask]
    alphas = np.asarray(Qmu(
        [(lp, mp) + tuple(map) for (lp, mp) in best_fit["spherical_modes"]],
        chif, l_max, s1=s1, s2=s2))
    z = np.sum(amps * np.conj(alphas))
    lps = list(range(max(2, abs(j)), l_max + 1))
    alphas_full = np.asarray(Qmu([(lp, j) + tuple(map) for lp in lps],
                                 chif, l_max, s1=s1, s2=s2))
    den2 = np.sum(np.abs(alphas_full) ** 2)
    den1 = np.abs(np.sum(amps * np.conj(amps)))
    sm = 1 - np.abs(z) / np.sqrt(den1 * den2)
    return sm, np.angle(z), z


def spatial_data_mismatch(best_fit1, best_fit2, map):
    """Amplitude-vector mismatch between two fits (reference :567-595)."""
    mask = np.array([mode == map for mode in best_fit1["modes"]])
    a1 = best_fit1["C"][mask]
    a2 = best_fit2["C"][mask]
    num = np.abs(np.sum(a1 * np.conj(a2)))
    den = np.sqrt(np.abs(np.sum(a1 * np.conj(a1)))
                  * np.abs(np.sum(a2 * np.conj(a2))))
    return 1 - num / den


def data_mismatch(sim1, sim2, t0=0, modes=None, T=100, dt=0.01, shift=0):
    """Time-domain mismatch between two simulations (levels/radii)
    (reference :598-656)."""
    new_times = np.arange(t0, t0 + T, dt)
    if modes is None:
        modes = list(sim1.h.keys())
    num = den1 = den2 = 0.0
    for mode in modes:
        h1 = np.interp(new_times, sim1.times, sim1.h[mode])
        h2 = np.interp(new_times - shift, sim2.times, sim2.h[mode])
        num += np.abs(np.trapezoid(h1 * np.conj(h2), x=new_times))
        den1 += np.abs(np.trapezoid(h1 * np.conj(h1), x=new_times))
        den2 += np.abs(np.trapezoid(h2 * np.conj(h2), x=new_times))
    return 1 - num / np.sqrt(den1 * den2)
