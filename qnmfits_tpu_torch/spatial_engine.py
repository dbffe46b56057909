"""Compiled spatial-mapping compute (port of qnmfits_tpu/spatial_engine.py):
vectorised Qmu, sky contractions, and the mapping-fit design routed
through the port's sweeps.

The reference evaluates its quadratic-mixing predictions with a Python
double loop of per-scalar spline calls (one `qnm.mu` per (d, h) pair per
output index, reference spatial_mapping_functions.py:728-885) and its
mapping fit with a materialised design matrix and np.linalg.lstsq per fit
(:212-248).  Here, as in the JAX package:

* ``QmuCompiled`` -- for an index list and spin weights (s1, s2), the
  kappa tensor (N, D, H) and the factor-mu spline gathers (N, D) / (N, H)
  are compiled once; evaluation at any chif (scalar or array) is two
  batched piecewise-cubic evaluations and one einsum (spatial.Qmu_A/B/D);
* ``sky_matrix`` / ``sky_sum`` -- sky maps as one stacked sYlm matrix
  contraction;
* ``eval_qmu_c`` -- Qmu_C from one stacked eigensolve of the angular
  matrices;
* ``mapping_design`` -- the mapping fit's per-spherical-mode mixing rows
  as an (I, J) matrix: exactly the ``mu`` of a multimode sweep, so the
  mapping sweep ``mapping_mismatch_t0_array`` runs on the port's sweeps
  and their batched Hermitian solve (the CUDA kernels on the card), its
  'sharded' engine over a mesh of torch.distributed ranks
  (``parallel.mesh.sharded_t0_sweep_factored``).

The Qmu and eigensystem work stays host NumPy, as in the JAX package;
only the sweep runs on the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .harmonics import sYlm
from .spectrum.tables import eval_spline_np, solves_on_device

__all__ = [
    "compile_qmu", "eval_qmu", "eval_qmu_c",
    "spheroidal_coeffs_batched", "sky_sum", "mapping_design",
    "mapping_mismatch_t0_array",
]


def _tables_for(s: int):
    from .qnm_api import get_qnm
    return get_qnm()._t(s)


def _kappa_np(i, j, d, h, b, f, s1, s2):
    # spatial.kappa is the single source of truth; spatial imports this
    # module at load time, so the import is deferred to compile time.
    from .spatial import kappa
    return kappa(i, j, d, h, b, f, s1, s2)


class _FactorGather:
    """Batched mixing-coefficient gather for one Qmu factor
    (spatial_engine.py:59).

    Holds (rows, comps, signs, parity, nonzero) index arrays of shape
    (N, W) into the spin-weight-s tables; ``eval`` returns the (N, W[, Q])
    complex mu values at chif with mirror parity applied (the semantics of
    SpectrumTables.mu_np)."""

    def __init__(self, s: int, flat_indices, shape, valid):
        self.tables = _tables_for(s)
        r, c, sg, par, nz = self.tables.compile_mu_indices(flat_indices)
        self.signs = sg.reshape(shape)
        self.parity = par.reshape(shape)
        self.nonzero = nz.reshape(shape) & valid
        # Packed spline coefficients for the whole factor: (N, W, P-1, 4).
        self.coeffs = self.tables.mu_coeffs(r, c).reshape(
            tuple(shape) + (len(self.tables.chi) - 1, 4))

    def eval(self, chif):
        mu = eval_spline_np(self.tables.chi, self.coeffs, chif)  # (N, W[, Q])
        sg, par, nz = self.signs, self.parity, self.nonzero
        if mu.ndim == 3:
            sg = sg[..., None]; par = par[..., None]; nz = nz[..., None]
        mu = np.where(sg > 0, mu, par * np.conj(mu))
        return np.where(nz, mu, 0.0)


class QmuCompiled:
    """One compiled Qmu index list: kappa tensor and two factor gathers
    (spatial_engine.py:85)."""

    def __init__(self, indices, s1: int, s2: int, l_max: int,
                 with_extra: bool):
        indices = [tuple(int(x) for x in idx) for idx in indices]
        N = len(indices)
        self.N = N
        if N == 0:
            return

        d_los = [max(abs(s1), abs(b)) for (_, _, _, b, *_) in indices]
        h_los = [max(abs(s2), abs(idx[7])) for idx in indices]
        D = max(max(l_max + 1 - lo for lo in d_los), 1)
        H = max(max(l_max + 1 - lo for lo in h_los), 1)

        kap = np.zeros((N, D, H))
        valid1 = np.zeros((N, D), bool)
        valid2 = np.zeros((N, H), bool)
        idx1, idx2 = [], []
        for n, (i, j, a, b, c, sign1, e, f, g, sign2) in enumerate(indices):
            extra = 1.0
            if with_extra:
                extra = np.sqrt((i + 4.0) * (i - 3.0) * (i + 3.0) * (i - 2.0))
            for di in range(D):
                d = d_los[n] + di
                ok = d <= l_max
                valid1[n, di] = ok
                # The loop oracle evaluates mu1 for every d in range; a
                # padded slot reuses the safe index d_lo and is masked.
                idx1.append((d if ok else d_los[n], b, a, b, c, sign1))
                if not ok:
                    continue
                for hi in range(H):
                    h = h_los[n] + hi
                    if h > l_max:
                        continue
                    kap[n, di, hi] = _kappa_np(i, j, d, h, b, f, s1, s2) \
                        * extra
            for hi in range(H):
                h = h_los[n] + hi
                # The oracle touches mu2 only where kappa != 0: an h slot
                # whose whole kappa column vanishes must not compile a
                # (possibly out-of-table) index.
                ok = h <= l_max and bool(np.any(kap[n, :, hi]))
                valid2[n, hi] = ok
                idx2.append((h if ok else max(abs(s2), abs(f)), f, e, f, g,
                             sign2))

        self.kappa = kap
        self.f1 = _FactorGather(s1, idx1, (N, D), valid1)
        self.f2 = _FactorGather(s2, idx2, (N, H), valid2)

    def eval(self, chif):
        """Qmu values at chif: (N,) for scalar chif, (N, Q) for (Q,)."""
        if self.N == 0:
            return np.zeros((0,), complex) if np.ndim(chif) == 0 \
                else np.zeros((0, len(np.atleast_1d(chif))), complex)
        # Spins off either factor's table grid raise, as the loop oracle's
        # mu_np calls do; both tables are checked in case their grids
        # ever differ.
        self.f1.tables._check_chif(chif)
        self.f2.tables._check_chif(chif)
        mu1 = self.f1.eval(chif)
        mu2 = self.f2.eval(chif)
        if mu1.ndim == 3:
            return np.einsum("ndh,ndq,nhq->nq", self.kappa, mu1, mu2)
        return np.einsum("ndh,nd,nh->n", self.kappa, mu1, mu2)


@lru_cache(maxsize=512)
def compile_qmu(indices_key, s1: int, s2: int, l_max: int,
                with_extra: bool) -> QmuCompiled:
    return QmuCompiled(list(indices_key), s1, s2, l_max, with_extra)


def eval_qmu(indices, chif, l_max, s1=-2, s2=-2, with_extra=False):
    """Vectorised Qmu sum for a list of (i, j, a, b, c, p1, e, f, g, p2)
    output indices (the compute behind spatial.Qmu_A/B/D)."""
    key = tuple(tuple(int(x) for x in idx) for idx in indices)
    comp = compile_qmu(key, int(s1), int(s2), int(l_max), bool(with_extra))
    return list(comp.eval(chif))


# ---------------------------------------------------------------------------
# Sky maps as stacked-harmonic contractions
# ---------------------------------------------------------------------------

def sky_matrix(s: int, lm_list, theta, phi):
    """Stack sYlm columns for an explicit (l, m) list: (..., n_modes)."""
    th = np.asarray(theta, float)
    ph = np.asarray(phi, float)
    return np.stack([sYlm(s, l, m, th, ph) for (l, m) in lm_list], axis=-1)


def sky_sum(s: int, lm_list, amps, theta, phi):
    """sum_k amps[k] sYlm(s, l_k, m_k)(theta, phi) as one matrix
    contraction (the reference sums per (l, m), spatial_mapping_functions.
    py:286-411)."""
    Y = sky_matrix(s, lm_list, theta, phi)
    return Y @ np.asarray(amps, complex)


# ---------------------------------------------------------------------------
# Batched spheroidal expansions: the compiled Qmu_C path
# ---------------------------------------------------------------------------

def spheroidal_coeffs_batched(s, Ls, Ms, gammas, nl=30):
    """sYlm expansion coefficients of S_{s,L,M}(gamma) for a whole batch
    (spatial_engine.py:192).

    Ls/Ms (B,) ints, gammas (B,) complex.  The angular matrices are
    stacked and eigen-decomposed in one ``np.linalg.eig`` call; selection
    and normalisation reproduce ``spectrum.angular.mode_eigensystem`` at
    equal ``nl`` (sorted-by-real-part eigenvalue pick, diagonal component
    real and positive -- which makes the result independent of LAPACK's
    phase choice -- unit norm).  Returns (l0s (B,), C (B, nl)).
    """
    from .spectrum.angular import angular_matrix, lmin

    Ls = np.asarray(Ls, int)
    Ms = np.asarray(Ms, int)
    gammas = np.asarray(gammas, complex)
    B = gammas.shape[0]
    l0s = np.array([lmin(s, int(m)) for m in Ms])
    kidx = Ls - l0s
    if np.any(kidx >= nl) or np.any(kidx < 0):
        raise ValueError("nl too small for requested (L, M)")
    mats = np.empty((B, nl, nl), complex)
    for b in range(B):
        mats[b] = angular_matrix(s, int(Ms[b]), gammas[b], nl)
    A_all, C_all = np.linalg.eig(mats)
    rows = np.arange(B)
    order = np.argsort(A_all.real, axis=1)
    k = order[rows, kidx]
    C = C_all[rows, :, k]                                  # (B, nl)
    diag = C[rows, kidx]
    phase = np.where(diag != 0,
                     np.abs(diag) / np.where(diag == 0, 1.0, diag), 1.0)
    C = C * phase[:, None]
    C = C / np.sqrt(np.sum(np.abs(C) ** 2, axis=1))[:, None]
    return l0s, C


def eval_qmu_c(indices, chif, nl=30):
    """Vectorised Qmu_C (reference spatial_mapping_functions.py:802-849):
    the overlap <sYlm(i,j) | S_{L,M}(chif * omega_quad)> read off the
    spheroidal's sYlm expansion, batched over (index, chif).

    chif scalar -> (N,) complex array; chif (Q,) -> (N, Q).  Indices that
    share a quadratic map share (L, M, gamma): one eigensolve per map and
    spin.
    """
    from .qnm_api import get_qnm

    scalar = np.ndim(chif) == 0
    chif_arr = np.atleast_1d(np.asarray(chif, float))
    Q = chif_arr.shape[0]
    N = len(indices)
    out = np.zeros((N, Q), complex)
    if N == 0:
        return out[:, 0] if scalar else out

    idx_arr = np.asarray([tuple(int(x) for x in idx) for idx in indices])
    omg = np.asarray(get_qnm().omega_list(
        [tuple(row) for row in idx_arr[:, 2:10]], chif_arr, 1))  # (N, Q)
    gam = chif_arr[None, :] * omg

    i_, j_ = idx_arr[:, 0], idx_arr[:, 1]
    Ls = idx_arr[:, 2] + idx_arr[:, 6]
    Ms = idx_arr[:, 3] + idx_arr[:, 7]
    live = j_ == Ms                                        # else exactly 0
    if not np.any(live):
        return out[:, 0] if scalar else out

    live_idx = np.where(live)[0]
    uniq, inv = np.unique(idx_arr[live_idx, 2:10], axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)          # 2-D under NumPy 2.0.0's axis= unique
    U = uniq.shape[0]
    rep = np.empty(U, int)
    rep[inv] = live_idx
    uu, qq = np.meshgrid(np.arange(U), np.arange(Q), indexing="ij")
    uu, qq = uu.ravel(), qq.ravel()
    l0s, C = spheroidal_coeffs_batched(-2, Ls[rep[uu]], Ms[rep[uu]],
                                       gam[rep[uu], qq], nl=nl)
    l0s = l0s.reshape(U, Q)
    C = C.reshape(U, Q, nl)
    nn = np.repeat(live_idx, Q)
    un = np.repeat(inv, Q)
    qn = np.tile(np.arange(Q), live_idx.size)
    comp = i_[nn] - l0s[un, qn]
    ok = (comp >= 0) & (comp < nl)
    out[nn[ok], qn[ok]] = C[un[ok], qn[ok], comp[ok]]
    return out[:, 0] if scalar else out


# ---------------------------------------------------------------------------
# Mapping fit as a sweep's mu matrix
# ---------------------------------------------------------------------------

def split_mapping_modes(modes, mapping_modes):
    """Partition the model as the reference does (reference :165-183):
    non-mapped linear and non-mapped quadratic modes; other tuple lengths
    raise."""
    mod_modes = [tuple(m) for m in modes if tuple(m) not in
                 {tuple(mm) for mm in mapping_modes}]
    linear = [m for m in mod_modes if len(m) == 4]
    quadratic = [m for m in mod_modes if len(m) == 8]
    bad = [m for m in mod_modes if len(m) not in (4, 8)]
    if bad:
        raise ValueError(f"wrong number of indices in tuple: {bad[0]}")
    return linear, quadratic


def mapping_design(spherical_modes, modes, mapping_modes, chif, Mf,
                   l_max: int = 8):
    """The mapping fit's model as sweep arrays (spatial_engine.py:299).

    Returns (all_modes, omega (J,) complex, mu (I, J) complex), where
    column j of mu holds, for spherical-mode row i, the coefficient the
    reference writes into design block i: mu mixing for linear modes,
    Qmu_B for quadratic modes (reference :185-210), and identity blocks
    giving each mapped mode an independent amplitude per spherical mode
    (reference :212-219).  J = n_lin + n_quad + I * n_map.
    """
    from .qnm_api import get_qnm

    spherical_modes = [tuple(lm) for lm in spherical_modes]
    mapping_modes = [tuple(mm) for mm in mapping_modes]
    linear, quadratic = split_mapping_modes(modes, mapping_modes)
    mod_modes = linear + quadratic
    q = get_qnm()
    I = len(spherical_modes)
    n_lin, n_quad, n_map = len(linear), len(quadratic), len(mapping_modes)
    J = n_lin + n_quad + I * n_map

    mu = np.zeros((I, J), complex)
    if n_lin:
        mus = np.asarray(q.mu_list(
            [lm + m for lm in spherical_modes for m in linear], chif))
        mu[:, :n_lin] = mus.reshape(I, n_lin)
    if n_quad:
        alphas = np.asarray(eval_qmu(
            [lm + m for lm in spherical_modes for m in quadratic],
            chif, l_max=l_max, s1=-2, s2=0))
        mu[:, n_lin:n_lin + n_quad] = alphas.reshape(I, n_quad)
    for k in range(n_map):
        for i in range(I):
            mu[i, n_lin + n_quad + k * I + i] = 1.0

    all_modes = mod_modes + [mm for mm in mapping_modes for _ in range(I)]
    omega = np.asarray(q.omega_list(all_modes, chif, Mf))
    return all_modes, omega, mu


@solves_on_device
def mapping_mismatch_t0_array(times, data_dict, modes, Mf, chif, t0_array,
                              mapping_modes, t0_method="geq", T_array=100,
                              spherical_modes=None, l_max=8,
                              engine="batched", precision="x64",
                              return_amplitudes=False, mesh=None,
                              chunk=128, dedup=True, device="cuda",
                              solve=None):
    """Mapping-fit mismatch vs start time (spatial_engine.py:366): the
    compiled (omega, mu) design on the port's start-time sweeps, whose
    batched Hermitian solve is the CUDA kernel on the card (the team
    kernel for J <= 16, the wide kernel above).

      engine='batched'  -- the complex window sweep
                           (``batched.sweep_t0_core``), any window method;
      engine='fast'     -- the factored sweep
                           (``engine_real.sweep_t0_factored_real``;
                           t0_method='geq', t0_array sorted ascending);
      engine='sharded'  -- the factored sweep with the start times
                           sharded over ``mesh``'s 'sweep' ranks
                           (``parallel.mesh.sharded_t0_sweep_factored``;
                           'auto' when None: every rank of the
                           initialised torch.distributed process group);
      engine='loop'     -- serial ``spatial.mapping_multimode_ringdown_fit``
                           calls (SVD least squares), the oracle.

    A ``mesh`` given to 'batched' or 'fast' runs 'sharded'.

    The only precision is 'x64' (others raise), so the JAX function's rule
    that its f32 'batched' sweep never deduplicates has no counterpart
    here.  The 'fast' and 'sharded' checks run on the caller's t0_array,
    before dedup.
    ``solve`` substitutes the batched Hermitian solve.

    Returns mm (B,); with return_amplitudes=True also C (B, J) complex in
    mapping_design's column order.  dedup=True (default) solves each
    distinct window once and rephases the amplitudes (exact for this
    static design); the 'loop' oracle always runs per t0.
    """
    from . import resolve_device
    from .batched import (_cplx, _dedup_for, _mesh_for, _real, _safe_chunk,
                          _scatter, _uniform_spacing, sweep_t0_core)
    from .engine import check_spin
    from .engine_real import sweep_t0_factored_real
    from .fitting import _check_precision

    _check_precision(precision)
    if engine not in ("batched", "fast", "sharded", "loop"):
        raise ValueError(f"unknown engine {engine!r}")
    check_spin(chif)
    dev = resolve_device(device)
    if mesh is not None and engine in ("batched", "fast"):
        engine = "sharded"
    if engine == "sharded":
        mesh = _mesh_for("auto" if mesh is None else mesh, dev)

    if spherical_modes is None:
        spherical_modes = list(data_dict.keys())
    t0s = np.asarray(t0_array, float)
    Ts = np.ascontiguousarray(
        np.broadcast_to(np.asarray(T_array, float), t0s.shape))

    if engine == "loop":
        from .spatial import mapping_multimode_ringdown_fit
        mms, Cs = [], []
        for t0, T in zip(t0s, Ts):
            out = mapping_multimode_ringdown_fit(
                times, data_dict, modes, Mf, chif, float(t0),
                mapping_modes, t0_method=t0_method, T=float(T),
                spherical_modes=spherical_modes, device=dev)
            mms.append(out["mismatch"])
            Cs.append(out["C"])
        mm = np.asarray(mms)
        return (mm, np.asarray(Cs)) if return_amplitudes else mm

    _, omega, mu = mapping_design(spherical_modes, modes, mapping_modes,
                                  chif, Mf, l_max=l_max)
    times = np.asarray(times, float)
    rows = np.stack([np.asarray(data_dict[lm]) for lm in spherical_modes])

    # The caller's inputs are checked before dedup compresses them: the
    # dedup representatives are ascending, which would let an unsorted
    # t0_array past the factored sweep's contract.
    if engine in ("fast", "sharded"):
        if t0_method != "geq":
            raise ValueError(f"engine={engine!r} supports t0_method='geq' "
                             "only")
        if np.any(np.diff(t0s) < 0):
            raise ValueError("t0_array must be sorted ascending")

    dd = _dedup_for(t0_method, times, t0s, Ts) if dedup else None
    t0s_full = t0s
    if dd is not None:
        t0s, Ts = t0s[dd[0]], Ts[dd[0]]

    args = (_real(times, dev), _cplx(rows, dev), _cplx(omega, dev),
            _cplx(mu, dev), _real(t0s, dev), _real(Ts, dev))
    if engine in ("fast", "sharded"):
        ck = _safe_chunk(t0s, float(np.max(np.abs(omega.imag))), chunk)
        kw = dict(chunk=ck, analytic=_uniform_spacing(times), solve=solve)
        if engine == "sharded":
            from .parallel.mesh import sharded_t0_sweep_factored
            C, mm = sharded_t0_sweep_factored(*args, mesh, **kw)
        else:
            C, mm = sweep_t0_factored_real(*args, **kw)
    else:
        C, mm = sweep_t0_core(*args, t0_method, solve=solve)
    mm, C = _scatter(dd, t0s_full, mm, C, omega, return_amplitudes)
    return (mm, C) if return_amplitudes else mm
