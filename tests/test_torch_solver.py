"""The port's on-demand spectrum solver (``spectrum/radial.py``,
``spectrum/solver.py``, the plain version of the CF kernel) against the
JAX package's on the same seeded inputs, on the CPU.

Bounds: CF residuals within 1e-13 of |U| + |T| (near a root U - T cancels,
so the residual itself is no scale); tracks within 1e-11 in omega and
1e-10 in the mixing vectors at the same reduced depths (the JAX package
evaluates the CF in 80-bit where its native kernel builds, the port in
FP64: the two meet to ~1e-14 at these depths).
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import radial as jradial
from qnmfits_tpu.spectrum import solver as jsolver
from qnmfits_tpu_torch.ops import cf_cuda
from qnmfits_tpu_torch.spectrum import radial, solver

CF_TOL = 1e-13
OMEGA_TOL = 1e-11
MU_TOL = 1e-10


def _inputs(B, seed):
    """Frequencies (Leaver units), spins and separation constants near
    real modes."""
    rng = np.random.default_rng(seed)
    w = 2.0 * (0.3 + 0.6 * rng.random(B) - 1j * (0.05 + 0.6 * rng.random(B)))
    a = 0.5 * 0.99 * rng.random(B)
    A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
    return w, a, A


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("s,m,n_inv,N", [(-2, 2, 0, 400), (-2, -3, 4, 700),
                                         (-1, 1, 2, 513), (0, 0, 7, 900)])
def test_cf_matches_jax(s, m, n_inv, N):
    w, a, A = _inputs(9, seed=N)
    U, T = cf_cuda.cf_parts(_t(w), _t(a), _t(A), s, m, n_inv, N)
    scale = (U.abs() + T.abs()).numpy()
    ref = jsolver._cf_vec_a(w, a, A, s, m, n_inv, N)
    assert np.max(np.abs((U - T).numpy() - ref) / scale) <= CF_TOL
    # radial_cf: a scalar spin over a 2-D batch.
    U, T = cf_cuda.cf_parts(_t(w), 0.31, _t(A), s, m, n_inv, N)
    scale = (U.abs() + T.abs()).numpy().reshape(3, 3)
    ref = jradial.radial_cf(w.reshape(3, 3), 0.31, A.reshape(3, 3), s, m,
                            n_inv, N)
    got = radial.radial_cf(_t(w.reshape(3, 3)), 0.31, _t(A.reshape(3, 3)), s,
                           m, n_inv, N).numpy()
    assert np.max(np.abs(got - ref) / scale) <= CF_TOL


def test_cf_per_element_inversions_and_the_cpu_wrapper():
    """Per-element n_inv (the kernel's layout) against one JAX call per
    element; on CPU tensors the wrapper runs the plain version and counts
    no launch."""
    w, a, A = _inputs(8, seed=5)
    n_inv = np.array([0, 3, 1, 8, 2, 0, 5, 4])
    before = cf_cuda.launches
    f, scale = cf_cuda.leaver_cf(_t(w), _t(a), _t(A), -2, 2, _t(n_inv), 600,
                                 with_scale=True)
    assert cf_cuda.launches == before
    ref = np.array([jsolver._cf_vec_a(w[i:i + 1], a[i:i + 1], A[i:i + 1], -2,
                                      2, int(n_inv[i]), 600)[0]
                    for i in range(8)])
    assert np.max(np.abs(f.numpy() - ref) / scale.numpy()) <= CF_TOL
    U, T = cf_cuda.cf_parts(_t(w), _t(a), _t(A), -2, 2, _t(n_inv), 600)
    assert torch.equal(f, U - T)
    assert torch.equal(scale, U.abs() + T.abs())


def test_solve_omega_matches_jax():
    """The scalar-spin Newton with a user A(omega): the Schwarzschild
    (2,2,0) root from a nearby guess."""
    A_fn = lambda w: np.full(np.shape(w), 4.0 + 0j)             # noqa: E731
    A_fn_t = lambda w: torch.full(w.shape, 4.0 + 0j,            # noqa: E731
                                  dtype=torch.complex128)
    wj, Aj, okj = jradial.solve_omega(0.75 - 0.18j, 0.0, -2, 2, 0, A_fn,
                                      N=800)
    wt, At, okt = radial.solve_omega(0.75 - 0.18j, 0.0, -2, 2, 0, A_fn_t,
                                     N=800, device="cpu")
    assert okj and okt and abs(wt - wj) <= OMEGA_TOL and At == Aj


def test_default_chi_grid_is_jax_s():
    assert np.array_equal(solver.default_chi_grid(),
                          jsolver.default_chi_grid())
    assert np.array_equal(solver.default_chi_grid(37, 0.9),
                          jsolver.default_chi_grid(37, 0.9))


@pytest.mark.parametrize("s,l_max,n_max,low", [(-2, 3, 2, None), (-1, 2, 1, 0),
                                               (0, 1, 2, 0), (-2, 5, 1, 0)])
def test_schwarzschild_seeds_match_jax(s, l_max, n_max, low):
    kw = dict(l_max=l_max, n_max=n_max, s=s, N=1500, n_max_low_l=low)
    ref = jsolver.schwarzschild_seeds(**kw)
    got = solver.schwarzschild_seeds(**kw, device="cpu")
    assert got.keys() == ref.keys()
    assert max(abs(got[k] - ref[k]) for k in ref) <= OMEGA_TOL


def test_angular_selection_matches_jax():
    """The batched eig, the nearest-eigenvalue pick, the diagonal-real-
    positive phase and the unit norm, at oblateness c near real modes."""
    rng = np.random.default_rng(2)
    c = 0.9 * rng.random(12) * (1.0 - 0.2j)
    for s, l, m in ((-2, 2, 2), (-2, 4, -3), (0, 1, 0)):
        nl = l - max(abs(s), abs(m)) + 1 + 24
        guess = np.full(12, l * (l + 1) - s * (s + 1) + 0j) - c * c / 4
        Aj, Cj = jsolver._angular_A_C(s, l, m, c, nl, guess)
        At, Ct = solver._angular_A_C(s, l, m, _t(c), nl, _t(guess))
        assert np.max(np.abs(At.numpy() - Aj)) <= 1e-12 * np.max(np.abs(Aj))
        assert np.max(np.abs(Ct.numpy() - Cj)) <= 1e-12
        Av, _ = solver._angular_A_C(s, l, m, _t(c), nl, _t(guess),
                                    vectors=False)
        assert np.max(np.abs(Av.numpy() - Aj)) <= 1e-12 * np.max(np.abs(Aj))


def test_lockstep_newton_matches_jax():
    chi = np.linspace(0.05, 0.6, 11)
    wj0 = jsolver.schwarzschild_seeds(l_max=2, n_max=1, s=-2, N=1500)[(2, 1)]
    guess = np.full(11, 2.0 * wj0) + 0.3 * chi
    A0 = np.full(11, 4.0 + 0j)
    wj, Aj, Cj, okj = jsolver._newton_coupled_vec_a(
        guess, chi / 2.0, A0, -2, 2, 2, 1, 25, 1200, 1e-12)
    wt, At, Ct, okt = solver._newton_coupled_vec_a(
        _t(guess), _t(chi / 2.0), _t(A0), -2, 2, 2, 1, 25, 1200, 1e-12)
    assert okj.all() and okt.numpy().all()
    assert np.max(np.abs(wt.numpy() - wj)) <= OMEGA_TOL
    assert np.max(np.abs(Ct.numpy() - Cj)) <= MU_TOL


@pytest.mark.parametrize("l,m,n,s", [(2, 2, 0, -2), (3, -2, 2, -2),
                                     (2, 1, 1, -1), (1, 0, 0, 0)])
def test_track_mode_matches_jax(l, m, n, s):
    """A ~30-point grid to chi = 0.7123 at reduced depths, the same
    arguments to both."""
    chi = np.linspace(0.0, 0.7123, 30)
    kw = dict(s=s, N_coarse=400, N_fine=1200)
    seed_j = jsolver.schwarzschild_seeds(l_max=l, n_max=n, s=s, N=1500,
                                         n_max_low_l=0)[(l, n)]
    seed_t = solver.schwarzschild_seeds(l_max=l, n_max=n, s=s, N=1500,
                                        n_max_low_l=0, device="cpu")[(l, n)]
    wj, Aj, Cj = jsolver.track_mode(l, m, n, seed_j, chi, **kw)
    wt, At, Ct = solver.track_mode(l, m, n, seed_t, chi, **kw, device="cpu")
    assert wt.shape == wj.shape and Ct.shape == Cj.shape
    assert np.max(np.abs(wt - wj)) <= OMEGA_TOL
    assert np.max(np.abs(At - Aj)) <= 1e-10 * np.max(np.abs(Aj))
    assert np.max(np.abs(Ct - Cj)) <= MU_TOL


def test_track_mode_failure_is_a_solve_error(monkeypatch):
    """A coarse point that never converges, after six levels of spin
    substeps, raises the solver's own error (the tables turn it into their
    KeyError), where the JAX package raises RuntimeError."""
    calls = []

    def never(omega_L, aL, A_guess, *args):
        calls.append(aL)
        return omega_L, A_guess, torch.zeros(1, dtype=torch.bool)

    monkeypatch.setattr(solver, "_newton_coupled", never)
    with pytest.raises(solver.SolveError, match="coarse track failed"):
        solver.track_mode(2, 2, 0, 0.37 - 0.09j, np.linspace(0.0, 0.3, 9),
                          device="cpu")
    assert len(calls) == 7 and calls[0] == 0.0      # depths 0..6
