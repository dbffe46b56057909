"""The last names of the JAX package's surface in the port, each held to
the JAX function on the same inputs (made with numpy) on the CPU:
``engine.dynamic_fit_core``, ``ops/solve.qr_solve``,
``ops/solve.gram_cholesky(jitter_scale=)`` and
``testing.synthetic_single``.  Bound: 1e-11 (the port's standing parity
bar); the jittered solve 1e-12 of each system's largest amplitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qnmfits_tpu import engine as jengine
from qnmfits_tpu import testing as jtesting
from qnmfits_tpu.ops import solve as jsolve
from qnmfits_tpu_torch import engine, testing
from qnmfits_tpu_torch.ops import solve
from qnmfits_tpu_torch.testing import random_hermitian_systems

TOL = 1e-11
JITTER_TOL = 1e-12


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def _dynamic_inputs(seed, I=2, J=3):
    """A damped-mode signal on slowly drifting frequencies and mixing, with
    noise; the window [5, 45)."""
    rng = np.random.default_rng(seed)
    times = np.arange(-10.0, 60.0, 0.1)
    K = times.size
    drift = np.linspace(0.0, 0.02, K)[:, None]
    omega_t = (np.array([0.55 - 0.08j, 0.52 - 0.25j, 0.7 - 0.1j])[:J]
               + drift * (1.0 - 0.5j))
    mu_t = (1.0 + 0.1 * rng.standard_normal((I, 1, J))
            + 0.05j * drift[None] * rng.standard_normal((I, 1, J)))
    C = rng.standard_normal(J) + 1j * rng.standard_normal(J)
    tpos = np.clip(times, 0.0, None)[:, None]
    data = np.einsum("ikj,kj,j->ik", mu_t, np.exp(-1j * omega_t * tpos), C)
    data = data + 1e-3 * (rng.standard_normal((I, K))
                          + 1j * rng.standard_normal((I, K)))
    w = ((times >= 5.0) & (times < 45.0)).astype(float)
    return times, data, omega_t, mu_t, 5.0, w


@pytest.mark.parametrize("mask", [None, (True, False, True)])
def test_dynamic_fit_core_matches_jax(mask):
    times, data, omega_t, mu_t, t0, w = _dynamic_inputs(seed=3)
    col = None if mask is None else np.array(mask)
    C_j, mm_j = jengine.dynamic_fit_core(
        jnp.asarray(times), jnp.asarray(data), jnp.asarray(omega_t),
        jnp.asarray(mu_t), t0, jnp.asarray(w),
        col_mask=None if col is None else jnp.asarray(col))
    C, mm = engine.dynamic_fit_core(
        torch.as_tensor(times), torch.as_tensor(data),
        torch.as_tensor(omega_t), torch.as_tensor(mu_t), t0,
        torch.as_tensor(w), None if col is None else torch.as_tensor(col))
    assert C.shape == (3,) and mm.shape == ()
    assert _rel(C.numpy(), C_j) <= TOL
    assert abs(float(mm) - float(mm_j)) <= TOL
    if col is not None:
        assert C[1] == 0


@pytest.mark.parametrize("shape", [(50, 4), (3, 50, 4), (2, 3, 20, 20)])
def test_qr_solve_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    d = (rng.standard_normal(shape[:-1])
         + 1j * rng.standard_normal(shape[:-1]))
    ref = np.asarray(jsolve.qr_solve(jnp.asarray(a), jnp.asarray(d)))
    x = solve.qr_solve(torch.as_tensor(a), torch.as_tensor(d)).numpy()
    assert x.shape == shape[:-2] + shape[-1:]
    assert _rel(x, ref) <= TOL


@pytest.mark.parametrize("jitter", [1e-13, 1e-10, 1e-6, 1e-3])
@pytest.mark.parametrize("n", [3, 8, 20])
def test_gram_cholesky_jitter_matches_jax(jitter, n):
    """Random Hermitian systems with column scales over 1e-3..1e3, a dead
    column in every other system and identity padding: each solution
    within JITTER_TOL of its largest amplitude of the JAX function's with
    the same floor."""
    G, b = random_hermitian_systems(24, n, seed=n, n_pad=n // 4)
    ref = np.asarray(jsolve.gram_cholesky(jnp.asarray(G), jnp.asarray(b),
                                          jitter_scale=jitter))
    x = solve.gram_cholesky(torch.as_tensor(G), torch.as_tensor(b),
                            jitter_scale=jitter).numpy()
    err = (np.abs(x - ref).max(-1) / np.abs(ref).max(-1)).max()
    assert err <= JITTER_TOL
    # The floor changes the solution: the default one is not this one.
    if jitter >= 1e-6:
        x0 = solve.gram_cholesky(torch.as_tensor(G), torch.as_tensor(b))
        assert (np.abs(x0.numpy() - ref).max(-1)
                / np.abs(ref).max(-1)).max() > 1e3 * JITTER_TOL


def test_gram_cholesky_without_jitter_is_the_default_floor():
    G, b = (torch.as_tensor(x) for x in random_hermitian_systems(8, 5,
                                                                 seed=1))
    assert torch.equal(solve.gram_cholesky(G, b, jitter_scale=0.0),
                       solve.gram_cholesky(G, b))
    ref = np.asarray(jsolve.gram_cholesky(jnp.asarray(G.numpy()),
                                          jnp.asarray(b.numpy())))
    assert _rel(solve.gram_cholesky(G, b).numpy(), ref) <= JITTER_TOL


@pytest.mark.parametrize("kw", [dict(), dict(noise=1e-4, seed=21),
                                dict(modes=[(2, 2, 0, 1), (3, 2, 0, 1),
                                            (2, 2, 0, -1)],
                                     Mf=0.9, chif=0.5, seed=4,
                                     times=np.arange(-5.0, 40.0, 0.25))])
def test_synthetic_single_matches_jax(kw):
    ref = jtesting.synthetic_single(**kw)
    got = testing.synthetic_single(**kw)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["times"], ref["times"])
    np.testing.assert_array_equal(got["amplitudes"], ref["amplitudes"])
    assert got["modes"] == ref["modes"]
    assert (got["Mf"], got["chif"]) == (ref["Mf"], ref["chif"])
    assert _rel(got["frequencies"], ref["frequencies"]) <= TOL
    assert _rel(got["data"], ref["data"]) <= TOL


def test_names_are_exported():
    assert "dynamic_fit_core" in engine.__all__
    assert {"qr_solve", "gram_cholesky"} <= set(solve.__all__)
    assert "synthetic_single" in testing.__all__
