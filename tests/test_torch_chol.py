"""The port's batched Hermitian solve against the JAX package's.

qnmfits_tpu_torch.ops.chol (plain complex Cholesky) and
engine_real._regularised_solve (equilibrated, dead-column masked,
floored) are held against qnmfits_tpu's complex_cholesky_solve_unrolled /
_regularised_solve and against the Pallas kernel's double-single math
(_solve_values, run eagerly as tests/test_ops.py runs it).  The CUDA
kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qnmfits_tpu import engine_real as jer
from qnmfits_tpu.ops import chol as jchol
from qnmfits_tpu.ops import solve as jsolve
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch.ops import chol_cuda
from qnmfits_tpu_torch.ops.chol import complex_cholesky_solve_unrolled
from qnmfits_tpu_torch.testing import random_hermitian_systems


def _t(a):
    return torch.as_tensor(a, dtype=torch.complex128)


def _rel(x, ref):
    """Largest per-system relative error ||x - ref||_inf / ||ref||_inf."""
    x, ref = np.asarray(x), np.asarray(ref)
    return np.max(np.max(np.abs(x - ref), axis=-1)
                  / np.max(np.abs(ref), axis=-1))


def _jax_split(G, b):
    return (jnp.asarray(G.real), jnp.asarray(G.imag),
            jnp.asarray(b.real), jnp.asarray(b.imag))


def _well_conditioned(B, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, 2 * n)) \
        + 1j * rng.standard_normal((B, n, 2 * n))
    G = M @ np.conj(np.swapaxes(M, -1, -2)) + 2 * np.eye(n)[None]
    b = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    return G, b


@pytest.mark.parametrize("n", [2, 8, 16])
def test_plain_cholesky_matches_jax(n):
    G, b = _well_conditioned(32, n, seed=n)
    x = complex_cholesky_solve_unrolled(_t(G), _t(b)).numpy()
    xre, xim = jax.jit(jchol.complex_cholesky_solve_unrolled)(
        *_jax_split(G, b))
    assert _rel(x, np.asarray(xre) + 1j * np.asarray(xim)) <= 1e-12
    xref = np.linalg.solve(G, b[..., None])[..., 0]
    assert _rel(x, xref) <= 1e-12


@pytest.mark.parametrize("n,n_pad", [(2, 0), (5, 1), (8, 3), (65, 8),
                                     (80, 20)])
def test_regularised_solve_matches_jax(n, n_pad):
    """Dead columns (every other system), padded identity rows and
    column scales over 1e-3..1e3.  Beyond 64 modes the reference is the
    JAX package's complex128 regularised solve ``ops.solve.gram_cholesky``
    (the same mask, equilibration and floor, XLA's Cholesky): its
    column-unrolled ``_regularised_solve`` takes minutes to compile
    there and more memory than a test has."""
    G, b = random_hermitian_systems(48, n, seed=10 + n, n_pad=n_pad)
    x = ter._regularised_solve(_t(G), _t(b)).numpy()
    if n <= 64:
        xre, xim = jax.jit(jer._regularised_solve)(*_jax_split(G, b))
        xj = np.asarray(xre) + 1j * np.asarray(xim)
    else:
        xj = np.asarray(jax.jit(jsolve.gram_cholesky)(jnp.asarray(G),
                                                      jnp.asarray(b)))
    assert _rel(x, xj) <= 1e-12
    # Padded slots and dead columns give exactly zero amplitudes.
    assert np.all(x[:, n - n_pad:] == 0) and np.all(xj[:, n - n_pad:] == 0)
    dead = np.abs(np.diagonal(G, axis1=1, axis2=2)) < 1e-40
    assert dead[::2].sum() == 24
    assert np.all(x[dead] == 0) and np.all(xj[dead] == 0)


def test_plain_matches_pallas_ds_math():
    """The Pallas kernel's double-single math (_solve_values), eagerly:
    both solve the same Hermitian systems to <= 1e-11 relative."""
    from qnmfits_tpu.ops.chol_pallas import _solve_values
    from qnmfits_tpu.ops.ds import ds_from_f64
    B, n = 32, 6
    G, b = _well_conditioned(B, n, seed=2)
    args = []
    for Mx in (jnp.transpose(jnp.asarray(G.real), (1, 2, 0)),
               jnp.transpose(jnp.asarray(G.imag), (1, 2, 0))):
        args.extend(ds_from_f64(Mx))
    for v in (jnp.asarray(b.real).T, jnp.asarray(b.imag).T):
        args.extend(ds_from_f64(v))
    rh, rl, ih, il = _solve_values(n, *args)
    x_ds = (np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
            + 1j * (np.asarray(ih, np.float64)
                    + np.asarray(il, np.float64))).T
    x = complex_cholesky_solve_unrolled(_t(G), _t(b)).numpy()
    assert _rel(x, x_ds) <= 1e-11


def test_ill_conditioned_matches_jax_unrolled():
    """Near-singular Grams (one column dead at 1e-30, one sick at 1e-9,
    as tests/test_ops.py builds them) against the JAX solve on
    complex_cholesky_solve_unrolled only: the double-single math is not
    the reference in this regime."""
    rng = np.random.default_rng(6)
    B, J = 8, 5
    M = rng.standard_normal((B, J, 2 * J))
    G = M @ np.swapaxes(M, -1, -2) + np.eye(J)[None]
    scale = np.ones(J)
    scale[2] = 1e-30
    scale[4] = 1e-9
    G = (G * scale[None, :, None] * scale[None, None, :]).astype(complex)
    b = (rng.standard_normal((B, J)) * scale[None, :]) * (1 + 1j)
    x = ter._regularised_solve(_t(G), _t(b)).numpy()
    xre, xim = jer._regularised_solve(*_jax_split(G, b))
    xj = np.asarray(xre) + 1j * np.asarray(xim)
    assert np.all(np.isfinite(x))
    assert np.all(x[:, 2] == 0)
    assert _rel(x, xj) <= 1e-12


def test_cpu_tensors_take_the_plain_version():
    G, b = random_hermitian_systems(16, 6, seed=3)
    chol_cuda.launches = 0
    x = ter._regularised_solve(_t(G), _t(b))
    assert chol_cuda.launches == 0
    assert torch.equal(x, ter._regularised_solve_plain(_t(G), _t(b)))
    with pytest.raises(ValueError, match="CUDA"):
        chol_cuda.regularised_solve(_t(G), _t(b))

