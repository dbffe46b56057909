"""The port's twice-differentiable solve, its batched triangular factor and
inverse, and the bordered free-frequency sweep against the JAX package's,
on the CPU.

Bounds: the solve's gradients against autograd through its plain version
1e-10 relative (and torch.autograd.gradcheck / gradgradcheck); the factor
and inverse 1e-13 relative per window; the bordered sweep and
``mismatch_omega_grid(engine='fast')`` 1e-11 in mismatch (amplitudes
1e-9 relative, as tests/test_batched.py's bordered cases).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qnmfits_tpu import batched as jb
from qnmfits_tpu import engine_real as jer
from qnmfits_tpu import fitting as jf
from qnmfits_tpu.ops import chol as jchol
from qnmfits_tpu.ops.windows import window_closest as jwin_closest
from qnmfits_tpu.ops.windows import window_geq as jwin_geq
from qnmfits_tpu.testing import synthetic_single
import qnmfits_tpu_torch as tq
from qnmfits_tpu_torch import batched as tb
from qnmfits_tpu_torch import engine_real as ter
from qnmfits_tpu_torch.engine import SpectrumEvaluator
from qnmfits_tpu_torch.ops import chol as tchol
from qnmfits_tpu_torch.ops import chol_cuda
from qnmfits_tpu_torch.ops.windows import window_closest, window_geq
from qnmfits_tpu_torch.testing import random_hermitian_systems

MM_TOL = 1e-11
GRAD_RTOL = 1e-10
FACTOR_RTOL = 1e-13


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# ---------------------------------------------------------------------------
# The solve as an autograd function
# ---------------------------------------------------------------------------

def _gradcheck_case(n, dead, pad, seed):
    """A well-conditioned Hermitian system of size n as a function of a
    free (n, n) complex input M: G = (M + M^H) / 2 + n I, with the dead
    column's diagonal (if any) set to 1e-40 (the dead test reads only the
    diagonal, so perturbing the rest keeps it dead) and the last ``pad``
    columns identity padding.  Returns (fn, inputs)."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((2, n, n)) + 1j * rng.standard_normal((2, n, n))
    b0 = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    keep = torch.ones(n, n, dtype=torch.bool)
    live = n - pad
    keep[live:, :] = keep[:, live:] = False
    fixed = torch.eye(n, dtype=torch.complex128)
    if dead is not None:
        keep[dead, dead] = False
        fixed[dead, dead] = 1e-40

    def fn(M, b):
        G = (M + M.mH) / 2 + n * torch.eye(n, dtype=M.dtype)
        G = torch.where(keep, G, fixed)
        b = torch.where(torch.arange(n) < live, b,
                        torch.zeros((), dtype=b.dtype))
        return ter._regularised_solve(G, b)

    return fn, (_t(M0).requires_grad_(True), _t(b0).requires_grad_(True))


@pytest.mark.parametrize("n,dead,pad", [(1, None, 0), (3, None, 1),
                                        (4, 1, 0), (5, 2, 1)])
def test_solve_gradcheck_and_gradgradcheck(n, dead, pad):
    fn, inputs = _gradcheck_case(n, dead, pad, seed=n)
    assert torch.autograd.gradcheck(fn, inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


@pytest.mark.parametrize("n", [1, 5, 8, 17])
def test_solve_gradients_match_plain_autograd(n):
    """Gradient and Hessian-vector product of a real loss of the solution
    through ``RegularisedSolve`` against autograd through the plain
    column-unrolled solve, on the random systems the kernel tests use
    (column scales 1e-3..1e3, dead columns, padding), perturbed along
    Hermitian directions."""
    G0, b0 = random_hermitian_systems(6, n, seed=n, n_pad=n // 4)
    w = torch.linspace(0.5, 1.5, n, dtype=torch.float64)

    def grads(solve):
        M = _t(G0).clone().requires_grad_(True)
        b = _t(b0).clone().requires_grad_(True)
        x = solve((M + M.mH) / 2, b)
        loss = (w * x.abs() ** 2).sum() + x.real.sum()
        gM, gb = torch.autograd.grad(loss, (M, b), create_graph=True)
        # A Hessian-vector product: the second backward.
        hv = torch.autograd.grad((gM.real.sum() + gb.imag.sum()), (M, b))
        return [t.detach() for t in (gM, gb) + hv]

    for a, c in zip(grads(ter._regularised_solve),
                    grads(ter._regularised_solve_plain)):
        assert float((a - c).abs().max()) <= GRAD_RTOL * max(
            float(c.abs().max()), 1e-300)


def test_solve_counts_its_forward_and_backward_solves(monkeypatch):
    """One solve forward, one in the first backward, and two in each
    second backward (the backward's own solve, and the forward's again):
    the count the optimisers' launch arithmetic uses."""
    calls = []
    real = ter._solve_detached
    monkeypatch.setattr(ter, "_solve_detached",
                        lambda G, b: calls.append(1) or real(G, b))
    G0, b0 = random_hermitian_systems(3, 4, seed=1)
    M = _t(G0).requires_grad_(True)
    x = ter._regularised_solve((M + M.mH) / 2, _t(b0))
    assert len(calls) == 1
    g, = torch.autograd.grad((x.abs() ** 2).sum(), M, create_graph=True)
    assert len(calls) == 2
    torch.autograd.grad(g.real.sum(), M)
    assert len(calls) == 4


def test_raw_kernel_wrapper_refuses_grad_tensors():
    """The CUDA wrapper writes through raw pointers: a tensor that
    requires grad, passed around RegularisedSolve, raises before anything
    else is checked (so here on CPU tensors too)."""
    G, b = random_hermitian_systems(2, 3, seed=2)
    G, b = _t(G), _t(b)
    for args in ((G.clone().requires_grad_(True), b),
                 (G, b.clone().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="RegularisedSolve"):
            chol_cuda.regularised_solve(*args)


# ---------------------------------------------------------------------------
# Batched factor and inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 4, 8])
def test_factor_and_inverse_match_jax(n):
    """The batched factor and triangular inverse against the JAX
    package's unbatched scalar-unrolled ones, window by window, on
    equilibrated floored systems like the bordered sweep's."""
    G, _ = random_hermitian_systems(5, max(n, 1), seed=7 + n)
    G = G[:, :n, :n]
    d = np.sqrt(np.abs(np.diagonal(G, axis1=1, axis2=2)))
    A = G / d[:, :, None] / d[:, None, :] + 500 * (n + 1) * 2.2e-16 * np.eye(n)
    L = tchol.complex_cholesky_factor(_t(A))
    X = tchol.complex_lower_inverse(L)
    assert L.shape == X.shape == (5, n, n)
    for i in range(5):
        Lre, Lim = jchol.complex_cholesky_factor(jnp.asarray(A[i].real),
                                                 jnp.asarray(A[i].imag))
        Xre, Xim = jchol.complex_lower_inverse(Lre, Lim)
        if n == 0:
            continue
        assert _rel(L[i], np.asarray(Lre) + 1j * np.asarray(Lim)) \
            <= FACTOR_RTOL
        assert _rel(X[i], np.asarray(Xre) + 1j * np.asarray(Xim)) \
            <= FACTOR_RTOL


# ---------------------------------------------------------------------------
# The bordered sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def syn():
    """A noisy 3-overtone single series, 400 samples."""
    return synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                            noise=1e-4, seed=9,
                            times=np.arange(-10.0, 30.0, 0.1))


@pytest.mark.parametrize("method,t0", [("geq", 2.0), ("closest", 2.03)])
def test_window_scalars_match_jax(syn, method, t0):
    t = syn["times"]
    jwin = jwin_geq if method == "geq" else jwin_closest
    twin = window_geq if method == "geq" else window_closest
    s_j, m_j = jer._window_scalars(jnp.asarray(t), jwin(t, t0, 20.0), t0)
    tt = torch.as_tensor(t)
    t0_t = torch.tensor(t0, dtype=torch.float64)
    s, m = ter._window_scalars(tt, twin(tt, t0_t, 20.0), t0_t)
    assert int(m) == int(m_j) and float(s) == float(s_j)


@pytest.mark.parametrize("n_fixed", [0, 2])
@pytest.mark.parametrize("method,t0", [("geq", 2.0), ("closest", 2.03)])
@pytest.mark.parametrize("analytic", [False, True])
def test_bordered_sweep_matches_jax(syn, n_fixed, method, t0, analytic):
    """sweep_omega_grid_bordered_real, summed and closed-form branches, on
    a grid whose Im axis reaches a growing mode and whose Re axis does
    not divide a_chunk."""
    t, d = syn["times"], syn["data"]
    fixed = SpectrumEvaluator(syn["modes"][:n_fixed]).omega(
        syn["chif"], syn["Mf"]) if n_fixed else np.zeros(0, complex)
    re_axis, im_axis = np.linspace(0.3, 0.8, 7), np.linspace(-0.4, 0.05, 5)
    jwin = jwin_geq if method == "geq" else jwin_closest
    w = np.asarray(jwin(t, t0, 20.0), float)
    Cre, Cim, mm_j = jer.sweep_omega_grid_bordered_real(
        t, d.real, d.imag, fixed.real.copy(), fixed.imag.copy(),
        jnp.asarray(re_axis), jnp.asarray(im_axis), t0, jnp.asarray(w),
        a_chunk=3, analytic=analytic)
    C, mm = ter.sweep_omega_grid_bordered_real(
        _t(t), _t(d), _t(fixed), _t(re_axis), _t(im_axis),
        torch.tensor(t0, dtype=torch.float64),
        _t(w), a_chunk=3, analytic=analytic)
    assert mm.shape == (35,) and C.shape == (35, n_fixed + 1)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=0,
                               atol=MM_TOL)
    C_j = np.asarray(Cre) + 1j * np.asarray(Cim)
    assert _rel(C.numpy(), C_j) <= 1e-9


@pytest.mark.parametrize("n_fixed", [0, 1, 2])
def test_omega_grid_fast_matches_jax(syn, n_fixed):
    """mismatch_omega_grid(engine='fast'), fixed QNMs plus a free mode,
    the Im axis reaching Im w > 0 (as test_omega_grid_matches_jax), and
    its return_amplitudes layout."""
    args = (syn["times"], syn["data"], syn["modes"][:n_fixed], syn["Mf"],
            syn["chif"])
    kw = dict(re_minmax=(0.4, 0.6), im_minmax=(-0.2, 0.05), t0=0.0, T=20.0,
              res=4)
    mm = tq.mismatch_omega_grid(*args, engine="fast", device="cpu", **kw)
    mm_j = jf.mismatch_omega_grid(*args, engine="fast", **kw)
    assert mm.shape == (4, 4) and np.all(np.isfinite(mm))
    np.testing.assert_allclose(mm, mm_j, rtol=0, atol=MM_TOL)
    mm_b = tq.mismatch_omega_grid(*args, engine="batched", device="cpu", **kw)
    np.testing.assert_allclose(mm, mm_b, rtol=0, atol=MM_TOL)
    mm2, C = tb.batch_mismatch_omega_bordered(*args, device="cpu",
                                              return_amplitudes=True, **kw)
    mm2_j, C_j = jb.batch_mismatch_omega_bordered(*args,
                                                  return_amplitudes=True,
                                                  **kw)
    assert C.shape == C_j.shape == (4, 4, n_fixed + 1)
    np.testing.assert_array_equal(mm2, mm)
    assert _rel(C, C_j) <= 1e-9


def test_bordered_grid_raises(syn):
    args = (syn["times"], syn["data"], syn["modes"][:1], syn["Mf"],
            syn["chif"], (0.4, 0.6), (-0.2, -0.05))
    # mesh='auto' with no torch.distributed process group: no silent
    # one-rank mesh.
    with pytest.raises(ValueError, match="init_process_group"):
        tq.mismatch_omega_grid(*args, t0=0.0, engine="fast", mesh="auto",
                               device="cpu")
    with pytest.raises(ValueError, match="init_process_group"):
        tb.batch_mismatch_omega_bordered(*args, t0=0.0, mesh="auto",
                                         device="cpu")
    with pytest.raises(ValueError, match="single data series"):
        tb.batch_mismatch_omega_bordered(
            syn["times"], {(2, 2): syn["data"], (3, 2): syn["data"]},
            syn["modes"][:1], syn["Mf"], syn["chif"], (0.4, 0.6),
            (-0.2, -0.05), t0=0.0, device="cpu")
