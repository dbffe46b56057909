"""The port's spectrum (frequencies, mixing coefficients) against the JAX
package's SpectrumEvaluator, for the bench's 16 mode sets."""

import numpy as np
import pytest

from qnmfits_tpu.engine import SpectrumEvaluator as JaxEvaluator
from qnmfits_tpu.spectrum.tables import DEFAULT_TABLE as JAX_TABLE
from qnmfits_tpu_torch.engine import SpectrumEvaluator, check_spin
from qnmfits_tpu_torch.spectrum.tables import (DEFAULT_TABLE, SpectrumTables,
                                               default_tables)
from qnmfits_tpu_torch.testing import bench_mode_sets

SPH = [(2, 2), (3, 2)]
CHIS = np.linspace(0.0, 0.99, 7)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_bench_mode_sets_are_the_bench_s():
    import bench
    assert bench_mode_sets() == bench._mode_sets()


def test_reads_the_jax_package_table_in_place():
    assert DEFAULT_TABLE.resolve() == JAX_TABLE.resolve()


@pytest.mark.parametrize("si", range(16))
def test_omega_mu_match_jax(si):
    ms = bench_mode_sets()[si]
    ev, ev_j = SpectrumEvaluator(ms, SPH), JaxEvaluator(ms, SPH)
    for chif, Mf in ((0.692, 0.952), (CHIS, 1.0)):
        assert _rel(ev.omega(chif, Mf), ev_j.omega(chif, Mf)) <= 1e-13
        mu, mu_j = ev.mu(chif), np.asarray(ev_j.mu(chif))
        assert mu.shape == mu_j.shape
        assert _rel(mu, mu_j) <= 1e-13
        assert np.array_equal(mu == 0, mu_j == 0)


def test_from_arrays_equals_in_place_loader():
    with np.load(DEFAULT_TABLE) as z:
        t = SpectrumTables.from_arrays(z["chi"], z["keys"], z["omega"],
                                       z["mu"], z["s"], z["n_mu"])
    ms = bench_mode_sets()[15]
    a = SpectrumEvaluator(ms, SPH, tables=t)
    b = SpectrumEvaluator(ms, SPH, tables=default_tables())
    for chif in (0.692, CHIS):
        assert np.array_equal(a.omega(chif, 0.952), b.omega(chif, 0.952))
        assert np.array_equal(a.mu(chif), b.mu(chif))


def test_from_arrays_carries_state_to_both_packages():
    """A small table built from numpy arrays gives both packages the same
    spectrum (the JAX tables take the same arrays as attributes)."""
    from qnmfits_tpu.spectrum import tables as jt
    rng = np.random.default_rng(4)
    chi = np.linspace(0.0, 0.99, 40)
    keys = np.array([[2, 2, 0], [2, -2, 0], [3, 2, 0]])
    omega = (rng.standard_normal((3, 40)) + 1j * rng.standard_normal((3, 40))
             ).cumsum(axis=1) * 0.01 + 0.5 - 0.1j
    mu = rng.standard_normal((3, 40, 4)) + 1j * rng.standard_normal((3, 40, 4))
    t = SpectrumTables.from_arrays(chi, keys, omega, mu, -2, 4)
    tj = jt.SpectrumTables.__new__(jt.SpectrumTables)
    tj.chi, tj.keys, tj.omega, tj.mu = chi, [tuple(k) for k in keys], omega, mu
    tj.s, tj.n_mu, tj._jax = -2, 4, None
    tj.row = {k: i for i, k in enumerate(tj.keys)}
    tj.omega_c = jt._fit_cubic_coeffs(chi, omega)
    tj.mu_c = jt._fit_cubic_coeffs(chi, np.moveaxis(mu, 2, 1))
    modes = [(2, 2, 0, 1), (2, 2, 0, -1), (3, 2, 0, 1)]
    ev = SpectrumEvaluator(modes, SPH, tables=t)
    ev_j = JaxEvaluator(modes, SPH, tables=tj)
    for chif in (0.3, chi[5:9] + 0.001):
        assert _rel(ev.omega(chif), ev_j.omega(chif)) <= 1e-13
        assert _rel(ev.mu(chif), np.asarray(ev_j.mu(chif))) <= 1e-13


def test_missing_mode_and_bad_spin_raise(tmp_path, monkeypatch):
    # A mode past the l = 2 ladder's algebraically special point: the
    # on-demand solve fails at its n = 8 Schwarzschild seed, as the JAX
    # package's does.
    from qnmfits_tpu_torch.spectrum import tables as ttab
    monkeypatch.setattr(ttab, "TRACK_CACHE", tmp_path)
    with pytest.raises(KeyError, match="on-demand solve failed"), \
            ttab.solve_on("cpu"):
        SpectrumEvaluator([(2, 2, 40, 1)])
    with pytest.raises(ValueError, match="chif"):
        check_spin(1.2)
    with pytest.raises(ValueError, match="chif"):
        SpectrumEvaluator([(2, 2, 0, 1)]).omega(-0.1)
    check_spin(np.array([1.2, 0.3]))          # spin arrays are exempt
