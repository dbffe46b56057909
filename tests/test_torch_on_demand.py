"""Modes outside the tables are solved on demand, as the JAX package
solves them (its tables.py:182-250): the port against JAX on one small
table, the track cache, the errors, the device of the solve, the
multiplet root sweep and ``build_tables``, on the CPU.

Bounds: an on-demand row's spline values within 1e-11 of JAX's (the JAX
package's CF runs in 80-bit where its native kernel builds, the port's in
FP64); roots within 1e-11.
"""

import functools

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import build_tables as jbuild
from qnmfits_tpu.spectrum import multiplets as jmultiplets
from qnmfits_tpu.spectrum import tables as jtables
from qnmfits_tpu_torch import engine, fitting, qnm_api
from qnmfits_tpu_torch.spectrum import build_tables as tbuild
from qnmfits_tpu_torch.spectrum import multiplets, solver
from qnmfits_tpu_torch.spectrum import tables as ttables

TOL = 1e-11
MISSING = (3, 1, 0)              # not in the small table below
P = 17


def _arrays(seed=7):
    """A small s = -2 table: 17 spins to 0.6, rows (2, m, 0), m = -2..2,
    random values (the missing row's solve does not read them)."""
    rng = np.random.default_rng(seed)
    chi = solver.default_chi_grid(P, 0.6)
    keys = np.array([(2, m, 0) for m in range(-2, 3)], np.int32)
    M, n_mu = len(keys), 12
    omega = rng.random((M, P)) - 1j * rng.random((M, P))
    A = rng.random((M, P)) + 0j
    mu = rng.random((M, P, n_mu)) + 1j * rng.random((M, P, n_mu))
    return dict(chi=chi, keys=keys, omega=omega, A=A, mu=mu, s=np.int32(-2),
                n_mu=np.int32(n_mu))


def _port_table():
    z = _arrays()
    return ttables.SpectrumTables.from_arrays(z["chi"], z["keys"],
                                              z["omega"], z["mu"], z["s"],
                                              z["n_mu"])


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The port's track cache in tmp_path."""
    monkeypatch.setattr(ttables, "TRACK_CACHE", tmp_path / "port_cache")
    return tmp_path / "port_cache"


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The missing mode solved by both packages on the small table: the
    port's (on the CPU) with its cache in a temporary directory, the JAX
    package's from an .npz with its DATA_DIR moved there too."""
    tmp = tmp_path_factory.mktemp("on_demand")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(ttables, "TRACK_CACHE", tmp / "port_cache")
        mp.setattr(jtables, "DATA_DIR", tmp / "jax_data")
        np.savez(tmp / "small.npz", **_arrays())
        tj = jtables.SpectrumTables(tmp / "small.npz")
        tj.compile_modes([MISSING + (1,)])
        t = _port_table()
        M = len(t.keys)
        with ttables.solve_on("cpu"):
            t.compile_modes([MISSING + (1,)])
    finally:
        mp.undo()
    return dict(t=t, tj=tj, M=M, cache=tmp / "port_cache")


def test_on_demand_row_matches_jax(solved):
    t, tj = solved["t"], solved["tj"]
    assert t.keys[solved["M"]] == MISSING and t.row[MISSING] == solved["M"]
    assert t.omega.shape[0] == solved["M"] + 1 == t.mu.shape[0]
    chis = np.array([0.0, 0.013, 0.31, 0.4471, 0.6])
    for mode in (MISSING + (1,), (3, -1, 0, -1)):     # and its mirror
        w = t.omega_np(t.compile_modes([mode]), chis)
        wj = tj.omega_np(tj.compile_modes([mode]), chis)
        assert np.max(np.abs(w - wj)) <= TOL
    idx = [(3, 1, 3, 1, 0, 1), (4, 1, 3, 1, 0, 1), (2, 1, 3, 1, 0, 1),
           (5, -1, 3, -1, 0, -1)]
    assert np.max(np.abs(t.mu_np(idx, chis) - tj.mu_np(idx, chis))) <= TOL
    # The row is a real (3,1,0) track: Re omega grows with prograde spin.
    w = t.omega[t.row[MISSING]]
    assert np.all(np.diff(w.real) > 0) and np.all(w.imag < 0)


def test_track_cache_written_and_read_back(solved, monkeypatch):
    files = sorted(p.name for p in solved["cache"].iterdir())
    assert files == [f"s-2_l3_m1_n0_P{P}.npz"]
    monkeypatch.setattr(ttables, "TRACK_CACHE", solved["cache"])

    def no_solve(*a, **k):
        raise AssertionError("the cached track was solved again")

    monkeypatch.setattr(solver, "track_mode", no_solve)
    t = _port_table()
    ms = t.compile_modes([MISSING + (1,)])      # no device: the cache serves
    chis = np.linspace(0.0, 0.6, 9)
    t0 = solved["t"]
    assert np.array_equal(t.omega_np(ms, chis),
                          t0.omega_np(t0.compile_modes([MISSING + (1,)]),
                                      chis))


def test_cached_track_of_another_grid_is_solved_again(solved, tmp_path,
                                                      monkeypatch):
    """A cached track serves only the spin grid it was solved on: a file
    of the same name from another grid of as many points (or from before
    the grid was stored) is solved again, and overwritten."""
    name = f"s-2_l3_m1_n0_P{P}.npz"
    z = dict(np.load(solved["cache"] / name))
    seen = []

    def spy(*args, **kw):
        seen.append(torch.device(kw["device"]).type)
        return z["w"], z["A"], z["C"]

    monkeypatch.setattr(solver, "track_mode", spy)
    monkeypatch.setattr(solver, "schwarzschild_seeds",
                        lambda **kw: {(3, 0): 0.6 - 0.09j})
    monkeypatch.setattr(ttables, "TRACK_CACHE", tmp_path)
    stale = [dict(z, chi=0.9 * z["chi"]),
             {k: v for k, v in z.items() if k != "chi"}]
    for arrays in stale:
        np.savez(tmp_path / name, **arrays)
        with ttables.solve_on("cpu"):
            _port_table().compile_modes([MISSING + (1,)])
        assert np.array_equal(np.load(tmp_path / name)["chi"], z["chi"])
    assert seen == ["cpu", "cpu"]
    _port_table().compile_modes([MISSING + (1,)])   # now the cache serves
    assert len(seen) == 2


def test_read_only_cache_still_solves(tmp_path, monkeypatch):
    """A cache that cannot be written does not stop the solve (the JAX
    package's test_read_only_install_still_solves)."""
    def denied(*a, **k):
        raise OSError(30, "Read-only file system")

    monkeypatch.setattr(ttables, "TRACK_CACHE", tmp_path / "ro")
    monkeypatch.setattr(ttables.np, "savez", denied)
    t = _port_table()
    with ttables.solve_on("cpu"):
        w = t.omega_np(t.compile_modes([MISSING + (1,)]), 0.5)[0]
    assert np.isfinite(w) and w.imag < 0
    assert not list((tmp_path / "ro").rglob("*.npz"))


@pytest.mark.parametrize("mode", [(1, 1, 0, 1), (3, 4, 0, 1), (2, 2, -1, 1)])
def test_invalid_mode_raises_at_once(mode, cache, monkeypatch):
    monkeypatch.setattr(solver, "track_mode", None)   # never reached
    with pytest.raises(KeyError, match="invalid mode"), \
            ttables.solve_on("cpu"):
        _port_table().compile_modes([mode])
    with pytest.raises(KeyError, match="invalid mode"):
        _jax_small(cache.parent / "jax").compile_modes([mode])


def _jax_small(tmp):
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "small.npz", **_arrays())
    return jtables.SpectrumTables(tmp / "small.npz")


def test_failed_solve_message_and_other_errors(cache, monkeypatch):
    def fails(*a, **k):
        raise solver.SolveError("fine polish failed: mode (3,1,0)")

    monkeypatch.setattr(solver, "track_mode", fails)
    with pytest.raises(KeyError, match="on-demand solve failed") as err, \
            ttables.solve_on("cpu"):
        _port_table().compile_modes([MISSING + (1,)])
    assert "python -m qnmfits_tpu_torch.spectrum.build_tables" in str(err)
    assert "fine polish failed" in str(err)

    def kernel_fault(*a, **k):
        raise RuntimeError("leaver_cf kernel launch failed: CUDA error 1")

    # Anything but the solver's own failure propagates as it is.
    monkeypatch.setattr(solver, "track_mode", kernel_fault)
    with pytest.raises(RuntimeError, match="launch failed"), \
            ttables.solve_on("cpu"):
        _port_table().compile_modes([MISSING + (1,)])
    assert not list(cache.rglob("*.npz"))


def test_solve_runs_on_the_device_asked_for(solved, monkeypatch, cache):
    """The device of the call that asked for the mode: the one ``solve_on``
    sets (as every entry point does with its own), else the card (which
    raises here, with no card)."""
    seen = []
    z = np.load(solved["cache"] / f"s-2_l3_m1_n0_P{P}.npz")

    def spy(*args, device, **kw):
        seen.append(torch.device(device).type)
        return z["w"], z["A"], z["C"]

    monkeypatch.setattr(solver, "track_mode", spy)
    monkeypatch.setattr(solver, "schwarzschild_seeds",
                        lambda **kw: {(3, 0): 0.6 - 0.09j})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_table().compile_modes([MISSING + (1,)])
    assert seen == []
    with ttables.solve_on("cpu"):
        _port_table().compile_modes([MISSING + (1,)])
    assert seen == ["cpu"]
    for f in cache.iterdir():
        f.unlink()
    # The host qnm class, given a device.
    q = qnm_api.qnm(tables=_port_table(), device="cpu")
    assert np.isfinite(q.omega(3, 1, 0, 1, 0.5))
    assert seen == ["cpu", "cpu"]
    for f in cache.iterdir():
        f.unlink()
    # A qnm given no device solves where the surrounding call asks.
    with ttables.solve_on("cpu"):
        assert np.isfinite(qnm_api.qnm(tables=_port_table()).omega(
            3, 1, 0, 1, 0.5))
    assert seen == ["cpu"] * 3
    for f in cache.iterdir():
        f.unlink()
    # An entry point passes its own device down to the tables.
    small = _port_table()
    monkeypatch.setattr(engine, "default_tables", lambda: small)
    engine._cached_evaluator.cache_clear()
    try:
        times = np.arange(0.0, 20.0, 0.1)
        h = np.exp(-0.1 * times) * np.exp(-0.6j * times)
        fit = fitting.ringdown_fit(times, h, [MISSING + (1,)], 0.95, 0.5,
                                   0.0, device="cpu")
    finally:
        engine._cached_evaluator.cache_clear()
    assert np.isfinite(fit["mismatch"])
    assert seen == ["cpu"] * 4


@pytest.mark.parametrize("args", [
    dict(m=2, center=-2j, chi=0.02, n_inv=8, spread=0.3, ngrid=3, N=3000),
    dict(m=2, center=0.065 - 2.31j, chi=0.02, n_inv=9, spread=0.13, ngrid=3,
         N=3000),
    dict(m=1, center=0.5 - 0.3j, chi=0.3, n_inv=1, spread=0.2, ngrid=3,
         N=1500)])
def test_find_roots_near_matches_jax(args):
    """The multiplet root sweep at small depth: the same roots in the JAX
    package's order of first finding."""
    ref = jmultiplets.find_roots_near(**args)
    got = multiplets.find_roots_near(**args, device="cpu")
    assert len(got) == len(ref) > 0
    assert max(abs(g - r) for g, r in zip(got, ref)) <= TOL


def test_build_matches_jax(tmp_path, monkeypatch):
    """l_max = 2, n_max = 1, 12 spins to 0.6, no l = 2 extension, at reduced
    depths in both packages; the second build reads the track cache."""
    grid = functools.partial(solver.default_chi_grid, chi_max=0.6)
    depth = dict(N_coarse=300, N_fine=600)
    monkeypatch.setattr(jbuild, "DATA_DIR", tmp_path / "jax_data")
    monkeypatch.setattr(jbuild, "default_chi_grid", grid)
    monkeypatch.setattr(jbuild, "track_mode",
                        functools.partial(jbuild.track_mode, **depth))
    monkeypatch.setattr(tbuild, "default_chi_grid", grid)
    monkeypatch.setattr(tbuild, "track_mode",
                        functools.partial(tbuild.track_mode, **depth))
    kw = dict(l_max=2, n_max=1, s=-2, n_chi=12, verbose=False,
              l2_extension=False)
    monkeypatch.setattr(ttables, "TRACK_CACHE", tmp_path / "port_cache")
    ref = np.load(jbuild.build(out=tmp_path / "jax.npz", **kw))
    port = tbuild.build(out=tmp_path / "port.npz", device="cpu", **kw)
    got = np.load(port)
    assert sorted(got.files) == sorted(ref.files)
    for k in ("chi", "keys", "s", "n_mu"):
        assert np.array_equal(got[k], ref[k]), k
    assert np.max(np.abs(got["omega"] - ref["omega"])) <= TOL
    assert np.max(np.abs(got["mu"] - ref["mu"])) <= 1e-10
    assert len(list((tmp_path / "port_cache").iterdir())) == 10
    monkeypatch.setattr(tbuild, "track_mode", None)       # cache only
    again = tbuild.build(device="cpu", **kw)    # beside the track cache
    assert again == tmp_path / "qnm_tables_s-2.npz"
    assert np.array_equal(np.load(again)["omega"], got["omega"])
    t = ttables.SpectrumTables(port)
    assert t.keys == [tuple(k) for k in ref["keys"]]


def test_build_command_line(monkeypatch):
    seen = {}
    monkeypatch.setattr(tbuild, "build", lambda **kw: seen.update(kw))
    tbuild.main(["--lmax", "3", "--nmax", "2", "--s", "0", "--no-l2ext",
                 "--device", "cpu"])
    assert seen == dict(l_max=3, n_max=2, s=0, n_chi=400, n_mu=12,
                        l2_extension=False, device="cpu")


def test_default_cache_is_outside_the_repository(monkeypatch, tmp_path):
    monkeypatch.setattr(ttables, "TRACK_CACHE", None)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert ttables.track_cache_dir() == (tmp_path / "xdg" / "qnmfits_tpu_torch"
                                         / "track_cache")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert ttables.track_cache_dir() == (tmp_path / "home" / ".cache"
                                         / "qnmfits_tpu_torch" / "track_cache")
