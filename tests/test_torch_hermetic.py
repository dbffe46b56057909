"""The port and chip_smoke.py stand alone: they import neither jax nor
qnmfits_tpu, run on the CPU only when asked, and write nothing into the
repository outside build/ and __pycache__/ (phase 11's SXS cache and the
on-demand solver's track cache go outside it)."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Directories left out of the listing: caches, builds, and the JAX
# package's table directory, where its own tests write spline sidecars.
_SKIP_DIRS = {".git", "build", "__pycache__", "chiprun_out"}
_SKIP_PATHS = {os.path.join("qnmfits_tpu", "data")}

_SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "qnmfits_tpu"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, {repo!r})
import qnmfits_tpu_torch
from qnmfits_tpu_torch import (batched, engine, engine_real, filters,
                               fitting, harmonics, optimize, orthonormal,
                               plotting, qnm_api, ref_impl, spatial,
                               parallel, spatial_engine, stability, testing,
                               uncertainty, utils, waveforms)
from qnmfits_tpu_torch.parallel import mesh
from qnmfits_tpu_torch.utils import checkpoint, diagnostics
from qnmfits_tpu_torch.waveforms import base, custom, surrogate, sxs
from qnmfits_tpu_torch.ops import (cf_cuda, chol, chol_cuda, cmath, solve,
                                   sweep_cuda, windows)
from qnmfits_tpu_torch.spectrum import (angular, build_tables, multiplets,
                                        radial, solver, tables)
import chip_smoke

# An on-demand solve on the CPU, its track cache where the environment
# puts it (XDG_CACHE_HOME, outside the repository).
t = tables.SpectrumTables.from_arrays(
    solver.default_chi_grid(9, 0.5), [(2, 2, 0)], [[0.5 - 0.1j] * 9],
    [[[1.0] * 12] * 9], -2, 12)
with tables.solve_on("cpu"):
    ms = t.compile_modes([(3, 1, 0, 1)])
assert t.row[(3, 1, 0)] == 1 and (t.omega_np(ms, 0.4)[0].imag < 0)
assert (tables.track_cache_dir() / "s-2_l3_m1_n0_P9.npz").exists()

problem = chip_smoke.build_problem(**chip_smoke.SMALL)
out = chip_smoke.run_main_path(problem, "cpu")
assert out["mm"].shape == (4, 64) and out["launches"] == 0
assert out["factored_launches"] == out["factored_launches_nodedup"] == (0, 0)
paths = chip_smoke.run_paths(problem, "cpu")
paths += chip_smoke.run_dynamic(problem, "cpu")[0]
paths += chip_smoke.run_optimisers(problem, "cpu")[0]
paths += chip_smoke.run_diagnostics(problem, "cpu")[0]
paths += chip_smoke.run_mapping(problem, "cpu")[0]
paths += chip_smoke.run_waveforms(problem, "cpu")[0]
paths += chip_smoke.run_spectrum(problem, "cpu")[0]
assert len(paths) == 45 and all(p["launches"] == 0 for p in paths)
# Phase 13 on gloo CPU ranks: N1 on one rank (NCCL needs the card), N4 on
# four; the ranks report the JAX modules they loaded (none).
layouts = chip_smoke.run_mesh(problem, "cpu")["layouts"]
assert [(k, v["world"], v["backend"]) for k, v in layouts.items()] == [
    ("N1", 1, "gloo"), ("N4", 4, "gloo")]
assert len(layouts["N1"]["paths"]) == 12 and len(layouts["N4"]["paths"]) == 7
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "qnmfits_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("HERMETIC-OK")
"""


def _listing():
    found = set()
    for root, dirs, files in os.walk(REPO):
        rel = os.path.relpath(root, REPO)
        dirs[:] = [d for d in dirs if d not in _SKIP_DIRS
                   and os.path.normpath(os.path.join(rel, d))
                   not in _SKIP_PATHS]
        found.update(os.path.normpath(os.path.join(rel, f)) for f in files)
    return found


def _track_cache():
    """The JAX package's track cache: the port never writes there."""
    path = os.path.join(REPO, "qnmfits_tpu", "data", "track_cache")
    return sorted(os.listdir(path)) if os.path.isdir(path) else None


def test_port_and_smoke_run_without_jax(tmp_path):
    before = _listing()
    jax_cache = _track_cache()
    # One intra-op thread: at these sizes the script runs as fast alone on
    # one thread as on all, and it does not spin threads for cores that
    # the test workers beside it hold.
    env = dict(os.environ, XDG_CACHE_HOME=str(tmp_path / "xdg"),
               OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _SCRIPT.format(repo=REPO)],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "HERMETIC-OK" in r.stdout
    assert "oracle" in r.stdout            # the phases ran their checks
    assert "40-mode set" in r.stdout and "96-mode set" in r.stdout
    assert "D1 dynamic mode sets" in r.stdout and "D4 fit_events" in r.stdout
    assert "O2 calculate_epsilon_array" in r.stdout and "phase 8" in r.stdout
    assert "S1 amplitude_stability" in r.stdout and "phase 9" in r.stdout
    assert "M2 mapping_mismatch_t0_array" in r.stdout
    assert "U2 amplitude_uncertainty" in r.stdout and "phase 10" in r.stdout
    assert "W1 SXS(8888) through the local SXS-format cache" in r.stdout
    assert "W3 'rotation' against the untilted modes" in r.stdout
    assert "W1 calculate_epsilon ('gradient')" in r.stdout
    assert "phase 11" in r.stdout
    assert "S1 CF kernel vs plain on cpu" in r.stdout
    assert "F1 (2,2,n<4) + on-demand (5,2,8)" in r.stdout
    assert "S2 (2,2,0) s=-2 re-solved" in r.stdout
    assert "S3 (11,2,0) on demand (cpu)" in r.stdout
    assert "S3 (5,5,8) on demand (cpu)" in r.stdout
    assert "phase 12" in r.stdout
    assert "phase 13 N4 sharded_t0_sweep_factored_2d" in r.stdout
    assert "phase 13: the mesh" in r.stdout
    new = _listing() - before
    assert not new, f"files written into the repository: {sorted(new)}"
    # JAX's own tests may add tracks of its 400-spin tables meanwhile; the
    # port's 9-spin track must not be among them.
    after = _track_cache()
    assert not [f for f in (after or []) if f not in (jax_cache or [])
                and "_P9." in f]
    assert (tmp_path / "xdg" / "qnmfits_tpu_torch" / "track_cache"
            / "s-2_l3_m1_n0_P9.npz").exists()


def test_entry_point_without_cuda_raises(monkeypatch):
    import numpy as np
    import qnmfits_tpu_torch as tq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tq.resolve_device()
    times, h = np.arange(0.0, 10.0, 0.1), np.zeros(100, complex)
    modes, t0s = [(2, 2, 0, 1)], np.array([0.0, 1.0])
    chif_t = np.full(len(times), 0.692)
    calls = [
        lambda: tq.mismatch_t0_mode_sets(times, h, [modes], 0.952, 0.692,
                                         t0s),
        lambda: tq.ringdown_fit(times, h, modes, 0.952, 0.692, 0.0),
        lambda: tq.multimode_ringdown_fit(times, {(2, 2): h}, modes, 0.952,
                                          0.692, 0.0),
        lambda: tq.mismatch_t0_array(times, h, modes, 0.952, 0.692, t0s),
        lambda: tq.mismatch_t0_array(times, h, modes, 0.952, 0.692, t0s,
                                     engine="fast"),
        lambda: tq.mismatch_M_chi_grid(times, h, modes, (0.9, 1.0),
                                       (0.6, 0.7), 0.0, res=2),
        lambda: tq.mismatch_omega_grid(times, h, modes, 0.952, 0.692,
                                       (0.4, 0.5), (-0.2, -0.1), 0.0, res=2),
        lambda: tq.mismatch_t0_array(times, h, modes, 0.952, chif_t, t0s),
        lambda: tq.mismatch_t0_array(times, h, modes, 0.952, chif_t, t0s,
                                     engine="fast"),
        lambda: tq.mismatch_t0_mode_sets(times, h, [modes], 0.952, chif_t,
                                         t0s, dynamic=True),
        lambda: tq.fit_events(times, np.stack([h, h]), modes, 0.952, 0.692,
                              t0s),
        lambda: tq.fit_events(times, np.stack([h, h]), modes, 0.952, 0.692,
                              t0s, engine="fast"),
        lambda: tq.mismatch_omega_grid(times, h, modes, 0.952, 0.692,
                                       (0.4, 0.5), (-0.2, -0.1), 0.0, res=2,
                                       engine="fast"),
        lambda: tq.free_frequency_fit_array(times, h, t0s),
        lambda: tq.calculate_epsilon_array(times, h, modes, 0.952, 0.692,
                                           t0s),
        lambda: tq.free_frequency_fit(times, h, 0.0),
        lambda: tq.calculate_epsilon(times, h, modes, 0.952, 0.692, 0.0),
        lambda: tq.mismatch_M_chi_grid(times, h, modes, (0.9, 1.0),
                                       (0.6, 0.7), 0.0, res=2, engine="fast"),
        lambda: tq.mismatch_omega_grid(times, h, modes, 0.952, 0.692,
                                       (0.4, 0.5), (-0.2, -0.1), 0.0, res=2,
                                       engine="fast-full"),
        lambda: tq.rational_filter(times, h, modes, 0.952, 0.692,
                                   t_start=0.0),
        lambda: tq.amplitude_stability(times, h, modes, 0.952, 0.692, t0s),
        lambda: tq.orthonormal_decomposition(times, h, modes, 0.952, 0.692,
                                             0.0),
        lambda: tq.orthonormal_t0_sweep(times, h, modes, 0.952, 0.692, t0s),
        lambda: tq.amplitude_uncertainty(times, h, modes, 0.952, 0.692, 0.0),
        lambda: tq.mode_selection(times, h, [modes, modes + [(2, 2, 1, 1)]],
                                  0.952, 0.692, 0.0),
        lambda: tq.spatial.mapping_multimode_ringdown_fit(
            times, {(2, 2): h}, modes, 0.952, 0.692, 0.0, modes),
        lambda: tq.spatial.mapping_mismatch_t0_array(
            times, {(2, 2): h}, modes, 0.952, 0.692, t0s, modes),
        lambda: tq.spatial.mapping_mismatch_t0_array(
            times, {(2, 2): h}, modes, 0.952, 0.692, t0s, modes,
            engine="fast"),
        lambda: tq.spatial.mapping_mismatch_t0_array(
            times, {(2, 2): h}, modes, 0.952, 0.692, t0s, modes,
            engine="loop"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tq.resolve_device("cpu").type == "cpu"


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_EXP_SCRIPT = r"""
import math, sys
sys.path.insert(0, {repo!r})
import torch
import qnmfits_tpu_torch
x = torch.linspace(-3.0, 0.0, 25664, dtype=torch.float64)
y = torch.exp(x)                       # the first parallel call after import
err = max(abs(v - math.exp(u)) / math.exp(u)
          for u, v in zip(x.tolist(), y.tolist()))
print("EXP-ERR", err)
"""


def test_first_cpu_exp_after_import_is_accurate():
    """A fresh process's first multi-threaded float64 exp on the CPU could
    come back ~3e-9 off (MKL's vector math set up by several threads at
    once, in about one process in ten); importing the port sets it up
    first.  Sixteen fresh processes, eight at a time."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-c", _EXP_SCRIPT.format(repo=REPO)]
    outs = []
    for _ in range(2):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  cwd=REPO, env=env) for _ in range(8)]
        outs += [p.communicate(timeout=120) for p in procs]
    errs = [float(out.split("EXP-ERR")[1]) for out, _ in outs]
    assert max(errs) <= 1e-15, errs
