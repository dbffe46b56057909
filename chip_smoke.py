#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qnmfits_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them.  Phases, one
flushed line each with elapsed seconds:

1. the card's name and power limit (nvidia-smi);
2. the build of the solve kernels (csrc/chol_solve.cu, sm_90a), the
   Leaver CF kernel (csrc/leaver_cf.cu, FP64 and double-double), the
   factored sweep's systems and epilogue kernels (csrc/factored_sweep.cu),
   the angular eig kernel (csrc/angular_eig.cu) and the optimisers'
   window moments kernel (csrc/window_moments.cu, also its phases build),
   one nvcc each,
   started together, from this checkout into build/qnmfits_tpu_torch/,
   and ptxas's registers and spills for each instantiation (no spill
   allowed);
3. the kernels against their plain PyTorch version on the card, on
   random batches with dead columns and padding: the team kernel at every
   n = 1..16, at B = 8208 and at batches that leave partial slabs (B = 1,
   15, 17, 1000), and at B = 131072 for n = 8; the wide kernel at n =
   17..200 on each side of its thresholds (threads a block, stages, shared
   memory or the global workspace) at B = 1, 15, 17, 1000;
   ``ops/solve.gram_cholesky(jitter_scale=)`` through both kernels
   against the same call on the CPU; then the wide
   kernel timed at B = 8208 for n = 17, 40 and 64 beside its bound, its
   plain version and torch.linalg, and at B = 1000 for n = 200 (the
   global workspace) beside its bound and torch.linalg;
4. the main path at the bench's full width (bench.py: K=2001 samples,
   spherical modes (2,2) and (3,2), the 16 mode sets padded to J=8,
   8192 start times on [-5, 46.2], T=100, seed 11) through the public
   ``mismatch_t0_mode_sets``, with and without window dedup: exactly one
   launch each of the factored systems kernel, the solve and the epilogue
   kernel per sweep, finite values of the right shape, the factored
   kernels against their plain versions on the sweep's own inputs (each
   system's G, G2, rhs, rt, dnorm and C within SYSTEMS_RTOL of its
   largest entry, mm within EPILOGUE_TOL for t0 >= 0), the kernel path
   against the plain-solve path and the all-plain path (``all_plain``),
   and a stratified check against the NumPy oracle (ref_impl);
5. the solve kernel on the very systems each sweep gave it (8208 with
   dedup, 131072 without): its backward error, and its device time beside
   its bound, its plain version's and torch.linalg's; the sweep's fits/s;
   the factored kernels on the sweep's own inputs by torch.profiler (the
   call by CUDA events) beside their bounds and their plain versions,
   with the systems kernel's launch plan (``sweep_cuda.plan``: the shared
   or global variant, clusters of 1-8 blocks, dynamic shared bytes a block)
   and registers; the systems kernel with 17 and 40 data rows and on a
   grid of WORKSPACE_K samples (the global workspace) against its plain
   version; and the sweep's profile (warm wall, device busy, idle share,
   kernels a sweep);
6. the rest of the static-spectrum surface at the same width, each path
   through its public entry point with the kernels' launch counts set to
   0 just before it and read just after: the mode-set sweep with 'closest'
   windows; a remnant axis of 8 spins around chif = 0.692, with dedup
   (one launch) and without (one launch per group of the join budget);
   bucket=True; mismatch_t0_array 'fast' and 'batched' on the deepest
   set; ringdown_fit and multimode_ringdown_fit at t0 = 0, 10, 20 (SVD,
   no hand kernel); the (Mf, chif) and free-frequency grids at res = 50;
   sweeps of one-mode, 17-mode, 40-mode and 96-mode sets (the team
   kernel's n = 1, the wide kernel's 17, 40 and 96).  Each is held against
   the same call through the plain solve and against the NumPy oracle, and
   reports its launches and its wall time; the 17-, 40- and 96-mode
   sweeps also against the all-plain route and their factored kernels
   against the plain versions on their own inputs; then the wide kernel on the
   17-, 40- and 96-mode paths' own systems beside its bound, its plain
   version and torch.linalg;
7. the dynamic-spectrum sweeps and the catalog event batch at the same
   width, each through its public entry point with the launch counts
   read as in phase 6, along tracks Mf(t) = linspace(1.02 Mf, Mf, K) and
   chif(t) = linspace(0.60, chif, K): D1 ``mismatch_t0_mode_sets(dynamic=
   True)`` on the 16 sets and 8192 start times (131072 fits, one team
   launch); D2 the 17-mode set on every 16th start time (one wide
   launch); D3 ``mismatch_t0_array`` with the tracks on the deepest set
   and the (2,2) row, 'geq' and 'closest' windows; D4 ``fit_events`` on a
   catalog of 8192 events in the shape of examples/catalog_events.py.
   (engine='fast' runs the very sweep of 'batched' for D3's 'geq' and for
   D4, tests/test_torch_dynamic.py checks that, so each runs once here.)
   Each is held against its plain-solve route and the NumPy oracle; the
   kernel's backward error is gated on D1's and D2's systems; each
   path's solve is timed on its own systems (D1's back to back with the
   main path's systems of the same shape), and its call's device time
   split into Gram/projection products, elementwise work, the solve,
   host-device copies and the rest, with the device's idle share;
8. the optimisers at the same width, each through its public entry point
   with the launch counts read as in phase 6 and held to the count derived
   from the code (``opt_launches``), solve and window-moments launches
   apart: O1 ``free_frequency_fit_array`` on the (2,2) row with the
   overtones (2,2,n=1..3) fixed and one free mode (193 bordered seeds a
   window, then 30 Newton steps, each the order-2 window moments, three
   stacked solves for the fit and its derivatives, and a trial fit from
   the order-0 moments); O2 ``calculate_epsilon_array`` on both rows with
   the (2,2,n<8) ladder (189 seed fits and 5 polished trajectories a
   window); O3 ``mismatch_omega_grid(engine='fast')``, the bordered grid,
   which launches no solve; and the one-window L-BFGS-B paths
   ``calculate_epsilon`` and ``free_frequency_fit`` at t0 = 0, 10, 20
   (two launches an objective evaluation).  Each is held against the same
   call with the plain solve and the plain moments, and its oracle
   (Nelder-Mead, the one-window path, or the NumPy grid); the moments
   kernel against its plain version on O1's and O2's own first order-2
   and order-0 inputs, in the variant the wrapper picks (their grid is
   uniform) and in the general variant forced, and the wrapper's
   (general) variant on a non-uniform copy of O2's order-2 inputs; O1's
   and O2's gradients and Hessians through both routes and against
   autograd, their device-time split, the moments kernel timed in both
   variants on O2's and O1's inputs (and the general variant on O2's
   non-uniform copy) beside its bound and the variant's own, its plain
   version and batched torch.matmul, with a warp's cycles by phase on
   O2's Newton inputs, and the solve on O2's own systems;
9. the diagnostics and the stacked spectrum grids at the same width, each
   through its public entry point with the launch counts read as in phase
   6 and held to the count derived from the code: G1
   ``mismatch_M_chi_grid(engine='fast')`` on both rows with the (2,2,n<8)
   ladder at t0 = 10, Mf in (0.90, 1.00), chif in (0.60, 0.80), at res =
   50 against the NumPy loop and at res = 200 (40000 fits, one launch)
   against 'batched', and with the (2,2,n<4) set at res = 50 against both;
   G2 ``mismatch_omega_grid(engine='fast-full')``, (2,2,n<4) fixed and a
   free mode, res = 200, against 'batched' (and reported against the
   bordered 'fast'); S1 ``amplitude_stability``, the ladder over the 8192
   start times (one launch), its amplitudes against the oracle's fits at
   8 windows; R1 ``orthonormal_t0_sweep`` over the same start times (no
   launch), against ``orthonormal_decomposition`` at 8 windows; U1
   ``amplitude_uncertainty`` and ``mode_selection`` over the ladder's 8
   nested candidates at t0 = 10 on the data with white noise, against
   the NumPy formulas here; F1 ``rational_filter`` on a two-mode series
   (the FFT on the card) against the oracle.  Each path through the solve
   is held against its plain-solve route; the solve is timed on G1's,
   G2's and S1's own systems, and each path's device time split;
10. the spatial mapping at the same grid (K = 2001, 8192 start times,
   T = 100) on data from seed 11 over the (l, 4) spheres l = 4..8: linear
   (4,4,n<4) and (5,4,0) mixed by mu, (2,2,0)x(3,2,0) mixed by Qmu_B (the
   s = 0 table), (2,2,0)^2 with its own amplitude a sphere, white noise of
   1e-4 of max |h|.  M1 (J = 11, the team kernel): the linear modes, the
   unmapped (2,2,0)x(3,2,0) and the mapped (2,2,0)^2 through
   ``spatial.mapping_mismatch_t0_array`` 'fast' with and without dedup
   and 'batched'; M2 (J = 18, the wide kernel): (4,4,n=1..3) with
   (4,4,0), (5,4,0) and (2,2,0)^2 mapped, 'fast' with dedup.  Each is
   held to the launches derived from the code (``mapping_launches``), its
   plain-solve route, the kernel's backward error on its systems, and the
   'loop' engine (serial SVD fits) at 32 start times with t0 >= 0.  Q1:
   Qmu_A/B/D/C on the (l, 4) ladder of the (2,2,0)^2 map at l_max = 8 and
   200 spins in [0, 0.95] against the loop oracle at 5 of them, and Qmu_C
   against its quadrature at one; SKY: M1's fit at t0 = 10 against
   np.linalg.lstsq, its four sky maps and spatial mismatches; U2:
   ``amplitude_uncertainty`` and ``mode_selection`` with
   ``mapping_modes=`` on M1's design at t0 = 10 against the NumPy
   formulas.  The solve is timed on M1's and M2's own systems, and each
   path's device time split;
11. the waveform layer feeding the fits: W1, the BBH fixture
   (tests/data/fixture_bbh_waveform.npz, K = 5001) through
   ``waveforms.SXS(8888, zero_time=(2, 2))`` from an SXS-format cache in a
   temporary directory (where h5py is installed; without it, through the
   loader's `sxs`-package branch with the fixture played back); W2, the
   NRSur7dq4 recording (tests/data/fixture_surrogate.npz, 21 modes, a
   tilted remnant spin) through ``Custom`` with transform='rotation' and
   'dynamic_rotation'; W3, every mode to ellMax = 8 (77) on K = 20001
   samples, Kerr QNMs from seed 11 tilted by a known rotation, through
   ``Custom`` both ways, its 'rotation' gated against the untilted modes.
   Each loader stage's host seconds are reported.  Then on the card: W1's
   main path (the (2,2,n<N) ladders, N = 1..8, 8192 start times, with and
   without dedup), its dynamic sweep on its own Moft / chioft tracks, its
   dynamic, multimode and epsilon fits at t0 = 10 against the JAX
   package's pins; W2's main path (the 16 bench sets on the rotated rows);
   W3's 18-mode sweep on the rotated (2,2), (3,2), (4,2) rows (the wide
   kernel).  Each with its derived launches, against its plain-solve
   route and the oracle (each window held to the larger of the usual
   bound and the normal equations' error at its conditioning, ROADMAP
   C.3: ``gram_bound``), the kernel's backward error gated, and its
   device-time split;
12. the on-demand Kerr spectrum solver, with the track cache in a
   temporary directory: F1, the phase's main path: the bench's (2,2,n<4)
   set with (5,2,8), which the tables lack, through
   ``mismatch_t0_mode_sets`` at the bench's width with dedup, the mode
   solved on the card inside the call (CF launches counted; the Leaver CF
   kernel, csrc/leaver_cf.cu, built in phase 2 beside the solve) and then
   one team launch of the solve, held to its plain-solve route and the
   NumPy oracle; S2 baked rows ((2,2,0), (2,2,7), (3,-3,5), (4,4,0) at
   s = -2, (2,1,0) at s = -1, (0,0,2) at s = 0) re-solved over the
   table's 400 spins, bypassing the table, gated against the rows to chi
   = 0.985 and beyond, each solve's wall split into CF and eig time, and
   where torch.linalg.eigvals of CUDA matrices spends its time; S3 a fresh
   SpectrumTables solving (11,2,0) (the JAX package's pin, 1e-8) and
   (5,5,8) (its ordering checks) on demand; S4 ``multiplet_tracks(m=2)``
   on the table's spins to chi = 0.3 (a subgrid, for time) against its
   (2,2,8..20) rows; F1's and S4's CF kernel time replayed per launch
   shape; S1 the CF kernel against its plain version on random batches
   near real modes (B = 1, 17, 400, 4096 at N = 2000, 8192, 32768), with
   each launch's team and segment, gated relative to |U| + |T| and timed
   beside its bound; S1-X the kernel's double-double variant (spins
   beyond chi = 0.985) against its plain version at the solver's
   near-extremal tiers and retries (B = 1-256, N = 8192-884736), each
   element over ``plan_dd``'s team and blocks, and at every (team, blocks)
   of ``dd_plans``, gated at 1e-17 of |U| + |T|, with one launch's cycles
   by phase, and a batch straddling chi = 0.985 whose FP64 elements are
   bit for bit an FP64-only call; then both
   variants timed on F1's largest launches.  F1 also holds its (5,2,8) to
   no point on the coarse track and, beyond chi = 0.985, to the JAX
   package's 80-bit pins (PIN_528), and counts each solve's double-double
   launches and their seconds by CUDA events.  Every angular eigenproblem
   of these solves runs in the eig kernel (csrc/angular_eig.cu, built in
   phase 2): each solve's eig launches are counted (one an eig call, none
   may be missing), its largest eig call of each mode is held to the
   plain version (eigenvalues as sets within 1e-12 max(1, ||M||_F), the
   selected vector within 1e-10, its residual within 1e-13 ||M||_F), and
   its wall is split into eig and CF (CUDA events around each wrapper
   call) and the rest, the eig calls by stage (the coarse pass, each
   lockstep depth, the rest); the kernel is timed on F1's largest call of
   each mode and on S2's 800-matrix fine-pass step beside
   torch.linalg.eigvals of the same matrices on the card and on a CPU
   copy, and beside its bound;
13. the mesh (``qnmfits_tpu_torch.parallel``): two layouts of ranks
   spawned after phase 2 built the kernels (``testing.run_world``; each
   layout's ranks bounded by MESH_TIMEOUT in all and every collective by
   ``parallel.mesh.TIMEOUT``; a rank that fails fails the run).  N1, one
   rank over NCCL with a file store (no network), every path on a (1, 1)
   mesh: the main path at the bench's width with and without dedup,
   ``mismatch_t0_array(engine='sharded')`` on the deepest set, the
   (Mf, chif) and bordered free-frequency grids at res 50 with
   engine='sharded', ``fit_events`` on the 8192 events, D1's dynamic
   sweep on every 16th start time, O1 on 64 windows and O2 on 16; N4,
   four gloo ranks sharing the card (NCCL refuses two ranks on one
   GPU): the main path, the grids and the events on a (4, 1) mesh, and
   ``sharded_t0_sweep_factored_2d`` (analytic and summation Grams) and
   ``sharded_fit_core`` on a (2, 2) mesh, on the (2,2,n<4) set with both
   rows and K cut to 2000 (the time axis divides by 2).  Every rank's
   results are held to the same call with mesh=None in this process
   (<= 1e-12 in mismatch for t0 >= 0, PRE_TOL before; the optimisers at
   phase 8's bars), and every rank's solve launches to the count derived
   from its block; a ``{"mesh": ...}`` line gives each path's walls and
   launches by rank, its gaps and the backend;
14. a JSON line of the paths, a JSON line describing each kernel, and
   last the JSON ok line.

Any failure raises and exits non-zero before the last line.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

MF, CHIF = 0.952, 0.692
SPH = [(2, 2), (3, 2)]
# bench.py's problem, and phase 7's catalog in the shape of
# examples/catalog_events.py; SMALL is the same shape of problem cut to
# CPU size.
FULL = dict(t_range=(-50.0, 150.05), n_t0=8192, t0_range=(-5.0, 46.2),
            T=100.0, sets=tuple(range(16)), res=50, spins=8, events=8192,
            event_t=(-5.0, 95.0), event_T=80.0, opt_maxiter=30,
            grid_res=200, qmu_spins=200, map_loop=32, wave_t0=8192,
            wave_dyn_t0=513, w3_ell=8, w3_K=20001,
            cf_batches=(1, 17, 400, 4096), cf_depths=(2000, 8192, 32768),
            cf_dd_shapes=((1, 8192), (2, 16384), (24, 32768), (256, 8192),
                          (2, 98304), (6, 294912), (2, 884736),
                          (256, 884736)),
            resolve_rows=6, resolve_stride=1, multiplet_chi_max=0.3,
            spectrum_chi=None, mesh_opt=(64, 16))
SMALL = dict(t_range=(-10.0, 30.05), n_t0=64, t0_range=(-2.0, 10.0),
             T=20.0, sets=(1, 3, 9, 13), res=6, spins=3, events=48,
             event_t=(-5.0, 35.0), event_T=25.0, opt_maxiter=8, grid_res=8,
             qmu_spins=8, map_loop=8, wave_t0=64, wave_dyn_t0=17, w3_ell=4,
             w3_K=2001, cf_batches=(1, 17), cf_depths=(300, 700),
             cf_dd_shapes=((2, 300), (5, 700)), resolve_rows=1,
             resolve_stride=40, multiplet_chi_max=None,
             spectrum_chi=tuple(sorted({*np.linspace(0.0, 0.75, 51).round(6),
                                        0.68, 0.692, 0.7})), mesh_opt=(8, 4))
STRATA = (-5.0, -1.0, 0.5, 2.5, 10.0, 25.0, 40.0)     # bench.py:160-179

MAIN_TOL = 1e-11      # kernel path vs plain-solve path, |mismatch| abs
# The same for t0 < 0, where windows start before the ringdown and the
# Grams are ill-conditioned up to the floor's cap: two backward-stable
# solvers differ there by ~1e-9, and the oracle itself moves ~1e-7.
PRE_TOL = 1e-8
ORACLE_TOL = 1e-10    # vs the NumPy oracle for t0 >= 0, |mismatch| abs
KERNEL_RTOL = 1e-12   # kernel vs plain solve, per-system relative
# The factored sweep's kernels vs their plain versions on the same inputs:
# each system's G, G2, rhs, rt, dnorm and C relative to its largest entry
# (sums taken in another order), and the mismatch for t0 >= 0, absolute;
# before the ringdown, and everywhere, mm within ``epilogue_bound``.
SYSTEMS_RTOL = 1e-12
EPILOGUE_TOL = 1e-12
# Normwise backward error of the kernel's solutions on the main path's
# own systems.  A stable solve reads ~n eps; a kernel that drops the
# 500 J eps floor reads ~floor / ||A|| ~ 9e-13, so this bound sees it.
KERNEL_BWD_TOL = 1e-14

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and FP64 (67 TFLOP/s
# on the tensor cores; 34 outside them, where this kernel runs: the card's
# peak gives the least time).  They assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12


def log(msg):
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", flush=True)


def build_problem(t_range, n_t0, t0_range, T, sets, res=6, spins=3,
                  events=48, event_t=(-5.0, 35.0), event_T=25.0,
                  opt_maxiter=8, grid_res=8, qmu_spins=8, map_loop=8,
                  wave_t0=64, wave_dyn_t0=17, w3_ell=4, w3_K=2001,
                  cf_batches=(1, 17), cf_depths=(300, 700),
                  cf_dd_shapes=((2, 300),), resolve_rows=1,
                  resolve_stride=40, multiplet_chi_max=None,
                  spectrum_chi=None, mesh_opt=(8, 4)):
    """The bench problem: a synthetic (2,2,n<8) ringdown with mixing
    into (2,2) and (3,2), sampled at 0.1 M; with the grid resolution and
    the number of remnant spins of phase 6, the remnant tracks and the
    catalog of phase 7, the Newton steps of phase 8, the stacked grids'
    resolution of phase 9, phase 10's spins of the Qmu axis and start
    times of the 'loop' oracle, phase 11's start times (of the main
    paths, and of the dynamic and wide sweeps) and W3's ellMax and
    samples, and phase 12's CF batches and depths (and the double-double
    variant's (batch, depth) pairs), its number of re-solved
    rows and their spin stride, the multiplets' largest spin (None: S4
    not run) and the spins of its tables (None: the tracked tables' 400;
    a few spins up to past CHIF cut S3 and F1's on-demand solves to CPU
    size), and phase 13's windows of O1 and O2.  The arguments are kept
    (``build_kw``): phase 13's ranks rebuild the problem from them."""
    build_kw = dict(locals())
    from qnmfits_tpu_torch.testing import (bench_mode_sets,
                                           synthetic_multimode)
    times = np.arange(*t_range, 0.1)
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(8)],
                              spherical_modes=SPH, Mf=MF, chif=CHIF,
                              times=times, seed=11)
    all_sets = bench_mode_sets()
    K = len(times)
    return dict(times=times, data=syn["data_dict"],
                mode_sets=[all_sets[i] for i in sets],
                t0s=np.linspace(*t0_range, n_t0), T=T, res=res,
                spins=np.linspace(CHIF - 0.03, CHIF + 0.03, spins),
                Mf_t=np.linspace(1.02 * MF, MF, K),
                chif_t=np.linspace(0.60, CHIF, K),
                catalog=build_catalog(events, event_t, event_T),
                opt_maxiter=opt_maxiter, grid_res=grid_res,
                qmu_spins=qmu_spins, map_loop=map_loop, wave_t0=wave_t0,
                wave_dyn_t0=wave_dyn_t0, w3_ell=w3_ell, w3_K=w3_K,
                cf_batches=cf_batches, cf_depths=cf_depths,
                cf_dd_shapes=cf_dd_shapes, resolve_rows=resolve_rows,
                resolve_stride=resolve_stride,
                multiplet_chi_max=multiplet_chi_max,
                spectrum_chi=spectrum_chi, mesh_opt=mesh_opt,
                build_kw=build_kw)


EVENT_MODES = [(2, 2, n, 1) for n in range(4)]


def build_catalog(E, t_range, T, seed=42):
    """A catalog in the shape of examples/catalog_events.py: E events on
    one grid of 0.1 M steps, each a (2,2,n<4) ringdown with its own
    remnant, Mf ~ U(0.90, 0.99), chif ~ U(0.45, 0.85), amplitudes scaled
    1, 0.5, 0.2, 0.1, complex noise of 2e-5, and its own start time t0 ~
    U(0, 6); window length T."""
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    rng = np.random.default_rng(seed)
    times = np.arange(*t_range, 0.1)
    Mfs = rng.uniform(0.90, 0.99, E)
    chifs = rng.uniform(0.45, 0.85, E)
    t0s = rng.uniform(0.0, 6.0, E)
    omegas = SpectrumEvaluator(EVENT_MODES).omega(chifs, Mfs).T     # (E, J)
    amps = ((rng.standard_normal((E, 4)) + 1j * rng.standard_normal((E, 4)))
            * np.array([1.0, 0.5, 0.2, 0.1]))
    tpos = np.maximum(times, 0.0)
    rows = np.zeros((E, len(times)), complex)
    for j in range(4):
        rows += amps[:, j:j + 1] * np.exp(-1j * omegas[:, j:j + 1] * tpos)
    rows[:, times < 0] = 0.0
    rows += 2e-5 * (rng.standard_normal(rows.shape)
                    + 1j * rng.standard_normal(rows.shape))
    return dict(times=times, rows=rows, Mfs=Mfs, chifs=chifs, t0s=t0s, T=T)


def sweep(problem, device, dedup, solve=None):
    """The mode-set sweep: the public entry point, or the batched layer
    under it when a solve is substituted."""
    from qnmfits_tpu_torch import batched, mismatch_t0_mode_sets
    args = (problem["times"], problem["data"], problem["mode_sets"], MF,
            CHIF, problem["t0s"])
    kw = dict(T_array=problem["T"], spherical_modes=SPH, dedup=dedup,
              device=device)
    if solve is None:
        return mismatch_t0_mode_sets(*args, **kw)
    return batched.batch_mismatch_t0_modesets(*args, solve=solve, **kw)


def oracle_diff(problem, mm, mode_sets, chif=CHIF, t0_method="geq",
                sets_axis=None, Mf=MF, t0s=None, data=None):
    """max |mm - oracle| over the mode sets x the t0 STRATA, for t0 >= 0
    and for t0 < 0: mm (S, B) against ref_impl.fit_dispatch (the
    multimode fit for the problem's data; a dynamic fit where Mf/chif are
    tracks).  ``sets_axis`` picks which sets to check (all by default);
    ``t0s`` (the problem's by default) are mm's start times and ``data``
    a substitute for the problem's data."""
    from qnmfits_tpu_torch import ref_impl
    t0s = problem["t0s"] if t0s is None else t0s
    data = problem["data"] if data is None else data
    dev_in, dev_pre = 0.0, 0.0
    for si in (range(len(mode_sets)) if sets_axis is None else sets_axis):
        for t0_val in STRATA:
            if not t0s[0] <= t0_val <= t0s[-1]:
                continue
            i = int(round((t0_val - t0s[0]) / (t0s[-1] - t0s[0])
                          * (len(t0s) - 1)))
            ref = ref_impl.fit_dispatch(
                problem["times"], data, mode_sets[si], Mf, chif,
                float(t0s[i]), t0_method, problem["T"], SPH)
            d = abs(float(mm[si, i]) - ref["mismatch"])
            if t0_val >= 0.0:
                dev_in = max(dev_in, d)
            else:
                dev_pre = max(dev_pre, d)
    return dev_in, dev_pre


class PlainSolve:
    """The plain-solve route: the kernels' plain PyTorch version (through
    which autograd differentiates, on a differentiable path), keeping the
    systems of every call (the same systems the kernel route solves)."""

    def __init__(self):
        self.systems = []

    def __call__(self, G, b):
        from qnmfits_tpu_torch import engine_real
        self.systems.append((G.detach(), b.detach()))
        return engine_real._regularised_solve_plain(G, b)


@contextlib.contextmanager
def all_plain():
    """The all-plain route: inside it the factored sweep's systems and
    epilogue run their plain PyTorch versions on the card (with a
    PlainSolve, every stage of the sweep is plain).  The port's wrappers
    never do that themselves; this script swaps the module's functions
    for the comparison and puts them back."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    saved = sweep_cuda.factored_systems, sweep_cuda.mismatch_rephase
    sweep_cuda.factored_systems = sweep_cuda.factored_systems_plain
    sweep_cuda.mismatch_rephase = sweep_cuda.mismatch_rephase_plain
    try:
        yield
    finally:
        sweep_cuda.factored_systems, sweep_cuda.mismatch_rephase = saved


@contextlib.contextmanager
def recording_sweeps():
    """Keeps the arguments and results of every call of the factored
    sweep's two wrappers made inside it: {"systems": [(args, out)],
    "epilogue": [(args, out)]}; the calls themselves are unchanged."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    calls = {"systems": [], "epilogue": []}
    saved = sweep_cuda.factored_systems, sweep_cuda.mismatch_rephase

    def keep(key, fn):
        def call(*args):
            out = fn(*args)
            calls[key].append((args, out))
            return out
        return call

    sweep_cuda.factored_systems = keep("systems", saved[0])
    sweep_cuda.mismatch_rephase = keep("epilogue", saved[1])
    try:
        yield calls
    finally:
        sweep_cuda.factored_systems, sweep_cuda.mismatch_rephase = saved


def epilogue_bound(C0, G2, rt, mm):
    """How far two orders of summation may move each mm = 1 - num /
    sqrt(model dnorm) of the epilogue: (1 - mm) times num's and half
    model's relative rounding, each 4 n eps times its sum of magnitudes
    over its value (n = J and J^2 terms).  Ill-conditioned fits (windows
    before the ringdown, random systems) are where these sums cancel."""
    J = C0.shape[-1]
    eps = float(np.finfo(float).eps)
    num = (C0.conj() * rt).real.sum(-1)
    model = (C0.conj() * (G2 @ C0[..., None])[..., 0]).real.sum(-1)
    num_abs = (C0.abs() * rt.abs()).sum(-1)
    model_abs = (C0.abs()[..., :, None] * G2.abs()
                 * C0.abs()[..., None, :]).sum((-2, -1))
    return 4 * (1 + (1 - mm).abs()) * (J * eps * num_abs / num.abs()
                                       + J * J * eps * model_abs
                                       / model.abs())


def first_order_gaps(calls_a, calls_b, solves=2):
    """Two runs of one factored sweep (``recording_sweeps`` of each, the
    same join groups): per window, the gap between their mismatches and
    how far rounding can move it, to first order, from route a's systems.

    The solve works on the equilibrated, floored system A z = b' (A = Di G
    Di + floor, b' = Di b, C = Di z).  With N = Re C^H rt, Q = Re C^H G2 C
    and n = dnorm, mm = 1 - N / sqrt(Q n) has the gradient in C
        g = -rt / sqrt(Q n) + N G2 C / (sqrt(n) Q^(3/2)),
    so a change (dA, db') of the solve's input moves mm by at most
    |A^-1 Di g| (|dA| |z| + |db'|) (2-norms), and changes of rt, G2 and n
    at the same C move it by |dN| / sqrt(Q n) + N |dQ| / (2 sqrt(n)
    Q^(3/2)) + |N dn| / (2 sqrt(Q) n^(3/2)).  The changes counted are
    ``solves`` backward-stable solves, each J eps (|A| |z| + |b'|), the
    measured difference of the two runs' systems (dA = Di dG Di, db' = Di
    db, dN, dQ, dn), and each run's epilogue sums (``epilogue_bound``).
    A is ill-conditioned where the design is (ROADMAP C.3): |A^-1 Di g|
    carries the window's measured conditioning, where ``gram_bound``
    takes the worst direction of kappa(A)^2.  Returns one dict a group:
    gap, bound (S, B), live (S,) columns a set and t0s (B,)."""
    import torch
    from qnmfits_tpu_torch import engine_real
    eps = float(np.finfo(float).eps)
    out = []
    for (sa, ea), (sb, eb) in zip(zip(calls_a["systems"],
                                      calls_a["epilogue"]),
                                  zip(calls_b["systems"],
                                      calls_b["epilogue"])):
        G, G2, rhs, rt, dn = sa[1]
        dG, dG2, drhs, drt, ddn = (y - x for x, y in zip(sa[1], sb[1]))
        C0, mm = ea[0][0], ea[1][1]
        mm_b = eb[1][1]
        J = G.shape[-1]
        A, bs, Di = engine_real._equilibrated(G, rhs)
        z = C0 / Di
        G2C = (G2 @ C0[..., None])[..., 0]
        N = (C0.conj() * rt).real.sum(-1)
        Q = (C0.conj() * G2C).real.sum(-1)
        n = dn[None, :]
        g = (-rt / torch.sqrt(Q * n)[..., None]
             + (N / (torch.sqrt(n) * Q ** 1.5))[..., None] * G2C)
        y = torch.linalg.solve(A, (Di * g)[..., None])[..., 0]
        vn = torch.linalg.vector_norm
        z_n = vn(z, dim=-1)
        dA = dG * Di[..., :, None] * Di[..., None, :]
        solve_in = (solves * J * eps
                    * (torch.linalg.matrix_norm(A, ord=2) * z_n
                       + vn(bs, dim=-1))
                    + torch.linalg.matrix_norm(dA, ord=2) * z_n
                    + vn(Di * drhs, dim=-1))
        dN = (C0.conj() * drt).real.sum(-1)
        dQ = (C0.conj() * (dG2 @ C0[..., None])[..., 0]).real.sum(-1)
        bound = (vn(y, dim=-1) * solve_in
                 + dN.abs() / torch.sqrt(Q * n)
                 + N.abs() * dQ.abs() / (2 * torch.sqrt(n) * Q ** 1.5)
                 + (N * ddn[None, :]).abs() / (2 * torch.sqrt(Q) * n ** 1.5)
                 + 2 * epilogue_bound(C0, G2, rt, mm))
        out.append(dict(gap=(mm - mm_b).abs(), bound=bound,
                        live=sa[0][6].sum(-1), t0s=sa[0][4]))
    return out


def bounded_gap(groups, sets, side):
    """Over the windows of ``first_order_gaps``'s groups on one side of
    the ringdown (side "in": t0 >= 0, "pre": t0 < 0) of the sets with a
    True in ``sets`` (a function of each set's live columns): the largest
    gap, the largest bound, and the largest gap over max(tol, bound) with
    tol = MAIN_TOL or PRE_TOL (the check holds where it is <= 1).  NaN
    mismatches (empty windows, both runs alike) count as no gap."""
    import torch
    tol = MAIN_TOL if side == "in" else PRE_TOL
    gap = bound = ratio = 0.0
    for grp in groups:
        on_side = (grp["t0s"] >= 0) == (side == "in")
        sel = sets(grp["live"])[:, None] & on_side[None, :]
        g = torch.nan_to_num(grp["gap"], nan=0.0)[sel]
        b = torch.nan_to_num(grp["bound"], nan=0.0)[sel]
        if g.numel():
            gap, bound = max(gap, float(g.max())), max(bound, float(b.max()))
            ratio = max(ratio, float((g / b.clamp_min(tol)).max()))
    return gap, bound, ratio


def per_system_rel(x, ref, lead):
    """Largest |x - ref| of a system over its largest |ref|, over the
    systems: the first ``lead`` axes index them."""
    d = (x - ref).abs().reshape(*ref.shape[:lead], -1).amax(-1)
    r = ref.abs().reshape(*ref.shape[:lead], -1).amax(-1)
    return float((d / r.clamp_min(1e-300)).max())


def run_main_path(problem, device):
    """Phase 4: drive the public sweep with and without dedup, count the
    launches of the solve kernel and of the factored sweep's two kernels
    in each, hold the factored kernels to their plain versions on the
    sweep's own inputs, and check the results against the plain-solve
    route, the all-plain route and the NumPy oracle.  Returns a dict of
    what it found; raises on any failure."""
    from qnmfits_tpu_torch.ops import chol_cuda, sweep_cuda

    S, B = len(problem["mode_sets"]), len(problem["t0s"])
    out = {}
    for dedup in (True, False):
        chol_cuda.launches = chol_cuda.wide_launches = 0
        sweep_cuda.systems_launches = sweep_cuda.epilogue_launches = 0
        with recording_sweeps() as calls:
            mm = sweep(problem, device, dedup)
        n_launch = chol_cuda.launches
        n_fac = (sweep_cuda.systems_launches, sweep_cuda.epilogue_launches)
        if chol_cuda.wide_launches:
            raise RuntimeError("the main path launched the wide kernel")
        if mm.shape != (S, B) or not np.all(np.isfinite(mm)):
            raise RuntimeError(f"main path (dedup={dedup}) gave shape "
                               f"{mm.shape} or non-finite mismatches")
        if device != "cpu" and (n_launch, *n_fac) != (1, 1, 1):
            raise RuntimeError(f"main path (dedup={dedup}) launched the CUDA "
                               f"solve kernel {n_launch} times and the "
                               f"factored sweep's kernels {n_fac}, not once "
                               "each")
        if (len(calls["systems"]), len(calls["epilogue"])) != (1, 1):
            raise RuntimeError(f"main path (dedup={dedup}) made "
                               f"{len(calls['systems'])} systems and "
                               f"{len(calls['epilogue'])} epilogue calls")
        out[dedup] = dict(mm=mm, launches=n_launch, factored=n_fac,
                          calls=calls)
    log(f"main path: mm {out[True]['mm'].shape}, launches of the solve, "
        f"systems and epilogue kernels {out[True]['launches']}, "
        f"{out[True]['factored']} with dedup, {out[False]['launches']}, "
        f"{out[False]['factored']} without")

    pre = problem["t0s"] < 0

    def diff(a, b):
        """max |a - b| over t0 >= 0 and over t0 < 0 (windows that start
        before the ringdown sit at their own conditioning floor, where
        two correct solvers differ by more)."""
        d = np.abs(a - b)
        return float(np.max(d[:, ~pre])), float(np.max(d[:, pre],
                                                        initial=0.0))

    checks, systems = {}, {}
    for dedup in (True, False):
        plain = PlainSolve()
        mm_plain = sweep(problem, device, dedup, solve=plain)
        checks[f"kernel vs plain solve (dedup={dedup})"] = diff(
            out[dedup]["mm"], mm_plain)
        if len(plain.systems) != 1:
            raise RuntimeError(f"the sweep (dedup={dedup}) called its solve "
                               f"{len(plain.systems)} times, not once")
        systems[dedup] = plain.systems[0]
        with all_plain():
            mm_all = sweep(problem, device, dedup, solve=PlainSolve())
        checks[f"kernels vs the all-plain route (dedup={dedup})"] = diff(
            out[dedup]["mm"], mm_all)
    checks["dedup vs per-t0"] = diff(out[True]["mm"], out[False]["mm"])
    for name, (d_in, d_pre) in checks.items():
        log(f"{name}: max |d mm| t0 >= 0: {d_in:.3e} (bound "
            f"{MAIN_TOL:.0e}); t0 < 0: {d_pre:.3e} (bound {PRE_TOL:.0e})")
        if not (d_in <= MAIN_TOL and d_pre <= PRE_TOL):
            raise RuntimeError(f"{name} disagree beyond {MAIN_TOL:.0e} "
                               f"(t0 >= 0) or {PRE_TOL:.0e} (t0 < 0)")

    factored = {}
    for dedup in (True, False):
        f = factored[dedup] = factored_vs_plain(out[dedup]["calls"])
        log(f"factored kernels vs plain on the main path's inputs "
            f"(dedup={dedup}, B={f['windows']} windows x S={S}): systems "
            + ", ".join(f"{k} {v:.3e}" for k, v in f["systems_rel"].items())
            + f" (relative to each system's largest entry, bound "
            f"{SYSTEMS_RTOL:.0e}); epilogue C {f['C_rel']:.3e} (relative, "
            f"bound {SYSTEMS_RTOL:.0e}), mm {f['mm_abs']:.3e} for t0 >= 0 "
            f"(bound {EPILOGUE_TOL:.0e}), {f['mm_abs_pre']:.3e} for t0 < 0 "
            "(each within its summation's rounding, epilogue_bound)")

    dev_in, dev_pre = oracle_diff(problem, out[True]["mm"],
                                  problem["mode_sets"])
    log(f"oracle (NumPy lstsq), {S} sets x strata {STRATA}: max |d mm| "
        f"t0 >= 0: {dev_in:.3e} (bound {ORACLE_TOL:.0e}); t0 < 0: "
        f"{dev_pre:.3e} (reported, conditioning floor)")
    if not dev_in <= ORACLE_TOL:
        raise RuntimeError("main path disagrees with the NumPy oracle")
    return dict(launches=out[True]["launches"],
                launches_nodedup=out[False]["launches"],
                factored_launches=out[True]["factored"],
                factored_launches_nodedup=out[False]["factored"],
                mm=out[True]["mm"], systems=systems,
                sweep_calls={d: out[d]["calls"] for d in (True, False)},
                factored=factored, checks=checks,
                oracle_in=dev_in, oracle_pre=dev_pre)


def factored_vs_plain(calls):
    """The factored sweep's two kernels against their plain versions on
    the inputs one sweep gave them (``recording_sweeps``): G, G2, rhs, rt
    and dnorm relative to each system's largest entry (SYSTEMS_RTOL), C
    relative per system and mm absolute (EPILOGUE_TOL) on the same C0.
    Raises beyond the bounds."""
    import torch
    from qnmfits_tpu_torch.ops import sweep_cuda
    (args, got), = calls["systems"]
    ref = sweep_cuda.factored_systems_plain(*args)
    rel = {name: per_system_rel(x, r, 2 if r.dim() > 1 else 1)
           for name, x, r in zip(("G", "G2", "rhs", "rt", "dnorm"), got,
                                 ref)}
    max_abs = max(float((x - r).abs().max()) for x, r in zip(got, ref))
    (eargs, (C, mm)), = calls["epilogue"]
    C_ref, mm_ref = sweep_cuda.mismatch_rephase_plain(*eargs)
    C_rel = per_system_rel(C, C_ref, 2)
    nan = torch.isnan(mm_ref)
    gap = torch.where(nan, 0.0, (mm - mm_ref).abs())
    bound = epilogue_bound(eargs[0], eargs[1], eargs[2], mm_ref)
    pre = eargs[5] < 0
    mm_in = float(torch.where(pre, 0.0, gap).max())
    mm_pre = float(torch.where(pre, gap, 0.0).max())
    if not (max(rel.values()) <= SYSTEMS_RTOL and C_rel <= SYSTEMS_RTOL
            and torch.equal(nan, torch.isnan(mm)) and mm_in <= EPILOGUE_TOL
            and bool((gap <= torch.where(nan, 0.0, bound)).all())):
        raise RuntimeError(f"factored kernels vs plain: systems {rel}, C "
                           f"{C_rel:.3e}, mm {mm_in:.3e} (t0 >= 0), "
                           f"{mm_pre:.3e} (t0 < 0)")
    return dict(windows=args[4].shape[0], systems_rel=rel, C_rel=C_rel,
                mm_abs=mm_in, mm_abs_pre=mm_pre, max_abs_err=max_abs,
                epilogue_max_abs_err=max(float((C - C_ref).abs().max()),
                                         float(gap.max())))


# Data rows beyond a pass of the systems kernel's 16 columns: a mode's
# rows then take several passes, its mixing added up over them.
WIDE_ROWS = (17, 40)
# A grid long enough that the systems kernel's tile sums leave shared
# memory for its global workspace (``sweep_cuda.plan``), with 2 rows.
WORKSPACE_K = 40001


def check_factored_rows(device, K=2001, S=2, J=8, B=64, chunk=16):
    """The systems kernel against its plain version on random inputs
    (``testing.random_factored_sweep``) with WIDE_ROWS data rows, and with
    2 rows on a grid of WORKSPACE_K samples, which takes the global
    workspace; each system relative to its largest entry (SYSTEMS_RTOL).
    Returns {case: largest relative gap}; raises beyond the bound or when
    the long grid's launch kept its tile sums in shared memory."""
    import torch
    from qnmfits_tpu_torch.ops import sweep_cuda
    from qnmfits_tpu_torch.testing import random_factored_sweep
    found = {}
    for I, K_ in [(I, K) for I in WIDE_ROWS] + [(2, WORKSPACE_K)]:
        r = random_factored_sweep(K_, I, S, J, B, seed=I, n_pad=1)
        args = [torch.as_tensor(r[k], device=device) for k in
                ("times", "data", "omegas", "mus", "t0s", "Ts", "col_masks")]
        got = sweep_cuda.factored_systems(*args, chunk)
        ref = sweep_cuda.factored_systems_plain(*args, chunk)
        key = f"{I} rows" if K_ == K else f"K={K_} ({I} rows, workspace)"
        found[key] = max(per_system_rel(x, y, 2 if y.dim() > 1 else 1)
                         for x, y in zip(got, ref))
        if not found[key] <= SYSTEMS_RTOL:
            raise RuntimeError(f"factored systems kernel, {key}, vs plain: "
                               f"{found[key]:.3e} > {SYSTEMS_RTOL:.0e}")
        if device != "cpu" and (K_ == K) != (
                sweep_cuda.last_plan["variant"] == "shared"):
            raise RuntimeError(f"factored systems kernel, {key}: the "
                               f"{sweep_cuda.last_plan['variant']} variant")
    log("factored systems kernel vs plain: "
        + ", ".join(f"{k} {v:.3e}" for k, v in found.items())
        + f" (relative per system, bound {SYSTEMS_RTOL:.0e})")
    return found


def solve_flops(n):
    """FP64 operations of one regularised solve of size n, as the kernel
    does them: scaling of the lower triangle, the Cholesky's complex
    multiply-subtracts and column scaling, two substitutions, unscaling."""
    scale = 2 * n * (n + 1) + 2 * n
    chol = sum(8 * (n - j) * j + 2 * (n - j) for j in range(n))
    subs = 2 * sum(8 * j + 2 for j in range(n)) + 2 * n
    return scale + chol + subs


def bound_ms(batch, n):
    """Least time the card could take: the larger of the bytes moved
    (the lower triangle of G and b read once, x written once; the solve
    reads nothing above G's diagonal) over HBM bandwidth and the FP64
    operations over the FP64 peak.  Returns (ms, 'bytes'|'operations')."""
    t_bytes = batch * (n * (n + 1) // 2 + 2 * n) * 16 / HBM_BYTES_PER_S
    t_ops = batch * solve_flops(n) / FP64_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def rel_err(x, ref):
    """Largest per-system relative error ||x - ref||_inf / ||ref||_inf."""
    num = (x - ref).abs().amax(dim=-1)
    den = ref.abs().amax(dim=-1).clamp_min(1e-300)
    return float((num / den).max())


# Timings for which torch.profiler recorded no device time, even after a
# retry, and CUDA events stood in (reported in the kernels' JSON).
EVENT_TIMINGS = []
# Kernel records torch.profiler dropped, per profile that dropped any.
DROPPED = []


def device_ms(fn, reps=20):
    """Device time of one fn() call: the durations of the kernels it
    launches, summed, from torch.profiler (CUPTI) over reps calls.  The
    host's launch cost and the gaps between kernels are left out.

    On an H100 with torch 2.11 a profile drops one to three kernel
    records, whatever reps is (2 of 20, 2 of 5, 2 of 40), so the sum of
    the records over reps reads low, by 40% at 5 reps.  Each kernel is
    therefore counted as its mean duration over its records times its
    launches a call: its records over reps, rounded up, which is exact
    while reps exceeds the records dropped.  For the CUDA solve that
    count must equal what its wrapper counted (chol_cuda.launches).  A
    profile with no device time is taken again; twice running (seen once),
    CUDA events around the reps calls stand in: they include the gaps
    between a call's kernels."""
    import math
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from qnmfits_tpu_torch.ops import chol_cuda
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        made = chol_cuda.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        made = chol_cuda.launches - made
        us, solve, dropped = 0.0, 0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.count == 0:
                continue
            per_call = math.ceil(e.count / reps)
            us += e.self_device_time_total / e.count * per_call
            dropped += per_call * reps - e.count
            if "regularised_solve" in e.key:
                solve += per_call * reps
        if us == 0:
            continue
        if dropped:
            DROPPED.append(dropped)
        if made and solve != made:
            raise RuntimeError(f"torch.profiler counted {solve} solve "
                               f"launches, the wrapper {made}")
        return us / 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    EVENT_TIMINGS.append(ms)
    log(f"torch.profiler recorded no device time; CUDA events: {ms:.4f} ms")
    return ms


def backward_err(G, b, x):
    """Largest normwise backward error of x as the solution of the
    equilibrated, floored system the solve works on: ||A z - b'|| /
    (||A|| ||z|| + ||b'||) with z = x / Di (max norms, per system).  It
    stays near n eps for a stable solve however ill-conditioned A is."""
    from qnmfits_tpu_torch import engine_real
    A, bs, Di = engine_real._equilibrated(G, b)
    z = x / Di
    r = (A @ z[..., None])[..., 0] - bs
    den = A.abs().amax(dim=(-2, -1)) * z.abs().amax(-1) + bs.abs().amax(-1)
    return float((r.abs().amax(-1) / den).max())


# Phase 3's batches: the main path's 8208 (513 windows x 16 sets), and
# batches that leave partial slabs and teams, at every n of the team
# kernel; the last four at the wide kernel's sizes, each side of its
# thresholds (threads a block 32/33 and 96/97, two stages or one 118/119,
# shared memory or the global workspace 167/168) and the sweeps' 17, 40
# and 96 (tests/test_torch_cuda.py covers every n to 64); 131072 (8192
# start times x 16 sets, the sweep without dedup) at the bench's n = 8.
CHECK_BATCHES = (8208, 1, 15, 17, 1000)
CHECK_WIDE_N = (17, 31, 32, 33, 40, 64, 65, 96, 97, 118, 119, 128, 167,
                168, 200)
CHECK_LARGE = (131072, 8)
# The wide kernel timed on random systems, (B, n): where many systems share
# each SM, 8208 (513 windows x 16 sets) at n = 17, 40 and 64; and in the
# global workspace.  Above n = 96 the plain version is not timed: its
# column loop issues ~n^2 operations a call, which the profiler takes
# minutes to record.
TIME_WIDE = ((8208, 17), (8208, 40), (8208, 64), (1000, 200))
TIME_PLAIN_MAX_N = 96


def check_build():
    """Phase 2: ptxas's registers and spills per kernel (the team kernel
    per system size, the wide kernel per block size and arena).  Returns
    (registers by kernel, the largest spill in bytes); raises on a
    spill."""
    from qnmfits_tpu_torch.ops import chol_cuda
    report = chol_cuda.ptxas_report()
    spill = max(max(r["spill_stores"], r["spill_loads"])
                for r in report.values())
    regs = {n: r["registers"] for n, r in report.items()}
    log(f"ptxas: registers by kernel {regs}; largest spill {spill} bytes")
    if spill:
        raise RuntimeError(f"ptxas reports spills: {report}")
    from qnmfits_tpu_torch.ops import cf_cuda
    cf = cf_cuda.ptxas_report()
    log(f"ptxas, the Leaver CF kernel by its block: {cf}")
    if set(cf) != set(cf_cuda.KERNELS) or any(
            r["spill_stores"] or r["spill_loads"] for r in cf.values()):
        raise RuntimeError(f"ptxas reports CF kernels {sorted(cf)} "
                           f"(expected {cf_cuda.KERNELS}) or spills: {cf}")
    from qnmfits_tpu_torch.ops import sweep_cuda
    sw = sweep_cuda.ptxas_report()
    log(f"ptxas, the factored sweep's kernels: {sw}")
    if any(r["spill_stores"] or r["spill_loads"] for r in sw.values()):
        raise RuntimeError(f"ptxas reports spills in the factored sweep's "
                           f"kernels: {sw}")
    from qnmfits_tpu_torch.ops import eig_cuda
    eig = eig_cuda.ptxas_report()
    log(f"ptxas, the angular eig kernel: {eig}")
    if any(r["spill_stores"] or r["spill_loads"] for r in eig.values()):
        raise RuntimeError(f"ptxas reports spills in the eig kernel: {eig}")
    from qnmfits_tpu_torch.ops import moments_cuda
    mom = moments_cuda.ptxas_report()
    mom.update({f"phases_{k}": r for k, r in
                moments_cuda.ptxas_report(phases=True).items()})
    log(f"ptxas, the window moments kernel by variant and order (and its "
        f"phases build): {mom}")
    if any(r["spill_stores"] or r["spill_loads"] for r in mom.values()):
        raise RuntimeError(f"ptxas reports spills in the window moments "
                           f"kernel: {mom}")
    return regs, spill


def check_jitter(device, jitter=1e-6):
    """``ops/solve.gram_cholesky(jitter_scale=)`` on the card: the floor
    goes through the solve kernels (one team launch at n = 6, one wide
    launch at n = 20), within KERNEL_RTOL of the same call on the CPU."""
    import torch
    from qnmfits_tpu_torch.ops import chol_cuda, solve
    from qnmfits_tpu_torch.testing import random_hermitian_systems
    out = {}
    for n in (6, 20):
        G, b = random_hermitian_systems(64, n, seed=n, n_pad=1)
        before = chol_cuda.launches, chol_cuda.wide_launches
        x = solve.gram_cholesky(torch.as_tensor(G, device=device),
                                torch.as_tensor(b, device=device),
                                jitter_scale=jitter).cpu()
        launched = (chol_cuda.launches - before[0],
                    chol_cuda.wide_launches - before[1])
        ref = solve.gram_cholesky(torch.as_tensor(G), torch.as_tensor(b),
                                  jitter_scale=jitter)
        out[n] = rel_err(x, ref)
        if launched != (1, int(n > chol_cuda.TEAM_MAX_N)):
            raise RuntimeError(f"gram_cholesky(jitter_scale=) at n={n} "
                               f"launched {launched}")
    log(f"gram_cholesky(jitter_scale={jitter}) through the solve kernels "
        f"(n = 6 team, 20 wide) vs the CPU route: {out} (bound "
        f"{KERNEL_RTOL:.0e})")
    if max(out.values()) > KERNEL_RTOL:
        raise RuntimeError(f"jittered solve off its CPU route: {out}")
    return out


def check_kernel_sizes(device):
    """Phase 3: kernel vs plain on random systems with dead columns and
    padding, n = 1..16 at each of CHECK_BATCHES, n in CHECK_WIDE_N at
    each but the first, and CHECK_LARGE.  Returns {n: max |x_kernel -
    x_plain|}."""
    import torch
    from qnmfits_tpu_torch import engine_real
    from qnmfits_tpu_torch.ops import chol_cuda
    from qnmfits_tpu_torch.testing import random_hermitian_systems

    cases = ([(B, n) for n in range(1, 17) for B in CHECK_BATCHES]
             + [(B, n) for n in CHECK_WIDE_N for B in CHECK_BATCHES[1:]])
    worst, max_abs = 0.0, {}
    for B, n in cases + [CHECK_LARGE]:
        G, b = random_hermitian_systems(B, n, seed=n + B, n_pad=n // 4)
        G = torch.as_tensor(G, dtype=torch.complex128, device=device)
        b = torch.as_tensor(b, dtype=torch.complex128, device=device)
        x = chol_cuda.regularised_solve(G, b)
        ref = engine_real._regularised_solve_plain(G, b)
        torch.cuda.synchronize()
        err = rel_err(x, ref)
        worst = max(worst, err)
        max_abs[n] = max(max_abs.get(n, 0.0), float((x - ref).abs().max()))
        if not err <= KERNEL_RTOL:
            raise RuntimeError(f"kernel vs plain at n={n}, B={B}: relative "
                               f"error {err:.3e} > {KERNEL_RTOL:.0e}")
    log(f"kernel vs plain, n = 1..16 at B = {CHECK_BATCHES}, n = "
        f"{CHECK_WIDE_N} at B = {CHECK_BATCHES[1:]} and B = "
        f"{CHECK_LARGE[0]} at n = "
        f"{CHECK_LARGE[1]} (dead columns, padding): max relative error "
        f"{worst:.3e} (bound {KERNEL_RTOL:.0e})")
    return max_abs


def time_wide(gpu):
    """Phase 3, last: the wide kernel on random systems at each (B, n) of
    TIME_WIDE, beside its bound, its plain version and torch.linalg,
    with its backward error gated.  Returns {n: record}."""
    import torch
    from qnmfits_tpu_torch.testing import random_hermitian_systems
    out = {}
    for B, n in TIME_WIDE:
        G, b = random_hermitian_systems(B, n, seed=n, n_pad=n // 4)
        G = torch.as_tensor(G, dtype=torch.complex128, device="cuda")
        b = torch.as_tensor(b, dtype=torch.complex128, device="cuda")
        r = out[n] = time_solves(G, b, plain=n <= TIME_PLAIN_MAX_N)
        r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], n)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        plain = ("not timed" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.4f} ms")
        log(f"wide kernel on {gpu}, B={r['batch']} random systems, n={n}: "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.3e} ms "
            f"({r['bound_by']}), share {r['bound_share']:.3f}; plain "
            f"{plain}; torch.linalg {r['library_ms']:.4f} ms; "
            f"backward error {r['backward_err']:.3e}")
        if not r["backward_err"] <= KERNEL_BWD_TOL:
            raise RuntimeError(f"wide kernel solution (n={n}, "
                               f"B={B}) fails the backward-error "
                               "check")
    return out


def time_solves(G, b, plain=True):
    """Device times (ms) of the kernel, its plain version (None unless
    ``plain``) and torch.linalg.cholesky_ex + cholesky_solve (on the
    equilibrated system only) on one batch, and the kernel's backward
    error beside the plain solve's, and its relative difference from it."""
    import torch
    from qnmfits_tpu_torch import engine_real
    from qnmfits_tpu_torch.ops import chol_cuda
    x = chol_cuda.regularised_solve(G, b)
    ref = engine_real._regularised_solve_plain(G, b)
    torch.cuda.synchronize()
    A, bs, _ = engine_real._equilibrated(G, b)
    return dict(
        batch=b.shape[0], backward_err=backward_err(G, b, x),
        backward_err_plain=backward_err(G, b, ref), rel_diff=rel_err(x, ref),
        ms=device_ms(lambda: chol_cuda.regularised_solve(G, b)),
        plain_ms=device_ms(
            lambda: engine_real._regularised_solve_plain(G, b), reps=10)
        if plain else None,
        library_ms=device_ms(lambda: torch.cholesky_solve(
            bs[..., None], torch.linalg.cholesky_ex(A)[0])))


def measure(problem, main, max_abs, build, device, gpu):
    """Phase 5: sweep throughput, and the kernel on the very systems each
    main-path sweep gave it in its one launch (8208 with dedup, 131072
    without): its backward error (gated; the pre-ringdown Grams are too
    ill-conditioned for a forward comparison with the plain solve, which
    is reported), and its device time beside its bound, the plain
    solve's and torch.linalg's.  Returns the kernel's JSON record."""
    n_fits = len(problem["mode_sets"]) * len(problem["t0s"])
    rates = {}
    for dedup in (True, False):
        reps = []
        for _ in range(3):
            t = time.perf_counter()
            sweep(problem, device, dedup)
            reps.append(time.perf_counter() - t)
        rates[dedup] = n_fits / min(reps)
    log(f"throughput on {gpu}: {rates[True]:.1f} fits/s with dedup, "
        f"{rates[False]:.1f} fits/s without ({n_fits} fits, best of 3)")

    res = {}
    for dedup in (True, False):
        G, b = main["systems"][dedup]
        n = b.shape[-1]
        r = res[dedup] = time_solves(G, b)
        r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], n)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"kernel on the main path's systems (dedup={dedup}, one launch "
            f"of B={r['batch']}, n={n}): backward error "
            f"{r['backward_err']:.3e} (bound {KERNEL_BWD_TOL:.0e}; plain "
            f"solve {r['backward_err_plain']:.3e}); relative difference "
            f"from the plain solve {r['rel_diff']:.3e} (reported: "
            f"ill-conditioned pre-ringdown Grams)")
        log(f"solve kernel on {gpu}, dedup={dedup}: {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.3e} ms ({r['bound_by']}), share of the bound "
            f"{r['bound_share']:.3f}; plain {r['plain_ms']:.4f} ms; "
            f"torch.linalg.cholesky_ex + torch.cholesky_solve "
            f"{r['library_ms']:.4f} ms (device time)")
        if not r["backward_err"] <= KERNEL_BWD_TOL:
            raise RuntimeError(f"kernel solution (dedup={dedup}) fails the "
                               "backward-error check")
    on, off = res[True], res[False]
    regs, spill = build
    return dict(name="chol_solve", route="cuda",
                source="qnmfits_tpu_torch/csrc/chol_solve.cu",
                replaces="qnmfits_tpu/ops/chol_pallas.py:184",
                launches=main["launches"], max_abs_err=max_abs[n],
                ms=on["ms"], plain_ms=on["plain_ms"],
                bound_ms=on["bound_ms"], bound_by=on["bound_by"],
                library_ms=on["library_ms"],
                library="torch.linalg.cholesky_ex + torch.cholesky_solve",
                bound_share=on["bound_share"], batch=on["batch"],
                ms_nodedup=off["ms"], plain_ms_nodedup=off["plain_ms"],
                bound_ms_nodedup=off["bound_ms"],
                library_ms_nodedup=off["library_ms"],
                bound_share_nodedup=off["bound_share"],
                batch_nodedup=off["batch"],
                launches_nodedup=main["launches_nodedup"], n=n,
                backward_err=max(on["backward_err"], off["backward_err"]),
                registers=regs, spill_bytes_max=spill,
                fits_per_s_dedup=rates[True],
                fits_per_s_nodedup=rates[False])


def event_ms(fn, reps=20):
    """Device time of one fn() call by CUDA events around reps calls after
    two warm ones (the gaps between a call's kernels included)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Operations the least time of the factored systems counts: the product
# conj(phi0_j(t_k)) d_i(t_k), a complex multiply (6 FP64 operations), once
# a (set, chunk, sample of the chunk's windows, row, mode), since each
# chunk has its own anchor; its window sums, a complex add (2) a (set,
# window, sample, row, mode); and a Gram entry's ladder, ~14 a level, with
# ~60 for its closing products and divisions (transcendentals not
# counted).  Prefix sums over the samples would make a window's sums two
# operations, but their differences of large partial sums lose the
# relative accuracy the systems are held to.
PRODUCT_OPS, WINDOW_SUM_OPS = 6, 2
GRAM_OPS_LEVEL, GRAM_OPS_ONCE = 14, 60


def factored_bounds(args):
    """Least times (ms) of the two kernels on one group's inputs ``args``
    (``factored_systems``'s arguments): each the larger of its bytes (each
    input read once, each output written once) over HBM bandwidth and its
    FP64 operations over the FP64 peak.  Returns {"systems": (ms, by),
    "epilogue": (ms, by)}."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    times, data, omegas, mus, t0s, Ts = (np.asarray(a.cpu())
                                         for a in args[:6])
    chunk = args[7]
    K, (I, _), (S, J), B = len(times), data.shape, omegas.shape, len(t0s)
    a = np.searchsorted(times, t0s, side="left")
    m = np.maximum(np.searchsorted(times, t0s + Ts, side="left") - a, 0)
    # The samples each chunk's windows cover, which its products need.
    spans = 0
    for lo in range(0, B, chunk):
        live = m[lo:lo + chunk] > 0
        if live.any():
            seg = slice(lo, lo + chunk)
            spans += int(np.max((a + m)[seg][live]) - np.min(a[seg][live]))
    nbits = sweep_cuda._nbits(K)
    sys_bytes = (K * 8 + I * K * 16 + S * J * 16 + S * I * J * 16 + S * J
                 + 16 * B + S * B * (2 * J * J + 2 * J) * 16 + 8 * B)
    sys_ops = (S * I * J * (PRODUCT_OPS * spans
                            + WINDOW_SUM_OPS * float(m.sum()))
               + S * B * J * J * (GRAM_OPS_LEVEL * nbits + GRAM_OPS_ONCE))
    epi_bytes = S * B * (J * J * 16 + 3 * J * 16 + 8) + 16 * B + S * J * 16
    epi_ops = S * B * (8 * J * J + 4 * J + 12 * J)

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP64_FLOP_PER_S
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    return dict(systems=bound(sys_bytes, sys_ops),
                epilogue=bound(epi_bytes, epi_ops))


# How the factored kernels' records are timed, by field.
FACTORED_TIMED_BY = dict(
    ms="torch.profiler: the kernel's device time, mean over its launches",
    call_ms="CUDA events around back-to-back wrapper calls (the host's "
            "launch gaps included)",
    plain_ms="CUDA events around back-to-back plain-version calls")


def measure_factored(problem, main, device, gpu):
    """Phase 5, the factored sweep's kernels: each on the inputs each
    main-path sweep gave it (dedup on and off), its device time from
    torch.profiler and its call's by CUDA events, beside its bound and its
    plain version's time (no single PyTorch call computes
    either function: library_ms is null); then the sweep's profile, wall,
    device busy, idle share and kernels a sweep.  Returns the two
    kernels' JSON records."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    timed = {}
    for dedup in (True, False):
        calls = main["sweep_calls"][dedup]
        args = calls["systems"][0][0]
        eargs = calls["epilogue"][0][0]
        bounds = factored_bounds(args)
        t = timed[dedup] = {}
        for key, kernel, fn, plain, a in (
                ("systems", "factored_systems_kernel",
                 sweep_cuda.factored_systems,
                 sweep_cuda.factored_systems_plain, args),
                ("epilogue", "mismatch_rephase_kernel",
                 sweep_cuda.mismatch_rephase,
                 sweep_cuda.mismatch_rephase_plain, eargs)):
            ms = kernel_ms(lambda: fn(*a), kernel=kernel)
            call_ms = event_ms(lambda: fn(*a))
            plain_ms = event_ms(lambda: plain(*a), reps=3)
            b_ms, by = bounds[key]
            t[key] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=by, bound_share=b_ms / ms)
            plan = ""
            if key == "systems":
                t[key]["plan"] = dict(sweep_cuda.last_plan)
                plan = (" ({variant} variant, clusters of {cluster}, "
                        "{smem_bytes} B of dynamic shared memory a block, "
                        "{blocks} blocks)").format(**sweep_cuda.last_plan)
            log(f"{key} kernel on {gpu}, dedup={dedup} (B={len(a[5])} "
                f"windows){plan}: {ms:.4f} ms (torch.profiler; the call "
                f"{call_ms:.4f} ms by CUDA events), bound {b_ms:.3e} ms "
                f"({by}), share {b_ms / ms:.3f}; plain {plain_ms:.4f} ms")
        split = device_split(lambda: sweep(problem, device, dedup))
        t["profile"] = split
        if split is None:
            log(f"main-path sweep (dedup={dedup}): torch.profiler recorded "
                "no device time (not measured)")
        else:
            log(f"main-path sweep profile (dedup={dedup}) on {gpu}: warm "
                f"wall {split['wall_ms']:.2f} ms, busy {split['busy_ms']:.3f} "
                f"ms, idle share {split['idle_share']:.3f}, "
                f"{split['kernels']} kernels and {split['copies']} copies a "
                f"sweep; factored kernels {split['sweep_ms']:.3f} ms, solve "
                f"{split['solve_ms']:.4f} ms, elementwise "
                f"{split['elementwise_ms']:.3f}, products "
                f"{split['products_ms']:.3f}, rest {split['rest_ms']:.3f}, "
                f"copies {split['copies_ms']:.3f} ms")
    records = []
    report = sweep_cuda.ptxas_report()
    for i, (key, name, kernel, line, err) in enumerate((
            ("systems", "factored_systems", "factored_systems_kernel",
             "qnmfits_tpu/engine_real.py:717", "max_abs_err"),
            ("epilogue", "mismatch_rephase", "mismatch_rephase_kernel",
             "qnmfits_tpu/engine_real.py:826", "epilogue_max_abs_err"))):
        on, off = timed[True][key], timed[False][key]
        f_on, f_off = main["factored"][True], main["factored"][False]
        records.append(dict(
            name=name, route="cuda",
            source="qnmfits_tpu_torch/csrc/factored_sweep.cu",
            replaces=line, launches=main["factored_launches"][i],
            max_abs_err=max(f_on[err], f_off[err]), ms=on["ms"],
            plain_ms=on["plain_ms"], bound_ms=on["bound_ms"],
            bound_by=on["bound_by"], library_ms=None,
            bound_share=on["bound_share"], call_ms=on["call_ms"],
            timed_by=FACTORED_TIMED_BY,
            launches_nodedup=main["factored_launches_nodedup"][i],
            ms_nodedup=off["ms"], call_ms_nodedup=off["call_ms"],
            plain_ms_nodedup=off["plain_ms"],
            bound_ms_nodedup=off["bound_ms"],
            bound_share_nodedup=off["bound_share"],
            registers=report[kernel]["registers"]))
    records[0]["systems_rel"] = max(max(f["systems_rel"].values())
                                    for f in main["factored"].values())
    # The systems kernel's launch: its variant, cluster size, dynamic
    # shared bytes a block and blocks (registers above).
    records[0]["plan"] = timed[True]["systems"]["plan"]
    records[0]["plan_nodedup"] = timed[False]["systems"]["plan"]
    records[1]["C_rel"] = max(f["C_rel"] for f in main["factored"].values())
    records[0]["profile"] = {str(d): timed[d]["profile"]
                             for d in (True, False)}
    return records


# ---------------------------------------------------------------------------
# Phase 6: the rest of the static-spectrum surface
# ---------------------------------------------------------------------------

DEEPEST = 7                      # the bench's deepest set, (2,2,n<8)
SINGLE_T0S = (0.0, 10.0, 20.0)   # start times of the single fits
# The (Mf, chif) grid fits the bench's (2,2,n<4) set at t0 = 10.  With the
# deepest set the off-remnant Grams pass kappa ~ 1e8, where the Gram path
# and the oracle's SVD part (the JAX package's known delta, ROADMAP C.3).
GRID_SET = 3
GRID_T0 = 10.0                   # start time of the two grids
M_CHI_BOX = ((0.90, 1.00), (0.60, 0.78))     # (Mf, chif) around the remnant
OMEGA_BOX = ((0.2, 0.8), (-0.5, 0.05))       # free w; Im w > 0 grows


def _m2(l, count, sign=1):
    return [(l, 2, n, sign) for n in range(count)]


# Sets of the sizes the bench never makes: one mode each (the team
# kernel's n = 1), and 17, 40 and 96 m = 2 modes, prograde and mirror
# overtones (the wide kernel); SET_96 is every one with n < 8 of
# l = 2..7.  Before the ringdown (t0 < 0) the kernel and the plain solve,
# both backward stable, differ by more than PRE_TOL in mismatch at 40 and
# 96 modes (PERF.md, section 6), so there the kernel's backward error is
# gated instead.
ONE_MODE_SETS = [[(2, 2, 0, 1)], [(2, 2, 1, 1)], [(2, 2, 0, -1)],
                 [(3, 2, 0, 1)]]
SET_17 = _m2(2, 5) + _m2(2, 4, -1) + _m2(3, 4) + _m2(3, 2, -1) + _m2(4, 2)
SET_40 = (_m2(2, 8) + _m2(2, 6, -1) + _m2(3, 6) + _m2(3, 4, -1) + _m2(4, 5)
          + _m2(4, 3, -1) + _m2(5, 4) + _m2(5, 2, -1) + _m2(6, 2))
SET_96 = [m for l in range(2, 8) for m in _m2(l, 8) + _m2(l, 8, -1)]


def drive(fn):
    """fn() with the kernels' launch counts set to 0 just before it and
    read just after.  Returns (result, launches of both solve kernels,
    launches of the wide solve kernel, wall seconds, (launches of the
    factored sweep's systems kernel, of its epilogue kernel, of the window
    moments kernel)); results are NumPy arrays, so the device has
    finished."""
    from qnmfits_tpu_torch.ops import chol_cuda, moments_cuda, sweep_cuda
    chol_cuda.launches = chol_cuda.wide_launches = 0
    sweep_cuda.systems_launches = sweep_cuda.epilogue_launches = 0
    moments_cuda.launches = 0
    t = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t
    return (out, chol_cuda.launches, chol_cuda.wide_launches, wall,
            (sweep_cuda.systems_launches, sweep_cuda.epilogue_launches,
             moments_cuda.launches))


def _diff(a, b, pre):
    """max |a - b| over t0 >= 0 and over t0 < 0 (pre marks t0 < 0 along
    the last axis; None when every fit starts in the ringdown)."""
    d = np.abs(np.asarray(a, float) - np.asarray(b, float))
    if pre is None:
        return float(d.max()), 0.0
    return (float(np.max(d[..., ~pre], initial=0.0)),
            float(np.max(d[..., pre], initial=0.0)))


def _held(a, b, pre, tol_in, tol_pre):
    """Whether |a - b| holds tol_in for t0 >= 0 and tol_pre for t0 < 0
    (None: not held there); pre marks t0 < 0 along the last axis (None
    when every fit starts in the ringdown), and each bound is a scalar or
    one per set (S,), the first axis of a."""
    d = np.abs(np.asarray(a, float) - np.asarray(b, float))
    pre = np.zeros(d.shape[-1], bool) if pre is None else pre

    def ok(sel, tol):
        if tol is None or not sel.any():
            return True
        t = np.asarray(tol, float)
        t = t.reshape(t.shape + (1,) * (d.ndim - t.ndim))
        return bool(np.all(d[..., sel] <= t))

    return ok(~pre, tol_in) and ok(pre, tol_pre)


def remnant_groups(problem):
    """The join groups a remnant sweep without dedup must make, computed
    from the spectrum and the budget: (R*S sets, chunk sizes) ->
    engine_real.join_groups."""
    from qnmfits_tpu_torch import batched, engine_real
    sets = [list(batched._canon(ms)) for ms in problem["mode_sets"]]
    eval_all, _ = batched._modesets_spectrum_fn(
        tuple(tuple(ms) for ms in sets), tuple(SPH))
    spins = problem["spins"]
    omegas, _ = eval_all(spins, np.full(len(spins), MF))
    t0s = problem["t0s"]
    ck = batched._safe_chunk(t0s, float(np.max(np.abs(omegas.imag))), 256)
    S, J = len(sets), omegas.shape[-1]
    sizes = [min(ck, len(t0s) - lo) for lo in range(0, len(t0s), ck)]
    return engine_real.join_groups(sizes, 2 * S * len(spins) * J * J * 16)


def path_specs(problem, device):
    """The paths of phase 6.  Each spec: key, name; ``kernel``, the public
    entry point's call; ``plain``, the same call one layer down with the
    solve substituted (None for the SVD single fits); ``pre``, the
    t0 < 0 mask of its last axis, and ``pre_tol``, the bound there against
    the plain route (None: the kernel's backward error is gated
    instead); ``oracle``, mm -> max |d| against the
    NumPy oracle (t0 >= 0, t0 < 0); ``expect``, the launches (both
    kernels, wide kernel) the call must make on the card."""
    from qnmfits_tpu_torch import batched, fitting, ref_impl
    from qnmfits_tpu_torch.testing import bench_mode_sets
    times, data, t0s, T = (problem[k] for k in ("times", "data", "t0s", "T"))
    sets, spins, res = problem["mode_sets"], problem["spins"], problem["res"]
    deep = bench_mode_sets()[DEEPEST]
    grid_set = bench_mode_sets()[GRID_SET]
    pre = t0s < 0
    kw = dict(T_array=T, spherical_modes=SPH, device=device)
    specs = []

    def modesets(key, name, mode_sets, expect, chif=CHIF, pre_tol=PRE_TOL,
                 all_plain=False, route=None, **extra):
        def kernel():
            return fitting.mismatch_t0_mode_sets(
                times, data, mode_sets, MF, chif, t0s, **kw, **extra)

        def plain(solve):
            return batched.batch_mismatch_t0_modesets(
                times, data, mode_sets, MF, chif, t0s, solve=solve, **kw,
                **extra)

        def check(mm):
            method = extra.get("t0_method", "geq")
            if np.ndim(chif) == 0:
                return oracle_diff(problem, mm, mode_sets, CHIF, method)
            # Off the remnant's spin, the 8-mode ladder's Grams pass
            # kappa ~ 1e8, where the Gram path and the oracle's SVD part
            # (the JAX package's known delta, ROADMAP C.3): that set is
            # reported, the others gated.
            gated = [i for i, ms in enumerate(mode_sets) if len(ms) < 8]
            ungated = [i for i in range(len(mode_sets)) if i not in gated]
            found, deep_in = [], 0.0
            for r in (0, len(chif) - 1):
                found.append(oracle_diff(problem, mm[:, r], mode_sets,
                                         chif[r], method, gated))
                deep_in = max(deep_in, oracle_diff(
                    problem, mm[:, r], mode_sets, chif[r], method,
                    ungated)[0])
            if ungated:
                log(f"{name}: the 8-mode set against the oracle at spins "
                    f"{chif[0]:.3f} and {chif[-1]:.3f}: {deep_in:.3e} "
                    "(t0 >= 0; reported)")
            return tuple(max(f[i] for f in found) for i in range(2))

        specs.append(dict(key=key, name=name, kernel=kernel, plain=plain,
                          pre=pre, pre_tol=pre_tol, oracle=check,
                          expect=expect, all_plain=all_plain,
                          **(route or {})))

    modesets("closest", "mode sets, t0_method='closest' (dedup)", sets,
             (1, 0), t0_method="closest")
    # Off the remnant's spin the 8-mode ladder's Grams pass kappa ~ 1e8
    # (ROADMAP C.3): two backward-stable solves of its systems part by
    # ~1e-11, on the kernel's systems as on the plain version's, so that
    # set is held to each window's first-order rounding bound, with the
    # kernel's backward error gated; the other sets to MAIN_TOL.
    off_remnant = dict(route_tol=np.array(
        [MAIN_TOL if len(ms) < 8 else np.inf for ms in sets]),
        bounded=(lambda live: live >= 8, "in"), plain_systems_gap=True,
        backward=True)
    modesets("remnant", f"remnant axis R={len(spins)} (dedup)", sets,
             (1, 0), chif=spins, route=off_remnant)
    modesets("remnant_nodedup", f"remnant axis R={len(spins)} (no dedup)",
             sets, (len(remnant_groups(problem)), 0), chif=spins,
             dedup=False, route=off_remnant)
    J = max(len(ms) for ms in sets)
    widths = {batched._bucket_width(len(ms), J) for ms in sets}
    modesets("bucket", "mode sets, bucket=True", sets, (len(widths), 0),
             bucket=True)

    def oracle_t0(mm):
        return oracle_diff(problem, np.asarray(mm)[None], [deep])

    for engine, layer in (("fast", batched.batch_mismatch_t0_fast),
                          ("batched", batched.batch_mismatch_t0)):
        specs.append(dict(
            key=f"t0_array_{engine}",
            name=f"mismatch_t0_array engine='{engine}' (deepest set)",
            kernel=lambda engine=engine: fitting.mismatch_t0_array(
                times, data, deep, MF, CHIF, t0s, engine=engine, **kw),
            plain=lambda solve, layer=layer: layer(
                times, data, deep, MF, CHIF, t0s, solve=solve, **kw),
            pre=pre, oracle=oracle_t0, expect=(1, 0)))

    def fits():
        return np.array(
            [fitting.ringdown_fit(times, data[(2, 2)], deep, MF, CHIF, t0,
                                  T=T, device=device)["mismatch"]
             for t0 in SINGLE_T0S]
            + [fitting.multimode_ringdown_fit(
                times, data, deep, MF, CHIF, t0, T=T, spherical_modes=SPH,
                device=device)["mismatch"] for t0 in SINGLE_T0S])

    def fits_oracle(mm):
        ref = np.array(
            [ref_impl.ringdown_fit(times, data[(2, 2)], deep, MF, CHIF, t0,
                                   T=T)["mismatch"] for t0 in SINGLE_T0S]
            + [ref_impl.multimode_ringdown_fit(
                times, data, deep, MF, CHIF, t0, T=T,
                spherical_modes=SPH)["mismatch"] for t0 in SINGLE_T0S])
        return _diff(mm, ref, None)

    specs.append(dict(key="single_fits",
                      name="ringdown_fit + multimode_ringdown_fit (SVD), "
                      f"t0 = {SINGLE_T0S}", kernel=fits, plain=None,
                      pre=None, oracle=fits_oracle, expect=(0, 0)))

    step = max(1, res // 7)
    Mfs, chifs = np.linspace(*M_CHI_BOX[0], res), np.linspace(*M_CHI_BOX[1],
                                                             res)
    grid_kw = dict(T=T, res=res, device=device)

    def m_chi_oracle(mm):
        d = 0.0
        for i in range(0, res, step):
            for j in range(0, res, step):
                ref = ref_impl.multimode_ringdown_fit(
                    times, data, grid_set, Mfs[i], chifs[j], GRID_T0, T=T,
                    spherical_modes=SPH)["mismatch"]
                d = max(d, abs(float(mm[i, j]) - ref))
        return d, 0.0

    specs.append(dict(
        key="m_chi_grid",
        name=f"mismatch_M_chi_grid res={res} ((2,2,n<4), t0={GRID_T0})",
        kernel=lambda: fitting.mismatch_M_chi_grid(
            times, data, grid_set, *M_CHI_BOX, GRID_T0, spherical_modes=SPH,
            **grid_kw),
        plain=lambda solve: batched.batch_mismatch_M_chi(
            times, data, grid_set, *M_CHI_BOX, GRID_T0, spherical_modes=SPH,
            solve=solve, **grid_kw),
        pre=None, oracle=m_chi_oracle, expect=(1, 0)))
    omega_args = (times, data[(2, 2)], deep[:2], MF, CHIF, *OMEGA_BOX,
                  GRID_T0)
    specs.append(dict(
        key="omega_grid",
        name=f"mismatch_omega_grid res={res} ((2,2,n<2) + a free mode, "
             f"t0={GRID_T0})",
        kernel=lambda: fitting.mismatch_omega_grid(*omega_args, **grid_kw),
        plain=lambda solve: batched.batch_mismatch_omega(
            *omega_args, solve=solve, **grid_kw),
        pre=None, oracle=lambda mm: _diff(mm, ref_impl.mismatch_omega_grid(
            *omega_args, T=T, res=res), None),
        expect=(1, 0)))

    modesets("n1", "one-mode sets (n = 1)", ONE_MODE_SETS, (1, 0))
    modesets("n17", "17-mode set (n = 17)", [SET_17] + sets[:2], (1, 1),
             all_plain=True)
    # Before the ringdown two backward-stable solves of the 40- and 96-mode
    # systems part by ~1e-7 (ROADMAP C.2): there each window is held to
    # its first-order rounding bound, with the kernel's backward error.
    before = dict(bounded=(lambda live: live > 0, "pre"))
    modesets("n40", "40-mode set (n = 40)", [SET_40], (1, 1), pre_tol=None,
             all_plain=True, route=before)
    modesets("n96", "96-mode set (n = 96)", [SET_96], (1, 1), pre_tol=None,
             all_plain=True, route=before)
    return specs


def run_paths(problem, device):
    """Phase 6: ``run_specs`` on the paths of ``path_specs``."""
    return run_specs(path_specs(problem, device), device)


def run_specs(specs, device):
    """Drive each path spec through its public entry point, check its
    launches, and hold it against the plain-solve route (MAIN_TOL, or the
    spec's ``route_tol``, for t0 >= 0; the spec's pre_tol for t0 < 0, or
    else the kernel's backward error KERNEL_BWD_TOL, which a spec with
    ``backward`` gates as well)
    and the NumPy oracle (ORACLE_TOL, or the spec's ``oracle_tol``, for
    t0 >= 0).  Returns one record per
    path, with the systems the plain route solved; raises on any failed
    gate."""
    records = []
    for spec in specs:
        # The factored sweep's inputs and outputs are kept on the paths
        # that are one such sweep, for its kernels against their plain
        # versions on them and the all-plain route (on the CPU the
        # kernel route is the plain route: nothing to compare).
        all_plain_check = spec.get("all_plain") and device != "cpu"
        # A spec's ``bounded`` = (sets, side): on that side of the ringdown
        # those sets (a function of each set's live columns) are held to
        # each window's first-order rounding bound (``first_order_gaps``)
        # against both routes, where a bar for every window would be
        # either loose or broken by their measured conditioning.
        bounded = spec.get("bounded")

        def recorded(on=bounded is not None):
            return recording_sweeps() if on else contextlib.nullcontext()

        def bounded_check(route, groups):
            gap, bnd, ratio = bounded_gap(groups, *bounded)
            side = "t0 >= 0" if bounded[1] == "in" else "t0 < 0"
            rec[f"bounded_{route}"] = dict(gap=gap, bound=bnd, ratio=ratio,
                                           side=side)
            if not ratio <= 1.0:
                raise RuntimeError(f"{name}: kernel route and {route} route "
                                   f"part beyond their first-order bound "
                                   f"({side}): gap {gap:.3e}, "
                                   f"{ratio:.2e} of the bound")
            return (f"; vs {route} route on the bounded sets ({side}) "
                    f"{gap:.3e}, {ratio:.2e} of the first-order bound "
                    f"(largest {bnd:.3e})")

        with recorded(all_plain_check or bounded is not None) as calls:
            mm, n, n_wide, wall, (n_sys, n_epi, _) = drive(spec["kernel"])
        mm = np.asarray(mm)
        name = spec["name"]
        if not np.all(np.isfinite(mm)):
            raise RuntimeError(f"{name}: non-finite mismatches")
        expect = (spec["expect"]() if callable(spec["expect"])
                  else spec["expect"])
        if device != "cpu" and (n, n_wide) != expect:
            raise RuntimeError(f"{name}: {n} kernel launches ({n_wide} of "
                               f"the wide kernel), expected {expect}")
        rec = dict(key=spec["key"], name=name, launches=n,
                   wide_launches=n_wide, expected_launches=expect[0],
                   systems_launches=n_sys, epilogue_launches=n_epi,
                   wall_s=wall)
        msg = f"{name}: mm {mm.shape}, launches {n} (wide {n_wide})"
        # Each join group of a factored sweep launches both of its kernels
        # once; a path that is one factored sweep launches them as often
        # as the solve.
        if n_sys != n_epi or (all_plain_check and n_sys != n):
            raise RuntimeError(f"{name}: the factored sweep's kernels "
                               f"launched {n_sys} and {n_epi} times beside "
                               f"{n} solves")
        msg += f", factored kernels {n_sys} + {n_epi}"
        if spec["plain"] is not None:
            plain = PlainSolve()
            with recorded() as calls_p:
                mm_p = np.asarray(spec["plain"](plain))
            d_in, d_pre = _diff(mm, mm_p, spec["pre"])
            rec.update(plain_in=d_in, plain_pre=d_pre, systems=plain.systems)
            msg += (f"; vs plain solve {d_in:.3e} (t0 >= 0), {d_pre:.3e} "
                    f"(t0 < 0)")
            if device != "cpu" and len(plain.systems) != n:
                raise RuntimeError(f"{name}: the plain route solved "
                                   f"{len(plain.systems)} times, the "
                                   f"kernel route launched {n}")
            pre_tol = spec.get("pre_tol", PRE_TOL)
            route_tol = spec.get("route_tol", MAIN_TOL)
            if np.ndim(route_tol):
                d = np.abs(mm - mm_p)
                rec.update(
                    plain_in_by_set=np.max(
                        d[..., ~spec["pre"]].reshape(d.shape[0], -1),
                        axis=1, initial=0.0).tolist(),
                    route_tol_by_set=np.asarray(route_tol).tolist())
            if not _held(mm, mm_p, spec["pre"], route_tol, pre_tol):
                bound_pre = (None if pre_tol is None
                             else f"{np.max(pre_tol):.1e}")
                raise RuntimeError(f"{name}: kernel route and plain route "
                                   f"disagree: {d_in:.3e} (t0 >= 0, bound "
                                   f"{np.max(route_tol):.1e}), {d_pre:.3e} "
                                   f"(t0 < 0, bound {bound_pre})")
            if bounded is not None:
                msg += bounded_check("plain-solve",
                                     first_order_gaps(calls, calls_p))
            if bounded is not None and spec.get("plain_systems_gap"):
                # The same two solves on the plain version's systems: how
                # far they part there, beside the kernel's systems.
                with all_plain():
                    with recording_sweeps() as ck:
                        spec["kernel"]()
                    with recording_sweeps() as cp:
                        spec["plain"](PlainSolve())
                gap, bnd, ratio = bounded_gap(first_order_gaps(ck, cp),
                                              *bounded)
                rec["plain_systems_route"] = dict(gap=gap, bound=bnd,
                                                  ratio=ratio)
                msg += (f"; the two solves on the plain systems {gap:.3e}, "
                        f"{ratio:.2e} of their bound")
            if all_plain_check:
                # Before the ringdown the bound is the spec's own: where
                # two solvers of the same systems part by more than
                # PRE_TOL (the 40- and 96-mode sets, ROADMAP C.2), the
                # systems and the backward error are gated instead.
                with all_plain(), recorded() as calls_a:
                    mm_a = np.asarray(spec["plain"](PlainSolve()))
                a_in, a_pre = _diff(mm, mm_a, spec["pre"])
                rec.update(all_plain_in=a_in, all_plain_pre=a_pre)
                msg += (f"; vs the all-plain route {a_in:.3e} (t0 >= 0), "
                        f"{a_pre:.3e} (t0 < 0)")
                if not _held(mm, mm_a, spec["pre"], MAIN_TOL, pre_tol):
                    raise RuntimeError(
                        f"{name}: kernel route and all-plain route "
                        f"disagree: {a_in:.3e} (t0 >= 0, bound "
                        f"{MAIN_TOL:.0e}), {a_pre:.3e} (t0 < 0, bound "
                        f"{pre_tol})")
                if bounded is not None:
                    msg += bounded_check("all-plain", first_order_gaps(
                        calls, calls_a, solves=2))
                f = factored_vs_plain(calls)
                rec.update(systems_rel=max(f["systems_rel"].values()),
                           epilogue_C_rel=f["C_rel"],
                           epilogue_mm=f["mm_abs"])
                msg += (f"; factored kernels vs plain on its inputs: "
                        f"systems {rec['systems_rel']:.3e}, C "
                        f"{f['C_rel']:.3e}, mm {f['mm_abs']:.3e}")
            if (pre_tol is None or spec.get("backward")) and device != "cpu":
                from qnmfits_tpu_torch.ops import chol_cuda
                bwd = max(backward_err(G, b, chol_cuda.regularised_solve(G, b))
                          for G, b in plain.systems)
                rec["backward_err"] = bwd
                msg += f"; kernel backward error {bwd:.3e}"
                if not bwd <= KERNEL_BWD_TOL:
                    raise RuntimeError(f"{name}: kernel backward error "
                                       f"{bwd:.3e} > {KERNEL_BWD_TOL:.0e}")
        if spec["oracle"] is not None:
            found = spec["oracle"](mm)
            o_in, o_pre = found[:2]
            # An oracle that bounds each window itself returns the largest
            # of its bounds third.
            o_tol = (found[2] if len(found) > 2
                     else spec.get("oracle_tol", ORACLE_TOL))
            rec.update(oracle_in=o_in, oracle_pre=o_pre, oracle_tol=o_tol)
            msg += f"; vs oracle {o_in:.3e} (t0 >= 0), {o_pre:.3e} (t0 < 0)"
            if not o_in <= o_tol:
                raise RuntimeError(f"{name}: disagrees with the NumPy "
                                   f"oracle beyond {o_tol:.0e}")
        log(f"{msg}; wall {wall:.3f} s")
        records.append(rec)
    return records


def check_closest_keys(problem, device):
    """The 'closest' dedup groups of the bench's start times against the
    windows the device computes: within a group every start time's
    (k0, k1), the argmins of ops.windows.window_closest's own scores on
    the device, equals its representative's, and distinct groups have
    distinct (k0, k1)."""
    import torch
    from qnmfits_tpu_torch import batched
    times, t0s, T = problem["times"], problem["t0s"], problem["T"]
    rep, inverse = batched._window_dedup_closest(times, t0s,
                                                 np.full_like(t0s, T))
    tt = torch.as_tensor(times, device=device)
    t0 = torch.as_tensor(t0s, device=device)[:, None]
    k0 = torch.argmin((tt - t0) ** 2, dim=-1).cpu().numpy()
    k1 = torch.argmin((tt - t0 - T) ** 2, dim=-1).cpu().numpy()
    keys = k0 * (len(times) + 1) + k1
    if not (np.array_equal(keys[rep][inverse], keys)
            and len(np.unique(keys[rep])) == len(rep)):
        raise RuntimeError("the 'closest' dedup keys group start times "
                           "the device windows differently")
    log(f"'closest' dedup: {len(rep)} groups of {len(t0s)} start times; "
        "every group's (k0, k1) on the device equals its key's")


def measure_paths(records, max_abs, build, random_wide):
    """Phase 6, on the card: the wide kernel on the 17-, 40- and 96-mode
    paths' own systems (the ones their plain route solved) beside its
    bound, its plain version and torch.linalg, with its backward error
    gated.  Each path record keeps the count and largest size of its
    systems.  Returns the wide kernel's JSON record, with phase 3's
    timings on random systems (``random_wide``)."""
    wide = {}
    for rec in records:
        systems = rec.pop("systems", None)
        if not systems:
            continue
        rec["systems"] = sum(b.shape[0] for _, b in systems)
        rec["n"] = max(b.shape[-1] for _, b in systems)
        if rec["key"] in ("n17", "n40", "n96"):
            wide[rec["n"]] = (rec, systems)

    out = {}
    for n, (rec, systems) in sorted(wide.items()):
        G, b = next((G, b) for G, b in systems if b.shape[-1] == n)
        r = out[n] = time_solves(G, b)
        r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], n)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["launches"] = rec["wide_launches"]
        log(f"wide kernel on the {n}-mode path's systems (B={r['batch']}): "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.3e} ms "
            f"({r['bound_by']}), share {r['bound_share']:.3f}; plain "
            f"{r['plain_ms']:.4f} ms; torch.linalg {r['library_ms']:.4f} "
            f"ms; backward error {r['backward_err']:.3e} (bound "
            f"{KERNEL_BWD_TOL:.0e}; plain {r['backward_err_plain']:.3e})")
        if not r["backward_err"] <= KERNEL_BWD_TOL:
            raise RuntimeError(f"wide kernel solution (n={n}) fails the "
                               "backward-error check")
    big = out[40]
    regs, _ = build
    keys = ("batch", "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
            "library_ms", "backward_err")
    return dict(name="chol_solve_wide", route="cuda",
                source="qnmfits_tpu_torch/csrc/chol_solve.cu",
                replaces="qnmfits_tpu/ops/chol_pallas.py:184",
                launches=big["launches"], max_abs_err=max_abs[40],
                ms=big["ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"], bound_by=big["bound_by"],
                library_ms=big["library_ms"],
                library="torch.linalg.cholesky_ex + torch.cholesky_solve",
                bound_share=big["bound_share"], batch=big["batch"], n=40,
                paths={n: {k: r[k] for k in keys + ("launches",)}
                       for n, r in out.items()},
                random={n: {k: r[k] for k in keys}
                        for n, r in random_wide.items()},
                max_abs_err_wide=max(max_abs[n] for n in CHECK_WIDE_N),
                backward_err=max(r["backward_err"] for r in out.values()),
                registers={k: v for k, v in regs.items() if "wide" in k})


# ---------------------------------------------------------------------------
# Phase 7: dynamic spectra and the catalog event batch
# ---------------------------------------------------------------------------

D2_STRIDE = 16                   # D2 fits every 16th start time
EVENT_ORACLE = 64                # events checked against the NumPy oracle
# Along the tracks (not the data's remnant: mismatch ~1e-4) the bench's
# 8-overtone ladder has Grams of kappa ~ 1e8, where the Gram path and the
# oracle's SVD part: by 1.3e-9 at the bench shape on the CPU, and the JAX
# package by as much (ROADMAP C.3; tests/test_torch_dynamic.py,
# test_deep_ladder_oracle_gap_is_the_jax_packages).  That set is held to
# this bound, every other set to ORACLE_TOL.
DEEP_ORACLE_TOL = 1e-8


def events_oracle(cat, mm):
    """max |mm - oracle| over EVENT_ORACLE events spread over the catalog
    (every start time is >= 0): ref_impl.ringdown_fit per event."""
    from qnmfits_tpu_torch import ref_impl
    E = len(cat["t0s"])
    d = 0.0
    picks = np.linspace(0, E - 1, EVENT_ORACLE).round().astype(int)
    for e in np.unique(picks):
        ref = ref_impl.ringdown_fit(cat["times"], cat["rows"][e], EVENT_MODES,
                                    cat["Mfs"][e], cat["chifs"][e],
                                    float(cat["t0s"][e]), T=cat["T"])
        d = max(d, abs(float(mm[e]) - ref["mismatch"]))
    return d, 0.0


def dynamic_specs(problem, device):
    """The paths of phase 7, as ``path_specs`` describes them: D1, D2
    (``backward``: the kernel's backward error on their systems is gated),
    D3 and D4."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, fitting
    from qnmfits_tpu_torch.testing import bench_mode_sets
    times, data, t0s, T = (problem[k] for k in ("times", "data", "t0s", "T"))
    Mf_t, chif_t, sets = problem["Mf_t"], problem["chif_t"], \
        problem["mode_sets"]
    kw = dict(T_array=T, spherical_modes=SPH, device=device)
    deep, row = bench_mode_sets()[DEEPEST], data[(2, 2)]
    specs = []

    def modesets(key, name, mode_sets, t0v, expect):
        def check(mm):
            gated = [i for i, ms in enumerate(mode_sets) if ms != deep]
            d_in, d_pre = oracle_diff(problem, mm, mode_sets, chif_t,
                                      Mf=Mf_t, t0s=t0v, sets_axis=gated)
            if len(gated) < len(mode_sets):
                ladder = [mode_sets.index(deep)]
                l_in, l_pre = oracle_diff(problem, mm, mode_sets, chif_t,
                                          Mf=Mf_t, t0s=t0v, sets_axis=ladder)
                log(f"{name}: the 8-overtone ladder against the oracle: "
                    f"{l_in:.3e} (t0 >= 0; bound {DEEP_ORACLE_TOL:.0e}, "
                    f"ROADMAP C.3), {l_pre:.3e} (t0 < 0)")
                if not l_in <= DEEP_ORACLE_TOL:
                    raise RuntimeError(f"{name}: the 8-overtone ladder "
                                       "disagrees with the NumPy oracle")
                d_pre = max(d_pre, l_pre)
            return d_in, d_pre

        specs.append(dict(
            key=key, name=name, expect=expect, pre=t0v < 0, backward=True,
            kernel=lambda: fitting.mismatch_t0_mode_sets(
                times, data, mode_sets, Mf_t, chif_t, t0v, dynamic=True,
                **kw),
            plain=lambda solve: batched.batch_mismatch_t0_modesets_dynamic(
                times, data, mode_sets, Mf_t, chif_t, t0v, solve=solve, **kw),
            oracle=check))

    modesets("d1", f"D1 dynamic mode sets, {len(sets)} sets x {len(t0s)} "
             "start times", sets, t0s, (1, 0))
    modesets("d2", f"D2 dynamic 17-mode set, every {D2_STRIDE}th start time",
             [SET_17], t0s[::D2_STRIDE], (1, 1))

    for method in ("geq", "closest"):
        specs.append(dict(
            key=f"d3_{method}",
            name=f"D3 mismatch_t0_array with tracks, '{method}' (deepest "
                 "set, (2,2) row)",
            kernel=lambda method=method: fitting.mismatch_t0_array(
                times, row, deep, Mf_t, chif_t, t0s, t0_method=method,
                T_array=T, device=device),
            plain=lambda solve, method=method:
                batched.batch_mismatch_t0_dynamic(
                    times, row, deep, Mf_t, chif_t, t0s, t0_method=method,
                    T_array=T, device=device, solve=solve),
            pre=t0s < 0, expect=(1, 0), oracle_tol=DEEP_ORACLE_TOL,
            oracle=lambda mm, method=method: oracle_diff(
                problem, np.asarray(mm)[None], [deep], chif_t, method,
                Mf=Mf_t, data=row)))

    cat = problem["catalog"]
    ev = (cat["times"], cat["rows"], EVENT_MODES, cat["Mfs"], cat["chifs"],
          cat["t0s"])
    specs.append(dict(
        key="d4", name=f"D4 fit_events, {len(cat['t0s'])} events",
        kernel=lambda: tq.fit_events(*ev, T=cat["T"], device=device)[0],
        plain=lambda solve: batched.batch_fit_events(
            *ev, T=cat["T"], device=device, solve=solve)[0],
        pre=None, expect=(1, 0), oracle=lambda mm: events_oracle(cat, mm)))
    return specs


def _kernel_kind(name):
    """The share of phase 7's device-time split a kernel belongs to."""
    low = name.lower()
    if "regularised_solve" in name:
        return "solve"
    if "window_moments" in name:
        return "moments"
    if "factored_systems" in name or "mismatch_rephase" in name:
        return "sweep"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "dot_kernel",
                              "xmma")):
        return "products"
    return "elementwise" if "elementwise" in low else "rest"


def device_split(fn, reps=2, host_ops=True):
    """Device time of one fn() call split by kind of record: the Gram and
    projection products (GEMM kernels), elementwise kernels (the basis
    build among them), the solve kernels, the factored sweep's kernels
    (sweep), the host-device copies and
    memsets (CUPTI's Memcpy/Memset records) and the rest (reductions,
    concatenations), from torch.profiler over reps calls, each record
    counted as in ``device_ms``.  wall_ms is a warm call's wall time
    without the profiler (mean over reps), profiled_wall_ms the same under
    the profiler, and idle_share 1 - busy / profiled_wall_ms: busy time
    and the wall it divides come from the same profiled calls; peak_gib
    the device memory the unprofiled calls peaked at.  host_ops=False
    records the device alone (no host operator events, which the
    optimisers' autograd issues by the hundred thousand).  None where the
    profiler recorded no device time."""
    import math
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) / reps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU] * host_ops
                 + [ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / reps * 1e3
    split = dict(products=0.0, elementwise=0.0, solve=0.0, moments=0.0,
                 sweep=0.0, copies=0.0, rest=0.0)
    kernels = copies = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.count == 0:
            continue
        per_call = math.ceil(e.count / reps)
        kind = _kernel_kind(e.key)
        if kind == "copies":
            copies += per_call
        else:
            kernels += per_call
        split[kind] += e.self_device_time_total / e.count * per_call / 1e3
    busy = sum(split.values())
    if busy == 0:
        return None
    return dict(wall_ms=plain_wall, profiled_wall_ms=wall, busy_ms=busy,
                peak_gib=peak,
                idle_share=1.0 - busy / wall, kernels=kernels, copies=copies,
                **{f"{k}_ms": v for k, v in split.items()})


def solve_side_by_side(batches, rounds=2):
    """The kernel's device time (``device_ms``) on each of two batches of
    systems of one shape, timed in the order A B B A, ``rounds`` times in
    one process, so that a gap between them is the systems' and not the
    run's.  Returns [mean ms of A, mean ms of B] and every reading."""
    from qnmfits_tpu_torch.ops import chol_cuda
    reads = ([], [])
    for _ in range(rounds):
        for i in (0, 1, 1, 0):
            G, b = batches[i]
            reads[i].append(device_ms(
                lambda: chol_cuda.regularised_solve(G, b)))
    return [sum(r) / len(r) for r in reads], reads


def run_dynamic(problem, device, gpu=None, main_systems=None):
    """Phase 7: ``run_specs`` on the paths of ``dynamic_specs``; on the
    card also each path's solve timed on its own systems beside its bound,
    its plain version and torch.linalg (its backward error gated), D1's
    back to back with ``main_systems`` (the main path's systems of the
    same shape), and each call's device-time split.  Returns the path
    records and the solve records by path key."""
    t = time.perf_counter()
    specs = dynamic_specs(problem, device)
    records = run_specs(specs, device)
    solves = {}
    for spec, rec in zip(specs, records):
        systems = rec.pop("systems")
        rec["systems"] = sum(b.shape[0] for _, b in systems)
        rec["n"] = max(b.shape[-1] for _, b in systems)
        if device == "cpu":
            continue
        G, b = systems[0]
        r = solves[rec["key"]] = time_solves(G, b)
        r["n"], r["launches"] = rec["n"], rec["launches"]
        r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], rec["n"])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if rec["key"] == "d1" and main_systems is not None:
            if main_systems[1].shape != b.shape:
                raise RuntimeError("D1 and the main path without dedup solve "
                                   "batches of different shapes")
            (ms_main, ms_d1), reads = solve_side_by_side([main_systems,
                                                          (G, b)])
            r["side_by_side"] = dict(main_ms=ms_main, d1_ms=ms_d1,
                                     main_reads=reads[0], d1_reads=reads[1])
            log(f"solve on {gpu}, back to back (order main D1 D1 main, "
                f"twice): main path's {b.shape[0]} systems {ms_main:.4f} ms, "
                f"D1's {ms_d1:.4f} ms; readings main "
                f"{[round(x, 4) for x in reads[0]]}, D1 "
                f"{[round(x, 4) for x in reads[1]]}")
        split = rec["split"] = device_split(spec["kernel"])
        log(f"{rec['name']} on {gpu}: solve {r['ms']:.4f} ms on its "
            f"{r['batch']} systems (n={rec['n']}), bound {r['bound_ms']:.3e} "
            f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"torch.linalg {r['library_ms']:.4f} ms, backward error "
            f"{r['backward_err']:.3e}")
        if split is None:
            log("  device-time split: torch.profiler recorded no device time "
                "(not measured)")
        else:
            log(f"  device-time split: warm wall {split['wall_ms']:.2f} ms "
                f"unprofiled, {split['profiled_wall_ms']:.2f} ms profiled; "
                f"busy {split['busy_ms']:.2f} ms, idle share of the profiled "
                f"wall {split['idle_share']:.3f}; {split['kernels']} "
                f"kernels and {split['copies']} copies: products "
                f"{split['products_ms']:.2f}, elementwise "
                f"{split['elementwise_ms']:.2f}, solve "
                f"{split['solve_ms']:.4f}, factored kernels "
                f"{split['sweep_ms']:.3f}, copies {split['copies_ms']:.2f}, "
                f"rest {split['rest_ms']:.2f} ms")
        if not r["backward_err"] <= KERNEL_BWD_TOL:
            raise RuntimeError(f"{rec['name']}: kernel backward error "
                               f"{r['backward_err']:.3e}")
    wall = time.perf_counter() - t
    log(f"phase 7: {len(records)} paths in {wall:.1f} s")
    return records, solves, wall


# ---------------------------------------------------------------------------
# Phase 8: the optimisers
# ---------------------------------------------------------------------------

# O1 fits the (2,2) row with the overtones (2,2,n=1..3) fixed and one free
# mode, which finds the fundamental: a free mode on top of (2,2,n<4) would
# have nothing left to find once the ringdown's higher overtones have
# decayed below the data's precision (from t0 ~ 10 on), and its optimum
# would be any frequency.
OPT_FIXED = [(2, 2, n, 1) for n in range(1, 4)]
OPT_ORACLE_T0S = (0.0, 2.5, 5.0, 10.0, 15.0, 20.0, 30.0, 40.0)
FF_ORACLE_TOL = 1e-5     # omega vs Nelder-Mead (tests/test_optimize.py:121)
EPS_ORACLE_TOL = 1e-6    # (Mf, chif) vs one-window calculate_epsilon (:140)
OPT_MM_TOL = 1e-10       # kernel vs plain route: mismatch at the optimum
# ... and parameters where both report ok.  A Newton endpoint is fixed
# only to where the gradient's rounding balances the Hessian: two routes
# that differ by rounding alone end 1.3e-8 apart at the SMALL size on the
# CPU, so the JAX package's own optimiser bar (tests/test_optimize.py)
# gates and the measured gap is reported.
OPT_PARAM_TOL = 1e-6
# The one-window L-BFGS-B paths: parameters kernel vs plain route, and
# against Nelder-Mead (omega; the remnant is reported).
LBFGS_PARAM_TOL = 1e-6
# Gradient and Hessian, kernel vs plain route, 0.01 off the optimum.  Two
# backward-stable solves differ by ~cond * eps in the amplitudes, and the
# 8-overtone ladder's equilibrated Grams reach cond ~1e8: O2's read
# 1.8e-8 on the H100, O1's (four modes) 4.9e-13 (PERF.md, section 6).
GRAD_RTOL = 1e-6


def _nearest(t0s, values):
    return sorted({int(np.argmin(np.abs(t0s - v))) for v in values
                   if t0s[0] <= v <= t0s[-1]})


def opt_launches(problem, kind, K, J):
    """The solve and window-moments launches an array optimiser must make,
    derived from the code: its window chunks (optimize.free_frequency_
    chunks / epsilon_chunks over the distinct windows) times, per chunk:
    the seeds' (none for the bordered free-frequency seeds; for the
    remnant's two seed stages one moments launch and one solve each); the
    winning seed's exact fit (free frequency: one of each); each Newton
    step's 4 solves from 2 moments launches (the order-2 moments, then the
    fit C, its first derivatives and its second, each order one stacked
    solve; the trial fit's order-0 moments and solve); and the final
    gradient's order-1 moments and 2 solves.  The plain route makes every
    solve through its given solve, so its solves are the launches.
    Returns (solve launches, moments launches, chunks)."""
    from qnmfits_tpu_torch import optimize
    t0s, maxiter = problem["t0s"], problem["opt_maxiter"]
    n_win = len(optimize._windows(problem["times"], t0s, problem["T"], "geq",
                                  True)[0])
    if kind == "ff":
        chunks = optimize.free_frequency_chunks(n_win, K, J - 1)
        seeds = 1
    else:
        chunks = optimize.epsilon_chunks(n_win, K, J)
        seeds = 2
    solves = (seeds + 4 * maxiter + 2) * len(chunks)
    moments = (seeds + 2 * maxiter + 1) * len(chunks)
    return solves, moments, len(chunks)


@contextlib.contextmanager
def plain_moments():
    """Inside it the array optimisers' window moments run their plain
    PyTorch version on the card (with a PlainSolve, every stage of an
    optimiser's fits is plain).  The port never does that itself; this
    script swaps the module's function for the comparison and puts it
    back."""
    from qnmfits_tpu_torch.ops import moments_cuda
    saved = moments_cuda.window_moments
    moments_cuda.window_moments = (
        lambda *a, grid=None: moments_cuda.window_moments_plain(*a))
    try:
        yield
    finally:
        moments_cuda.window_moments = saved


@contextlib.contextmanager
def recording_moments():
    """Keeps the arguments of the first call of the window moments at each
    order made inside it ({order: args}); the calls themselves are
    unchanged."""
    from qnmfits_tpu_torch.ops import moments_cuda
    calls = {}
    saved = moments_cuda.window_moments

    def call(*args, **kw):
        calls.setdefault(args[-1], args)
        return saved(*args, **kw)

    moments_cuda.window_moments = call
    try:
        yield calls
    finally:
        moments_cuda.window_moments = saved


def opt_gradients(problem, device, kind, x, n_check=64):
    """The objective's gradient and Hessian (``optimize._fit_derivs``, the
    window moments and the implicit solve) through the kernel route (the
    moments kernel and the solve kernel) against the plain route (their
    plain versions), and against autograd through the kernel solve
    (``optimize._grad``), on the first n_check distinct windows with t0 >=
    0: the largest relative differences 0.01 off their optimum x (in both
    parameters), and at x, where the gradient is a cancellation to ~0, the
    gradient's difference between the routes as a step, max |d g| / max
    |H|.  Returns dict(grad_rel, hess_rel, grad_step, autograd_grad_rel,
    autograd_hess_rel)."""
    import torch
    from qnmfits_tpu_torch import engine_real, optimize
    from qnmfits_tpu_torch.engine import cached_evaluator
    from qnmfits_tpu_torch.testing import bench_mode_sets
    t0s, Ts = optimize._windows(problem["times"], problem["t0s"],
                                problem["T"], "geq", True)[:2]
    keep = np.flatnonzero(t0s >= 0)[:n_check]
    dev = torch.device(device)
    if kind == "ff":
        rows = np.asarray(problem["data"][(2, 2)])[None]
        fixed = torch.as_tensor(cached_evaluator(OPT_FIXED).omega(CHIF, MF),
                                device=dev)
        spectrum = optimize.free_frequency_spectrum(fixed)
    else:
        rows = np.stack([problem["data"][lm] for lm in SPH])
        ev = cached_evaluator(bench_mode_sets()[DEEPEST], SPH)
        spectrum = optimize.epsilon_spectrum(ev, SPH, 1.0, dev)
    xt = torch.as_tensor(np.asarray(x)[keep], device=dev)
    win = torch.arange(len(keep), device=dev)
    out = {}
    for name, solve in (("kernel", None),
                        ("plain", engine_real._regularised_solve_plain)):
        prob = optimize._Problem(problem["times"], rows, t0s[keep], Ts[keep],
                                 "geq", dev, solve)
        with plain_moments() if name == "plain" else contextlib.nullcontext():
            out[name] = [optimize._fit_derivs(prob, spectrum, xt + shift,
                                              win, 2)[1:]
                         for shift in (0.01, 0.0)]
        if name == "kernel":
            out["autograd"] = optimize._grad(
                lambda y: prob.mm(*spectrum(y), win), xt + 0.01,
                hessian=True)
    (g, H), (g0, H0) = out["kernel"]
    (gp, Hp), (gp0, _) = out["plain"]
    ga, Ha = out["autograd"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    return dict(grad_rel=rel(g, gp), hess_rel=rel(H, Hp),
                grad_step=float((g0 - gp0).abs().max() / H0.abs().max()),
                autograd_grad_rel=rel(g, ga), autograd_hess_rel=rel(H, Ha))


def optimiser_specs(problem, device):
    """The paths of phase 8.  Each spec: key, name, ``kernel`` and
    ``plain`` (the call through the kernel route and with a given solve),
    ``expect`` (the launches on the card), ``check`` (kernel result, plain
    result -> dict of gaps, raising on a failed gate)."""
    from qnmfits_tpu_torch import fitting, optimize, ref_impl
    from qnmfits_tpu_torch.testing import bench_mode_sets
    import qnmfits_tpu_torch as tq
    times, data, t0s, T = (problem[k] for k in ("times", "data", "t0s", "T"))
    row, deep = data[(2, 2)], bench_mode_sets()[DEEPEST]
    K, pre = len(times), t0s < 0
    oracle_idx = _nearest(t0s, OPT_ORACLE_T0S)
    specs = []

    def route_gaps(name, mm, mm_p, dx, ok, ok_p):
        """Kernel route against plain route: the mismatch at the optimum
        (t0 >= 0 gated, t0 < 0 reported) and the largest parameter gap dx
        (per start time) where both report ok."""
        both = ok & ok_p & ~pre
        gaps = dict(route_mm=float(np.max(np.abs(mm - mm_p)[~pre])),
                    route_mm_pre=float(np.max(np.abs(mm - mm_p)[pre],
                                              initial=0.0)),
                    route_param=float(np.max(dx[both], initial=0.0)),
                    ok_share=float(np.mean(ok[~pre])),
                    both_ok=int(both.sum()))
        if not (gaps["route_mm"] <= OPT_MM_TOL
                and gaps["route_param"] <= OPT_PARAM_TOL):
            raise RuntimeError(f"{name}: kernel and plain routes disagree: "
                               f"{gaps}")
        return gaps

    ff_kw = dict(modes=OPT_FIXED, Mf=MF, chif=CHIF, T_array=T,
                 maxiter=problem["opt_maxiter"], return_mismatch=True,
                 device=device)

    def ff_check(out, out_p):
        (w, mm, ok), (w_p, mm_p, ok_p) = out, out_p
        gaps = route_gaps("O1", mm, mm_p, np.abs(w - w_p), ok, ok_p)
        gaps["oracle"] = max(abs(w[i] - ref_impl.free_frequency_fit(
            times, row, float(t0s[i]), modes=OPT_FIXED, Mf=MF, chif=CHIF,
            T=T)) for i in oracle_idx)
        if not gaps["oracle"] <= FF_ORACLE_TOL:
            raise RuntimeError(f"O1: omega {gaps['oracle']:.3e} from "
                               "Nelder-Mead")
        return gaps

    ff_l, ff_m, ff_c = opt_launches(problem, "ff", K, len(OPT_FIXED) + 1)
    specs.append(dict(
        key="o1", name=f"O1 free_frequency_fit_array, (2,2) row, "
        f"{len(OPT_FIXED)} fixed + 1 free", expect=ff_l, forward=ff_l,
        moments=ff_m, chunks=ff_c, kind="ff",
        kernel=lambda: tq.free_frequency_fit_array(times, row, t0s, **ff_kw),
        plain=lambda solve: optimize.free_frequency_fit_array(
            times, row, t0s, solve=solve, **ff_kw), check=ff_check))

    eps_kw = dict(spherical_modes=SPH, T_array=T,
                  maxiter=problem["opt_maxiter"], return_mismatch=True,
                  device=device)

    def eps_check(out, out_p):
        (_, Mf, chif, mm, ok), (_, Mf_p, chif_p, mm_p, ok_p) = out, out_p
        x, x_p = np.stack([Mf, chif], 1), np.stack([Mf_p, chif_p], 1)
        gaps = route_gaps("O2", mm, mm_p, np.abs(x - x_p).max(1), ok, ok_p)
        gaps["oracle"] = max(
            float(np.max(np.abs(np.array(fitting.calculate_epsilon(
                times, data, deep, MF, CHIF, float(t0s[i]), T=T,
                spherical_modes=SPH, device=device)[1:]) - x[i])))
            for i in oracle_idx)
        if not gaps["oracle"] <= EPS_ORACLE_TOL:
            raise RuntimeError(f"O2: remnant {gaps['oracle']:.3e} from the "
                               "one-window calculate_epsilon")
        return gaps

    eps_l, eps_m, eps_c = opt_launches(problem, "eps", K, len(deep))
    specs.append(dict(
        key="o2", name=f"O2 calculate_epsilon_array, both rows, "
        f"(2,2,n<{len(deep)})", expect=eps_l, forward=eps_l, moments=eps_m,
        chunks=eps_c, kind="eps",
        kernel=lambda: tq.calculate_epsilon_array(times, data, deep, MF, CHIF,
                                                  t0s, **eps_kw),
        plain=lambda solve: optimize.calculate_epsilon_array(
            times, data, deep, MF, CHIF, t0s, solve=solve, **eps_kw),
        check=eps_check))

    res = problem["res"]
    omega_args = (times, row, deep[:2], MF, CHIF, *OMEGA_BOX, GRID_T0)

    def o3_check(mm, _):
        mm_b = fitting.mismatch_omega_grid(*omega_args, T=T, res=res,
                                           device=device)
        ref = ref_impl.mismatch_omega_grid(*omega_args, T=T, res=res)
        gaps = dict(vs_batched=_diff(mm, mm_b, None)[0],
                    oracle=_diff(mm, ref, None)[0])
        if not (gaps["vs_batched"] <= MAIN_TOL
                and gaps["oracle"] <= ORACLE_TOL):
            raise RuntimeError(f"O3: {gaps}")
        return gaps

    specs.append(dict(
        key="o3", name=f"O3 mismatch_omega_grid engine='fast' res={res}",
        expect=0, forward=0, chunks=0,
        kernel=lambda: fitting.mismatch_omega_grid(
            *omega_args, T=T, res=res, engine="fast", device=device),
        plain=None, check=o3_check))

    def single_calls(solve=None):
        out = []
        for t0 in SINGLE_T0S:
            out.append(optimize.calculate_epsilon_gradient(
                times, data, deep, MF, CHIF, t0, T=T, spherical_modes=SPH,
                device=device, solve=solve)[1:])
            w = optimize.free_frequency_fit_gradient(
                times, row, t0, modes=OPT_FIXED, Mf=MF, chif=CHIF, T=T,
                device=device, solve=solve)
            out.append((w.real, w.imag))
        return np.array(out)

    def single_check(x, x_p):
        gaps = dict(route_param=float(np.max(np.abs(x - x_p))))
        nm = []
        for t0 in SINGLE_T0S:
            nm.append(ref_impl.calculate_epsilon(
                times, data, deep, MF, CHIF, t0, T=T,
                spherical_modes=SPH)[1:])
            w = ref_impl.free_frequency_fit(times, row, t0, modes=OPT_FIXED,
                                            Mf=MF, chif=CHIF, T=T)
            nm.append((w.real, w.imag))
        d = np.abs(x - np.array(nm)).max(1)
        gaps["oracle_remnant"] = float(d[0::2].max())
        gaps["oracle"] = float(d[1::2].max())
        if not (gaps["route_param"] <= LBFGS_PARAM_TOL
                and gaps["oracle"] <= FF_ORACLE_TOL):
            raise RuntimeError(f"one-window L-BFGS-B paths: {gaps}")
        return gaps

    specs.append(dict(
        key="single", name="calculate_epsilon + free_frequency_fit "
        f"('gradient'), t0 = {SINGLE_T0S}", expect=None, forward=None,
        chunks=0, kernel=lambda: single_calls(),
        plain=lambda solve: single_calls(solve), check=single_check))
    return specs


MOMENTS_RTOL = 1e-12     # moments kernel vs plain, of a moment's largest entry
MOMENTS_TIMED_BY = dict(
    ms="CUDA events around 20 back-to-back launches of the kernel's C "
       "entry (moments_cuda._launch) on preallocated outputs, in the "
       "variant the wrapper picks (variant_ms: each variant so)",
    phases="moments_cuda.phase_cycles: a warp's clock64 cycles by phase "
           "in the phases build, one launch, in the wrapper's variant",
    call_ms="CUDA events around back-to-back wrapper calls (the windows' "
            "bounds and the outputs' allocation included, the grid given "
            "as the optimisers give it)",
    plain_ms="CUDA events around back-to-back plain-version calls",
    library_ms="CUDA events around the 2 (order + 1) batched torch.matmul "
               "pairs of the same moments (A^H phi and h conj(A) for each "
               "weighted design A) from designs materialised beforehand: "
               "the designs' build is excluded",
    variant_bound_ms="the bound of the operations and bytes the variant "
                     "needs: the uniform one sums (order + 1) weights, "
                     "not 2 (order + 1), and reads no tau")


def moments_forced(args, grid):
    """S and P of one launch of the moments kernel through its C entry
    (``moments_cuda._launch``) on a recorded call's inputs ``args``, in
    the variant of ``grid`` (``moments_cuda.moments_grid``'s, or (False,
    0.0) for the general variant on any grid)."""
    import torch
    from qnmfits_tpu_torch.ops import moments_cuda
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    times, rows, omega, t0s, w, win, order = args
    first, count = (b.to(torch.int32) for b in moments_cuda.window_bounds(w))
    M, J = omega.shape
    S, P = (torch.full((M, 2, order + 1, n, J), complex("nan+nanj"),
                       dtype=torch.complex128, device=omega.device)
            for n in (J, rows.shape[0]))
    tau = None if grid[0] else trapz_weights(times, w)
    moments_cuda._launch(times, rows, omega, t0s, tau, first, count, win, S,
                         P, order, grid)
    return S, P


def moments_gap(out, ref):
    """The window moments ``out`` against the plain version's ``ref`` on
    the same inputs: for each moment (S or P, weight v, power p) the
    largest |difference| over the moment's largest entry (over the
    batch), the largest of these (rel), the largest |difference|
    (max_abs) and the batch (M)."""
    rel = max_abs = 0.0
    for a, b in zip(out, ref):
        for v in range(2):
            for p in range(a.shape[2]):
                d = float((a[:, v, p] - b[:, v, p]).abs().max())
                rel = max(rel, d / float(b[:, v, p].abs().max()))
                max_abs = max(max_abs, d)
    return dict(rel=rel, max_abs=max_abs, M=int(out[0].shape[0]))


def nonuniform_copy(args, seed=0):
    """A recorded call's inputs on a grid that the uniform gate refuses:
    each time moved by up to 1e-3 of a step, the same windows (w)."""
    import torch
    times, rows, omega, t0s, w, win, order = args
    rng = np.random.default_rng(seed)
    dt = float(times[1] - times[0])
    moved = times + torch.as_tensor(
        rng.uniform(-1e-3, 1e-3, times.shape[0]) * dt, device=times.device)
    return (moved, rows, omega, t0s, w, win, order)


def check_moments_variants(key, order, args, nonuniform=False):
    """Phase 8's check of the moments kernel on an optimiser's recorded
    inputs ``args`` (their grid uniform): the variant the wrapper picks
    (the uniform one), the general one forced, and with ``nonuniform`` the
    wrapper on ``nonuniform_copy`` (the general one), each against the
    plain version on the same inputs (``MOMENTS_RTOL``).  Returns {name:
    gap}."""
    from qnmfits_tpu_torch.ops import moments_cuda
    plain = moments_cuda.window_moments_plain
    ref = plain(*args)
    out = moments_cuda.window_moments(*args)
    gaps = {"wrapper": dict(moments_gap(out, ref),
                            variant=moments_cuda.last_plan["variant"]),
            "general": dict(moments_gap(moments_forced(args, (False, 0.0)),
                                        ref),
                            variant=moments_cuda.last_plan["variant"])}
    if nonuniform:
        copy = nonuniform_copy(args)
        out = moments_cuda.window_moments(*copy)
        gaps["nonuniform"] = dict(moments_gap(out, plain(*copy)),
                                  variant=moments_cuda.last_plan["variant"])
    want = dict(wrapper="uniform", general="general", nonuniform="general")
    for name, gap in gaps.items():
        log(f"  window moments kernel ({name}: {gap['variant']} variant) vs "
            f"plain on {key}'s first order-{order} inputs ({gap['M']} "
            f"trajectories): {gap['rel']:.3e} of each moment's largest "
            f"entry (bound {MOMENTS_RTOL:.0e}), largest |difference| "
            f"{gap['max_abs']:.3e}")
        if gap["variant"] != want[name]:
            raise RuntimeError(f"{key}: the moments wrapper ran the "
                               f"{gap['variant']} variant for {name}")
        if not gap["rel"] <= MOMENTS_RTOL:
            raise RuntimeError(f"{key}: the moments kernel ({name}) and its "
                               f"plain version differ by {gap['rel']:.3e}")
    return gaps


def moments_bound(count, win, K, N, I, J, order, weights=2):
    """(FP64 operations, bytes) of the window moments on these inputs,
    with ``weights`` weights summed: 2 (w and tau, the first design's
    loops: the yardstick every design's share is read against) or 1 (the
    uniform variant, which sums the w moments only and reads no tau).
    Operations: a (trajectory, window sample, entry) its conj product (6)
    and its weights (order + 1) weighted sums (4 each); a (trajectory,
    sample, mode) its phase (4 products, the exp and the sincos one
    operation each); a (trajectory, sample) its weights (order + 1)
    weights; count (N,) the windows' sample counts, win (M,) the
    trajectories' windows.  Bytes: each input read once (times, rows,
    omega, t0s, tau where summed, the windows' bounds and win), each
    output written once (S and P)."""
    nw = weights * (order + 1)
    M = win.shape[0]
    samples = int(count[win].sum())
    flops = samples * ((J * (J + 1) // 2 + I * J) * (6 + 4 * nw) + 6 * J
                       + nw)
    nbytes = (8 * K + 16 * I * K + 16 * M * J + 8 * N
              + 8 * N * K * (weights - 1) + 16 * N + 8 * M
              + 16 * M * 2 * (order + 1) * (J * J + I * J))
    return flops, nbytes


def moments_library_ms(args):
    """``MOMENTS_TIMED_BY['library_ms']`` on the inputs ``args``."""
    import torch
    from qnmfits_tpu_torch.ops.cmath import damped_phase
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    times, rows, omega, t0s, w, win, order = args
    wm = w[win]
    tau = trapz_weights(times, w)[win]
    s = (times - t0s[win][:, None]) * wm
    phi = damped_phase(omega[:, None, :], s[..., None])
    powers = [torch.ones_like(s), s, s * s][:order + 1]
    mats = []
    for vw in (wm, tau):
        for sp in powers:
            a = phi * (vw * sp)[..., None]
            mats.append((a, a.conj().resolve_conj()))
    del s, wm, tau

    def library():
        for a, ac in mats:
            torch.matmul(a.mH, phi)
            torch.matmul(rows, ac)

    return event_ms(library, reps=5)


def moments_timing(args, phases=False):
    """The moments kernel's ms (the wrapper's variant), each variant's
    (variant_ms), call_ms and plain_ms (``MOMENTS_TIMED_BY``), its bound
    on the inputs ``args`` and the variant's own (``variant_bound_ms``),
    and with ``phases`` a warp's cycles by phase in the wrapper's variant
    (``moments_cuda.phase_cycles``)."""
    import torch
    from qnmfits_tpu_torch.ops import moments_cuda
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    times, rows, omega, t0s, w, win, order = args
    grid = moments_cuda.moments_grid(times)
    first, count = (b.to(torch.int32)
                    for b in moments_cuda.window_bounds(w))
    tau = trapz_weights(times, w)
    S, P = moments_cuda.window_moments(*args, grid=grid)
    variant = moments_cuda.last_plan["variant"]
    I, K = rows.shape
    M, J = omega.shape
    grids = ({"uniform": grid, "general": (False, 0.0)} if grid[0]
             else {"general": grid})
    variant_ms = {v: event_ms(lambda g=g: moments_cuda._launch(
        times, rows, omega, t0s, None if g[0] else tau, first, count, win, S,
        P, order, g)) for v, g in grids.items()}
    rec = dict(
        M=M, order=order, variant=variant, ms=variant_ms[variant],
        variant_ms=variant_ms,
        call_ms=event_ms(lambda: moments_cuda.window_moments(*args,
                                                             grid=grid)),
        plain_ms=event_ms(lambda: moments_cuda.window_moments_plain(*args),
                          reps=3))
    if phases:
        rec["phases"] = moments_cuda.phase_cycles(*args, grid=grid)
    for name, weights in (("", 2), ("variant_", 1 if grid[0] else 2)):
        flops, nbytes = moments_bound(count.long(), win, K, t0s.shape[0], I,
                                      J, order, weights)
        ops_ms = flops / FP64_FLOP_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec.update({f"{name}flops": flops, f"{name}bytes": nbytes,
                    f"{name}bound_ms": max(ops_ms, bytes_ms),
                    f"{name}bound_by": ("operations" if ops_ms >= bytes_ms
                                        else "bytes")})
        rec[f"{name}bound_share"] = rec[f"{name}bound_ms"] / rec["ms"]
    return rec


def measure_moments(moments, records, gpu):
    """The window moments kernel's JSON record: timed on O2's first
    Newton step's order-2 inputs (2565 trajectories; with library_ms and
    a warp's cycles by phase) and on its first seed stage's order-0
    inputs, on O1's order-2 inputs, and on O2's order-2 inputs on a
    non-uniform grid (the general variant); its registers, its launches
    on phase 8's O1 and O2, and its largest gap from the plain version on
    their own inputs."""
    from qnmfits_tpu_torch.ops import moments_cuda
    timed = {}
    for key, order in (("o2", 2), ("o2", 0), ("o1", 2), ("o2_nonuniform", 2)):
        args = (nonuniform_copy(moments[("o2", 2)]["args"])
                if key == "o2_nonuniform" else moments[(key, order)]["args"])
        main = (key, order) == ("o2", 2)
        r = timed[f"{key}_order{order}"] = moments_timing(args, phases=main)
        if main:
            r["library_ms"] = moments_library_ms(args)
        log(f"window moments kernel on {key}'s order-{order} inputs "
            f"({r['M']} trajectories) on {gpu}: {r['ms']:.4f} ms "
            f"({r['variant']} variant; "
            + ", ".join(f"{v} {t:.4f} ms" for v, t in r["variant_ms"].items())
            + f"; call {r['call_ms']:.4f} ms), bound {r['bound_ms']:.3e} ms "
            f"({r['bound_by']}, {r['flops']:.3e} FP64 operations), share "
            f"{r['bound_share']:.3f}; the variant's own bound "
            f"{r['variant_bound_ms']:.3e} ms, share "
            f"{r['variant_bound_share']:.3f}; plain {r['plain_ms']:.4f} ms"
            + (f"; batched torch.matmul from built designs "
               f"{r['library_ms']:.4f} ms" if "library_ms" in r else ""))
        if "phases" in r:
            log(f"  {r['variant']} variant, a warp's cycles by phase: "
                + ", ".join(f"{name} {c:.0f}" for name, c in
                            r["phases"].items()
                            if name not in ("warps", "variant")))
    main = timed["o2_order2"]
    by_key = {r["key"]: r for r in records}
    report = moments_cuda.ptxas_report()
    return dict(
        name="window_moments", route="cuda",
        source="qnmfits_tpu_torch/csrc/window_moments.cu",
        replaces="qnmfits_tpu/optimize.py:177",
        launches=by_key["o2"]["moments_launches"],
        launches_o1=by_key["o1"]["moments_launches"],
        max_abs_err=max(m["max_abs"] for m in moments.values()),
        max_rel_err=max(m["rel"] for m in moments.values()),
        variant=main["variant"], variant_ms=main["variant_ms"],
        phases=main["phases"],
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], bound_share=main["bound_share"],
        variant_bound_ms=main["variant_bound_ms"],
        variant_bound_share=main["variant_bound_share"],
        call_ms=main["call_ms"], timed_by=MOMENTS_TIMED_BY,
        shapes={k: {x: v for x, v in r.items()} for k, r in timed.items()},
        registers={k: r["registers"] for k, r in report.items()})


def run_optimisers(problem, device, gpu=None):
    """Phase 8: drive each optimiser path through its public entry point
    with the launch counts read as in phase 6, check the launches against
    the derived counts (the one-window paths: twice their objective
    evaluations), hold each against its plain route and its oracle, and
    on the card hold the window moments kernel to its plain version on
    O1's and O2's own first order-2 and order-0 inputs, check the
    objectives' gradients and Hessians through both routes and against
    autograd, split each array optimiser's device time and time the
    moments kernel and the solve on O2's own inputs.  Returns (path
    records, O2's solve timings, the phase's wall, the moments kernel's
    JSON record or None on the CPU)."""
    from qnmfits_tpu_torch import optimize
    t = time.perf_counter()
    records, solves, moments = [], {}, {}
    for spec in optimiser_specs(problem, device):
        optimize.evaluations = 0
        with recording_moments() as mom_args:
            out, n, n_wide, wall, (_, _, n_mom) = drive(spec["kernel"])
        expect = (2 * optimize.evaluations if spec["expect"] is None
                  else spec["expect"])
        rec = dict(key=spec["key"], name=spec["name"], launches=n,
                   wide_launches=n_wide, expected_launches=expect,
                   moments_launches=n_mom,
                   expected_moments_launches=spec.get("moments", 0),
                   chunks=spec["chunks"], wall_s=wall)
        if device != "cpu" and (n, n_wide, n_mom) != (
                expect, 0, rec["expected_moments_launches"]):
            raise RuntimeError(f"{spec['name']}: {n} solve launches "
                               f"({n_wide} wide) and {n_mom} moments "
                               f"launches, derived {expect} and "
                               f"{rec['expected_moments_launches']}")
        if device != "cpu" and spec["key"] in ("o1", "o2"):
            for order in (2, 0):
                gaps = check_moments_variants(
                    spec["key"], order, mom_args[order],
                    nonuniform=(spec["key"], order) == ("o2", 2))
                rec[f"moments_rel_order{order}"] = max(
                    g["rel"] for g in gaps.values())
                rec[f"moments_variants_order{order}"] = {
                    k: {x: g[x] for x in ("rel", "variant")}
                    for k, g in gaps.items()}
                moments[(spec["key"], order)] = dict(
                    gaps["wrapper"], args=mom_args[order],
                    rel=rec[f"moments_rel_order{order}"],
                    max_abs=max(g["max_abs"] for g in gaps.values()))
        plain = None
        if spec["plain"] is not None:
            plain = PlainSolve()
            t_p = time.perf_counter()
            with plain_moments():
                out_p = spec["plain"](plain)
            rec["plain_wall_s"] = time.perf_counter() - t_p
            calls = len(plain.systems)
            if spec["forward"] is not None and calls != spec["forward"]:
                raise RuntimeError(f"{spec['name']}: the plain route made "
                                   f"{calls} forward solves, derived "
                                   f"{spec['forward']}")
        else:
            out_p = None
        for v in (out if isinstance(out, tuple) else (out,)):
            if not np.all(np.isfinite(np.asarray(v, float)
                                      if np.asarray(v).dtype != complex
                                      else np.abs(v))):
                raise RuntimeError(f"{spec['name']}: non-finite output")
        rec.update(spec["check"](out, out_p))
        log(f"{spec['name']}: launches {n} (derived {expect}), wall "
            f"{wall:.2f} s; " + ", ".join(
                f"{k} {v:.3e}" for k, v in rec.items()
                if isinstance(v, float) and k != "wall_s"))
        if device != "cpu" and spec["key"] in ("o1", "o2"):
            x = (np.stack([out[0].real, out[0].imag], 1) if spec["key"] == "o1"
                 else np.stack([out[1], out[2]], 1))
            x = _distinct(problem, x)
            rec.update(opt_gradients(problem, device, spec["kind"], x))
            worst = max(rec[k] for k in ("grad_rel", "hess_rel",
                                         "autograd_grad_rel",
                                         "autograd_hess_rel"))
            if not worst <= GRAD_RTOL:
                raise RuntimeError(f"{spec['name']}: gradient or Hessian "
                                   "through the kernel route, the plain "
                                   "route and autograd differ: "
                                   f"{rec['grad_rel']:.3e}, "
                                   f"{rec['hess_rel']:.3e}, "
                                   f"{rec['autograd_grad_rel']:.3e}, "
                                   f"{rec['autograd_hess_rel']:.3e}")
            rec["split"] = device_split(spec["kernel"], reps=1,
                                        host_ops=False)
        if device != "cpu" and spec["key"] == "o2":
            # The seed stage's first launch and the Newton stage's.
            n_win = len(_distinct(problem, problem["t0s"]))
            for batch in (n_win * (len(optimize._OFFS)
                                   + len(optimize._GLOBAL)),
                          n_win * (1 + optimize.NPOL)):
                G, b = next(s for s in plain.systems if len(s[1]) == batch)
                r = solves[batch] = time_solves(G, b)
                r["bound_ms"], r["bound_by"] = bound_ms(batch, b.shape[-1])
                r["bound_share"] = r["bound_ms"] / r["ms"]
                log(f"solve on O2's {batch} systems (n={b.shape[-1]}) on "
                    f"{gpu}: {r['ms']:.4f} ms, bound {r['bound_ms']:.3e} ms "
                    f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                    f"torch.linalg {r['library_ms']:.4f} ms, backward error "
                    f"{r['backward_err']:.3e}")
                if not r["backward_err"] <= KERNEL_BWD_TOL:
                    raise RuntimeError("O2: kernel backward error "
                                       f"{r['backward_err']:.3e}")
        if "grad_rel" in rec:
            log(f"  gradient / Hessian kernel vs plain route, 0.01 off the "
                f"optimum: {rec['grad_rel']:.3e} / {rec['hess_rel']:.3e} "
                f"relative, vs autograd {rec['autograd_grad_rel']:.3e} / "
                f"{rec['autograd_hess_rel']:.3e} (bound {GRAD_RTOL:.0e}); "
                f"at the optimum the gradient's difference as a step "
                f"{rec['grad_step']:.3e}")
        split = rec.get("split")
        if split is not None:
            log(f"  device-time split: warm wall {split['wall_ms']:.1f} ms "
                f"unprofiled, {split['profiled_wall_ms']:.1f} ms profiled; "
                f"busy {split['busy_ms']:.1f} ms, idle share "
                f"{split['idle_share']:.3f}; peak memory "
                f"{split['peak_gib']:.2f} GiB; {split['kernels']} kernels: "
                f"products {split['products_ms']:.2f}, elementwise "
                f"{split['elementwise_ms']:.2f}, solve "
                f"{split['solve_ms']:.3f}, moments kernel "
                f"{split['moments_ms']:.3f}, factored kernels "
                f"{split['sweep_ms']:.3f}, copies {split['copies_ms']:.2f}, "
                f"rest {split['rest_ms']:.2f} ms")
        records.append(rec)
    record = None
    if device != "cpu":
        record = measure_moments(moments, records, gpu)
    wall = time.perf_counter() - t
    log(f"phase 8: {len(records)} paths in {wall:.1f} s")
    return records, solves, wall, record


def _distinct(problem, x):
    """x over every start time -> x over the distinct windows (the first
    start time of each)."""
    from qnmfits_tpu_torch import batched
    dd = batched._window_dedup(problem["times"], problem["t0s"],
                               np.full_like(problem["t0s"], problem["T"]))
    return x if dd is None else x[dd[0]]


# ---------------------------------------------------------------------------
# Phase 9: the diagnostics and the stacked spectrum grids
# ---------------------------------------------------------------------------

G1_BOX = ((0.90, 1.00), (0.60, 0.80))        # (Mf, chif) box of G1
# The 8-overtone ladder on the (Mf, chif) grid: off the remnant its Grams
# are so ill-conditioned that the Gram path and the oracle's SVD part
# (ROADMAP C.3), and so do two backward-stable solves.  At res = 20 on the
# CPU the JAX package's own 'fast' grid reads 4.6e-8 from its NumPy loop
# and 9.6e-10 from its 'batched' grid, the port's 4.6e-8 and 1.6e-9; at
# res = 50 the plain solve and torch.linalg's Cholesky read 1.3e-10
# apart.  The ladder's grids are held to these bounds (route and 'batched'
# LADDER_GRID_ROUTE_TOL, with the kernel's backward error gated); the
# (2,2,n<4) set (GRID_SET), well conditioned, to ORACLE_TOL and MAIN_TOL.
LADDER_GRID_ORACLE_TOL = 1e-7
LADDER_GRID_ROUTE_TOL = 1e-8
# S1's amplitudes against the oracle's at 8 windows, largest |dC| over
# largest |C| a window: the ladder's top overtones are fixed only to
# ~kappa eps by the Gram path (1.0e-4 at t0 = 0 on the CPU); a wrong
# rephasing reads ~0.1-1.
STAB_C_RTOL = 1e-3
U1_NOISE = 1e-4          # white complex noise a quadrature on U1's data
U1_RTOL = 1e-9           # U1 vs the NumPy formula, relative (p: absolute)
FILTER_TOL = 1e-12       # F1 vs the oracle, of max |data|
FILTER_DROP = 1e4        # F1: the filtered mode's amplitude falls this much


def window_samples(problem, t0):
    t = problem["times"]
    return int(np.count_nonzero((t >= t0) & (t < t0 + problem["T"])))


def stacked_launches(n_points, J, K_window):
    """Solve launches of a stacked grid of n_points fits of J modes on a
    window of K_window samples, derived from the code: the join groups of
    batched._run_spectra_sweep's default chunks."""
    from qnmfits_tpu_torch import batched, engine_real
    chunk = max(1, batched._BASIS_BYTES // (K_window * J * 16))
    sizes = [min(chunk, n_points - lo) for lo in range(0, n_points, chunk)]
    return len(engine_real.join_groups(sizes, 2 * J * J * 16))


def stability_launches(problem, J):
    """Solve launches of amplitude_stability on the problem's start times
    with dedup, derived from the code: the join groups of
    batched.sweep_t0_modesets's chunks over the distinct windows."""
    from qnmfits_tpu_torch import batched, engine_real
    n = len(_distinct(problem, problem["t0s"]))
    per_t0 = len(problem["times"]) * J * 16
    chunk = max(1, min(batched._CHUNK, batched._BASIS_BYTES // per_t0))
    sizes = [min(chunk, n - lo) for lo in range(0, n, chunk)]
    return len(engine_real.join_groups(sizes, 2 * J * J * 16))


def numpy_uncertainty(times, data, modes, t0, T, design=None):
    """The amplitude covariance of one multimode fit by the textbook
    formula, in NumPy: the masked mixing-stacked design a, C =
    lstsq(a, d), sigma^2 = RSS / (n_obs - J), cov = sigma^2 inv(a^H a).
    ``design`` = (omega (J,), mu (I, J), spherical modes) replaces the
    spectrum of ``modes`` on SPH.  Returns C, cov, RSS, n_obs and
    kappa(a)^2, the condition number of a^H a."""
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    if design is None:
        ev = SpectrumEvaluator(modes, SPH)
        design = (ev.omega(CHIF, MF), ev.mu(CHIF), SPH)
    w, mu, sph = design
    sel = (times >= t0) & (times < t0 + T)
    phi = np.exp(-1j * w[None, :] * (times[sel][:, None] - t0))
    a = np.concatenate([m[None, :] * phi for m in mu])
    d = np.concatenate([data[lm][sel] for lm in sph])
    C, _, _, sv = np.linalg.lstsq(a, d, rcond=None)
    r = d - a @ C
    rss = float(np.vdot(r, r).real)
    cov = rss / (len(d) - len(w)) * np.linalg.inv(a.conj().T @ a)
    return C, cov, rss, len(d), float((sv[0] / sv[-1]) ** 2)


def numpy_selection(rss, n_modes, n_obs):
    """AIC, BIC and the consecutive nested F-tests' p-values of candidates
    of n_modes modes with residuals rss (k = 2 J + 1 real parameters, N =
    2 n_obs real observations)."""
    from scipy import stats
    rss, J = np.asarray(rss), np.asarray(n_modes)
    N, k = 2 * n_obs, 2 * J + 1
    logterm = N * np.log(np.maximum(rss, 1e-280) / N)
    df1, df2 = 2 * np.diff(J), N - 2 * J[1:]
    F = (np.maximum(rss[:-1] - rss[1:], 0.0) / df1
         / (np.maximum(rss[1:], 1e-280) / df2))
    return logterm + 2.0 * k, logterm + k * np.log(N), stats.f.sf(F, df1,
                                                                  df2)


def _rel_max(x, ref):
    return float(np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)))


def filter_signal():
    """F1's input: (2,2,0) + (2,2,1) from t = 0 on [-300, 150] at dt = 0.1
    (tests/test_filters.py:20-27)."""
    from qnmfits_tpu_torch import ref_impl
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    w = SpectrumEvaluator([(2, 2, 0, 1), (2, 2, 1, 1)]).omega(CHIF, MF)
    times = np.arange(-300.0, 150.0, 0.1)
    return times, ref_impl.ringdown(times, 0.0, [0.8 * np.exp(0.3j),
                                                 2.1 * np.exp(-1.1j)], w)


FILTER_CALLS = (([(2, 2, 0, 1)], False), ([(2, 2, 0, 1), (2, 2, 1, 1)], True))


def diagnostic_specs(problem, device):
    """The paths of phase 9, as ``path_specs`` describes them: G1 (the
    ladder at res 50 against the NumPy loop, and at grid_res against
    'batched'; GRID_SET at res 50 against both), G2, S1, R1, U1 and F1."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, fitting, ref_impl
    from qnmfits_tpu_torch.testing import bench_mode_sets
    times, data, t0s, T = (problem[k] for k in ("times", "data", "t0s", "T"))
    res, gres = problem["res"], problem["grid_res"]
    deep, row = bench_mode_sets()[DEEPEST], data[(2, 2)]
    k_win = window_samples(problem, GRID_T0)
    oracle_idx = _nearest(t0s, OPT_ORACLE_T0S)
    specs, found = [], {}

    def m_chi(key, name, ms, r, check, tol):
        kw = dict(T=T, res=r, spherical_modes=SPH, device=device)
        args = (times, data, ms, *G1_BOX, GRID_T0)
        route = (dict(route_tol=LADDER_GRID_ROUTE_TOL, backward=True)
                 if ms == deep else {})
        specs.append(dict(
            key=key, name=name, pre=None, oracle_tol=tol, **route,
            expect=(stacked_launches(r * r, len(ms), k_win), 0),
            kernel=lambda: fitting.mismatch_M_chi_grid(*args, engine="fast",
                                                       **kw),
            plain=lambda solve: batched.batch_mismatch_M_chi_fast(
                *args, solve=solve, **kw),
            oracle=lambda mm: check(mm, args, kw)))

    def vs_loop(mm, args, kw):
        return _diff(mm, ref_impl.mismatch_M_chi_grid(
            *args, T=T, res=kw["res"], spherical_modes=SPH), None)

    def vs_batched(mm, args, kw):
        t_b = time.perf_counter()
        mm_b = fitting.mismatch_M_chi_grid(*args, **kw)
        found[f"batched_wall_{kw['res']}_{len(args[2])}"] = \
            time.perf_counter() - t_b
        return _diff(mm, mm_b, None)

    def both(mm, args, kw):
        d_b = vs_batched(mm, args, kw)[0]
        if not d_b <= MAIN_TOL:
            raise RuntimeError(f"G1 (2,2,n<4): 'fast' {d_b:.3e} from "
                               "'batched'")
        log(f"G1 (2,2,n<4) res={kw['res']}: 'fast' vs 'batched' {d_b:.3e} "
            f"(bound {MAIN_TOL:.0e})")
        return vs_loop(mm, args, kw)

    ladder = f"(2,2,n<{len(deep)}) both rows"
    m_chi("g1_oracle", f"G1 mismatch_M_chi_grid 'fast' res={res}, {ladder}, "
          "vs the NumPy loop", deep, res, vs_loop, LADDER_GRID_ORACLE_TOL)
    m_chi("g1", f"G1 mismatch_M_chi_grid 'fast' res={gres}, {ladder}, vs "
          "'batched'", deep, gres, vs_batched, LADDER_GRID_ROUTE_TOL)
    m_chi("g1_set", f"G1 mismatch_M_chi_grid 'fast' res={res}, (2,2,n<4) "
          "both rows, vs 'batched' and the NumPy loop",
          bench_mode_sets()[GRID_SET], res, both, ORACLE_TOL)

    omega_args = (times, row, deep[:4], MF, CHIF, *OMEGA_BOX, GRID_T0)
    omega_kw = dict(T=T, res=gres, device=device)

    def g2_check(mm):
        walls = {}
        for engine in ("batched", "fast"):
            t_e = time.perf_counter()
            walls[engine] = (fitting.mismatch_omega_grid(
                *omega_args, engine=engine, **omega_kw),
                time.perf_counter() - t_e)
        d_f = found["g2_vs_bordered"] = _diff(mm, walls["fast"][0], None)[0]
        found["g2_walls"] = {k: v[1] for k, v in walls.items()}
        log(f"G2: 'fast-full' vs 'fast' (the bordered grid) {d_f:.3e} "
            f"(reported); first-call walls 'batched' "
            f"{walls['batched'][1]:.3f} s, 'fast' {walls['fast'][1]:.3f} s")
        return _diff(mm, walls["batched"][0], None)

    specs.append(dict(
        key="g2", name=f"G2 mismatch_omega_grid 'fast-full' res={gres}, "
        "(2,2,n<4) fixed + a free mode, vs 'batched'", pre=None,
        expect=(stacked_launches(gres * gres, 5, k_win), 0),
        oracle_tol=MAIN_TOL,
        kernel=lambda: fitting.mismatch_omega_grid(
            *omega_args, engine="fast-full", **omega_kw),
        plain=lambda solve: batched.batch_mismatch_omega_fast(
            *omega_args, solve=solve, **omega_kw),
        oracle=g2_check))

    stab_kw = dict(T_array=T, spherical_modes=SPH, device=device)

    def s1(solve=None):
        out = tq.amplitude_stability(times, data, deep, MF, CHIF, t0s,
                                     solve=solve, **stab_kw)
        if solve is None:
            found["s1"] = out
        return out["mm"]

    def s1_check(mm):
        out, d_c, d_mm = found["s1"], 0.0, 0.0
        for i in oracle_idx:
            ref = ref_impl.multimode_ringdown_fit(
                times, data, deep, MF, CHIF, float(t0s[i]), T=T,
                spherical_modes=SPH)
            d_c = max(d_c, _rel_max(out["C"][i], ref["C"]))
            d_mm = max(d_mm, abs(float(mm[i]) - ref["mismatch"]))
        found["s1_C"] = d_c
        log(f"S1: amplitudes vs the oracle at {len(oracle_idx)} windows "
            f"(t0 >= 0): {d_c:.3e} relative (bound {STAB_C_RTOL:.0e})")
        if not d_c <= STAB_C_RTOL:
            raise RuntimeError("S1: amplitudes disagree with the oracle")
        return d_mm, 0.0

    specs.append(dict(
        key="s1", name=f"S1 amplitude_stability, {ladder}, {len(t0s)} start "
        "times", pre=t0s < 0, expect=(stability_launches(problem, len(deep)),
                                      0),
        kernel=s1, plain=s1, oracle=s1_check))

    def r1():
        out = found["r1"] = tq.orthonormal_t0_sweep(
            times, data, deep, MF, CHIF, t0s, **stab_kw)
        return out["mismatch"]

    def r1_check(mm):
        out = found["r1"]
        if not np.all(out["ok"]):
            raise RuntimeError(f"R1: {np.sum(~out['ok'])} windows not ok")
        d = 0.0
        for i in oracle_idx:
            one = tq.orthonormal_decomposition(
                times, data, deep, MF, CHIF, float(t0s[i]), T=T,
                spherical_modes=SPH, device=device)
            d = max(d, float(np.max(np.abs(out["power"][i] - one["power"]))
                             / one["data_norm"]))
        return d, 0.0

    specs.append(dict(
        key="r1", name=f"R1 orthonormal_t0_sweep, {ladder}, {len(t0s)} start "
        "times", pre=None, expect=(0, 0), plain=None, kernel=r1,
        oracle=r1_check, oracle_tol=1e-10))

    rng = np.random.default_rng(17)
    noisy = {lm: h + U1_NOISE * (rng.standard_normal(len(times))
                                 + 1j * rng.standard_normal(len(times)))
             for lm, h in data.items()}
    cands = bench_mode_sets()[:len(deep)]

    def u1():
        found["u1"] = [tq.amplitude_uncertainty(
            times, noisy, ms, MF, CHIF, GRID_T0, T=T, spherical_modes=SPH,
            device=device) for ms in cands]
        sel = found["u1_sel"] = tq.mode_selection(
            times, noisy, cands, MF, CHIF, GRID_T0, T=T, spherical_modes=SPH,
            device=device)
        return sel["aic"]

    def u1_check(_):
        d_c, cov_rel, cov_bound, rss = 0.0, [], [], []
        for ms, out in zip(cands, found["u1"]):
            C, cov, r2, n_obs, kappa = numpy_uncertainty(times, noisy, ms,
                                                         GRID_T0, T)
            rss.append(r2)
            d_c = max(d_c, _rel_max(out["C"], C))
            # inv(a^H a) is itself fixed only to ~kappa eps.
            cov_bound.append(max(U1_RTOL, 10 * kappa * np.finfo(float).eps))
            cov_rel.append(_rel_max(out["cov"], cov))
        sel = found["u1_sel"]
        aic, bic, p = numpy_selection(rss, [len(ms) for ms in cands], n_obs)
        d_sel = max(_rel_max(sel["rss"], rss), _rel_max(sel["aic"], aic),
                    _rel_max(sel["bic"], bic))
        d_p = float(np.max(np.abs(sel["pvalue"] - p)))
        found["u1_gaps"] = dict(C=d_c, cov=cov_rel, cov_bound=cov_bound,
                                criteria=d_sel, pvalue=d_p,
                                best_bic=sel["best_bic"])
        log(f"U1 vs the NumPy formula: C {d_c:.3e}, rss/aic/bic {d_sel:.3e} "
            f"relative; p-values {d_p:.3e}; cov by candidate "
            f"{[f'{x:.1e}' for x in cov_rel]} (bounds "
            f"{[f'{x:.0e}' for x in cov_bound]}); best BIC candidate "
            f"{sel['best_bic']}")
        if not all(r <= b for r, b in zip(cov_rel, cov_bound)):
            raise RuntimeError("U1: cov disagrees with the NumPy formula")
        if not (d_c <= U1_RTOL and d_sel <= U1_RTOL and d_p <= U1_RTOL):
            raise RuntimeError(f"U1: {found['u1_gaps']}")
        return d_c, 0.0

    specs.append(dict(
        key="u1", name=f"U1 amplitude_uncertainty + mode_selection, "
        f"{len(cands)} nested candidates, t0={GRID_T0}", pre=None,
        expect=(0, 0), plain=None, kernel=u1, oracle=u1_check,
        oracle_tol=U1_RTOL))

    f_times, f_data = filter_signal()
    f_scale = float(np.max(np.abs(f_data)))

    def f1():
        found["f1"] = [fitting.rational_filter(
            f_times, f_data, modes, MF, CHIF, t_start=-300.0,
            align_inspiral=align, device=device) for modes, align
            in FILTER_CALLS]
        return np.concatenate([d for _, d in found["f1"]])

    def f1_check(_):
        d = 0.0
        for (modes, align), (t_u, d_f) in zip(FILTER_CALLS, found["f1"]):
            t_o, d_o = ref_impl.rational_filter(
                f_times, f_data, modes, MF, CHIF, t_start=-300.0,
                align_inspiral=align)
            if not np.array_equal(t_u, t_o):
                raise RuntimeError("F1: the uniform grids differ")
            d = max(d, float(np.max(np.abs(d_f - d_o))) / f_scale)
        pair = [(2, 2, 0, 1), (2, 2, 1, 1)]
        t_u, d_f = found["f1"][0]
        before = ref_impl.ringdown_fit(f_times, f_data, pair, MF, CHIF, 10.0,
                                       T=80.0)["C"]
        after = ref_impl.ringdown_fit(t_u, d_f, pair, MF, CHIF, 10.0,
                                      T=80.0)["C"]
        drop = found["f1_drop"] = abs(before[0]) / abs(after[0])
        log(f"F1: (2,2,0)'s refit amplitude falls {drop:.3e}x (bound "
            f">= {FILTER_DROP:.0e})")
        if not drop >= FILTER_DROP:
            raise RuntimeError("F1: the filter leaves (2,2,0) in the data")
        return d, 0.0

    specs.append(dict(
        key="f1", name=f"F1 rational_filter, {len(f_times)} samples, "
        "(2,2,0) then (2,2,0) + (2,2,1)", pre=None, expect=(0, 0),
        plain=None, kernel=f1, oracle=f1_check, oracle_tol=FILTER_TOL))
    return specs, found


def run_diagnostics(problem, device, gpu=None):
    """Phase 9: ``run_specs`` on the paths of ``diagnostic_specs``; on the
    card also the solve on G1's (at grid_res), G2's and S1's own systems
    beside its bound, its plain version and torch.linalg (its backward
    error gated), and each path's device-time split.  Returns the path
    records, the solve records by path key and the phase's wall."""
    t = time.perf_counter()
    specs, found = diagnostic_specs(problem, device)
    records = run_specs(specs, device)
    solves = {}
    for spec, rec in zip(specs, records):
        systems = rec.pop("systems", None)
        if systems:
            rec["systems"] = sum(b.shape[0] for _, b in systems)
            rec["n"] = max(b.shape[-1] for _, b in systems)
        if rec["key"] == "g1":
            rec["batched_wall_s"] = found[
                f"batched_wall_{problem['grid_res']}_{rec['n']}"]
        if rec["key"] == "g2":
            rec["vs_bordered"] = found["g2_vs_bordered"]
            rec["other_walls_s"] = found["g2_walls"]
        if rec["key"] == "u1":
            rec.update(found["u1_gaps"])
        if device == "cpu":
            continue
        if rec["key"] in ("g1", "g2", "s1"):
            G, b = systems[0]
            r = solves[rec["key"]] = time_solves(G, b)
            r["n"], r["launches"] = rec["n"], rec["launches"]
            r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], rec["n"])
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"{rec['name']} on {gpu}: solve {r['ms']:.4f} ms on its "
                f"{r['batch']} systems (n={rec['n']}), bound "
                f"{r['bound_ms']:.3e} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, torch.linalg "
                f"{r['library_ms']:.4f} ms, backward error "
                f"{r['backward_err']:.3e}")
            if not r["backward_err"] <= KERNEL_BWD_TOL:
                raise RuntimeError(f"{rec['name']}: kernel backward error "
                                   f"{r['backward_err']:.3e}")
        split = rec["split"] = device_split(spec["kernel"])
        if split is None:
            log(f"  {rec['key']} device-time split: torch.profiler recorded "
                "no device time (not measured)")
            continue
        log(f"  {rec['key']} device-time split: warm wall "
            f"{split['wall_ms']:.2f} ms unprofiled, "
            f"{split['profiled_wall_ms']:.2f} ms profiled; busy "
            f"{split['busy_ms']:.2f} ms, idle share {split['idle_share']:.3f}"
            f"; peak {split['peak_gib']:.2f} GiB; {split['kernels']} kernels "
            f"and {split['copies']} copies: products "
            f"{split['products_ms']:.2f}, elementwise "
            f"{split['elementwise_ms']:.2f}, solve {split['solve_ms']:.4f}, "
            f"factored kernels {split['sweep_ms']:.3f}, copies "
            f"{split['copies_ms']:.2f}, rest {split['rest_ms']:.2f} ms")
    wall = time.perf_counter() - t
    log(f"phase 9: {len(records)} paths in {wall:.1f} s")
    return records, solves, wall


# ---------------------------------------------------------------------------
# Phase 10: spatial mapping of linear and quadratic QNMs
# ---------------------------------------------------------------------------

# The (l, 4) spheres, linear modes mixed into them, and the quadratic modes
# (tests/test_spatial.py:57-80 at this width).  M1 maps the (2,2,0)^2 mode
# and fits the (2,2,0)x(3,2,0) mode through Qmu_B (the s = 0 table): J = 5
# + 1 + 5 = 11, the team kernel.  M2 maps (4,4,0), (5,4,0) and (2,2,0)^2:
# J = 3 + 3 * 5 = 18, the wide kernel.
MAP_SPH = [(l, 4) for l in range(4, 9)]
MAP_LINEAR = [(4, 4, n, 1) for n in range(4)] + [(5, 4, 0, 1)]
QUAD_UNMAPPED = (2, 2, 0, 1, 3, 2, 0, 1)
QUAD_MAPPED = (2, 2, 0, 1, 2, 2, 0, 1)
MAP_MODELS = {
    "m1": (MAP_LINEAR + [QUAD_UNMAPPED, QUAD_MAPPED], [QUAD_MAPPED]),
    "m2": (MAP_LINEAR[1:4] + [(4, 4, 0, 1), (5, 4, 0, 1), QUAD_MAPPED],
           [(4, 4, 0, 1), (5, 4, 0, 1), QUAD_MAPPED]),
}
MAP_NOISE = 1e-4         # white complex noise, of max |h| a sphere
MAP_T0 = 10.0            # start time of the single fit, the sky and U2
QMU_LADDER = [(i, 4) + QUAD_MAPPED for i in range(4, 9)]
QMU_L_MAX = 8
QMU_LOOP_TOL = 1e-13     # Qmu_A/B/D/C vs the loop oracle
QMU_QUAD_TOL = 1e-6      # Qmu_C coefficients vs quadrature (test_spatial.py)
QMU_LOOP_SPINS = 5       # spins of Q1 held against the loop oracle


def build_mapping(times, seed=11):
    """Phase 10's data on ``times``: each (l, 4) sphere holds the linear
    modes mixed by mu, the (2,2,0)x(3,2,0) mode mixed by Qmu_B, the
    (2,2,0)^2 mode with its own amplitude a sphere, all from t = 0, and
    complex white noise of MAP_NOISE of the sphere's max |h|, from
    ``seed``."""
    from qnmfits_tpu_torch.qnm_api import get_qnm
    from qnmfits_tpu_torch.ref_impl import ringdown
    from qnmfits_tpu_torch.spatial import Qmu_B
    q = get_qnm()
    rng = np.random.default_rng(seed)
    I, n_lin = len(MAP_SPH), len(MAP_LINEAR)
    a_lin = rng.standard_normal(n_lin) + 1j * rng.standard_normal(n_lin)
    a_quad = rng.standard_normal() + 1j * rng.standard_normal()
    a_map = rng.standard_normal(I) + 1j * rng.standard_normal(I)
    w_lin = np.array(q.omega_list(MAP_LINEAR, CHIF, MF))
    w_quad, w_map = q.omega_list([QUAD_UNMAPPED, QUAD_MAPPED], CHIF, MF)
    alphas = Qmu_B([lm + QUAD_UNMAPPED for lm in MAP_SPH], CHIF, QMU_L_MAX)
    data = {}
    for i, lm in enumerate(MAP_SPH):
        mu = np.array(q.mu_list([lm + m for m in MAP_LINEAR], CHIF))
        h = (ringdown(times, 0.0, mu * a_lin, w_lin)
             + ringdown(times, 0.0, [alphas[i] * a_quad, a_map[i]],
                        [w_quad, w_map]))
        scale = MAP_NOISE * np.max(np.abs(h))
        data[lm] = h + scale * (rng.standard_normal(len(times))
                                + 1j * rng.standard_normal(len(times)))
    return data


def mapping_launches(problem, key, engine, dedup):
    """Solve launches of a mapping sweep on the problem's start times,
    derived from the code: the join groups of the chunks the sweep makes
    ('fast': _safe_chunk over the design's largest |Im omega|; 'batched':
    the complex sweep's default chunk) over the distinct windows."""
    from qnmfits_tpu_torch import batched, engine_real
    from qnmfits_tpu_torch.spatial_engine import mapping_design
    modes, mapped = MAP_MODELS[key]
    _, omega, _ = mapping_design(MAP_SPH, modes, mapped, CHIF, MF)
    t0s = _distinct(problem, problem["t0s"]) if dedup else problem["t0s"]
    J, n = len(omega), len(t0s)
    if engine == "fast":
        chunk = batched._safe_chunk(t0s, float(np.max(np.abs(omega.imag))),
                                    128)
    else:
        chunk = max(1, min(batched._CHUNK, batched._BASIS_BYTES
                           // (len(problem["times"]) * J * 16)))
    sizes = [min(chunk, n - lo) for lo in range(0, n, chunk)]
    return len(engine_real.join_groups(sizes, 2 * J * J * 16))


def _stratified(t0s, n):
    """n start times with t0 >= 0, spread evenly over them (indices)."""
    first = int(np.searchsorted(t0s, 0.0))
    return np.unique(np.linspace(first, len(t0s) - 1, n).round().astype(int))


def mapping_specs(problem, device):
    """The paths of phase 10, as ``path_specs`` describes them: M1's
    sweeps ('fast' with and without dedup, 'batched'), M2's 'fast' sweep,
    Q1 (the Qmu predictions on a spin axis), SKY (M1's fit at MAP_T0, its
    sky predictions and spatial mismatches) and U2 (the uncertainty and
    mode selection of M1's design)."""
    from qnmfits_tpu_torch import spatial
    from qnmfits_tpu_torch.spatial_engine import mapping_design
    import qnmfits_tpu_torch as tq
    times, t0s, T = problem["times"], problem["t0s"], problem["T"]
    data = build_mapping(times)
    loop_idx = _stratified(t0s, problem["map_loop"])
    kw = dict(T_array=T, spherical_modes=MAP_SPH, device=device)
    specs, found = [], {}

    def loop_oracle(key):
        """The 'loop' engine (serial SVD fits) at the stratified start
        times, once per model."""
        if key not in found:
            modes, mapped = MAP_MODELS[key]
            found[key] = spatial.mapping_mismatch_t0_array(
                times, data, modes, MF, CHIF, t0s[loop_idx], mapped,
                engine="loop", **kw)
        return found[key]

    def sweep(key, engine, dedup, name):
        modes, mapped = MAP_MODELS[key]
        n = mapping_launches(problem, key, engine, dedup)
        J = len(modes) - len(mapped) + len(mapped) * len(MAP_SPH)
        wide = n if J > 16 else 0

        def run(solve=None):
            return spatial.mapping_mismatch_t0_array(
                times, data, modes, MF, CHIF, t0s, mapped, engine=engine,
                dedup=dedup, solve=solve, **kw)

        specs.append(dict(
            key=f"{key}_{engine}" + ("" if dedup else "_nodedup"),
            name=f"{key.upper()} mapping_mismatch_t0_array '{engine}' "
            f"(J={J}, {'dedup' if dedup else 'no dedup'}), {name}",
            kernel=run, plain=run, pre=t0s < 0, backward=True,
            expect=(n, wide), all_plain=engine == "fast",
            oracle=lambda mm: _diff(mm[loop_idx], loop_oracle(key), None)))

    sweep("m1", "fast", True, "team kernel")
    sweep("m1", "fast", False, "team kernel")
    sweep("m1", "batched", True, "team kernel")
    sweep("m2", "fast", True, "wide kernel")

    spins = np.linspace(0.0, 0.95, problem["qmu_spins"])
    loop_q = np.unique(np.linspace(0, len(spins) - 1,
                                   QMU_LOOP_SPINS).round().astype(int))
    preds = {"A": (spatial.Qmu_A, -2, -2, None),
             "B": (spatial.Qmu_B, -2, 0, None),
             "D": (spatial.Qmu_D, -2, -2,
                   lambda i: np.sqrt((i + 4) * (i - 3) * (i + 3) * (i - 2)))}

    def q1():
        out = {k: np.array(f(QMU_LADDER, spins, QMU_L_MAX, s1=s1, s2=s2))
               for k, (f, s1, s2, _) in preds.items()}
        out["C"] = np.array(spatial.Qmu_C(QMU_LADDER, spins))
        found["q1"] = out
        return np.stack(list(out.values()))

    def q1_check(_):
        out, d = found["q1"], 0.0
        for qi in loop_q:
            c = float(spins[qi])
            for k, (_, s1, s2, extra) in preds.items():
                ref = spatial._Qmu_sum_loop(QMU_LADDER, c, QMU_L_MAX, s1, s2,
                                            extra=extra)
                d = max(d, float(np.max(np.abs(out[k][:, qi] - ref))))
            ref_c = spatial.Qmu_C(QMU_LADDER, c)
            d = max(d, float(np.max(np.abs(out["C"][:, qi] - ref_c))))
        mid = float(spins[len(spins) // 2])
        quad = spatial.Qmu_C(QMU_LADDER, mid, method="quadrature",
                             n_quad=48)
        d_q = found["q1_quadrature"] = float(np.max(np.abs(
            np.array(spatial.Qmu_C(QMU_LADDER, mid)) - quad)))
        log(f"Q1: Qmu_C coefficients vs quadrature at chif = {mid:.4f}: "
            f"{d_q:.3e} (bound {QMU_QUAD_TOL:.0e})")
        if not d_q <= QMU_QUAD_TOL:
            raise RuntimeError("Q1: Qmu_C disagrees with its quadrature")
        return d, 0.0

    specs.append(dict(
        key="q1", name=f"Q1 Qmu_A/B/D/C, (l, 4) ladder of the (2,2,0)^2 map, "
        f"l_max={QMU_L_MAX}, {len(spins)} spins in [0, 0.95], vs the loop "
        f"at {QMU_LOOP_SPINS}", pre=None, expect=(0, 0), plain=None,
        kernel=q1, oracle=q1_check, oracle_tol=QMU_LOOP_TOL))

    m1_modes, m1_mapped = MAP_MODELS["m1"]
    th, ph = np.meshgrid(np.linspace(0.1, np.pi - 0.1, 24),
                         np.linspace(0.0, 2 * np.pi, 25), indexing="ij")

    def sky():
        fit = spatial.mapping_multimode_ringdown_fit(
            times, data, m1_modes, MF, CHIF, MAP_T0, m1_mapped, T=T,
            spherical_modes=MAP_SPH, device=device)
        maps = [spatial.spatial_reconstruction(th, ph, fit, QUAD_MAPPED,
                                               QMU_L_MAX),
                spatial.spatial_prediction_linear(th, ph, MAP_LINEAR[0],
                                                  QMU_L_MAX, CHIF),
                spatial.spatial_prediction_quadratic(
                    th, ph, QUAD_MAPPED, QMU_L_MAX, CHIF, spatial.Qmu_B),
                spatial.spatial_prediction_C(th, ph, QUAD_MAPPED, CHIF)]
        sm = [spatial.spatial_mismatch_quadratic(fit, QUAD_MAPPED, QMU_L_MAX,
                                                 CHIF, f)[0]
              for f in (spatial.Qmu_A, spatial.Qmu_B, spatial.Qmu_C,
                        spatial.Qmu_D)]
        found["sky"] = dict(fit=fit, peaks=[float(np.max(np.abs(m)))
                                            for m in maps],
                            spatial_mismatch=dict(zip("ABCD", sm)))
        return np.concatenate([np.ravel(m) for m in maps]
                              + [[fit["mismatch"]], sm])

    def sky_check(_):
        """The device fit against np.linalg.lstsq on the same design."""
        from qnmfits_tpu_torch.ref_impl import mask_times, multimode_mismatch
        out = found["sky"]
        fit = out["fit"]
        _, omega, mu = mapping_design(MAP_SPH, m1_modes, m1_mapped, CHIF, MF)
        idx = mask_times(times, MAP_T0, T, "geq")
        tm = times[idx]
        phi = np.exp(-1j * omega[None, :] * (tm - MAP_T0)[:, None])
        a = np.concatenate([m[None, :] * phi for m in mu])
        d = np.concatenate([data[lm][idx] for lm in MAP_SPH])
        C = np.linalg.lstsq(a, d, rcond=None)[0]
        model = (a @ C).reshape(len(MAP_SPH), -1)
        ref = multimode_mismatch(
            tm, dict(zip(MAP_SPH, model)),
            {lm: data[lm][idx] for lm in MAP_SPH})
        sm = ", ".join(f"{k} {v:.4e}"
                       for k, v in out["spatial_mismatch"].items())
        log(f"SKY: M1 fit at t0 = {MAP_T0}: mismatch {fit['mismatch']:.6e}; "
            f"spatial mismatch of (2,2,0)^2 against Qmu {sm}; map peaks "
            f"{out['peaks']} (each 1 by normalisation)")
        if not np.allclose(out["peaks"], 1.0, rtol=0, atol=1e-12):
            raise RuntimeError("SKY: a sky map is not peak-normalised")
        return abs(fit["mismatch"] - ref), 0.0

    specs.append(dict(
        key="sky", name=f"SKY mapping_multimode_ringdown_fit (M1, t0="
        f"{MAP_T0}), sky maps on 24x25 points, spatial mismatches, vs "
        "np.linalg.lstsq", pre=None, expect=(0, 0), plain=None,
        kernel=sky, oracle=sky_check))

    cands = [MAP_LINEAR[:1] + [QUAD_MAPPED], MAP_LINEAR[:4] + [QUAD_MAPPED],
             MAP_LINEAR + [QUAD_UNMAPPED, QUAD_MAPPED]]
    u_kw = dict(T=T, spherical_modes=MAP_SPH, mapping_modes=m1_mapped,
                device=device)

    def u2():
        found["u2"] = [tq.amplitude_uncertainty(times, data, ms, MF, CHIF,
                                                MAP_T0, **u_kw)
                       for ms in cands]
        sel = found["u2_sel"] = tq.mode_selection(times, data, cands, MF,
                                                  CHIF, MAP_T0, **u_kw)
        return sel["aic"]

    def u2_check(_):
        d_c, cov_rel, cov_bound, rss, n_modes = 0.0, [], [], [], []
        for ms, out in zip(cands, found["u2"]):
            _, omega, mu = mapping_design(MAP_SPH, ms, m1_mapped, CHIF, MF)
            C, cov, r2, n_obs, kappa = numpy_uncertainty(
                times, data, None, MAP_T0, T, design=(omega, mu, MAP_SPH))
            rss.append(r2)
            n_modes.append(len(omega))
            d_c = max(d_c, _rel_max(out["C"], C))
            cov_bound.append(max(U1_RTOL, 10 * kappa * np.finfo(float).eps))
            cov_rel.append(_rel_max(out["cov"], cov))
        sel = found["u2_sel"]
        aic, bic, p = numpy_selection(rss, n_modes, n_obs)
        d_sel = max(_rel_max(sel["rss"], rss), _rel_max(sel["aic"], aic),
                    _rel_max(sel["bic"], bic))
        d_p = float(np.max(np.abs(sel["pvalue"] - p)))
        found["u2_gaps"] = dict(C=d_c, cov=cov_rel, cov_bound=cov_bound,
                                criteria=d_sel, pvalue=d_p,
                                best_bic=sel["best_bic"], n_modes=n_modes)
        log(f"U2 vs the NumPy formula: C {d_c:.3e}, rss/aic/bic {d_sel:.3e} "
            f"relative; p-values {d_p:.3e}; cov by candidate "
            f"{[f'{x:.1e}' for x in cov_rel]} (bounds "
            f"{[f'{x:.0e}' for x in cov_bound]}); J by candidate {n_modes}, "
            f"best BIC candidate {sel['best_bic']}")
        if not all(r <= b for r, b in zip(cov_rel, cov_bound)):
            raise RuntimeError("U2: cov disagrees with the NumPy formula")
        if not (d_c <= U1_RTOL and d_sel <= U1_RTOL and d_p <= U1_RTOL):
            raise RuntimeError(f"U2: {found['u2_gaps']}")
        return d_c, 0.0

    specs.append(dict(
        key="u2", name=f"U2 amplitude_uncertainty + mode_selection with "
        f"mapping_modes=, {len(cands)} nested candidates, t0={MAP_T0}",
        pre=None, expect=(0, 0), plain=None, kernel=u2, oracle=u2_check,
        oracle_tol=U1_RTOL))
    return specs, found


def run_mapping(problem, device, gpu=None):
    """Phase 10: ``run_specs`` on the paths of ``mapping_specs``; on the
    card also the solve on M1's ('fast', dedup) and M2's own systems
    beside its bound, its plain version and torch.linalg (its backward
    error gated), and each path's device-time split.  Returns the path
    records, the solve records by path key and the phase's wall."""
    t = time.perf_counter()
    specs, found = mapping_specs(problem, device)
    records = run_specs(specs, device)
    solves = {}
    for spec, rec in zip(specs, records):
        systems = rec.pop("systems", None)
        if systems:
            rec["systems"] = sum(b.shape[0] for _, b in systems)
            rec["n"] = max(b.shape[-1] for _, b in systems)
        if rec["key"] == "q1":
            rec["quadrature"] = found["q1_quadrature"]
        if rec["key"] == "sky":
            rec["spatial_mismatch"] = found["sky"]["spatial_mismatch"]
            rec["fit_mismatch"] = found["sky"]["fit"]["mismatch"]
        if rec["key"] == "u2":
            rec.update(found["u2_gaps"])
        if device == "cpu":
            continue
        if rec["key"] in ("m1_fast", "m2_fast"):
            G, b = systems[0]
            r = solves[rec["key"]] = time_solves(G, b)
            r["n"], r["launches"] = rec["n"], rec["launches"]
            r["bound_ms"], r["bound_by"] = bound_ms(r["batch"], rec["n"])
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"{rec['name']} on {gpu}: solve {r['ms']:.4f} ms on its "
                f"{r['batch']} systems (n={rec['n']}), bound "
                f"{r['bound_ms']:.3e} ms ({r['bound_by']}), share "
                f"{r['bound_share']:.3f}, plain {r['plain_ms']:.4f} ms, "
                f"torch.linalg {r['library_ms']:.4f} ms, backward error "
                f"{r['backward_err']:.3e}")
            if not r["backward_err"] <= KERNEL_BWD_TOL:
                raise RuntimeError(f"{rec['name']}: kernel backward error "
                                   f"{r['backward_err']:.3e}")
        split = rec["split"] = device_split(spec["kernel"])
        if split is None:
            log(f"  {rec['key']} device-time split: torch.profiler recorded "
                "no device time (not measured)")
            continue
        log(f"  {rec['key']} device-time split: warm wall "
            f"{split['wall_ms']:.2f} ms unprofiled, "
            f"{split['profiled_wall_ms']:.2f} ms profiled; busy "
            f"{split['busy_ms']:.2f} ms, idle share {split['idle_share']:.3f}"
            f"; peak {split['peak_gib']:.2f} GiB; {split['kernels']} kernels "
            f"and {split['copies']} copies: products "
            f"{split['products_ms']:.2f}, elementwise "
            f"{split['elementwise_ms']:.2f}, solve {split['solve_ms']:.4f}, "
            f"factored kernels {split['sweep_ms']:.3f}, copies "
            f"{split['copies_ms']:.2f}, rest {split['rest_ms']:.2f} ms")
    wall = time.perf_counter() - t
    log(f"phase 10: {len(records)} paths in {wall:.1f} s")
    return records, solves, wall


# ---------------------------------------------------------------------------
# Phase 11: the waveform layer feeding the fits
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "data")
W1_ID = 8888
W1_T, W1_DYN_T, W1_T0 = 90.0, 80.0, 10.0     # tests/test_sxs_fixture.py
W1_LADDERS = [[(2, 2, n, 1) for n in range(N)] for N in range(1, 9)]
W1_EPS_MODES = [(2, 2, 0, 1), (2, 2, 1, 1)]
# The JAX package's pins on the fixture (tests/test_sxs_fixture.py:153,
# 114, 127): value and relative bound.
W1_PINS = {"dynamic_ringdown_fit": (2.79778014e-06, 1e-3),
           "calculate_epsilon": (0.0122058, 1e-3),
           "multimode_ringdown_fit": (0.00110481, 1e-2)}
W2_T = 80.0              # the recording ends at t = 130
W3_SPH = [(2, 2), (3, 2), (4, 2)]
W3_SET = _m2(2, 8) + _m2(3, 5) + _m2(4, 5)              # J = 18, wide kernel
W3_TILT = (0.7, 1.1)     # (theta, phi) of the remnant spin in W3's frame
W3_T0 = (0.0, 51.2)      # W3's data start at t = 0
ROTATION_TOL = 1e-10     # 'rotation' undoes W3's tilt, of max |h|


GRAM_EVERY = 128         # every 128th start time sets a sweep's route bounds


def gram_bound(fit, J):
    """First-order error of a mismatch that the normal equations give at
    one window: 2 J sqrt(mm) eps kappa(A)^2, kappa(A) the window design's
    condition number (from the oracle fit's singular values ``s``).  Two
    backward-stable Gram solves, or a Gram solve and the oracle's SVD,
    differ by up to this much where the design is ill-conditioned
    (ROADMAP C.3): deep overtone ladders on data the model does not fit
    exactly, as a waveform's near its peak."""
    s = np.asarray(fit["s"])
    return (2 * J * np.sqrt(max(fit["mismatch"], 0.0))
            * np.finfo(float).eps * (s[0] / s[-1]) ** 2)


def _oracle_fit(wprob, ms, sph, Mf, chif, t0):
    from qnmfits_tpu_torch import ref_impl
    return ref_impl.fit_dispatch(wprob["times"], wprob["data"], ms, Mf, chif,
                                 float(t0), "geq", wprob["T"], sph)


def gram_oracle(wprob, mm, sets, sph, Mf, chif):
    """mm (S, B) against the oracle over the sets x the t0 STRATA: the
    largest gap for t0 >= 0 and for t0 < 0, and the largest bound the
    t0 >= 0 windows were held to, each max(ORACLE_TOL, gram_bound).
    Raises on a window past its bound."""
    t0s = wprob["t0s"]
    mm = np.asarray(mm).reshape(len(sets), -1)
    d_in = d_pre = tol_in = 0.0
    for si, ms in enumerate(sets):
        for t0_val in STRATA:
            if not t0s[0] <= t0_val <= t0s[-1]:
                continue
            i = int(np.argmin(np.abs(t0s - t0_val)))
            ref = _oracle_fit(wprob, ms, sph, Mf, chif, t0s[i])
            d = abs(float(mm[si, i]) - ref["mismatch"])
            if t0s[i] < 0:
                d_pre = max(d_pre, d)
                continue
            tol = max(ORACLE_TOL, gram_bound(ref, len(ms)))
            if not d <= tol:
                raise RuntimeError(f"set {ms} at t0 = {t0s[i]}: {d:.3e} "
                                   f"from the oracle, bound {tol:.3e}")
            d_in, tol_in = max(d_in, d), max(tol_in, tol)
    return d_in, d_pre, tol_in


def gram_route_tols(wprob, sets, sph, Mf, chif):
    """Per-set bounds (S,) of the kernel route against the plain one for
    t0 >= 0 and for t0 < 0: MAIN_TOL and PRE_TOL, or the largest
    gram_bound over every GRAM_EVERY-th start time on that side."""
    t0s = wprob["t0s"]
    tols = np.array([[MAIN_TOL, PRE_TOL]] * len(sets))
    for si, ms in enumerate(sets):
        for side, idx in enumerate((np.nonzero(t0s >= 0)[0],
                                    np.nonzero(t0s < 0)[0])):
            for i in idx[::GRAM_EVERY]:
                fit = _oracle_fit(wprob, ms, sph, Mf, chif, t0s[i])
                tols[si, side] = max(tols[si, side],
                                     gram_bound(fit, len(ms)))
    return tols[:, 0], tols[:, 1]


def fixture_metadata(fix):
    """The SXS metadata of the BBH fixture (tests/test_sxs_fixture.py:36-52):
    the remnant from the fixture, the rest a plausible binary."""
    return {
        "simulation_name": f"SXS:BBH:{W1_ID}/Lev3",
        "reference_time": 100.0,
        "reference_mass1": 0.54,
        "reference_mass2": 0.46,
        "reference_dimensionless_spin1": [0.0, 0.0, 0.1],
        "reference_dimensionless_spin2": [0.0, 0.0, -0.2],
        "reference_position1": [5.0, 0.0, 0.0],
        "reference_position2": [-5.8, 0.0, 0.0],
        "reference_orbital_frequency": [0.0, 0.0, 0.016],
        "common_horizon_time": float(fix["t_peak"]),
        "number_of_orbits": 8.0,
        "remnant_mass": float(fix["Mf"]),
        "remnant_dimensionless_spin": [0.0, 0.0, float(fix["chif"])],
        "remnant_velocity": [1e-4, 0.0, 0.0],
    }


def fixture_modes(fix):
    """The fixture's (l, m) modes, l = 2, 3, zero where it has none."""
    times = fix["times"]
    return {(l, m): fix[f"h_{l}_{m}"] if f"h_{l}_{m}" in fix.files
            else np.zeros(len(times), complex)
            for l in (2, 3) for m in range(-l, l + 1)}


def write_sxs_cache(root, fix):
    """The fixture as an SXS-format cache entry under ``root``: metadata.json
    and rhOverM_Asymptotic_GeometricUnits_CoM.h5 with Extrapolated_N2.dir/
    Y_l{l}_m{m}.dat datasets (tests/test_sxs_fixture.py:31-66)."""
    import h5py
    sim = os.path.join(root, f"SXS_BBH_{W1_ID}", "Lev3")
    os.makedirs(sim)
    with open(os.path.join(sim, "metadata.json"), "w") as f:
        json.dump(fixture_metadata(fix), f)
    times = fix["times"]
    with h5py.File(os.path.join(
            sim, "rhOverM_Asymptotic_GeometricUnits_CoM.h5"), "w") as f:
        grp = f.create_group("Extrapolated_N2.dir")
        for (l, m), h in fixture_modes(fix).items():
            grp.create_dataset(f"Y_l{l}_m{m}.dat",
                               data=np.stack([times, h.real, h.imag], 1))


def sxs_playback(fix):
    """An `sxs` module that serves the fixture through the calls the
    loader's `sxs`-package branch makes (sxs.load of the metadata and of
    rhOverM, data.t, data.ell_max, data.index, data[:, i]), and refuses
    any other simulation.  For machines without h5py, where the local
    SXS-format cache cannot be read; the arrays are the cache's."""
    import types
    md = fixture_metadata(fix)
    modes = fixture_modes(fix)

    class Modes:
        t = fix["times"]
        ell_max = 3

        def __init__(self):
            self.cols = np.stack([modes[l, m] for l in range(2, 4)
                                  for m in range(-l, l + 1)], 1)

        @staticmethod
        def index(l, m):
            return l * l + l + m - 4

        def __getitem__(self, key):
            return self.cols[key]

    def load(path, extrapolation_order=2):
        if path == f"SXS:BBH:{W1_ID}/Lev/metadata.json":
            return dict(md)
        if (path == f"SXS:BBH:{W1_ID}/Lev3/rhOverM"
                and extrapolation_order == 2):
            return Modes()
        raise KeyError(f"the fixture holds no {path!r} "
                       f"(extrapolation_order={extrapolation_order})")

    mod = types.ModuleType("sxs")
    mod.load = load
    return mod


def load_w1():
    """W1: the BBH fixture through ``SXS(8888, zero_time=(2, 2))``.  Where
    h5py is installed, from an SXS-format cache written into a temporary
    directory (SXS_CACHE_DIR; `sxs` blocked, so nothing is downloaded);
    without it, through the `sxs`-package branch served by
    ``sxs_playback``.  Returns the waveform and the branch's name."""
    import tempfile
    from unittest import mock
    from qnmfits_tpu_torch.waveforms import SXS
    fix = np.load(os.path.join(FIXTURES, "fixture_bbh_waveform.npz"))
    try:
        import h5py  # noqa: F401
        have_h5py = True
    except ImportError:
        have_h5py = False
    had_sxs, prev_sxs = "sxs" in sys.modules, sys.modules.get("sxs")
    write_s = 0.0
    with tempfile.TemporaryDirectory() as root, \
            mock.patch.dict(os.environ, {"SXS_CACHE_DIR": root}):
        try:
            if have_h5py:
                t = time.perf_counter()
                write_sxs_cache(root, fix)
                write_s = time.perf_counter() - t
                sys.modules["sxs"] = None
                branch = "local SXS-format cache (h5py)"
            else:
                sys.modules["sxs"] = sxs_playback(fix)
                branch = "sxs-package API, fixture playback (no h5py)"
            wf = SXS(W1_ID, zero_time=(2, 2))
        finally:
            if had_sxs:
                sys.modules["sxs"] = prev_sxs
            else:
                sys.modules.pop("sxs", None)
    wf.stage_seconds["cache_write"] = write_s
    return wf, branch


def load_w2():
    """W2: the NRSur7dq4 recording (21 modes, l <= 4, a tilted remnant
    spin) through ``Custom``, once with transform='rotation' and once with
    'dynamic_rotation'."""
    from qnmfits_tpu_torch.waveforms import Custom
    rec = np.load(os.path.join(FIXTURES, "fixture_surrogate.npz"))
    modes = {(int(l), int(m)): rec[f"sur_h_{l}_{m}"]
             for l, m in rec["sur_keys"]}
    md = {"remnant_mass": float(rec["sur_Mf"]),
          "remnant_dimensionless_spin": np.asarray(rec["sur_chif"], float)}
    return {tr: Custom(rec["times"], modes, md, transform=tr)
            for tr in ("rotation", "dynamic_rotation")}


def build_w3(ell_max, K, seed=11):
    """W3: every (l, m) mode to ``ell_max`` on K samples at 0.1 M from
    t = 0, each a sum of the port's Kerr QNMs (l, m, n < 3) at (MF, CHIF)
    with amplitudes from ``seed`` falling 10x an l, in the remnant frame;
    then tilted so that the remnant spin points along W3_TILT.  Returns
    times, the untilted and the tilted modes, and the metadata."""
    from qnmfits_tpu_torch.harmonics import (quat_from_axis_angle,
                                             rotate_mode_dict)
    from qnmfits_tpu_torch.qnm_api import get_qnm
    q = get_qnm()
    rng = np.random.default_rng(seed)
    times = np.arange(K) * 0.1
    h0 = {}
    for l in range(2, ell_max + 1):
        for m in range(-l, l + 1):
            w = np.array(q.omega_list([(l, m, n, 1) for n in range(3)], CHIF,
                                      MF))
            a = ((rng.standard_normal(3) + 1j * rng.standard_normal(3))
                 * 10.0 ** (2 - l))
            h0[l, m] = np.exp(-1j * np.outer(times, w)) @ a
    th, ph = W3_TILT
    n = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)])
    axis = np.cross([0.0, 0.0, 1.0], n)
    # 'rotation' applies the rotor taking z to n; the data carry its
    # inverse, so that rotation gives back h0.
    q_inv = quat_from_axis_angle(th * axis / np.linalg.norm(axis)) \
        * np.array([1.0, -1.0, -1.0, -1.0])
    tilted = rotate_mode_dict(h0, q_inv, ell_max)
    md = {"remnant_mass": MF, "remnant_dimensionless_spin": CHIF * n}
    return times, h0, tilted, md


def factored_launches(times, t0s, T, mode_sets, sph, Mf, chif, dedup):
    """Solve launches of a static 'geq' mode-set sweep, derived from the
    code: the join groups (2 S J^2 complex a start time) of the chunks
    ``batched._safe_chunk`` makes over the distinct windows (with dedup)
    or every start time."""
    from qnmfits_tpu_torch import batched, engine_real
    sets = tuple(tuple(batched._canon(ms)) for ms in mode_sets)
    eval_all, _ = batched._modesets_spectrum_fn(sets, tuple(sph))
    omegas, _ = eval_all(float(chif), float(Mf))
    if dedup:
        dd = batched._window_dedup(times, t0s, np.full_like(t0s, T))
        t0s = t0s if dd is None else t0s[dd[0]]
    ck = batched._safe_chunk(t0s, float(np.max(np.abs(omegas.imag))), 256)
    S, J = omegas.shape
    sizes = [min(ck, len(t0s) - lo) for lo in range(0, len(t0s), ck)]
    return len(engine_real.join_groups(sizes, 2 * S * J * J * 16))


def dynamic_launches(times, t0s, modes, n_rows):
    """Solve launches of a dynamic sweep of one set: the join groups of
    its chunks of start times, each within ``batched._BASIS_BYTES`` of
    (rows, K, J) basis."""
    from qnmfits_tpu_torch import batched, engine_real
    J, B = len(modes), len(t0s)
    chunk = max(1, batched._BASIS_BYTES // (n_rows * len(times) * J * 16))
    sizes = [min(chunk, B - lo) for lo in range(0, B, chunk)]
    return len(engine_real.join_groups(sizes, 2 * J * J * 16))


def waveform_specs(problem, device, w1, w2, w3):
    """The fits of phase 11, as ``path_specs`` describes them, on the
    waveforms the loaders gave: W1's main path with and without dedup, its
    dynamic sweep on its own tracks, its three fits at t0 = 10 against the
    JAX package's pins; W2's main path on the rotated rows; W3's wide
    sweep on the rotated rows."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, optimize, ref_impl
    from qnmfits_tpu_torch.testing import bench_mode_sets
    specs, found = [], {}
    t0s = np.linspace(*problem["t0s"][[0, -1]], problem["wave_t0"])
    t0s_dyn = np.linspace(*problem["t0s"][[0, -1]], problem["wave_dyn_t0"])

    def modesets(key, name, wprob, data, sets, sph, Mf, chif, dedup,
                 tols=None):
        kw = dict(T_array=wprob["T"], spherical_modes=sph, dedup=dedup,
                  device=device)
        args = (wprob["times"], data, sets, Mf, chif, wprob["t0s"])
        n = factored_launches(wprob["times"], wprob["t0s"], wprob["T"],
                              sets, sph, Mf, chif, dedup)
        wide = n if max(len(ms) for ms in sets) > 16 else 0
        tol_in, tol_pre = tols or gram_route_tols(wprob, sets, sph, Mf, chif)
        specs.append(dict(
            key=key, name=name, expect=(n, wide), pre=wprob["t0s"] < 0,
            backward=True, route_tol=tol_in, pre_tol=tol_pre,
            kernel=lambda: tq.mismatch_t0_mode_sets(*args, **kw),
            plain=lambda solve: batched.batch_mismatch_t0_modesets(
                *args, solve=solve, **kw),
            oracle=lambda mm: gram_oracle(wprob, mm, sets, sph, Mf, chif)))

    # W1: the fixture's (2,2) row.
    row = {(2, 2): w1.h[2, 2]}
    w1p = dict(times=w1.times, t0s=t0s, T=W1_T, data=row)
    tols = gram_route_tols(w1p, W1_LADDERS, [(2, 2)], w1.Mf, w1.chif_mag)
    for dedup in (True, False):
        modesets(f"w1_main{'' if dedup else '_nodedup'}",
                 f"W1 SXS mode sets (2,2,n<N), N=1..8, {len(t0s)} start "
                 f"times ({'dedup' if dedup else 'no dedup'})", w1p, row,
                 W1_LADDERS, [(2, 2)], w1.Mf, w1.chif_mag, dedup, tols)

    deep = W1_LADDERS[-1]
    chit = np.clip(w1.chioft_mag, 0.0, 0.99)
    # A single series: the oracle's dynamic_ringdown_fit (a one-row
    # multimode fit along a spin track would weight each sample by
    # mu(chif(t))).
    w1d = dict(times=w1.times, t0s=t0s_dyn, T=W1_DYN_T, data=w1.h[2, 2])
    dyn_args = (w1.times, w1.h[2, 2], deep, w1.Moft, chit, t0s_dyn)
    tol_in, tol_pre = gram_route_tols(w1d, [deep], None, w1.Moft, chit)
    specs.append(dict(
        key="w1_dynamic", name=f"W1 mismatch_t0_array on its Moft/chioft "
        f"tracks ((2,2,n<8), {len(t0s_dyn)} start times)",
        expect=(dynamic_launches(w1.times, t0s_dyn, deep, 1), 0),
        pre=t0s_dyn < 0, backward=True, route_tol=tol_in[0],
        pre_tol=tol_pre[0],
        kernel=lambda: tq.mismatch_t0_array(*dyn_args, T_array=W1_DYN_T,
                                            device=device),
        plain=lambda solve: batched.batch_mismatch_t0_dynamic(
            *dyn_args, T_array=W1_DYN_T, device=device, solve=solve),
        oracle=lambda mm: gram_oracle(w1d, mm, [deep], None, w1.Moft,
                                      chit)))

    two = {(2, 2): w1.h[2, 2], (3, 2): w1.h[3, 2]}

    def svd_fits():
        return np.array([
            tq.dynamic_ringdown_fit(w1.times, w1.h[2, 2], deep, w1.Moft,
                                    chit, W1_T0, T=W1_DYN_T,
                                    device=device)["mismatch"],
            tq.multimode_ringdown_fit(
                w1.times, two, deep, w1.Mf, w1.chif_mag, W1_T0,
                spherical_modes=[(2, 2), (3, 2)], device=device)["mismatch"]])

    def pin(name, value):
        ref, rtol = W1_PINS[name]
        found[name] = value
        log(f"W1 {name} at t0 = {W1_T0}: {value:.9g} (JAX package's pin "
            f"{ref:.9g}, rel {rtol:.0e})")
        if not abs(value - ref) <= rtol * abs(ref):
            raise RuntimeError(f"W1 {name}: {value} misses the pin {ref}")

    def svd_check(mm):
        pin("dynamic_ringdown_fit", float(mm[0]))
        pin("multimode_ringdown_fit", float(mm[1]))
        ref = [ref_impl.dynamic_ringdown_fit(w1.times, w1.h[2, 2], deep,
                                             w1.Moft, chit, W1_T0,
                                             T=W1_DYN_T)["mismatch"],
               ref_impl.multimode_ringdown_fit(
                   w1.times, two, deep, w1.Mf, w1.chif_mag, W1_T0,
                   spherical_modes=[(2, 2), (3, 2)])["mismatch"]]
        return _diff(mm, ref, None)

    specs.append(dict(
        key="w1_fits", name=f"W1 dynamic_ringdown_fit + "
        f"multimode_ringdown_fit (SVD), t0 = {W1_T0}", expect=(0, 0),
        pre=None, plain=None, kernel=svd_fits, oracle=svd_check))

    eps_args = (w1.times, w1.h[2, 2], W1_EPS_MODES, w1.Mf, w1.chif_mag,
                W1_T0)

    def epsilon(solve=None):
        """The public entry point; with ``solve``, the same optimiser one
        layer down with the solve substituted."""
        optimize.evaluations = 0
        out = (tq.calculate_epsilon(*eps_args, device=device)
               if solve is None else optimize.calculate_epsilon_gradient(
                   *eps_args, device=device, solve=solve))
        found["evaluations"] = optimize.evaluations
        return np.array(out)

    def epsilon_check(x):
        pin("calculate_epsilon", float(x[0]))
        x_p = epsilon(PlainSolve())
        ref = np.array(ref_impl.calculate_epsilon(*eps_args))
        found["epsilon_route"] = float(np.max(np.abs(x - x_p)))
        found["epsilon_nelder_mead"] = float(np.max(np.abs(x - ref)))
        log(f"W1 calculate_epsilon: kernel vs plain route "
            f"{found['epsilon_route']:.3e} (bound {LBFGS_PARAM_TOL:.0e}); "
            f"vs Nelder-Mead {found['epsilon_nelder_mead']:.3e} (reported)")
        if not found["epsilon_route"] <= LBFGS_PARAM_TOL:
            raise RuntimeError("W1 calculate_epsilon: the kernel and plain "
                               "routes disagree")
        return found["epsilon_route"], 0.0

    specs.append(dict(
        key="w1_epsilon", name=f"W1 calculate_epsilon ('gradient'), t0 = "
        f"{W1_T0}", expect=lambda: (2 * found["evaluations"], 0), pre=None,
        plain=None, kernel=epsilon, oracle=epsilon_check,
        oracle_tol=LBFGS_PARAM_TOL))

    # W2: the recording's rotated (2,2) and (3,2) rows.
    wr = w2["rotation"]
    data2 = {lm: wr.h[lm] for lm in SPH}
    w2p = dict(times=wr.times, t0s=t0s, T=W2_T, data=data2)
    modesets("w2_main", f"W2 NRSur7dq4 recording, rotated: the 16 bench "
             f"sets, {len(t0s)} start times (dedup)", w2p, data2,
             bench_mode_sets(), SPH, wr.Mf, wr.chif_mag, True)

    # W3: the rotated rows of the SXS-width waveform, one wide launch.
    times3, wr3 = w3["times"], w3["rotation"]
    data3 = {lm: wr3.h[lm] for lm in W3_SPH}
    t0s3 = np.linspace(*W3_T0, problem["wave_dyn_t0"])
    w3p = dict(times=times3, t0s=t0s3, T=problem["T"], data=data3)
    modesets("w3_wide", f"W3 ellMax={w3['ell_max']}, K={len(times3)}, "
             f"rotated (2,2), (3,2), (4,2): a {len(W3_SET)}-mode set, "
             f"{len(t0s3)} start times", w3p, data3, [W3_SET], W3_SPH,
             wr3.Mf, wr3.chif_mag, True)
    return specs, found


def _stages(wf):
    return ", ".join(f"{k} {v:.4f}" for k, v in wf.stage_seconds.items())


def _summary(path):
    """A phase 11 path's record in the kernels' JSON line."""
    out = {k: path[k] for k in ("launches", "wide_launches",
                                "expected_launches", "wall_s")}
    if path.get("split"):
        out.update({k: path["split"][k] for k in ("wall_ms", "busy_ms",
                                                  "idle_share", "kernels")})
    return out


def run_waveforms(problem, device, gpu=None):
    """Phase 11: build W1-W3 through the port's loaders (each stage's host
    seconds kept), gate W3's 'rotation' against its untilted modes, then
    ``run_specs`` on the fits of ``waveform_specs``; on the card also each
    fit's device-time split.  Returns the path records, the waveforms'
    record and the phase's wall."""
    from qnmfits_tpu_torch.waveforms import Custom
    t = time.perf_counter()
    w1, branch = load_w1()
    log(f"W1 SXS({W1_ID}) through the {branch}: K={len(w1.times)}, "
        f"ellMax={w1.ellMax}, Mf={w1.Mf}, |chif|={w1.chif_mag:.6f}; host "
        f"s by stage: {_stages(w1)}")
    w2 = load_w2()
    for tr, wf in w2.items():
        if not all(np.all(np.isfinite(v)) for v in wf.h.values()):
            raise RuntimeError(f"W2 {tr}: non-finite modes")
        log(f"W2 NRSur7dq4 recording, Custom(transform={tr!r}): "
            f"K={len(wf.times)}, {len(wf.h)} modes, thetaf="
            f"{wf.thetaf:.6f}; host s by stage: {_stages(wf)}")
    ell, K = problem["w3_ell"], problem["w3_K"]
    tb = time.perf_counter()
    times3, h0, tilted, md = build_w3(ell, K)
    build_s = time.perf_counter() - tb
    w3 = dict(times=times3, ell_max=ell, build_s=build_s)
    for tr in ("rotation", "dynamic_rotation"):
        w3[tr] = Custom(times3, tilted, md, transform=tr)
        log(f"W3 Custom(ellMax={ell}, K={K}, transform={tr!r}): "
            f"{len(w3[tr].h)} modes; host s by stage: "
            f"{_stages(w3[tr])}")
    hmax = max(float(np.max(np.abs(v))) for v in h0.values())
    rot_err = max(float(np.max(np.abs(w3["rotation"].h[lm] - h0[lm])))
                  for lm in h0) / hmax
    log(f"W3 'rotation' against the untilted modes: {rot_err:.3e} of max "
        f"|h| (bound {ROTATION_TOL:.0e}); the data built in {build_s:.2f} s")
    if not rot_err <= ROTATION_TOL:
        raise RuntimeError("W3: 'rotation' does not undo the tilt")
    if not np.all(np.isfinite(w3["dynamic_rotation"].chioft_mag)):
        raise RuntimeError("W3: non-finite spin track")

    specs, found = waveform_specs(problem, device, w1, w2, w3)
    records = run_specs(specs, device)
    for spec, rec in zip(specs, records):
        systems = rec.pop("systems", None)
        if systems:
            rec["systems"] = sum(b.shape[0] for _, b in systems)
            rec["n"] = max(b.shape[-1] for _, b in systems)
        if device == "cpu":
            continue
        split = rec["split"] = device_split(spec["kernel"], host_ops=False)
        if split is None:
            log(f"  {rec['key']} device-time split: torch.profiler recorded "
                "no device time (not measured)")
            continue
        log(f"  {rec['key']} on {gpu}: warm wall {split['wall_ms']:.2f} ms; "
            f"busy {split['busy_ms']:.2f} ms, idle share "
            f"{split['idle_share']:.3f} of the profiled wall "
            f"{split['profiled_wall_ms']:.2f} ms; {split['kernels']} kernels "
            f"and {split['copies']} copies: products "
            f"{split['products_ms']:.2f}, elementwise "
            f"{split['elementwise_ms']:.2f}, solve {split['solve_ms']:.4f}, "
            f"factored kernels {split['sweep_ms']:.3f}, copies "
            f"{split['copies_ms']:.2f}, rest {split['rest_ms']:.2f} ms")
    info = dict(
        w1=dict(branch=branch, K=len(w1.times), ell_max=w1.ellMax,
                stages=w1.stage_seconds,
                pins={k: found[k] for k in W1_PINS},
                epsilon_route=found["epsilon_route"],
                epsilon_nelder_mead=found["epsilon_nelder_mead"]),
        w2={tr: dict(K=len(wf.times), modes=len(wf.h),
                     stages=wf.stage_seconds) for tr, wf in w2.items()},
        w3=dict(K=K, ell_max=ell, modes=len(h0), build_s=build_s,
                rotation_err=rot_err,
                stages={tr: w3[tr].stage_seconds
                        for tr in ("rotation", "dynamic_rotation")}))
    wall = time.perf_counter() - t
    log(f"phase 11: 3 waveforms, {len(records)} paths in {wall:.1f} s")
    return records, info, wall



# ---------------------------------------------------------------------------
# Phase 12: the on-demand Kerr spectrum solver
# ---------------------------------------------------------------------------

# S1: the Leaver CF kernel against its plain version, relative to
# |U| + |T| (near a root U - T cancels, so the residual is no scale).  The
# random batches reach chi = 0.999 (b = sqrt(1 - chi^2) down to 0.045),
# where the coefficients carry 1/b: there contracting their formulas into
# fused multiply-adds alone moves the residual by up to 1.6e-13 of |U| +
# |T| (so the kernel is built without contraction and writes its loop's
# fused multiply-adds out; PERF.md, section 6).
CF_TOL = 1e-12
# The work of the recurrence, the yardstick of every CF row (the serial
# recursion's FP64 operations a step: alpha_k 6, beta_{k+1} 7,
# gamma_{k+1} 9, their product 6, the difference 2, Smith's division 10,
# two of them divisions; the kernel's segmented product does ~37 a step
# and its combine more), the once-an-element work (the coefficients and
# the tail's start), and the bytes an element reads (omega, a, A, n_inv:
# 44) and writes (U - T, |U| + |T|: 24).
CF_OPS_PER_STEP = 40
CF_OPS_ONCE = 120
CF_BYTES = 68
CF_SEED = 13
# S1-X: the double-double variant (spins beyond cf_cuda.CHI_EXTENDED)
# against its plain version, relative to |U| + |T|: both carry ~106 bits
# and round once, so they part by at most one rounding of an FP64 result
# that itself is far below |U| + |T| near a root.
CF_DD_TOL = 1e-17
# Its work, FP64 operations (a fused multiply-add counted as 2) a
# double-double step of the segmented product: tau_k 66, R_k 168, the two
# rows 640 (csrc/leaver_cf.cu: a double-double sum 20, product 10, product
# with a double 8; a complex product 80, a complex sum 40); and once an
# element, the coefficients (~60 complex operations), the tail's start and
# the finish (~40), ~100 x 60.
CF_DD_OPS_PER_STEP = 874
CF_DD_OPS_ONCE = 6000
# The kernel's own count a step, beside that yardstick: tau_k 66 and R_k
# 168 by Horner as before, the two rows 376 with one renormalisation a sum
# (csrc/leaver_cf.cu's zdot 116 and zmul_sub 72, two of each; a part of
# either: a product 7, its leading part and its rounding error; a join 8,
# a two-sum and two additions; the last two-sum 6).
CF_DD_KERNEL_OPS_PER_STEP = 66 + 168 + 2 * 116 + 2 * 72
CF_DD_CHI = (0.985, 0.9995)
# The angular eigen-kernel (csrc/angular_eig.cu) against its plain version
# (torch.linalg.eig of the CPU copy): eigenvalues as sets within EIG_TOL
# max(1, ||M||_F); the selected vector within EIG_VEC_TOL, its residual
# ||M v - A v|| within EIG_RES_TOL ||M||_F (tests/test_torch_angular_eig.py's
# bars).  Its bound counts the FP64 operations the kernel reports for each
# matrix (``eig_cuda.last_info``: its loops' work, set-up steps left out).
EIG_TOL = 1e-12
EIG_VEC_TOL = 1e-10
EIG_RES_TOL = 1e-13
# S2: baked rows (s, l, m, n) re-solved over the table's spins, bypassing
# the table, each held to its row for chi <= RESOLVE_SPLIT and beyond:
# omega absolute, A relative to the row's largest |A|, mu absolute.  The
# tables came from the JAX package's 80-bit CF; the port's FP64 re-solve of
# (2,2,0) and (3,-3,5) on the CPU read 5e-16 and 6.3e-14 in omega to
# 0.985, and 1.1e-10 beyond (PERF.md, section 6).
RESOLVE_ROWS = ((-2, 2, 2, 0), (-2, 2, 2, 7), (-2, 3, -3, 5), (-2, 4, 4, 0),
                (-1, 2, 1, 0), (0, 0, 0, 2))
RESOLVE_SPLIT = 0.985
RESOLVE_TOL = dict(omega=(1e-11, 1e-8), A=(1e-11, 1e-8), mu=(1e-10, 1e-8))
# (3,-3,5) beyond RESOLVE_SPLIT, the near-extremal tiers' row: omega within
# this of the row (PERF.md, section 6).
RESOLVE_335_TOL = 3.5e-10
# S3: the JAX package's pin of the on-demand (11,2,0)
# (tests/test_spectrum.py:481).
PIN_MODE, PIN_CHI = (11, 2, 0), 0.68
PIN_OMEGA, PIN_TOL = 2.3864244708 - 0.0906875519j, 1e-8
# S4: the l = 2, m = 2 multiplets and extended ladder against the baked
# (2,2,8..20) rows, on the table's spins up to multiplet_chi_max, held from
# MULTIPLET_CHI_MIN on (below it the tracks are a sqrt(chi) fit through the
# lowest solved spins).  The table's own spacing is kept: on every 8th spin
# the march's steps pass the continuity guard (0.12 |omega| ~ 0.24 near
# -2i) and every track lands one overtone (~0.25) off (PERF.md, section 6).
MULTIPLET_CHI_MIN = 0.05
MULTIPLET_TOL = 1e-8
# F1: the bench's (2,2,n<4) set with the on-demand (5,2,8).
F1_SET = [(2, 2, n, 1) for n in range(4)] + [(5, 2, 8, 1)]
# F1's (5,2,8) at the s = -2 table's spins beyond chi = 0.985 (omega, M = 1
# units, and A): the JAX package's track_mode with its 80-bit native CF, on
# the CPU (PYTHONPATH=. python tests/test_torch_extremal.py).  F1's omega is
# held to them within PIN_528_TOL.
PIN_528 = {
    0.9853425983505129: (1.0962006169750012 - 0.8229986663007255j,
                         27.219321142165523 + 1.057895753617208j),
    0.9866610259985805: (1.0958696818842026 - 0.8461711028607607j,
                         27.230763613591495 + 1.0902958348345728j),
    0.9879731754197524: (1.0901434768922627 - 0.823912171923649j,
                         27.225066167858234 + 1.060308595719232j),
    0.9892790466140289: (1.090607036799784 - 0.8383840537061834j,
                         27.23087115044567 + 1.0817311025524174j),
    0.9905786395814097: (1.0751254894248368 - 0.8051774586359035j,
                         27.232266308883364 + 1.0322760660464578j),
    0.991871954321895: (1.072528909250729 - 0.8121359165499469j,
                        27.23801112437893 + 1.0420985416835389j),
    0.9931589908354848: (1.0649790852231786 - 0.805089137616678j,
                         27.242899776046833 + 1.0310525766003373j),
    0.9944397491221789: (1.071888752253038 - 0.8305232037780387j,
                         27.246148985789972 + 1.070055001980229j),
    0.9957142291819776: (1.0711100362782882 - 0.8383233843111347j,
                         27.250187711833348 + 1.0820156445418103j),
    0.9969824310148806: (1.07129039863154 - 0.8357522828049027j,
                         27.247335221564715 + 1.0808790959822385j),
    0.9982443546208881: (1.069532876237053 - 0.83545852405038j,
                         27.248283838364276 + 1.0816636511388251j),
    0.9995: (1.0681572880044379 - 0.8349959552720283j,
             27.24864776250752 + 1.0824205784939513j),
}
PIN_528_TOL = 1e-8


class SolverClock:
    """While active, times the solver's CF calls (CUDA events around each
    call of the wrapper on the card, and around each launch of the
    double-double kernel; the host clock for the plain version) and its
    angular eigenproblems (CUDA events around each call of
    ``ops/eig_cuda``'s wrappers on the card: the eig kernel's launch and
    the wrapper's host work with its one synchronisation; the host clock
    for the plain version), the eig calls by stage of the solve (with a
    ``NewtonWatch``, its ``stage``: the coarse pass's Newton, each depth
    of the fine pass's lockstep Newton, the rest; without one, all
    "other"), and keeps the (B, N) of every CF call and of every launch
    of each variant, a copy of the inputs of the largest CF call and of
    the largest double-double launch, and of the largest eig call of each
    mode."""

    def __init__(self, watch=None):
        self.watch = watch

    def __enter__(self):
        import torch
        from qnmfits_tpu_torch.ops import cf_cuda
        from qnmfits_tpu_torch.spectrum import solver
        self.events, self.dd_events, self.eig_events = [], [], []
        self.cf_host_s, self.eig_host_s = 0.0, 0.0
        self.eig_calls = self.eig_matrices = self.largest_work = 0
        self.shapes, self.largest = {}, None
        self.launch_shapes = {False: {}, True: {}}
        self.largest_dd, self._largest_dd_work = None, 0
        self.eig_stages, self.eig_samples = {}, {}
        self._orig = (solver.leaver_cf, solver.angular_eigvals,
                      solver.angular_eigpair)
        orig_cf, orig_vals, orig_pair = self._orig
        self._orig_launch = orig_launch = cf_cuda._launch

        def cf(omega, aL, A, s, m, n_inv, N):
            key = (omega.shape[0], N)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            if key[0] * N > self.largest_work:
                self.largest_work = key[0] * N
                self.largest = (omega.clone(), aL.clone()
                                if torch.is_tensor(aL) else aL, A.clone(),
                                s, m, n_inv, N)
            if not omega.is_cuda:
                t = time.perf_counter()
                out = orig_cf(omega, aL, A, s, m, n_inv, N)
                self.cf_host_s += time.perf_counter() - t
                return out
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig_cf(omega, aL, A, s, m, n_inv, N)
            ev[1].record()
            self.events.append(ev)
            return out

        def launch(omega, a, A, s, m, n_inv, N, team, extended=False, **kw):
            key = (omega.shape[0], N)
            book = self.launch_shapes[extended]
            book[key] = book.get(key, 0) + 1
            if not extended:
                return orig_launch(omega, a, A, s, m, n_inv, N, team, **kw)
            if key[0] * N > self._largest_dd_work:
                self._largest_dd_work = key[0] * N
                self.largest_dd = tuple(x.clone() if torch.is_tensor(x)
                                        else x for x in
                                        (omega, a, A, s, m, n_inv, N))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = orig_launch(omega, a, A, s, m, n_inv, N, team, extended,
                              **kw)
            ev[1].record()
            self.dd_events.append(ev)
            return out

        def eig(mode, orig):
            def run(*args):
                c = args[2] if mode == "values" else args[3]
                book = self.eig_stages.setdefault(
                    self.watch.stage if self.watch else "other",
                    dict(calls=0, matrices=0, events=[], host_s=0.0))
                book["calls"] += 1
                book["matrices"] += c.shape[0]
                self.eig_calls += 1
                self.eig_matrices += c.shape[0]
                best = self.eig_samples.get(mode)
                if best is None or c.shape[0] > best["batch"]:
                    self.eig_samples[mode] = dict(
                        mode=mode, batch=c.shape[0],
                        args=tuple(x.clone() if torch.is_tensor(x) else x
                                   for x in args))
                if not c.is_cuda:
                    t = time.perf_counter()
                    out = orig(*args)
                    dt = time.perf_counter() - t
                    self.eig_host_s += dt
                    book["host_s"] += dt
                    return out
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = orig(*args)
                ev[1].record()
                self.eig_events.append(ev)
                book["events"].append(ev)
                return out
            return run

        solver.leaver_cf = cf
        solver.angular_eigvals = eig("values", orig_vals)
        solver.angular_eigpair = eig("vectors", orig_pair)
        cf_cuda._launch = launch
        return self

    def __exit__(self, *exc):
        from qnmfits_tpu_torch.ops import cf_cuda
        from qnmfits_tpu_torch.spectrum import solver
        (solver.leaver_cf, solver.angular_eigvals,
         solver.angular_eigpair) = self._orig
        cf_cuda._launch = self._orig_launch

    @staticmethod
    def _events_s(events):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / 1e3

    def cf_s(self):
        """Seconds in the CF: device time of the launches on the card."""
        return self._events_s(self.events) if self.events else self.cf_host_s

    def eig_s(self):
        """Seconds in the eig wrappers: CUDA events on the card."""
        return (self._events_s(self.eig_events) if self.eig_events
                else self.eig_host_s)

    def summary(self, wall):
        cf, eig = self.cf_s(), self.eig_s()

        def shapes(book):
            return {f"{b}x{n}": c for (b, n), c in sorted(book.items())}

        stages = {k: dict(calls=v["calls"], matrices=v["matrices"],
                          s=(self._events_s(v["events"]) if v["events"]
                             else v["host_s"]))
                  for k, v in self.eig_stages.items()}
        return dict(wall_s=wall, cf_s=cf, eig_s=eig, rest_s=wall - cf - eig,
                    cf_calls=sum(self.shapes.values()),
                    eig_calls=self.eig_calls,
                    eig_matrices=self.eig_matrices, eig_by_stage=stages,
                    cf_shapes=shapes(self.shapes),
                    cf_dd_s=(self._events_s(self.dd_events)
                             if self.dd_events else None),
                    cf_dd_launch_shapes=shapes(self.launch_shapes[True]))


class NewtonWatch:
    """While active, records each lockstep Newton call of the solver
    (``solver._newton_coupled_vec_a``: a depth tier of the fine pass, then
    its retries at 3x, 9x and 27x the depth): its depth, points,
    iterations and how many points ended converged (a step under tol
    |omega|), softly converged (after the 60 iterations, a last step under
    1e-9 |omega|) or unconverged, with the spins of the last; and the
    coarse pass's failed points (``_newton_coupled``), which it substeps,
    by spin.  A point still unconverged after its tier's last retry keeps
    the interpolated coarse track (``solver.track_mode``).  ``stage`` names
    the Newton running ("coarse", "N=<depth>", else "other"), for
    SolverClock's eig calls by stage.  The CF wrapper, which SolverClock
    brackets with CUDA events, is left alone."""

    def __init__(self, solver):
        self.solver = solver
        self.lockstep, self.coarse_failed_chi = [], []
        self.coarse_calls = 0
        self.stage = "other"

    def __enter__(self):
        import torch
        sv = self.solver
        self._orig = vec, step, coupled = (sv._newton_coupled_vec_a,
                                           sv._newton_step,
                                           sv._newton_coupled)
        state = {}

        def watched_step(omega, f, h, active=None):
            out = step(omega, f, h, active)
            if state:
                state["iterations"] += 1
                state["done"].append((out.abs() < state["tol"] * torch.clamp(
                    omega.abs(), min=1.0)).sum())
            return out

        def watched_vec(omega_L, aL_vec, A_guess, s, l, m, n_inv, nl, N, tol,
                        maxiter=60):
            state.update(iterations=0, done=[], tol=tol)
            self.stage = f"N={N}"
            try:
                out = vec(omega_L, aL_vec, A_guess, s, l, m, n_inv, nl, N,
                          tol, maxiter)
            finally:
                iterations, done = state["iterations"], state["done"]
                state.clear()
                self.stage = "other"
            ok = out[3]
            hard = int(sum(int(d) for d in done))
            self.lockstep.append(dict(
                N=int(N), points=int(ok.numel()), iterations=iterations,
                converged=hard, soft=int(ok.sum()) - hard,
                unconverged=int((~ok).sum()),
                unconverged_chi=[2.0 * float(a) for a in aL_vec[~ok]]))
            return out

        def watched_coupled(omega_L, aL, A_guess, s, l, m, n_inv, nl, N, tol,
                            maxiter=60):
            self.stage = "coarse"
            try:
                out = coupled(omega_L, aL, A_guess, s, l, m, n_inv, nl, N,
                              tol, maxiter)
            finally:
                self.stage = "other"
            self.coarse_calls += 1
            if not bool(out[2][0]):
                self.coarse_failed_chi.append(2.0 * float(aL))
            return out

        (sv._newton_coupled_vec_a, sv._newton_step,
         sv._newton_coupled) = watched_vec, watched_step, watched_coupled
        return self

    def __exit__(self, *exc):
        (self.solver._newton_coupled_vec_a, self.solver._newton_step,
         self.solver._newton_coupled) = self._orig

    def tiers(self):
        """The lockstep calls grouped by tier (a power-of-two depth and its
        retries), with the points each tier left unconverged."""
        out = []
        for call in self.lockstep:
            if call["N"] & (call["N"] - 1) == 0:
                out.append(dict(tier=call["N"], calls=[]))
            out[-1]["calls"].append(call)
        for tier in out:
            last = tier["calls"][-1]
            tier["fell_back"] = last["unconverged"]
            tier["fell_back_chi"] = last["unconverged_chi"]
        return out

    def on_coarse_track(self, points):
        """Points of a track of ``points`` spins that kept the coarse track:
        those its tiers left unconverged, and those past a failed coarse
        pass, which no tier took."""
        tiers = self.tiers()
        solved = sum(t["calls"][0]["points"] for t in tiers)
        return sum(t["fell_back"] for t in tiers) + points - solved


def _clocked(fn, watch=None):
    """(fn(), SolverClock summary, the clock), the CF and eig kernels'
    launch counts set to 0 just before and read just after; ``watch`` a
    NewtonWatch that names the stages of the eig calls."""
    from qnmfits_tpu_torch.ops import cf_cuda, eig_cuda
    cf_cuda.launches = cf_cuda.dd_launches = eig_cuda.launches = 0
    with SolverClock(watch) as clk:
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
    rec = clk.summary(wall)
    rec["cf_launches"] = cf_cuda.launches
    rec["cf_dd_launches"] = cf_cuda.dd_launches
    rec["eig_launches"] = eig_cuda.launches
    rec["timed_by"] = SOLVE_TIMED_BY
    return out, rec, clk


def cf_bound_ms(B, N, extended=False, per_step=None):
    """Least time of one CF launch of B elements at depth N: the larger of
    the bytes over HBM bandwidth and the FP64 operations (N + 1 recursion
    steps an element, upward and backward together; double-double steps
    where ``extended``, at ``per_step`` operations a step where given)
    over the FP64 peak."""
    step, once = ((CF_DD_OPS_PER_STEP, CF_DD_OPS_ONCE) if extended
                  else (CF_OPS_PER_STEP, CF_OPS_ONCE))
    per_step = step if per_step is None else per_step
    t_bytes = B * CF_BYTES / HBM_BYTES_PER_S
    t_ops = B * (per_step * (N + 1) + once) / FP64_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _timed_ms(fn, device, reps):
    """Mean ms of fn() over reps calls: CUDA events on the card, the host
    clock on the CPU."""
    import torch
    if device == "cpu":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=20, kernel="leaver_cf_kernel"):
    """Mean device time of a hand-written kernel's launches in fn() (one
    a call), from torch.profiler's records of ``kernel``
    (``leaver_cf_kernel``, ``leaver_cf_dd_kernel`` for the CF's
    double-double variant, one of ``sweep_cuda.KERNELS``, or a tuple of
    names, any of which counts: ``eig_cuda.KERNELS``) over reps calls:
    the wrapper's own copies and the host's launch cost are left out (at
    small batches they take longer than the kernel).  A profile without
    the kernel's records is taken again, up to three times; then it
    raises: CUDA events would time the wrapper, not the kernel."""
    import inspect
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    # Each profile keeps its own events (where this torch has the
    # setting), not only those of a profiler cycle.
    keep = ({"acc_events": True} if "acc_events" in
            inspect.signature(profile.__init__).parameters else {})
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **keep) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        recs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                and any(name in e.key for name in names)]
        count = sum(e.count for e in recs)
        if count:
            return sum(e.self_device_time_total for e in recs) / count / 1e3
    raise RuntimeError(f"torch.profiler recorded no {' or '.join(names)} "
                       "in three profiles")


# How the CF records' times are taken, by field, on the card and (the plain
# version only) on the CPU.
CF_TIMED_BY = dict(
    ms="torch.profiler: the kernel's device time, mean over its launches",
    call_ms="CUDA events around reps wrapper calls (host work included)",
    plain_ms="CUDA events around one plain-version call")
CF_TIMED_BY_CPU = dict(ms="host clock: the plain version",
                       call_ms="host clock: the plain version",
                       plain_ms="host clock: the plain version")
EIG_TIMED_BY = dict(
    ms="CUDA events around 20 back-to-back launches of the kernel's C "
       "entry (eig_cuda.launch_ms; torch.profiler late in this script "
       "has recorded none of this kernel's launches)",
    call_ms="CUDA events around 10 wrapper calls (each with its "
            "synchronisation)",
    plain_ms="host clock: the plain version on the CPU copy",
    library_ms="CUDA events around one call: torch.linalg on the CUDA "
               "matrices",
    library_cpu_ms="host clock: torch.linalg on a CPU copy")
SOLVE_TIMED_BY = dict(
    wall_s="host clock",
    cf_s="CUDA events around each wrapper call (host work included); the "
         "host clock on the CPU",
    cf_kernel_s="replayed: the kernel's device time (torch.profiler) at "
                "each launch shape of the solve on S1's random inputs, "
                "times that shape's launches",
    eig_s="CUDA events around each call of the eig wrappers (the kernel's "
          "launch and the wrapper's host work, one synchronisation "
          "included); the host clock on the CPU")


def _kernel_name(extended):
    return "leaver_cf_dd_kernel" if extended else "leaver_cf_kernel"


def check_cf(inputs, device, reps=10, extended=False):
    """One variant of the CF kernel (FP64, or double-double where
    ``extended``), launched on the whole batch with ``cf_cuda.plan``'s team
    (``plan_dd``'s team and blocks), against
    its plain version (``cf_parts``, ``cf_dd``), with both timed: on the
    card ``ms`` is the kernel's device time and ``call_ms`` the launch
    call's (CUDA events around reps calls), on the CPU both the plain
    version's host time.  Returns its record, with the launch's team,
    blocks an element and segment length (None on the CPU); raises beyond
    CF_TOL (CF_DD_TOL)."""
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, s, m, n_inv, N = inputs
    B = w.shape[0]
    tol = CF_DD_TOL if extended else CF_TOL
    plain = {}

    def run_plain():
        if extended:
            plain["f"] = cf_cuda.cf_dd(w, a, A, s, m, n_inv, N)
        else:
            U, T = cf_cuda.cf_parts(w, a, A, s, m, n_inv, N)
            plain["f"] = (U - T, U.abs() + T.abs())

    plain_ms = _timed_ms(run_plain, device, 1)
    ref, ref_scale = plain["f"]
    team = blocks = segment = None
    if device == "cpu":
        call = run_plain
        f, scale = ref, ref_scale
    else:
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        team, blocks = (cf_cuda.plan_dd(B, N, sms)[:2] if extended
                        else (cf_cuda.plan(B, N, sms)[0], 1))

        def call():
            return cf_cuda._launch(w, a, A, s, m, n_inv, N, team,
                                   extended=extended, blocks=blocks)

        before = cf_cuda.dd_launches if extended else cf_cuda.launches
        f, scale = call()
        after = cf_cuda.dd_launches if extended else cf_cuda.launches
        if after != before + 1:
            raise RuntimeError(f"{_kernel_name(extended)} did not launch")
        if extended:
            team, blocks, segment = cf_cuda.last_dd_plan
        else:
            team, segment = cf_cuda.last_plan
    err = float(((f - ref).abs() / scale).max())
    err_scale = float(((scale - ref_scale).abs() / scale).max())
    bound, by = cf_bound_ms(B, N, extended)
    call_ms = _timed_ms(call, device, reps)
    ms = (call_ms if device == "cpu"
          else kernel_ms(call, kernel=_kernel_name(extended)))
    if not (err <= tol and err_scale <= tol):
        raise RuntimeError(f"{_kernel_name(extended)} vs plain at B={B}, "
                           f"N={N}: {err:.3e} of |U| + |T| (scale "
                           f"{err_scale:.3e}); bound {tol:.0e}")
    rec = dict(batch=B, N=N, chain_steps=N + 1, team=team, blocks=blocks,
               segment=segment, rel_err=err, scale_err=err_scale,
               max_abs_err=float((f - ref).abs().max()), ms=ms,
               call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, bound_share=bound / ms,
               timed_by=CF_TIMED_BY_CPU if device == "cpu" else CF_TIMED_BY)
    if extended:
        own, _ = cf_bound_ms(B, N, True, CF_DD_KERNEL_OPS_PER_STEP)
        rec.update(variant_bound_ms=own, variant_bound_share=own / ms)
    return rec


def cf_replay_s(shapes, device, extended=False):
    """Device seconds of one CF kernel variant over a solve's launches,
    replayed: the kernel timed at each (B, N) of its launches (``shapes``,
    as SolverClock keeps them by variant) on S1's inputs with ``plan``'s
    team (S1-X's through ``leaver_cf``, all beyond CHI_EXTENDED, with the
    wrapper's own plan for the double-double variant), times that shape's
    count; and the ms of one launch by shape.  The CUDA events of
    SolverClock bracket each wrapper call and so also count the host's
    work in it, which at these shapes outlasts the kernel.  (Profiles of
    5 calls recorded no CF kernel after phases 1-11; those of kernel_ms's
    20 do.)"""
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    rng = np.random.default_rng(CF_SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    total, by_shape = 0.0, {}
    for (B, N), count in sorted(shapes.items()):
        w, a, A, s, m, n_inv, _ = cf_inputs(
            rng, B, N, device, CF_DD_CHI if extended else None)
        team = cf_cuda.plan(B, N, sms)[0]
        ms = kernel_ms((lambda: cf_cuda.leaver_cf(w, a, A, s, m, n_inv, N))
                       if extended else (lambda: cf_cuda._launch(
                           w, a, A, s, m, n_inv, N, team)),
                       kernel=_kernel_name(extended))
        by_shape[f"{B}x{N}"] = ms
        total += count * ms / 1e3
    return total, by_shape


def cf_inputs(rng, B, N, device, chi=None):
    """CF inputs near real modes from rng (S1's distribution: omega, spin
    to chi = 0.999, or in the range ``chi``, and A per element, n_inv 0..8,
    s = -2, m = 2) at depth N, as the wrapper takes them."""
    import torch
    w = 2.0 * (0.3 + 0.6 * rng.random(B) - 1j * (0.05 + 0.6 * rng.random(B)))
    lo, hi = chi or (0.0, 0.999)
    a = 0.5 * (lo + (hi - lo) * rng.random(B))
    A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
    n_inv = rng.integers(0, 9, B)
    return tuple(torch.as_tensor(x, device=device) for x in (w, a, A)) + (
        -2, 2, torch.as_tensor(n_inv, device=device), N)


def cf_checks(problem, device, gpu):
    """S1: the FP64 CF kernel against its plain version on random batches
    near real modes (omega, spin and A per element, n_inv 0..8, s = -2, m =
    2) at each batch and depth of the problem."""
    rng = np.random.default_rng(CF_SEED)
    out = []
    for N in problem["cf_depths"]:
        for B in problem["cf_batches"]:
            r = check_cf(cf_inputs(rng, B, N, device), device,
                         reps=10 if B * N < 2e7 else 3)
            out.append(r)
            log(f"S1 CF kernel vs plain on {gpu or device}, B={B}, N={N} "
                f"(team {r['team']}, {r['segment']} steps a thread): "
                f"{r['rel_err']:.3e} of |U| + |T| (bound {CF_TOL:.0e}); "
                f"{r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), plain "
                f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.3e} ms "
                f"({r['bound_by']}), share {r['bound_share']:.2e}")
    return out


def cf_dd_checks(problem, device, gpu):
    """S1-X: the double-double variant against its plain version on random
    batches at spins CF_DD_CHI (the solver's near-extremal tiers and
    retries) at each (B, N) of the problem with ``plan_dd``'s team and
    blocks, then at every (team, blocks) of ``dd_plans`` on the first; a
    launch's cycles by phase (``cf_cuda.phase_cycles``) at the first
    shape's plan; and a mixed batch: spins on both
    sides of CHI_EXTENDED through ``leaver_cf``, its FP64 elements bit for
    bit an FP64-only call of them, the others a double-double-only one."""
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    rng = np.random.default_rng(CF_SEED + 1)
    out = []
    for B, N in problem["cf_dd_shapes"]:
        r = check_cf(cf_inputs(rng, B, N, device, CF_DD_CHI), device,
                     reps=10 if B * N < 2e6 else 3, extended=True)
        out.append(r)
        log(f"S1-X double-double CF kernel vs plain on {gpu or device}, "
            f"B={B}, N={N} (team {r['team']} x {r['blocks']} blocks, "
            f"{r['segment']} steps a thread): {r['rel_err']:.3e} of |U| + "
            f"|T| (bound "
            f"{CF_DD_TOL:.0e}); {r['ms']:.4f} ms (call {r['call_ms']:.4f} "
            f"ms), plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.3e} ms "
            f"({r['bound_by']}), share {r['bound_share']:.2e}; the "
            f"kernel's own count's bound {r['variant_bound_ms']:.3e} ms, "
            f"share {r['variant_bound_share']:.2e}")
    teams, phases = {}, None
    if device != "cpu":
        B, N = problem["cf_dd_shapes"][0]
        inputs = cf_inputs(rng, B, N, device, CF_DD_CHI)
        ref, scale = cf_cuda.cf_dd(*inputs)
        for team, blocks in cf_cuda.dd_plans():
            f, _ = cf_cuda._launch(*inputs, team, extended=True,
                                   blocks=blocks)
            teams[f"{team}x{blocks}"] = float(((f - ref).abs() / scale).max())
        log(f"S1-X every (team, blocks) at B={B}, N={N} ({len(teams)}): "
            f"largest error {max(teams.values()):.3e} of |U| + |T| (bound "
            f"{CF_DD_TOL:.0e})")
        if max(teams.values()) > CF_DD_TOL:
            raise RuntimeError(f"S1-X: a (team, blocks) misses its plain "
                               f"version: {teams}")
        phases = cf_cuda.phase_cycles(*inputs)
        log(f"S1-X a double-double launch's cycles by phase at B={B}, N={N} "
            f"(team {phases['team']} x {phases['blocks']} blocks; per "
            f"segment block, per warp for segments, per last block, per "
            f"element for terms): "
            + ", ".join(f"{k} {v:.0f}" for k, v in phases["cycles"].items())
            + f"; counts {phases['counts']}")
    # The mixed batch: spins 0.97-0.999, a tier straddling CHI_EXTENDED.
    B, N = 64, 8192 if device != "cpu" else 300
    w, _, A, s, m, n_inv, _ = cf_inputs(rng, B, N, device)
    a = torch.as_tensor(0.5 * np.linspace(0.97, 0.999, B), device=device)
    ext = 2.0 * a > cf_cuda.CHI_EXTENDED
    before = (cf_cuda.launches, cf_cuda.dd_launches)
    f, scale = cf_cuda.leaver_cf(w, a, A, s, m, n_inv, N, with_scale=True)
    mixed_launches = (cf_cuda.launches - before[0],
                      cf_cuda.dd_launches - before[1])
    same = {}
    for name, sel in (("fp64", ~ext), ("dd", ext)):
        g, g_scale = cf_cuda.leaver_cf(w[sel], a[sel], A[sel], s, m,
                                       n_inv[sel], N, with_scale=True)
        same[name] = bool(torch.equal(f[sel], g)
                          and torch.equal(scale[sel], g_scale))
    log(f"S1-X mixed batch (B={B}, N={N}, {int(ext.sum())} elements beyond "
        f"chi = {cf_cuda.CHI_EXTENDED}): FP64 elements bit for bit an "
        f"FP64-only call: {same['fp64']}; double-double elements a "
        f"double-double-only call: {same['dd']}; launches (FP64, "
        f"double-double) {mixed_launches}")
    if not (same["fp64"] and same["dd"]):
        raise RuntimeError("S1-X: the mixed batch's elements differ from "
                           "their single-arithmetic calls")
    if device != "cpu" and mixed_launches != (1, 1):
        raise RuntimeError(f"S1-X: the mixed batch launched {mixed_launches}")
    return out, dict(teams=teams, phases=phases, mixed=dict(batch=B, N=N,
                                             extended=int(ext.sum()),
                                             launches=list(mixed_launches),
                                             **same))


def _table_rows(s):
    """The tracked table of spin weight s: chi, keys, omega, A, mu."""
    from qnmfits_tpu_torch.spectrum.tables import table_path
    with np.load(table_path(s)) as z:
        return dict(chi=z["chi"], keys=[tuple(k) for k in z["keys"]],
                    omega=z["omega"], A=z["A"], mu=z["mu"])


def _row_gaps(w, A, C, z, row, sel, chi):
    """omega, A (relative to the row's largest |A|) and mu gaps of a
    re-solved track from the table's row, for chi <= RESOLVE_SPLIT and
    beyond."""
    lo = chi <= RESOLVE_SPLIT
    K = z["mu"].shape[-1]
    gaps = dict(
        omega=np.abs(w - z["omega"][row][sel]),
        A=np.abs(A - z["A"][row][sel]) / np.max(np.abs(z["A"][row])),
        mu=np.max(np.abs(C[:, :K] - z["mu"][row][sel]), axis=1))
    return {k: (float(np.max(v[lo], initial=0.0)),
                float(np.max(v[~lo], initial=0.0))) for k, v in gaps.items()}


def eig_bound_ms(B, n, ops, vectors):
    """Least time of one eig launch of B matrices of order n whose loops
    did ``ops`` FP64 operations in all (the kernel's count, its info's
    second column: each reduction step's reflector over the column's
    nonzero rows, each rotation's updated pairs over the active block,
    and in vectors mode the band LU and its solves): the larger of the
    bytes (c, and in vectors mode the guess, in; the n eigenvalues, and
    in vectors mode A and the vector, out; 16 a complex) over HBM
    bandwidth and the operations over the card's FP64 peak,
    FP64_FLOP_PER_S (the tensor cores' 67 TFLOP/s, the least time; the
    kernel's scalar FP64 can reach 34, against which its share is twice
    this one)."""
    t_bytes = B * 16 * (1 + n + (2 + n if vectors else 0)) / HBM_BYTES_PER_S
    t_ops = ops / FP64_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_eig(sample, device, timed=False):
    """One eig call of a solve (``SolverClock.eig_samples``: values mode
    (s, m, c, nl) or vectors mode (s, l, m, c, nl, guess)) launched again
    on the kernel and held to its plain version on the CPU copy:
    eigenvalues as sets within EIG_TOL max(1, ||M||_F); in vectors mode A
    within the same, the vector within EIG_VEC_TOL and its residual within
    EIG_RES_TOL ||M||_F.  With ``timed`` also the kernel's device time
    (``eig_cuda.launch_ms``), the call's (CUDA events, its synchronisation
    included), the plain version's (host clock), torch.linalg's on the
    CUDA matrices (CUDA events) and on a CPU copy (host clock), and the
    bound.  Returns its record; raises beyond a bar.  On the CPU (no
    kernel) returns None."""
    import torch
    from qnmfits_tpu_torch.ops import eig_cuda
    from qnmfits_tpu_torch.testing import eig_matching
    if device == "cpu":
        return None
    vectors = sample["mode"] == "vectors"
    if vectors:
        s, l, m, c, nl, guess = sample["args"]
        sel = l - max(abs(s), abs(m))
    else:
        (s, m, c, nl), guess, sel = sample["args"], None, 0
    B = c.shape[0]
    cc = c.cpu()

    def kernel():
        return eig_cuda._launch(s, m, c, nl, guess, sel)

    ev, A, C = kernel()
    torch.cuda.synchronize()
    info = eig_cuda.last_info.cpu()
    ops = int(info[:, 1].sum())
    M = eig_cuda.angular_matrices(s, m, cc, nl)
    fro = np.maximum(1.0, torch.linalg.matrix_norm(M).numpy())
    plain = {}

    def run_plain():
        plain["ev"] = eig_cuda.eigvals_plain(s, m, cc, nl)
        if vectors:
            plain["A"], plain["C"] = eig_cuda.eigpair_plain(
                s, l, m, cc, nl, guess.cpu())

    plain_ms = _timed_ms(run_plain, "cpu", 1)
    _, gap = eig_matching(ev.cpu().numpy(), plain["ev"].numpy())
    rec = dict(mode=sample["mode"], batch=B, n=nl, s=s, m=m,
               max_abs_err=float(gap.max()), rel_err=float((gap / fro).max()),
               sweeps_mean=float(info[:, 0].double().mean()), ops=ops)
    ok = rec["rel_err"] <= EIG_TOL
    if vectors:
        A, C = A.cpu(), C.cpu()
        res = torch.linalg.vector_norm(
            torch.einsum("bij,bj->bi", M, C) - A[:, None] * C, dim=1).numpy()
        rec.update(A_rel_err=float(((A - plain["A"]).abs().numpy()
                                    / fro).max()),
                   C_err=float((C - plain["C"]).abs().max()),
                   residual=float((res / fro).max()))
        ok = ok and (rec["A_rel_err"] <= EIG_TOL
                     and rec["C_err"] <= EIG_VEC_TOL
                     and rec["residual"] <= EIG_RES_TOL)
    if not ok:
        raise RuntimeError(f"angular_eig kernel vs plain ({sample['mode']}, "
                           f"B={B}, n={nl}): {rec}")
    if timed:
        bound, by = eig_bound_ms(B, nl, ops, vectors)
        Mg = M.to(c.device)
        lib = (torch.linalg.eig if vectors else torch.linalg.eigvals)
        lib(Mg[:1])
        rec.update(ms=eig_cuda.launch_ms(s, m, c, nl, guess, sel),
                   plan=dict(eig_cuda.last_plan),
                   call_ms=_timed_ms(kernel, device, 10), plain_ms=plain_ms,
                   library_ms=_timed_ms(lambda: lib(Mg), device, 1),
                   library_cpu_ms=_timed_ms(lambda: lib(M), "cpu", 1),
                   bound_ms=bound, bound_by=by, timed_by=EIG_TIMED_BY)
        rec["bound_share"] = bound / rec["ms"]
    return rec


def eig_launch_shapes():
    """(label, s, m, c, nl) of the eig launches most of a solve's eig time
    goes to, in values mode: the coarse pass's one matrix of n = 25 (c on
    the (2,2,0) row) and two of n = 28 (c of the coarse pass's kind, |c| ~
    1, Im c < 0), one of n = 28 and two of n = 25.
    ``scripts/torch_eig_ab.py`` times the same launches."""
    z = _table_rows(-2)
    c220 = z["chi"] * z["omega"][z["keys"].index((2, 2, 0))]
    pair = np.array([0.5 - 0.8j, 0.5 - 0.8j + 1e-6])
    return [("1 x 25", -2, 2, c220[200:201], 25),
            ("2 x 28", -2, 2, pair, 28),
            ("1 x 28", -2, 2, pair[:1], 28),
            ("2 x 25", -2, 2, c220[200:202], 25)]


def eig_small_launches(device, gpu):
    """The one- and two-matrix launches (``eig_launch_shapes``), each held
    to the plain version and timed as ``check_eig`` times a solve's
    largest calls, with its plan and a matrix's cycles by phase."""
    import torch
    from qnmfits_tpu_torch.ops import eig_cuda
    out = []
    for label, s, m, c, nl in eig_launch_shapes():
        ct = torch.as_tensor(c, device=device)
        rec = check_eig(dict(mode="values", batch=len(c),
                             args=(s, m, ct, nl)), device, timed=True)
        rec.update(label=label)
        rec["cycles"] = eig_cuda.phase_cycles(s, m, ct, nl)
        cyc = rec["cycles"]
        log(f"eig launch {label} on {gpu or device}: {_eig_line(rec)}; "
            f"plan {rec['plan']}; cycles a matrix: "
            + ", ".join(f"{k} {cyc[k]:.0f}" for k in
                        ("hessenberg", "qr sweeps", "split tests", "shifts",
                         "solve", "rotations", "per_rotation")))
        out.append(rec)
    return out


def eig_sample_checks(clk, device, label):
    """A solve's largest eig call of each mode held to the plain version
    (``check_eig``); logged, and returned as records."""
    out = []
    for mode in ("values", "vectors"):
        sample = clk.eig_samples.get(mode)
        rec = None if sample is None else check_eig(sample, device)
        if rec is None:
            continue
        out.append(rec)
        extra = (f", A {rec['A_rel_err']:.1e}, vector {rec['C_err']:.1e} "
                 f"(bound {EIG_VEC_TOL:.0e}), residual {rec['residual']:.1e}"
                 f" (bound {EIG_RES_TOL:.0e})" if mode == "vectors" else "")
        log(f"{label} eig kernel vs plain on its largest {mode} call (B="
            f"{rec['batch']}, n={rec['n']}, {rec['sweeps_mean']:.1f} sweeps "
            f"a matrix): eigenvalues {rec['rel_err']:.1e} of max(1, "
            f"||M||_F) (bound {EIG_TOL:.0e}){extra}")
    return out


def eig_where(s, m, c, nl):
    """The eig of a fine pass's Newton step (values mode, every c of a
    (B,) CUDA tensor) through the kernel beside torch.linalg.eigvals of the
    same matrices on the card and on a CPU copy, and its bound
    (``check_eig``, timed)."""
    rec = check_eig(dict(mode="values", batch=c.shape[0],
                         args=(s, m, c, nl)), "cuda", timed=True)
    rec["matrices"] = c.shape[0]
    return rec


def _eig_line(rec):
    return (f"kernel {rec['ms']:.4f} ms (call {rec['call_ms']:.4f} ms, "
            f"{rec['sweeps_mean']:.1f} sweeps a matrix), plain "
            f"{rec['plain_ms']:.1f} ms, torch.linalg "
            f"{rec['library_ms']:.1f} ms on the card / "
            f"{rec['library_cpu_ms']:.1f} ms on a CPU copy, bound "
            f"{rec['bound_ms']:.3e} ms ({rec['bound_by']}), share "
            f"{rec['bound_share']:.2e}; {rec['rel_err']:.1e} of max(1, "
            f"||M||_F) from the plain version")


def resolve_rows(problem, device, gpu):
    """S2: re-solve baked rows through seeds and ``track_mode`` over the
    table's spins (every resolve_stride-th), bypassing the table; gate
    omega, A and mu against the rows; time each solve with its CF launches
    and the split between CF and eig time."""
    from qnmfits_tpu_torch.spectrum import solver
    stride, out, tables = problem["resolve_stride"], [], {}
    for s, l, m, n in RESOLVE_ROWS[:problem["resolve_rows"]]:
        z = tables.get(s) or tables.setdefault(s, _table_rows(s))
        sel = slice(None, None, stride)
        chi = z["chi"][sel]

        def solve():
            seeds = solver.schwarzschild_seeds(l_max=l, n_max=n, s=s,
                                               n_max_low_l=0, device=device)
            return solver.track_mode(l, m, n, seeds[(l, n)], chi, s=s,
                                     device=device)

        (w, A, C), rec, clk = _clocked(solve)
        rec.update(key=f"s{s}_{l}{m:+d}{n}", points=len(chi),
                   gaps=_row_gaps(w, A, C, z, z["keys"].index((l, m, n)),
                                  sel, chi))
        out.append(rec)
        g = rec["gaps"]
        log(f"S2 ({l},{m},{n}) s={s} re-solved on {len(chi)} spins "
            f"({device}): omega {g['omega'][0]:.2e} / {g['omega'][1]:.2e}, "
            f"A {g['A'][0]:.2e} / {g['A'][1]:.2e}, mu {g['mu'][0]:.2e} / "
            f"{g['mu'][1]:.2e} from the table (chi <= {RESOLVE_SPLIT} / "
            f"beyond; bounds {RESOLVE_TOL}); {rec['wall_s']:.2f} s: CF "
            f"{rec['cf_s']:.2f} s by events in {rec['cf_launches']} "
            f"launches, eig {rec['eig_s']:.3f} s by events in "
            f"{rec['eig_calls']} calls ({rec['eig_matrices']} matrices, "
            f"{rec['eig_launches']} kernel launches), rest "
            f"{rec['rest_s']:.2f} s; double-double CF "
            f"{rec['cf_dd_launches']} launches, {_opt_s(rec['cf_dd_s'])} by "
            f"events")
        for k, (tol_lo, tol_hi) in RESOLVE_TOL.items():
            if (s, l, m, n) == (-2, 3, -3, 5) and k == "omega":
                tol_hi = RESOLVE_335_TOL
            if not (g[k][0] <= tol_lo and g[k][1] <= tol_hi):
                raise RuntimeError(f"S2 ({l},{m},{n}) s={s}: {k} gap {g[k]} "
                                   f"beyond {(tol_lo, tol_hi)}")
        _solver_launches(rec, device, f"S2 ({l},{m},{n}) s={s}")
        rec["eig_checks"] = eig_sample_checks(clk, device,
                                              f"S2 ({l},{m},{n}) s={s}")
    if device != "cpu":
        import torch
        z = tables[-2]
        c = (z["chi"] / 2.0) * (2.0 * z["omega"][z["keys"].index((2, 2, 0))])
        where = eig_where(-2, 2, torch.as_tensor(
            np.concatenate([c, c + 1e-8]), device=device), 25)
        log(f"S2 eig of the (2,2,0) fine pass's {where['matrices']} "
            f"matrices (n={where['n']}) on {gpu}: {_eig_line(where)}")
        out.append(dict(key="eig_where", **where))
    return out


def _solver_launches(rec, device, label):
    """On the card a solve launches the CF kernel, and the eig kernel once
    for each of its eig calls."""
    if device == "cpu":
        return
    if not rec["cf_launches"] or rec["eig_launches"] != rec["eig_calls"] \
            or not rec["eig_launches"]:
        raise RuntimeError(f"{label}: {rec['cf_launches']} CF launches, "
                           f"{rec['eig_launches']} eig launches for "
                           f"{rec['eig_calls']} eig calls")


def spectrum_tables(problem):
    """A fresh s = -2 SpectrumTables for phase 12: the tracked tables, or,
    where the problem gives ``spectrum_chi``, their splines evaluated on
    those spins (knots at PIN_CHI, CHIF and 0.7, where S3 and F1 read)."""
    from qnmfits_tpu_torch.spectrum.tables import (SpectrumTables,
                                                   eval_spline_np)
    chi = problem["spectrum_chi"]
    if chi is None:
        return SpectrumTables()
    full = SpectrumTables()
    M, K = len(full.keys), full.n_mu
    omega = eval_spline_np(full.chi, full.omega_coeffs(np.arange(M)), chi)
    mu = eval_spline_np(full.chi, full.mu_coeffs(
        np.repeat(np.arange(M), K), np.tile(np.arange(K), M)), chi)
    return SpectrumTables.from_arrays(
        chi, full.keys, omega, mu.reshape(M, K, -1).transpose(0, 2, 1),
        full.s, K)


def on_demand_modes(problem, device):
    """S3: a fresh SpectrumTables solves (11,2,0) and (5,5,8) on demand
    through compile_modes: (11,2,0) held to the JAX package's pin and
    eikonal checks (tests/test_spectrum.py:462-481), (5,5,8) to its
    ordering checks (:174-190)."""
    from qnmfits_tpu_torch.spectrum.tables import solve_on
    t = spectrum_tables(problem)
    with solve_on(device):
        ms, rec, clk = _clocked(lambda: t.compile_modes([PIN_MODE + (1,)]))
    w11 = complex(t.omega_np(ms, PIN_CHI)[0])
    w10, w9 = (complex(t.omega_np(t.compile_modes([(l, 2, 0, 1)]),
                                  PIN_CHI)[0]) for l in (10, 9))
    step1, step2 = w10.real - w9.real, w11.real - w10.real
    pin_gap = abs(w11 - PIN_OMEGA)
    log(f"S3 (11,2,0) on demand ({device}): omega({PIN_CHI}) = {w11:.10f}, "
        f"{pin_gap:.2e} from the JAX package's pin (bound {PIN_TOL:.0e}); "
        f"{rec['wall_s']:.2f} s, {rec['cf_launches']} CF launches (and "
        f"{rec['cf_dd_launches']} double-double), CF {rec['cf_s']:.2f} s by "
        f"events, eig {rec['eig_s']:.3f} s by events in {rec['eig_calls']} "
        f"calls ({rec['eig_launches']} kernel launches), rest "
        f"{rec['rest_s']:.2f} s")
    if not (pin_gap <= PIN_TOL and abs(step2 - step1) < 0.05 * step1
            and abs(w11.imag - w10.imag) < 0.01):
        raise RuntimeError("S3: (11,2,0) misses the pin or the eikonal trend")
    rec["eig_checks"] = eig_sample_checks(clk, device, "S3 (11,2,0)")
    with solve_on(device):
        ms8, rec8, clk8 = _clocked(lambda: t.compile_modes([(5, 5, 8, 1)]))
    w8 = complex(t.omega_np(ms8, 0.7)[0])
    w7, w6 = (complex(t.omega_np(t.compile_modes([(5, 5, n, 1)]), 0.7)[0])
              for n in (7, 6))
    nz = t.compile_mu_indices([(6, 5, 5, 5, 8, 1)])[4]
    # The ordering alone passes a track that skipped an overtone; the
    # step from n = 7 is held near the step before it.
    ratio = abs(w8 - w7) / abs(w7 - w6)
    log(f"S3 (5,5,8) on demand ({device}): omega(0.7) = {w8:.10f} below "
        f"(5,5,7) {w7:.10f}, a step {ratio:.3f} x the (5,5,6) -> (5,5,7) "
        f"one (bound 0.5-2); {rec8['wall_s']:.2f} s, {rec8['cf_launches']} "
        f"CF launches (and {rec8['cf_dd_launches']} double-double), eig "
        f"{rec8['eig_s']:.3f} s by events in {rec8['eig_launches']} kernel "
        f"launches")
    if not (w8.imag < w7.imag < 0 and w8.real > 0 and nz[0]
            and 0.5 < ratio < 2.0):
        raise RuntimeError("S3: (5,5,8) fails the ordering checks")
    _solver_launches(rec, device, "S3 (11,2,0)")
    _solver_launches(rec8, device, "S3 (5,5,8)")
    rec8["eig_checks"] = eig_sample_checks(clk8, device, "S3 (5,5,8)")
    return [dict(rec, key="s3_11_2_0", omega=[w11.real, w11.imag],
                 pin_gap=pin_gap),
            dict(rec8, key="s3_5_5_8", omega=[w8.real, w8.imag])]


def multiplet_check(problem, device):
    """S4: multiplet_tracks(m=2) on the s = -2 table's spins up to
    multiplet_chi_max against its (2,2,8..20) rows from
    MULTIPLET_CHI_MIN on."""
    from qnmfits_tpu_torch.spectrum.multiplets import multiplet_tracks
    chi_max = problem["multiplet_chi_max"]
    if chi_max is None:
        log("S4 multiplet_tracks: not run at this size")
        return None
    z = _table_rows(-2)
    sel = z["chi"] <= chi_max
    chi = z["chi"][sel]
    tracks, rec, clk = _clocked(
        lambda: multiplet_tracks(2, chi, s=-2, verbose=False, device=device))
    rec["cf_kernel_s"] = (None if device == "cpu" else cf_replay_s(
        clk.launch_shapes[False], device)[0])
    baked = sorted(int(n) for l, m, n in z["keys"]
                   if l == 2 and m == 2 and n >= 8)
    held = chi >= MULTIPLET_CHI_MIN
    gaps = {}
    for n, (w, A, C) in sorted(tracks.items()):
        row = z["keys"].index((2, 2, n))
        gaps[n] = float(np.max(np.abs(w - z["omega"][row][sel])[held]))
    worst = max(gaps.values(), default=np.inf)
    shown = {n: float(f"{g:.1e}") for n, g in gaps.items()}
    log(f"S4 multiplet_tracks(m=2) on the table's {len(chi)} spins to "
        f"chi = {chi[-1]:.4f} ({device}; a subgrid of the 400 for the phase's "
        f"time): labels {sorted(tracks)} (table {baked}); omega gap over chi "
        f">= {MULTIPLET_CHI_MIN} by n {shown} (bound "
        f"{MULTIPLET_TOL:.0e}); {rec['wall_s']:.1f} s, {rec['cf_launches']} "
        f"CF launches, CF {rec['cf_s']:.2f} s by events (kernel "
        f"{_opt_s(rec['cf_kernel_s'])} replayed), eig {rec['eig_s']:.3f} s "
        f"by events in {rec['eig_launches']} kernel launches, rest "
        f"{rec['rest_s']:.1f} s")
    if sorted(tracks) != baked or not worst <= MULTIPLET_TOL:
        raise RuntimeError("S4: the multiplet tracks miss the table's rows")
    _solver_launches(rec, device, "S4")
    rec["eig_checks"] = eig_sample_checks(clk, device, "S4")
    return dict(rec, key="s4_multiplets", points=len(chi),
                chi_max=float(chi[-1]), gaps=gaps)


def _opt_s(x):
    return "not measured" if x is None else f"{x:.4f} s"


def on_demand_fit(problem, device):
    """F1, the main path of phase 12: the bench's (2,2,n<4) set with the
    on-demand (5,2,8) through ``mismatch_t0_mode_sets`` at the problem's
    width with dedup on: the mode solved on the card inside the call (the
    CF kernel), then one team launch of the solve; held to the plain-solve
    route and the NumPy oracle.  The solve's points that kept the coarse
    track are counted (NewtonWatch): none may; and where the tables hold
    the full spin grid, its omega beyond chi = 0.985 is held to the JAX
    package's 80-bit pins (PIN_528).  Returns (record, the solve's
    SolverClock: the largest CF call's and double-double launch's
    inputs)."""
    from qnmfits_tpu_torch import batched, engine, mismatch_t0_mode_sets
    from qnmfits_tpu_torch.ops import chol_cuda
    from qnmfits_tpu_torch.spectrum import solver
    if (5, 2, 8) in engine.default_tables().row:
        raise RuntimeError("F1: (5,2,8) is already in the tables")
    sets = [F1_SET]
    args = (problem["times"], problem["data"], sets, MF, CHIF,
            problem["t0s"])
    kw = dict(T_array=problem["T"], spherical_modes=SPH, dedup=True,
              device=device)
    chol_cuda.launches = chol_cuda.wide_launches = 0
    with NewtonWatch(solver) as watch:
        mm, rec, clk = _clocked(lambda: mismatch_t0_mode_sets(*args, **kw),
                                watch)
    launches, wide = chol_cuda.launches, chol_cuda.wide_launches
    rec["cf_kernel_s"] = rec["cf_dd_kernel_s"] = None
    if device != "cpu":
        rec["cf_kernel_s"] = cf_replay_s(clk.launch_shapes[False], device)[0]
        rec["cf_dd_kernel_s"], rec["cf_dd_kernel_ms_by_shape"] = cf_replay_s(
            clk.launch_shapes[True], device, extended=True)
    tables = engine.default_tables()
    chi = tables.chi
    w528 = tables.omega[tables.row[(5, 2, 8)]]
    coarse = watch.on_coarse_track(len(chi))
    pins = [(c, abs(w528[i] - PIN_528[float(c)][0]))
            for i, c in enumerate(chi) if c > RESOLVE_SPLIT]
    pin_gap = max((g for _, g in pins), default=None)
    if pins and len(pins) != len(PIN_528):
        raise RuntimeError(f"F1: the tables' spins beyond {RESOLVE_SPLIT} "
                           f"are not PIN_528's")
    t = time.perf_counter()
    mismatch_t0_mode_sets(*args, **kw)
    warm = time.perf_counter() - t
    plain = PlainSolve()
    mm_plain = batched.batch_mismatch_t0_modesets(*args, solve=plain, **kw)
    pre = problem["t0s"] < 0
    route = _diff(mm, mm_plain, pre)
    oracle = oracle_diff(problem, mm, sets)
    log(f"F1 (2,2,n<4) + on-demand (5,2,8), {len(problem['t0s'])} start "
        f"times ({device}): mm {mm.shape}, solve launches {launches} "
        f"(derived 1; wide {wide}), CF launches {rec['cf_launches']} in the "
        f"mode's solve; vs plain solve t0 >= 0: {route[0]:.3e} (bound "
        f"{MAIN_TOL:.0e}), t0 < 0: {route[1]:.3e} (bound {PRE_TOL:.0e}); "
        f"oracle t0 >= 0: {oracle[0]:.3e} (bound {ORACLE_TOL:.0e}), t0 < 0: "
        f"{oracle[1]:.3e} (reported); wall {rec['wall_s']:.2f} s with the "
        f"solve (CF {rec['cf_s']:.2f} s by events, kernel "
        f"{_opt_s(rec['cf_kernel_s'])} replayed; eig {rec['eig_s']:.3f} s "
        f"by events in {rec['eig_launches']} kernel launches; rest "
        f"{rec['rest_s']:.2f} s), {warm:.3f} s warm")
    stages = {k: (v["calls"], v["matrices"], round(v["s"], 4))
              for k, v in rec["eig_by_stage"].items()}
    log(f"F1's eig calls by stage of the solve (calls, matrices, s by "
        f"events): {stages}")
    tiers = [(t["tier"], [c["N"] for c in t["calls"]]) for t in watch.tiers()]
    log(f"F1 (5,2,8): {coarse} of {len(chi)} points on the coarse track "
        f"(bound 0); tiers and their calls' depths {tiers}; omega beyond "
        f"chi = {RESOLVE_SPLIT} "
        + (f"{pin_gap:.2e} from the JAX package's 80-bit pins (bound "
           f"{PIN_528_TOL:.0e})" if pins else "not held (no such spins at "
           "this size)")
        + f"; double-double CF {rec['cf_dd_launches']} launches of "
        f"{rec['cf_dd_launches'] + rec['cf_launches']}, "
        f"{_opt_s(rec['cf_dd_s'])} by events, kernel "
        f"{_opt_s(rec['cf_dd_kernel_s'])} replayed")
    if mm.shape != (1, len(problem["t0s"])) or not np.all(np.isfinite(mm)):
        raise RuntimeError("F1: bad mismatches")
    if device != "cpu" and (launches != 1 or wide or not rec["cf_launches"]):
        raise RuntimeError(f"F1 launched the solve {launches} times (wide "
                           f"{wide}) and the CF {rec['cf_launches']} times")
    _solver_launches(rec, device, "F1")
    if not (route[0] <= MAIN_TOL and route[1] <= PRE_TOL
            and oracle[0] <= ORACLE_TOL):
        raise RuntimeError("F1 disagrees with its plain route or the oracle")
    if coarse or (pins and not pin_gap <= PIN_528_TOL):
        raise RuntimeError(f"F1's (5,2,8): {coarse} points on the coarse "
                           f"track; {pin_gap} from the 80-bit pins")
    if device != "cpu" and pins and not rec["cf_dd_launches"]:
        raise RuntimeError("F1 solved its extremal spins without the "
                           "double-double kernel")
    path = dict(key="f1", name="F1 (2,2,n<4) + on-demand (5,2,8)",
                launches=launches, wide_launches=wide,
                expected_launches=1, cf_launches=rec["cf_launches"],
                cf_dd_launches=rec["cf_dd_launches"],
                eig_launches=rec["eig_launches"],
                wall_s=rec["wall_s"], warm_wall_s=warm, route_in=route[0],
                route_pre=route[1], oracle_in=oracle[0],
                oracle_pre=oracle[1], coarse_track_points=coarse,
                pin_gap=pin_gap, tiers=watch.tiers(),
                coarse_calls=watch.coarse_calls,
                coarse_failed_chi=watch.coarse_failed_chi, solve=rec)
    rec["eig_checks"] = eig_sample_checks(clk, device, "F1")
    return path, clk


def run_spectrum(problem, device, gpu=None):
    """Phase 12: S1-S4 and F1, with the track cache in a temporary
    directory (and, where the problem cuts the tables' spins, the entry
    points' tables swapped for the cut ones for the phase).  Returns (path
    records, the CF kernels' JSON records (FP64, double-double), the
    phase's wall)."""
    import shutil
    import tempfile
    from qnmfits_tpu_torch import engine
    from qnmfits_tpu_torch.spectrum import tables
    t = time.perf_counter()
    cache = tempfile.mkdtemp(prefix="qnm_track_cache_")
    saved = tables.TRACK_CACHE, engine.default_tables
    tables.TRACK_CACHE = cache
    if problem["spectrum_chi"] is not None:
        cut = spectrum_tables(problem)
        engine.default_tables = lambda: cut
        engine._cached_evaluator.cache_clear()
    try:
        # The solves first, S1's profiles of the kernel after them.
        f1, f1_clock = on_demand_fit(problem, device)
        s2 = resolve_rows(problem, device, gpu)
        s3 = on_demand_modes(problem, device)
        s4 = multiplet_check(problem, device)
        s1 = cf_checks(problem, device, gpu)
        s1x, s1x_more = cf_dd_checks(problem, device, gpu)
    finally:
        tables.TRACK_CACHE, engine.default_tables = saved
        engine._cached_evaluator.cache_clear()
        shutil.rmtree(cache, ignore_errors=True)
    # The FP64 kernel on the largest CF call of F1's solve, all its
    # elements (those beyond CHI_EXTENDED too), as PR 14 timed it; and the
    # double-double kernel on its largest launch in that solve.
    main = check_cf(f1_clock.largest, device)
    log(f"CF kernel on F1's largest call (B={main['batch']}, "
        f"N={main['N']}, team {main['team']}, {main['segment']} steps a "
        f"thread) on {gpu or device}: {main['ms']:.4f} ms (call "
        f"{main['call_ms']:.4f} ms), plain {main['plain_ms']:.2f} ms, bound "
        f"{main['bound_ms']:.3e} ms ({main['bound_by']}); "
        f"{main['rel_err']:.3e} of |U| + |T|")
    dd_main = (None if f1_clock.largest_dd is None else
               check_cf(f1_clock.largest_dd, device, extended=True))
    if dd_main is not None:
        log(f"double-double CF kernel on F1's largest launch of it "
            f"(B={dd_main['batch']}, N={dd_main['N']}, team "
            f"{dd_main['team']} x {dd_main['blocks']} blocks) on "
            f"{gpu or device}: {dd_main['ms']:.4f} ms "
            f"(call {dd_main['call_ms']:.4f} ms), plain "
            f"{dd_main['plain_ms']:.2f} ms, bound {dd_main['bound_ms']:.3e} "
            f"ms ({dd_main['bound_by']}); {dd_main['rel_err']:.3e} of "
            f"|U| + |T|")
    dd_ref = dd_main or s1x[-1]
    record = dict(
        name="leaver_cf", route="cuda",
        source="qnmfits_tpu_torch/csrc/leaver_cf.cu",
        replaces="qnmfits_tpu/spectrum/csrc/cf_kernel.cpp:100",
        launches=f1["cf_launches"],
        max_abs_err=max([main["max_abs_err"]]
                        + [r["max_abs_err"] for r in s1]),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        library="none: no PyTorch call evaluates a continued fraction",
        bound_share=main["bound_share"], batch=main["batch"], N=main["N"],
        chain_steps=main["chain_steps"], team=main["team"],
        segment=main["segment"], call_ms=main["call_ms"],
        timed_by=main["timed_by"],
        rel_err_max=max([main["rel_err"]] + [r["rel_err"] for r in s1]),
        checks=s1, f1_solve=f1["solve"], resolve=s2, on_demand=s3,
        multiplets=s4)
    dd_record = dict(
        name="leaver_cf_dd", route="cuda",
        source="qnmfits_tpu_torch/csrc/leaver_cf.cu",
        replaces="qnmfits_tpu/spectrum/csrc/cf_kernel.cpp:100",
        launches=f1["cf_dd_launches"],
        max_abs_err=max(r["max_abs_err"] for r in s1x + [dd_ref]),
        ms=dd_ref["ms"], plain_ms=dd_ref["plain_ms"],
        bound_ms=dd_ref["bound_ms"], bound_by=dd_ref["bound_by"],
        library_ms=None,
        library="none: no PyTorch call evaluates a continued fraction",
        arithmetic="double-double, spins beyond cf_cuda.CHI_EXTENDED",
        bound_share=dd_ref["bound_share"],
        variant_bound_ms=dd_ref["variant_bound_ms"],
        variant_bound_share=dd_ref["variant_bound_share"],
        variant_bound=(f"the operations the kernel does, "
                       f"{CF_DD_KERNEL_OPS_PER_STEP} a step (the bound's "
                       f"{CF_DD_OPS_PER_STEP} is the first design's)"),
        batch=dd_ref["batch"],
        N=dd_ref["N"], team=dd_ref["team"], blocks=dd_ref["blocks"],
        segment=dd_ref["segment"],
        call_ms=dd_ref["call_ms"], timed_by=dd_ref["timed_by"],
        from_f1=dd_main is not None,
        rel_err_max=max(r["rel_err"] for r in s1x + [dd_ref]),
        checks=s1x, **s1x_more)
    eig_record = eig_kernel_record(f1, f1_clock, s2, s3, s4, device, gpu)
    wall = time.perf_counter() - t
    rows = sum(r["key"] != "eig_where" for r in s2)
    log(f"phase 12: S1 {len(s1)} batches, S1-X {len(s1x)}, S2 {rows} rows, "
        f"S3, S4 {'run' if s4 else 'not run'}, F1 in {wall:.1f} s")
    return [f1], [record, dd_record] + ([eig_record] if eig_record
                                        else []), wall


def eig_kernel_record(f1, f1_clock, s2, s3, s4, device, gpu):
    """The eig kernel's JSON record: timed on F1's largest call of each
    mode (``check_eig``), with S2's fine-pass batch (``eig_where``) and
    every solve's sample checks; None on the CPU."""
    if device == "cpu":
        return None
    main = {mode: check_eig(f1_clock.eig_samples[mode], device, timed=True)
            for mode in ("values", "vectors")}
    for mode, r in main.items():
        log(f"eig kernel on F1's largest {mode} call (B={r['batch']}, "
            f"n={r['n']}) on {gpu or device}: {_eig_line(r)}")
    where = next(r for r in s2 if r["key"] == "eig_where")
    checks = [c for r in [f1["solve"], *s2, *s3, s4] if r
              for c in r.get("eig_checks", [])]
    small = eig_small_launches(device, gpu)
    v = main["values"]
    return dict(
        name="angular_eig", route="cuda",
        source="qnmfits_tpu_torch/csrc/angular_eig.cu",
        replaces="qnmfits_tpu/spectrum/solver.py:60",
        launches=f1["eig_launches"],
        max_abs_err=max(r["max_abs_err"] for r in
                        [*main.values(), where, *checks, *small]),
        ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
        bound_by=v["bound_by"], library_ms=v["library_ms"],
        library="torch.linalg.eigvals of the CUDA matrices (cusolver's "
                "geev); library_cpu_ms: of a CPU copy",
        library_cpu_ms=v["library_cpu_ms"], bound_share=v["bound_share"],
        batch=v["batch"], n=v["n"], call_ms=v["call_ms"],
        sweeps_mean=v["sweeps_mean"], ops=v["ops"],
        rel_err=v["rel_err"], timed_by=v["timed_by"],
        vectors=main["vectors"], fine_pass_800=where,
        small_launches=small, checks=checks)


# ---------------------------------------------------------------------------
# Phase 13: the mesh
# ---------------------------------------------------------------------------

MESH_TOL = 1e-12          # sharded vs mesh=None, |mismatch|, t0 >= 0
MESH_D1_STRIDE = 16       # D1 on every 16th start time
MESH_TIMEOUT = 600.0      # seconds for one layout's ranks in all


def _picks(t0s, n):
    """n start times spread over t0s (the optimisers' windows)."""
    return t0s[np.unique(np.linspace(0, len(t0s) - 1, n).round()
                         .astype(int))]


def _block_size(n, n_sweep, mult=1):
    """Items a rank holds of n padded to a multiple of n_sweep * mult."""
    return -(-n // (n_sweep * mult)) * mult


def mesh_factored_launches(t0s, wi_max, chunk, n_sweep, S, J):
    """Solve launches of every rank of a sharded factored sweep, derived
    from the code: the join groups (2 S J^2 complex a start time) of the
    chunks of its block of the sorted start times, padded to a multiple of
    n_sweep * chunk after ``batched._safe_chunk``'s budget."""
    from qnmfits_tpu_torch import batched, engine_real
    ck = batched._safe_chunk(t0s, wi_max, chunk)
    blk = _block_size(len(t0s), n_sweep, ck)
    return len(engine_real.join_groups([ck] * (blk // ck),
                                       2 * S * J * J * 16))


def mesh_item_launches(n_items, chunk, n_sweep, J, n_sets=1):
    """Solve launches of every rank of a sweep sharded item by item (the
    dynamic sweep, the event batch): the join groups of the chunks of its
    block, for each mode set."""
    from qnmfits_tpu_torch import engine_real
    blk = _block_size(n_items, n_sweep)
    sizes = [min(chunk, blk - lo) for _ in range(n_sets)
             for lo in range(0, blk, chunk)]
    return len(engine_real.join_groups(sizes, 2 * J * J * 16))


def _mesh_problem_2d(problem, device):
    """The 2D sweep's and the time-sharded fit's tensors: GRID_SET on both
    rows, K cut to a multiple of 2 (the (2, 2) mesh's time axis)."""
    import torch
    from qnmfits_tpu_torch.engine import SpectrumEvaluator
    from qnmfits_tpu_torch.testing import bench_mode_sets
    K = len(problem["times"]) // 2 * 2
    ev = SpectrumEvaluator(bench_mode_sets()[GRID_SET], SPH)
    f64, c128 = torch.float64, torch.complex128

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(problem["times"][:K], f64),
            t(np.stack([problem["data"][lm][:K] for lm in SPH]), c128),
            t(ev.omega(CHIF, MF), c128), t(ev.mu(CHIF), c128),
            t(problem["t0s"], f64), t(np.full(len(problem["t0s"]),
                                              problem["T"]), f64))


def mesh_specs(problem, device):
    """The paths of phase 13.  Each spec: key, name; ``n4``, the mesh
    shape it runs on in the four-rank layout (None: the one-rank layout
    only); ``call(mesh)``, the public entry point (or, for the 2D sweep
    and the time-sharded fit, the mesh function) with that mesh, or with
    mesh=None, the reference, returning a dict of NumPy arrays; ``gates``,
    (field, bound for t0 >= 0, bound for t0 < 0, the t0 < 0 mask or
    None); ``expect(n_sweep)``, the solve launches each rank must make on
    the card, and ``expect_moments(n_sweep)`` its window moments launches
    (none but on the optimisers' paths)."""
    import torch
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, engine, engine_real
    from qnmfits_tpu_torch.testing import bench_mode_sets
    times, data, t0s, T = (problem[k] for k in ("times", "data", "t0s", "T"))
    sets, K = problem["mode_sets"], len(times)
    deep, row = bench_mode_sets()[DEEPEST], data[(2, 2)]
    pre = t0s < 0
    specs = []

    def add(key, name, n4, call, gates, expect, expect_moments=None):
        specs.append(dict(key=key, name=name, n4=n4, call=call, gates=gates,
                          expect=expect,
                          expect_moments=expect_moments or (lambda n: 0)))

    # The main path, with and without dedup.
    omegas, _ = batched._modesets_spectrum_fn(
        tuple(tuple(batched._canon(ms)) for ms in sets), tuple(SPH))[0](
            CHIF, MF)
    wi_max, S, J = float(np.max(np.abs(omegas.imag))), *omegas.shape
    distinct = _distinct(problem, t0s)
    for dedup in (True, False):
        add("m" if dedup else "m0",
            f"main path mismatch_t0_mode_sets(mesh=), dedup={dedup}",
            (4, 1) if dedup else None,
            lambda mesh, dedup=dedup: dict(mm=tq.mismatch_t0_mode_sets(
                times, data, sets, MF, CHIF, t0s, T_array=T,
                spherical_modes=SPH, dedup=dedup, mesh=mesh, device=device)),
            [("mm", MESH_TOL, PRE_TOL, pre)],
            lambda n, ts=distinct if dedup else t0s: mesh_factored_launches(
                ts, wi_max, 256, n, S, J))
    deep_wi = float(np.max(np.abs(engine.cached_evaluator(
        batched._canon(deep)).omega(CHIF, MF).imag)))
    add("a", "mismatch_t0_array(engine='sharded'), deepest set, (2,2) row",
        None,
        lambda mesh: dict(mm=tq.mismatch_t0_array(
            times, row, deep, MF, CHIF, t0s, T_array=T,
            engine="sharded" if mesh is not None else "fast", mesh=mesh,
            device=device)),
        [("mm", MESH_TOL, PRE_TOL, pre)],
        lambda n: mesh_factored_launches(distinct, deep_wi, 64, n, 1,
                                         len(deep)))

    res = problem["res"]
    gset = bench_mode_sets()[GRID_SET]
    add("g1", f"mismatch_M_chi_grid(engine='sharded'), res {res}", (4, 1),
        lambda mesh: dict(mm=tq.mismatch_M_chi_grid(
            times, data, gset, *M_CHI_BOX, GRID_T0, T=T, res=res,
            spherical_modes=SPH,
            engine="fast" if mesh is None else "sharded",
            mesh=mesh, device=device)),
        [("mm", MESH_TOL, None, None)],
        lambda n: stacked_launches(_block_size(res * res, n), len(gset),
                                   window_samples(problem, GRID_T0)))
    add("g3", f"mismatch_omega_grid(engine='sharded'), res {res}", (4, 1),
        lambda mesh: dict(mm=tq.mismatch_omega_grid(
            times, row, gset[1:], MF, CHIF, *OMEGA_BOX, GRID_T0, T=T,
            res=res, engine="fast" if mesh is None else "sharded", mesh=mesh,
            device=device)),
        [("mm", MESH_TOL, None, None)], lambda n: 0)

    cat = problem["catalog"]
    ev = (cat["times"], cat["rows"], EVENT_MODES, cat["Mfs"], cat["chifs"],
          cat["t0s"])
    E, J_e = len(cat["t0s"]), len(EVENT_MODES)
    add("e", f"fit_events(mesh=), {E} events", (4, 1),
        lambda mesh: dict(mm=tq.fit_events(*ev, T=cat["T"], mesh=mesh,
                                           device=device)[0]),
        [("mm", MESH_TOL, None, None)],
        lambda n: mesh_item_launches(
            E, max(1, batched._BASIS_BYTES // (J_e * len(cat["times"]) * 16)),
            n, J_e))

    t0_d = t0s[::MESH_D1_STRIDE]
    add("d1", f"D1 mismatch_t0_mode_sets(dynamic=True, mesh=), every "
        f"{MESH_D1_STRIDE}th start time", None,
        lambda mesh: dict(mm=tq.mismatch_t0_mode_sets(
            times, data, sets, problem["Mf_t"], problem["chif_t"], t0_d,
            T_array=T, spherical_modes=SPH, dynamic=True, mesh=mesh,
            device=device)),
        [("mm", MESH_TOL, PRE_TOL, t0_d < 0)],
        lambda n: mesh_item_launches(
            len(t0_d), max(1, batched._BASIS_BYTES // (len(SPH) * K * J * 16)),
            n, J, S))

    n_o1, n_o2 = problem["mesh_opt"]
    t0_o1, t0_o2 = _picks(t0s, n_o1), _picks(t0s, n_o2)
    ff_kw = dict(modes=OPT_FIXED, Mf=MF, chif=CHIF, T_array=T,
                 maxiter=problem["opt_maxiter"], return_mismatch=True,
                 device=device)
    opt_gates = [("mm", OPT_MM_TOL, OPT_MM_TOL, None),
                 ("x", OPT_PARAM_TOL, OPT_PARAM_TOL, None)]

    def o1(mesh):
        w, mm, ok = tq.free_frequency_fit_array(times, row, t0_o1, mesh=mesh,
                                                **ff_kw)
        return dict(mm=mm, x=w, ok=ok)

    def o2(mesh):
        _, Mf, chif, mm, ok = tq.calculate_epsilon_array(
            times, data, deep, MF, CHIF, t0_o2, spherical_modes=SPH,
            T_array=T, maxiter=problem["opt_maxiter"], return_mismatch=True,
            mesh=mesh, device=device)
        return dict(mm=mm, x=np.stack([Mf, chif], 1), ok=ok)

    def opt_expect(kind, ts, J_o, which):
        def expect(n):
            # The same on every rank: each holds a block of one size.
            blk = _block_size(len(ts), n)
            sub = dict(problem, t0s=ts[:blk])
            return opt_launches(sub, kind, K, J_o)[which]
        return expect

    for key, kind, ts, J_o, call in (
            ("o1", "ff", t0_o1, len(OPT_FIXED) + 1, o1),
            ("o2", "eps", t0_o2, len(deep), o2)):
        entry = ("free_frequency_fit_array" if kind == "ff"
                 else "calculate_epsilon_array")
        add(key, f"{key.upper()} {entry}(mesh=), {len(ts)} windows", None,
            call, opt_gates, opt_expect(kind, ts, J_o, 0),
            opt_expect(kind, ts, J_o, 1))

    # Both axes live, on the (2, 2) mesh of the four-rank layout.
    def two_d(analytic):
        def call(mesh):
            from qnmfits_tpu_torch.parallel.mesh import (
                sharded_t0_sweep_factored_2d)
            args = _mesh_problem_2d(problem, device)
            if mesh is None:
                return dict(mm=engine_real.sweep_t0_factored_real(
                    *args, analytic=analytic)[1].cpu().numpy())
            return dict(mm=sharded_t0_sweep_factored_2d(
                *args, mesh, analytic=analytic)[1].cpu().numpy())
        return call

    wi_g = float(np.max(np.abs(engine.cached_evaluator(
        batched._canon(gset), tuple(SPH)).omega(CHIF, MF).imag)))
    for analytic in (True, False):
        add(f"f2{'a' if analytic else 's'}",
            f"sharded_t0_sweep_factored_2d, {'analytic' if analytic else 'summation'}"
            f" Grams, K cut to {K // 2 * 2}", (2, 2), two_d(analytic),
            [("mm", MESH_TOL, PRE_TOL, pre)],
            lambda n: mesh_factored_launches(t0s, wi_g, 64, n, 1,
                                             len(gset)))

    def fit_core(mesh):
        from qnmfits_tpu_torch.parallel.mesh import sharded_fit_core
        tt, dd, om, mu = _mesh_problem_2d(problem, device)[:4]
        w = ((tt >= GRID_T0) & (tt < GRID_T0 + T)).to(tt.dtype)
        if mesh is None:
            mm = engine.fit_core(tt, dd, om, mu,
                                 torch.tensor(GRID_T0, dtype=tt.dtype,
                                              device=tt.device), w)[1]
        else:
            mm = sharded_fit_core(tt, dd, om, mu, GRID_T0, w, mesh)[1]
        return dict(mm=mm.reshape(1).cpu().numpy())

    add("fc", f"sharded_fit_core at t0 = {GRID_T0:g}", (2, 2), fit_core,
        [("mm", MESH_TOL, None, None)], lambda n: 1)
    return specs


def mesh_rank(layout, device, build_kw):
    """One rank of a phase 13 layout: the problem rebuilt from its
    arguments, the layout's meshes, a warm-up call, and every path of the
    layout with the launch counts set to 0 just before it and read just
    after.  Returns
    dict(rank, backend, out={key: dict(res, launches, wall)}, jax: the
    JAX modules the rank loaded, which must be none)."""
    import torch
    import torch.distributed as dist
    from qnmfits_tpu_torch.ops import chol_cuda
    from qnmfits_tpu_torch.parallel.mesh import sweep_mesh
    problem = build_problem(**build_kw)
    specs = [s for s in mesh_specs(problem, device)
             if layout == "N1" or s["n4"] is not None]
    meshes = {}
    for shape in ([(1, 1)] if layout == "N1"
                  else sorted({s["n4"] for s in specs})):
        meshes[shape] = sweep_mesh(*shape, device_type=device)
    # A fresh process's first call reads the tables, makes the CUDA
    # context and the NCCL communicator and loads the kernel library: one
    # untimed call of the first path keeps that out of the walls.
    specs[0]["call"](meshes[(1, 1) if layout == "N1" else specs[0]["n4"]])
    out = {}
    for s in specs:
        mesh = meshes[(1, 1) if layout == "N1" else s["n4"]]
        res, n, _, wall, (_, _, n_mom) = drive(lambda: s["call"](mesh))
        out[s["key"]] = dict(res=res, launches=n, moments_launches=n_mom,
                             wall=wall)
    jax = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "qnmfits_tpu"))
    return dict(rank=dist.get_rank(), backend=dist.get_backend(), out=out,
                jax=jax)


def run_mesh(problem, device, gpu=None):
    """Phase 13: the sharded entry points on two layouts of ranks spawned
    on this machine (``testing.run_world``, each rank one CPU thread,
    every collective bounded by ``parallel.mesh.TIMEOUT``): N1, one rank
    over NCCL on the card (gloo on the CPU), every path on a (1, 1) mesh;
    N4, four gloo ranks sharing the device (NCCL refuses two ranks on one
    GPU), the main path, the event batch and the grids on a (4, 1) mesh
    and the 2D sweep and the time-sharded fit on (2, 2).  Each rank's
    results are held to the same call with mesh=None in this process, and
    each rank's solve launches to the count derived from its block.
    Returns the phase's JSON record."""
    from qnmfits_tpu_torch.testing import run_world
    t = time.perf_counter()
    specs = mesh_specs(problem, device)
    refs = {}
    for s in specs:
        refs[s["key"]] = drive(lambda: s["call"](None))
    layouts = {}
    for layout, world in (("N1", 1), ("N4", 4)):
        backend = "nccl" if device == "cuda" and world == 1 else "gloo"
        t_l = time.perf_counter()
        ranks = run_world(mesh_rank, world, (layout, device,
                                             problem["build_kw"]),
                          backend=backend, timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t_l
        if any(rk["jax"] for rk in ranks):
            raise RuntimeError(f"{layout}: ranks imported JAX modules: "
                               f"{[rk['jax'] for rk in ranks]}")
        paths = {}
        for s in specs:
            if layout == "N4" and s["n4"] is None:
                continue
            n_sweep = 1 if layout == "N1" else s["n4"][0]
            expect = s["expect"](n_sweep) if device != "cpu" else 0
            expect_m = (s["expect_moments"](n_sweep) if device != "cpu"
                        else 0)
            ref, _, _, ref_wall, _ = refs[s["key"]]
            got = [rk["out"][s["key"]] for rk in ranks]
            gaps = {}
            for field, tol_in, tol_pre, mask in s["gates"]:
                d = np.stack([np.abs(np.asarray(g["res"][field])
                                     - np.asarray(ref[field])) for g in got])
                m = (np.zeros(d.shape[-1], bool) if mask is None else mask)
                gaps[field] = float(np.max(d[..., ~m], initial=0.0))
                gaps[f"{field}_pre"] = float(np.max(d[..., m], initial=0.0))
                if not (np.all(np.isfinite(d)) and gaps[field] <= tol_in
                        and (not m.any() or gaps[f"{field}_pre"] <= tol_pre)):
                    raise RuntimeError(
                        f"{layout} {s['name']}: {field} {gaps[field]:.3e} "
                        f"(t0 >= 0; bound {tol_in:.0e}) and "
                        f"{gaps[f'{field}_pre']:.3e} (t0 < 0; bound "
                        f"{tol_pre}) from mesh=None")
            launches = [g["launches"] for g in got]
            moments = [g["moments_launches"] for g in got]
            if launches != [expect] * world or moments != [expect_m] * world:
                raise RuntimeError(f"{layout} {s['name']}: launches by rank "
                                   f"{launches} and moments launches "
                                   f"{moments}, derived {expect} and "
                                   f"{expect_m} each")
            paths[s["key"]] = dict(
                name=s["name"], mesh=[n_sweep, world // n_sweep],
                wall_s=[g["wall"] for g in got], ref_wall_s=ref_wall,
                launches=launches, expected_launches=expect,
                moments_launches=moments, expected_moments_launches=expect_m,
                gaps=gaps)
            log(f"phase 13 {layout} {s['name']} on a "
                f"{tuple(paths[s['key']]['mesh'])} mesh: launches by rank "
                f"{launches} (derived {expect}), moments {moments} "
                f"(derived {expect_m}), gaps from mesh=None "
                + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
                + f"; {max(g['wall'] for g in got):.2f} s (mesh=None "
                f"{ref_wall:.2f} s)")
        layouts[layout] = dict(world=world, backend=ranks[0]["backend"],
                               wall_s=wall, paths=paths)
        log(f"phase 13 {layout}: {world} rank(s) over "
            f"{ranks[0]['backend']}, {len(paths)} paths in {wall:.1f} s "
            "(spawn included)")
    wall = time.perf_counter() - t
    log(f"phase 13: the mesh in {wall:.1f} s on {gpu or device}")
    return dict(layouts=layouts, wall_s=wall, device=gpu or device)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from concurrent.futures import ThreadPoolExecutor
    from qnmfits_tpu_torch.ops import (cf_cuda, chol_cuda, eig_cuda,
                                       moments_cuda, sweep_cuda)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    gpu = f"{kind} ({smi.split(',')[-1].strip()} limit)"
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # One nvcc for each source, started together.
    t = time.perf_counter()
    with ThreadPoolExecutor(7) as pool:
        libs = list(pool.map(lambda build: build(),
                             (chol_cuda.build, cf_cuda.build, sweep_cuda.build,
                              eig_cuda.build, moments_cuda.build,
                              lambda: moments_cuda.build(phases=True),
                              lambda: cf_cuda.build(phases=True))))
    log(f"built {', '.join(os.path.relpath(lib, ROOT) for lib in libs)} in "
        f"{time.perf_counter() - t:.2f} s (sm_90a, in parallel)")
    build = check_build()

    device = "cuda"
    max_abs = check_kernel_sizes(device)
    check_jitter(device)
    random_wide = time_wide(gpu)
    t = time.perf_counter()
    problem = build_problem(**FULL)
    log(f"bench problem built in {time.perf_counter() - t:.2f} s: "
        f"K={len(problem['times'])}, S={len(problem['mode_sets'])}, "
        f"B={len(problem['t0s'])}")
    main_path = run_main_path(problem, device)
    record = measure(problem, main_path, max_abs, build, device, gpu)
    factored = measure_factored(problem, main_path, device, gpu)
    factored[0]["wide_rows_rel"] = check_factored_rows(device)
    main_path.pop("sweep_calls")
    paths = run_paths(problem, device)
    by_key = {p["key"]: p for p in paths}
    if by_key["remnant_nodedup"]["launches"] < 2:
        raise RuntimeError("the remnant sweep without dedup made one join "
                           "group: it does not exercise the budget")
    check_closest_keys(problem, device)
    wide = measure_paths(paths, max_abs, build, random_wide)
    dynamic, solves, phase7_wall = run_dynamic(
        problem, device, gpu, main_path["systems"][False])
    keys = ("batch", "n", "launches", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_share", "library_ms", "backward_err",
            "side_by_side")
    for rec in (record, wide):
        rec["dynamic_paths"] = {
            k: {x: r[x] for x in keys if x in r} for k, r in solves.items()
            if (r["n"] > chol_cuda.TEAM_MAX_N) == (rec is wide)}
    optimisers, opt_solves, phase8_wall, moments = run_optimisers(
        problem, device, gpu)
    record["optimiser_paths"] = {
        p["key"]: dict(launches=p["launches"],
                       expected_launches=p["expected_launches"])
        for p in optimisers}
    record["optimiser_solves"] = {
        b: {x: r[x] for x in keys if x in r} for b, r in opt_solves.items()}
    diagnostics, diag_solves, phase9_wall = run_diagnostics(problem, device,
                                                            gpu)
    record["diagnostic_paths"] = {
        k: {x: r[x] for x in keys if x in r} for k, r in diag_solves.items()}
    mapping, map_solves, phase10_wall = run_mapping(problem, device, gpu)
    for rec in (record, wide):
        rec["mapping_paths"] = {
            k: {x: r[x] for x in keys if x in r}
            for k, r in map_solves.items()
            if (r["n"] > chol_cuda.TEAM_MAX_N) == (rec is wide)}
    waveforms, wave_info, phase11_wall = run_waveforms(problem, device, gpu)
    for rec in (record, wide):
        rec["waveform_paths"] = {p["key"]: _summary(p) for p in waveforms
                                 if (p["wide_launches"] > 0) == (rec is wide)}
    record["waveforms"] = wave_info
    spectrum, cf_records, phase12_wall = run_spectrum(problem, device, gpu)
    mesh = run_mesh(problem, device, gpu)
    record["mesh_paths"] = {
        f"{layout}/{key}": dict(launches=p["launches"],
                                expected_launches=p["expected_launches"])
        for layout, rec in mesh["layouts"].items()
        for key, p in rec["paths"].items()}
    # Profiler health over the whole run, phases 7 to 12 included.
    wide.update(event_timings=len(EVENT_TIMINGS),
                profiles_dropping=len(DROPPED),
                records_dropped_max=max(DROPPED, default=0))
    print(json.dumps({"paths": paths + dynamic + optimisers + diagnostics
                      + mapping + waveforms + spectrum,
                      "phase7_wall_s": phase7_wall,
                      "phase8_wall_s": phase8_wall,
                      "phase9_wall_s": phase9_wall,
                      "phase10_wall_s": phase10_wall,
                      "phase11_wall_s": phase11_wall,
                      "phase12_wall_s": phase12_wall}), flush=True)
    print(json.dumps({"mesh": mesh}), flush=True)
    print(json.dumps({"kernels": [record, wide, *factored, *cf_records,
                                  moments]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
