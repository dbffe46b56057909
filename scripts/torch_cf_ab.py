#!/usr/bin/env python3
"""The Leaver CF kernel of one version of the port on one GPU: its device
time at phase 12's shapes, and F1's on-demand solve with the convergence
of its Newton points, tier by tier.  For comparing two versions in turns.

    python3 scripts/torch_cf_ab.py --label NAME [--root DIR] [--out FILE]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV | tar -x -C DIR``; this checkout by
default) and drives it with this checkout's ``chip_smoke.py``:

* the CF kernel's device time (torch.profiler's records of its launches,
  ``chip_smoke.kernel_ms``) through that version's ``leaver_cf`` at each
  (B, N) of phase 12's S1, on S1's random inputs in S1's order
  (``cf_inputs``, ``CF_SEED``), then on the inputs of F1's largest launch;
  and a digest of the FP64 kernel's outputs on S1's inputs at ``plan``'s
  teams (two versions with the same FP64 arithmetic print the same);
* the double-double kernel's device time the same way at each (B, N) of
  S1-X (``cf_dd_shapes``, spins ``CF_DD_CHI``), with the plan the version
  launched, and, where the version has it, a launch's cycles by phase
  (``cf_cuda.phase_cycles``) at each;
* F1 (``chip_smoke.on_demand_fit``: the bench's (2,2,n<4) set with the
  on-demand (5,2,8) through ``mismatch_t0_mode_sets``) in a fresh track
  cache: the solve's wall, its CF seconds by CUDA events around each
  wrapper call and replayed per launch shape (``cf_replay_s``), its eig
  seconds, and for each lockstep Newton call of the fine pass
  (``solver._newton_coupled_vec_a``: a depth tier, then its retries at 3x,
  9x and 27x the depth) its depth, points, iterations and how many points
  ended converged (a step under tol |omega|), softly converged (after the
  60 iterations, a last step under 1e-9 |omega|) or unconverged, with the
  spins of the last.  A point still unconverged after its tier's last
  retry keeps the interpolated coarse track (``solver.track_mode``).  The
  coarse pass's failed points (``_newton_coupled``), which it substeps,
  are listed by spin (``chip_smoke.NewtonWatch``), and the double-double
  CF's launches and seconds by CUDA events, its kernel seconds replayed
  (``cf_replay_s``) and its ms by launch shape (F1's largest and deep
  launches of it);
* the same for one re-solved near-extremal row, ``RESOLVE_ROW`` through
  ``solver.track_mode`` over the s = -2 table's 400 spins (the near-
  extremal tiers' row of phase 12's S2), with its gaps from the table's
  row to chi = 0.985 and beyond, and the wall and CF, eig and
  double-double seconds of a second, warm solve of it.

Prints the card's name and power limit, then one JSON line.  Run each
version in its own process, in turns (A, B, B, A), within one call: the
first solve of a process pays its start-up alike.  Needs CUDA and nvcc.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESOLVE_ROW = (-2, 3, -3, 5)


def resolve_row(chip_smoke, solver):
    """RESOLVE_ROW re-solved over the table's spins on the card, with its
    Newton tiers, CF launches and seconds, and gaps from the table."""
    s, l, m, n = RESOLVE_ROW
    z = chip_smoke._table_rows(s)
    chi = z["chi"]

    def solve():
        seeds = solver.schwarzschild_seeds(l_max=l, n_max=n, s=s,
                                           n_max_low_l=0, device="cuda")
        return solver.track_mode(l, m, n, seeds[(l, n)], chi, s=s,
                                 device="cuda")

    with chip_smoke.NewtonWatch(solver) as watch:
        (w, A, C), rec, clk = chip_smoke._clocked(solve, watch)
    dd_s, dd_ms = chip_smoke.cf_replay_s(clk.launch_shapes[True], "cuda",
                                         extended=True)
    warm = chip_smoke._clocked(solve)[1]
    return dict(
        row=list(RESOLVE_ROW), wall_s=rec["wall_s"],
        warm=dict((k, warm[k]) for k in ("wall_s", "cf_s", "eig_s",
                                         "cf_dd_s")),
        cf_s_events=rec["cf_s"],
        eig_s=rec["eig_s"], cf_launches=rec["cf_launches"],
        cf_dd_launches=rec["cf_dd_launches"], cf_dd_s_events=rec["cf_dd_s"],
        cf_dd_kernel_s_replayed=dd_s, cf_dd_kernel_ms_by_shape=dd_ms,
        tiers=watch.tiers(), coarse_failed_chi=watch.coarse_failed_chi,
        coarse_track_points=watch.on_coarse_track(len(chi)),
        gaps=chip_smoke._row_gaps(w, A, C, z, z["keys"].index((l, m, n)),
                                  slice(None), chi))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_cf_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, root)
    import qnmfits_tpu_torch
    from qnmfits_tpu_torch.ops import cf_cuda, chol_cuda, eig_cuda
    from qnmfits_tpu_torch.spectrum import solver, tables
    if not qnmfits_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {qnmfits_tpu_torch.__file__}, not "
                           f"the package under {root}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # Every kernel the runs below launch, built before any is timed (each
    # tree builds into its own directory).
    chol_cuda.build()
    cf_cuda.build()
    eig_cuda.build()
    problem = chip_smoke.build_problem(**chip_smoke.FULL)

    def kernel_ms(inputs, extended=False):
        w, a, A, s, m, n_inv, N = inputs
        call = lambda: cf_cuda.leaver_cf(w, a, A, s, m, n_inv, N)  # noqa
        plan = "last_dd_plan" if hasattr(cf_cuda, "last_dd_plan") and \
            extended else "last_plan"
        rec = dict(batch=int(w.shape[0]), N=int(N),
                   ms=chip_smoke.kernel_ms(
                       call, kernel=chip_smoke._kernel_name(extended)),
                   call_ms=chip_smoke._timed_ms(call, "cuda", 10),
                   plan=list(getattr(cf_cuda, plan, None) or []))
        if extended and hasattr(cf_cuda, "phase_cycles"):
            rec["phases"] = cf_cuda.phase_cycles(*inputs)["cycles"]
        return rec

    rng = np.random.default_rng(chip_smoke.CF_SEED)
    s1_inputs = [chip_smoke.cf_inputs(rng, B, N, "cuda")
                 for N in problem["cf_depths"] for B in problem["cf_batches"]]
    s1 = [kernel_ms(inputs) for inputs in s1_inputs]
    digest = hashlib.sha256()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for inputs in s1_inputs:
        team = cf_cuda.plan(inputs[0].shape[0], inputs[-1], sms)[0]
        for x in cf_cuda._launch(*inputs, team):
            digest.update(x.cpu().numpy().tobytes())
    rng = np.random.default_rng(chip_smoke.CF_SEED + 1)
    s1x = [kernel_ms(chip_smoke.cf_inputs(rng, B, N, "cuda",
                                          chip_smoke.CF_DD_CHI), True)
           for B, N in problem["cf_dd_shapes"]]

    tables.TRACK_CACHE = tempfile.mkdtemp(prefix="qnm_track_cache_")
    path, clock = chip_smoke.on_demand_fit(problem, "cuda")
    rec = path["solve"]
    row = resolve_row(chip_smoke, solver)
    line = json.dumps(dict(
        label=args.label, root=root, card=smi, s1_kernel=s1,
        s1_fp64_digest=digest.hexdigest(),
        s1x_kernel=s1x, f1_largest=kernel_ms(clock.largest),
        f1_largest_dd=(kernel_ms(clock.largest_dd, True)
                       if clock.largest_dd else None),
        cf_dd_kernel_s_replayed=rec["cf_dd_kernel_s"],
        cf_dd_kernel_ms_by_shape=rec.get("cf_dd_kernel_ms_by_shape"),
        cf_dd_launch_shapes=rec["cf_dd_launch_shapes"],
        resolved_row=row, wall_s=rec["wall_s"],
        cf_s_events=rec["cf_s"], cf_kernel_s_replayed=rec["cf_kernel_s"],
        eig_s=rec["eig_s"], rest_s=rec["rest_s"],
        cf_launches=rec["cf_launches"], eig_calls=rec["eig_calls"],
        cf_shapes=rec["cf_shapes"], route_in=path["route_in"],
        oracle_in=path["oracle_in"], coarse_calls=path["coarse_calls"],
        coarse_failed_chi=path["coarse_failed_chi"], tiers=path["tiers"],
        coarse_track_points=path["coarse_track_points"],
        cf_dd_launches=rec["cf_dd_launches"], cf_dd_s_events=rec["cf_dd_s"]))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
