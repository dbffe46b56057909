#!/usr/bin/env python3
"""F1's on-demand solve with one version of the port on one GPU, its wall
split into the angular eig, the CF and the rest.  For comparing the
version before the eig kernel with the version that has it, in turns.

    python3 scripts/torch_eig_ab.py --label NAME [--root DIR] [--out FILE]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV qnmfits_tpu_torch | tar -x -C DIR`` with
this checkout's ``qnmfits_tpu`` linked beside it for the tables; this
checkout by default) and takes the problem from this checkout's
``chip_smoke.py``.  It builds that version's kernels, warms the card with
the bench's main path and a short on-demand track of (2,2,0) (17 spins to
chi = 0.6), then runs F1 (the bench's (2,2,n<4) set with the on-demand
(5,2,8) through ``mismatch_t0_mode_sets``, dedup on) in a fresh track
cache.  The eig is timed by CUDA events around each call of whichever eig
function that version's solver calls (``angular_eigvals`` /
``angular_eigpair``, or ``_batched_angular_eig``), the CF by CUDA events
around each ``leaver_cf`` call; the rest is the wall less both.

Prints the card's name and power limit, then one JSON line.  Run each
version in its own process, in turns (A, B, B, A), within one call.
Needs CUDA and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EIG_FUNCTIONS = ("angular_eigvals", "angular_eigpair", "_batched_angular_eig")


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
        print("torch_eig_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("qnmfits_tpu_torch")]:
        del sys.modules[name]
    import qnmfits_tpu_torch as qt
    from qnmfits_tpu_torch import engine
    from qnmfits_tpu_torch.ops import cf_cuda, chol_cuda, sweep_cuda
    from qnmfits_tpu_torch.spectrum import solver, tables
    if not qt.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {qt.__file__}, not the package under "
                           f"{root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for mod in (chol_cuda, cf_cuda, sweep_cuda):
        mod.build()
    try:
        from qnmfits_tpu_torch.ops import eig_cuda
        eig_cuda.build()
    except ImportError:
        eig_cuda = None

    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    kw = dict(T_array=problem["T"], spherical_modes=chip_smoke.SPH,
              dedup=True, device="cuda")
    warm_sets = [chip_smoke.F1_SET[:-1]]
    qt.mismatch_t0_mode_sets(problem["times"], problem["data"], warm_sets,
                             chip_smoke.MF, chip_smoke.CHIF, problem["t0s"],
                             **kw)
    seeds = solver.schwarzschild_seeds(l_max=2, n_max=0, s=-2,
                                       device="cuda")
    solver.track_mode(2, 2, 0, seeds[(2, 0)],
                      solver.default_chi_grid(17, 0.6), device="cuda")
    torch.cuda.synchronize()

    events = {"eig": [], "cf": []}
    calls = {"eig": 0, "cf": 0}

    def timed(kind, fn):
        def run(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            events[kind].append(ev)
            calls[kind] += 1
            return out
        return run

    saved = {n: getattr(solver, n) for n in EIG_FUNCTIONS + ("leaver_cf",)
             if hasattr(solver, n)}
    for name, fn in saved.items():
        setattr(solver, name, timed("cf" if name == "leaver_cf" else "eig",
                                    fn))
    if eig_cuda is not None:
        eig_cuda.launches = 0
    tables.TRACK_CACHE = tempfile.mkdtemp(prefix="qnm_track_cache_")
    if (5, 2, 8) in engine.default_tables().row:
        raise RuntimeError("F1: (5,2,8) is already in the tables")
    t = time.perf_counter()
    mm = qt.mismatch_t0_mode_sets(problem["times"], problem["data"],
                                  [chip_smoke.F1_SET], chip_smoke.MF,
                                  chip_smoke.CHIF, problem["t0s"], **kw)
    wall = time.perf_counter() - t
    for name, fn in saved.items():
        setattr(solver, name, fn)
    torch.cuda.synchronize()
    secs = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
            for k, v in events.items()}
    line = json.dumps(dict(
        label=args.label, root=root, card=smi, wall_s=wall,
        eig_s=secs["eig"], cf_s=secs["cf"],
        rest_s=wall - secs["eig"] - secs["cf"], eig_calls=calls["eig"],
        cf_calls=calls["cf"],
        eig_launches=None if eig_cuda is None else eig_cuda.launches,
        finite=bool(np.all(np.isfinite(mm)))))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
