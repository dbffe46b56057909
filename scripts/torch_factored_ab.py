#!/usr/bin/env python3
"""The factored sweep's systems kernel of one version of the port on one
GPU, on the inputs of every factored path.  For comparing two versions in
turns.

    python3 scripts/torch_factored_ab.py --label NAME [--root DIR]
                                         [--out FILE]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV | tar -x -C DIR``; this checkout by
default) and drives it with this checkout's ``chip_smoke.py`` at
``chip_smoke.FULL``: each factored path below runs once through its public
entry point with the systems kernel's inputs recorded
(``chip_smoke.recording_sweeps``), then the kernel's device time on each
join group's inputs is read by torch.profiler (``chip_smoke.kernel_ms``,
mean over 20 launches) and added up over the path's groups.  The paths:
the main path with dedup and without (``main``, ``main_nodedup``); phase
6's remnant axis with and without dedup, bucket=True and the 17-, 40- and
96-mode sets (``chip_smoke.path_specs``: ``remnant``, ``remnant_nodedup``,
``bucket``, ``n17``, ``n40``, ``n96``); phase 10's M1 'fast' and M2 'fast'
(``chip_smoke.mapping_specs``: ``m1_fast``, ``m2_fast``); phase 11's W1
main path with dedup and W2's (``w1_main``, ``w2_main``: the calls of
``chip_smoke.waveform_specs``).

Prints the card's name and power limit, then one JSON line.  Run each
version in its own process, in turns (A, B, B, A), within one call; the
spread of a version is the difference of its two turns.  Needs CUDA and
nvcc.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE6 = ("remnant", "remnant_nodedup", "bucket", "n17", "n40", "n96")
PHASE10 = ("m1_fast", "m2_fast")


def path_calls(problem):
    """{key: the path's call through its public entry point} for every
    factored path of this module's list, on ``chip_smoke``'s problem, the
    card's device; the package is the one ``sys.path`` finds first."""
    import numpy as np
    import chip_smoke
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.testing import bench_mode_sets
    calls = {}
    for dedup in (True, False):
        calls["main" if dedup else "main_nodedup"] = (
            lambda dedup=dedup: chip_smoke.sweep(problem, "cuda", dedup))
    for spec in chip_smoke.path_specs(problem, "cuda"):
        if spec["key"] in PHASE6:
            calls[spec["key"]] = spec["kernel"]
    specs, _ = chip_smoke.mapping_specs(problem, "cuda")
    for spec in specs:
        if spec["key"] in PHASE10:
            calls[spec["key"]] = spec["kernel"]
    t0s = np.linspace(*problem["t0s"][[0, -1]], problem["wave_t0"])
    w1, _ = chip_smoke.load_w1()
    row = {(2, 2): w1.h[2, 2]}
    calls["w1_main"] = lambda: tq.mismatch_t0_mode_sets(
        w1.times, row, chip_smoke.W1_LADDERS, w1.Mf, w1.chif_mag, t0s,
        T_array=chip_smoke.W1_T, spherical_modes=[(2, 2)], dedup=True,
        device="cuda")
    wr = chip_smoke.load_w2()["rotation"]
    data2 = {lm: wr.h[lm] for lm in chip_smoke.SPH}
    calls["w2_main"] = lambda: tq.mismatch_t0_mode_sets(
        wr.times, data2, bench_mode_sets(), wr.Mf, wr.chif_mag, t0s,
        T_array=chip_smoke.W2_T, spherical_modes=chip_smoke.SPH, dedup=True,
        device="cuda")
    return calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_factored_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, root)
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.ops import chol_cuda, sweep_cuda
    if not tq.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {tq.__file__}, not the package "
                           f"under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chol_cuda.build()
    sweep_cuda.build()
    problem = chip_smoke.build_problem(**chip_smoke.FULL)

    calls = path_calls(problem)
    paths = {}
    for key, call in calls.items():
        with chip_smoke.recording_sweeps() as rec:
            call()
        groups = [a for a, _ in rec["systems"]]
        if not groups:
            raise RuntimeError(f"{key}: no systems kernel call recorded")
        each = [chip_smoke.kernel_ms(
            lambda a=a: sweep_cuda.factored_systems(*a),
            kernel="factored_systems_kernel") for a in groups]
        paths[key] = dict(groups=len(groups), ms=sum(each), ms_each=each,
                          windows=[int(a[4].shape[0]) for a in groups],
                          S=int(groups[0][2].shape[0]),
                          J=int(groups[0][2].shape[1]),
                          K=int(groups[0][0].shape[0]))
        print(f"{key}: {paths[key]['ms']:.4f} ms over {len(groups)} "
              f"group(s) (S={paths[key]['S']}, J={paths[key]['J']}, "
              f"windows {paths[key]['windows']})", flush=True)
    line = json.dumps(dict(label=args.label, root=root, card=smi,
                           paths=paths))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
