#!/usr/bin/env python3
"""The factored sweep's systems kernel against variants of its own source,
on one GPU, on the main path's inputs.

    python3 scripts/torch_factored_variants.py [--out FILE] [NAME ...]

Records the systems kernel's inputs on factored paths (by default the main
path's two sweeps, ``chip_smoke.sweep`` at ``chip_smoke.FULL`` with dedup
on and off; ``--path`` takes any keys of ``scripts/torch_factored_ab.py``,
the first join group of each) through ``chip_smoke.recording_sweeps``.  Then, for the source as it is and for
each variant of ``VARIANTS`` (all, or those named: edits of the source and
a cluster size forced in place of ``sweep_cuda.cluster_size``), builds
that source with
``ops/sweep_cuda.py``'s flags into ``build/factored_variants/<name>/``,
checks its outputs against the plain version (``SYSTEMS_RTOL`` of each
system's largest entry) and prints ptxas's registers and spills and its
device time by torch.profiler (``chip_smoke.kernel_ms``) on both sweeps'
inputs, in turns (the source, the variants, the variants backwards, the
source).  The card's name and power limit head the output, one JSON line
ends it.  Needs CUDA and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (((text in the source, its replacement), ...), blocks a cluster)
BOUNDS = "__global__ void __launch_bounds__(THREADS, 4)\nfactored_systems_kernel"
THREADS = "constexpr int THREADS = 256;"
VARIANTS = {
    "blocks2": (((BOUNDS, BOUNDS.replace("(THREADS, 4)", "(THREADS)")),),
                None),
    "blocks3": (((BOUNDS, BOUNDS.replace("(THREADS, 4)", "(THREADS, 3)")),),
                None),
    "gwin16": ((("constexpr int GWIN = 64;", "constexpr int GWIN = 16;"),),
               None),
    "cluster1": ((), 1),
    "cluster2": ((), 2),
    "cluster4": ((), 4),
    "cluster8": ((), 8),
    "threads128": (((BOUNDS, BOUNDS.replace("(THREADS, 4)", "(THREADS, 8)")),
                    (THREADS, THREADS.replace("256", "128"))), None),
    "threads128_cluster4": (((BOUNDS, BOUNDS.replace("(THREADS, 4)",
                                                     "(THREADS, 8)")),
                             (THREADS, THREADS.replace("256", "128"))), 4),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--path", nargs="+", default=["main", "main_nodedup"],
                    help="the factored paths whose inputs to take "
                         "(scripts/torch_factored_ab.py's keys; the first "
                         "join group of each)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_factored_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    from qnmfits_tpu_torch.ops import chol_cuda, sweep_cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chol_cuda.build()
    sweep_cuda.build()
    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    from torch_factored_ab import path_calls
    paths = path_calls(problem)
    inputs = {}
    for key in args.path:
        with chip_smoke.recording_sweeps() as calls:
            paths[key]()
        inputs[key] = calls["systems"][0][0]
    refs = {k: sweep_cuda.factored_systems_plain(*a)
            for k, a in inputs.items()}

    source = sweep_cuda.SOURCE.read_text()
    names = ["source"] + (args.names or list(VARIANTS))
    libs = {}
    for name in names:
        src = source
        for old, new in VARIANTS.get(name, ((), None))[0]:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   "once")
            src = src.replace(old, new)
        d = Path(ROOT) / "build" / "factored_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "factored_sweep.cu").write_text(src)
        sweep_cuda.SOURCE = d / "factored_sweep.cu"
        sweep_cuda.BUILD_DIR = d
        sweep_cuda.BUILD_LOG = d / "build.log"
        sweep_cuda._lib.cache_clear()
        report = sweep_cuda.ptxas_report()["factored_systems_kernel"]
        libs[name] = (sweep_cuda._lib(), report)

    cluster_size = sweep_cuda.cluster_size

    def use(name):
        sweep_cuda._lib = lambda: libs[name][0]
        forced = VARIANTS.get(name, ((), None))[1]
        sweep_cuda.cluster_size = ((lambda *a: forced) if forced
                                   else cluster_size)

    record = dict(card=smi, variants={})
    for name in names:
        use(name)
        rel = 0.0
        for key, a in inputs.items():
            got = sweep_cuda.factored_systems(*a)
            torch.cuda.synchronize()
            rel = max([rel] + [chip_smoke.per_system_rel(
                x, y, 2 if y.dim() > 1 else 1)
                for x, y in zip(got, refs[key])])
        if not rel <= chip_smoke.SYSTEMS_RTOL:
            raise RuntimeError(f"{name}: {rel:.3e} from the plain version")
        record["variants"][name] = dict(rel=rel, ms={k: [] for k in inputs},
                                        **libs[name][1])
    for name in names + names[::-1]:
        use(name)
        for key, a in inputs.items():
            record["variants"][name]["ms"][key].append(chip_smoke.kernel_ms(
                lambda a=a: sweep_cuda.factored_systems(*a),
                kernel="factored_systems_kernel"))
    for name, r in record["variants"].items():
        print(f"{name}: registers {r['registers']}, spills "
              f"{r['spill_stores']} / {r['spill_loads']} bytes; "
              + "; ".join(f"{k} " + ", ".join(f"{x:.4f}" for x in v)
                          + " ms" for k, v in r["ms"].items()), flush=True)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
