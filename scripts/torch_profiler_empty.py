"""Why torch.profiler sometimes records no device time for a short call.

Runs on the card.  Phase 10's short factored paths (M1 'fast' with and
without dedup, M2 'fast', Q1; ``chip_smoke.mapping_specs``) and the main
path's sweep (``chip_smoke.sweep``, dedup on) are each profiled ``--trials``
times in each of these ways, two warm calls a profile as
``chip_smoke.device_split`` takes them:

* ``plain``: the CPU and CUDA activities around the calls;
* ``padded``: the same with ``--pad`` seconds of host sleep inside the
  profile before the first call and after the last synchronize, so that
  every device record lies well inside the profiled window;
* ``device``: the CUDA activity alone.

For each (path, way) it prints the trials' device records (kernels and
copies, summed counts) and how many trials recorded none, and with
``--out FILE`` writes them to FILE as JSON.

    python scripts/torch_profiler_empty.py [--trials 8] [--pad 0.05] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def records(fn, way, pad, reps=2):
    """Device records (summed counts) of one profile of reps fn() calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if way == "device"
            else [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if way == "padded":
            time.sleep(pad)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if way == "padded":
            time.sleep(pad)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--pad", type=float, default=0.05)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    problem = chip_smoke.build_problem(**dict(chip_smoke.FULL, events=2))
    specs, _ = chip_smoke.mapping_specs(problem, "cuda")
    paths = {s["key"]: s["kernel"] for s in specs
             if s["key"] in ("m1_fast", "m1_fast_nodedup", "m2_fast", "q1")}
    paths["main"] = lambda: chip_smoke.sweep(problem, "cuda", True)
    out = {}
    ways = ("plain", "padded", "device")
    for key, fn in paths.items():
        fn()
        fn()
        counts = {way: [] for way in ways}
        for _ in range(args.trials):      # the ways in turn, trial by trial
            for way in ways:
                counts[way].append(records(fn, way, args.pad))
        for way in ways:
            c = out[f"{key}/{way}"] = counts[way]
            print(f"{key:16s} {way:7s} records {c}, empty "
                  f"{sum(x == 0 for x in c)} of {len(c)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
