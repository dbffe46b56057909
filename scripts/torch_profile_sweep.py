#!/usr/bin/env python3
"""Where the device time of the port's mode-set sweep goes, on one GPU.

    python3 scripts/torch_profile_sweep.py [--out FILE] [--root DIR]

Runs the bench problem (chip_smoke.FULL) through the public
``qnmfits_tpu_torch.mismatch_t0_mode_sets`` with and without window
dedup, once to warm up and once under ``torch.profiler``, and prints for
each: the wall time of the profiled call, the summed device time of all
kernels, the device's idle share over the call, and the device time by
kernel (the 15 largest, and the port's solve kernel wherever it ranks).  The card's name and power limit head the output.
``--root DIR`` imports ``qnmfits_tpu_torch`` from DIR (another commit's
tree) instead of this checkout.  Needs CUDA.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_profile_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]]
    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    for dedup in (True, False):
        chip_smoke.sweep(problem, "cuda", dedup)               # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            chip_smoke.sweep(problem, "cuda", dedup)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) / 1e3                  # ms
        lines.append(f"dedup={dedup}: wall {wall * 1e3:.3f} ms, device "
                     f"busy {busy:.3f} ms, idle share "
                     f"{1 - busy / (wall * 1e3):.3f}, {len(rows)} kernels")
        # The 15 largest, then the port's own kernels wherever they rank.
        for rank, (key, us, count) in enumerate(rows):
            if rank < 15 or "regularised_solve" in key:
                lines.append(f"  #{rank + 1:<3d} {us / 1e3:9.3f} ms "
                             f"{100 * us / 1e3 / busy:5.1f}% x{count:<5d} "
                             f"{key[:90]}")
    report = "\n".join(lines)
    print(report, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
