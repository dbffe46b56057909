#!/usr/bin/env python3
"""Where the time of the port's remnant optimiser goes, stage by stage,
on one GPU.

    python3 scripts/torch_optimiser_stages.py

Builds the bench problem (chip_smoke.FULL) and the pieces of
``optimize.calculate_epsilon_array`` on its 513 distinct windows with the
(2,2,n<8) ladder and both spherical rows (chip_smoke.py's O2): the two
seed stages (89 and 100 exact fits a window, forward only, one solve
launch each) and one damped-Newton step of the 2565 polished
trajectories (a forward, a backward and two Hessian passes through the
solve, and a trial fit), and the whole call.  For each, the warm wall
time (mean of 3) and the device busy time of one call from
torch.profiler (device records only; the profiler drops a few records a
profile on the H100, so busy time reads a little low), in ms.  The
card's name and power limit head the output.  Needs CUDA.
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, reps=3):
    """(warm wall ms, device busy ms) of one fn() call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) / reps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, busy


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_optimiser_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import optimize
    from qnmfits_tpu_torch.engine import cached_evaluator
    from qnmfits_tpu_torch.testing import bench_mode_sets

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    p = chip_smoke.build_problem(**chip_smoke.FULL)
    deep, sph = bench_mode_sets()[chip_smoke.DEEPEST], chip_smoke.SPH
    dev = torch.device("cuda")
    t0s, Ts = optimize._windows(p["times"], p["t0s"], p["T"], "geq",
                                True)[:2]
    rows = np.stack([p["data"][lm] for lm in sph])
    prob = optimize._Problem(p["times"], rows, t0s, Ts, "geq", dev, None)
    spectrum = optimize.epsilon_spectrum(cached_evaluator(deep, sph), sph,
                                         1.0, dev)
    n = len(t0s)
    win = torch.arange(n, device=dev)
    x0 = torch.tensor([chip_smoke.MF, chip_smoke.CHIF], dtype=torch.float64,
                      device=dev)
    offs = torch.as_tensor(optimize._OFFS, device=dev)
    cand0 = torch.cat([x0 + offs, torch.as_tensor(optimize._GLOBAL,
                                                  device=dev)])
    patches = (x0 + offs).repeat(n * optimize.NPOL, 1)
    P = 1 + optimize.NPOL
    traj = win.repeat_interleave(P)
    xs = (x0 + offs[:P]).repeat(n, 1)

    def mm_fn(x):
        return prob.mm(*spectrum(x), traj)

    def newton_step():
        with torch.no_grad():
            f = mm_fn(xs)
        optimize._newton_polish(mm_fn, xs, f, iters=1)

    stages = [
        ("seed stage 1 (x0 patch + global grid)", lambda: prob.seed_mm(
            spectrum, cand0.repeat(n, 1), win.repeat_interleave(len(cand0)))),
        ("seed stage 2 (refining patches)", lambda: prob.seed_mm(
            spectrum, patches,
            win.repeat_interleave(optimize.NPOL * len(optimize._OFFS)))),
        ("one Newton step (+ the fit it starts from)", newton_step),
        ("calculate_epsilon_array, whole call",
         lambda: tq.calculate_epsilon_array(
             p["times"], p["data"], deep, chip_smoke.MF, chip_smoke.CHIF,
             p["t0s"], spherical_modes=sph, T_array=p["T"])),
    ]
    print(f"O2: {n} windows, J = {len(deep)}, K = {len(p['times'])}")
    for name, fn in stages:
        wall, busy = timed(fn)
        print(f"{name}: warm wall {wall:.1f} ms, device busy {busy:.1f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
