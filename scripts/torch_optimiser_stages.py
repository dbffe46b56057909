#!/usr/bin/env python3
"""Where the time of the port's array optimisers goes, stage by stage, on
one GPU, with one version of the port.

    python3 scripts/torch_optimiser_stages.py [--root DIR] [--label L]
        [--reps N] [--out FILE]

Builds the bench problem (chip_smoke.FULL) and runs ``chip_smoke.py``'s
phase-8 calls on its 513 distinct windows: O1 ``free_frequency_fit_array``
(the (2,2) row, (2,2,n=1..3) fixed and one free mode) and O2
``calculate_epsilon_array`` (both rows, the (2,2,n<8) ladder), maxiter 30,
``return_mismatch=True``.  For each:

* the whole call: warm wall (mean of ``--reps``), device busy time and
  idle share under torch.profiler (device records only), peak device
  memory, and the device time by kind (``chip_smoke.device_split``);
* the call split into its seed stage (O1: the bordered seed scores and
  the winner's fit; O2: the two seed stages) and its Newton stage
  (``optimize._newton_polish``, timed by the host clock between two
  synchronisations; the final gradient check is the rest);
* one damped-Newton step of the call's own trajectory batch (513 for O1,
  2565 for O2), host clock between synchronisations, mean of ``--reps``:
  with autograd (a version without ``optimize._fit_derivs``) its forward
  fit, its backward pass, its two Hessian passes and the trial fit; with
  the window moments the spectrum's jets, the moments kernel alone, the
  whole order-2 fit with its gradient and Hessian, and the trial fit
  (order 0).

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree: ``mkdir -p
DIR && git archive REV qnmfits_tpu_torch | tar -x -C DIR`` with this
checkout's ``qnmfits_tpu`` linked beside it for the tables; this checkout
by default) and takes the problem and the split from this checkout's
``chip_smoke.py``.  Prints the card's name and power limit, a line a
measurement and one JSON line (also written to FILE).  Run each version in
its own process, in turns (A, B, B, A), within one call.  Needs CUDA.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_ms(fn, reps):
    """Mean host-clock ms of fn() between two synchronisations (after one
    warm call), and fn()'s last result."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t
    return total / reps * 1e3, out


def newton_stage_ms(optimize, call):
    """(call's wall ms, its Newton stage's ms) of one warm call, the
    stage timed by wrapping ``optimize._newton_polish`` with
    synchronisations."""
    import torch
    orig = optimize._newton_polish
    spent = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    call()
    torch.cuda.synchronize()
    optimize._newton_polish = timed
    try:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        optimize._newton_polish = orig
    return wall * 1e3, sum(spent) * 1e3


def step_autograd(optimize, mm_fn, x, reps):
    """One Newton step through autograd (``optimize._grad``), in parts."""
    import torch
    parts = {}
    state = {}

    def forward():
        state["x"] = x.detach().requires_grad_(True)
        with torch.enable_grad():
            state["f"] = mm_fn(state["x"])

    def backward():
        forward()
        with torch.enable_grad():
            state["g"], = torch.autograd.grad(state["f"].sum(), state["x"],
                                              create_graph=True)

    def hessian():
        backward()
        with torch.enable_grad():
            for i in range(2):
                torch.autograd.grad(state["g"][:, i].sum(), state["x"],
                                    retain_graph=i == 0, allow_unused=True)

    def trial():
        with torch.no_grad():
            return mm_fn(x + 1e-3)

    f_ms = host_ms(forward, reps)[0]
    b_ms = host_ms(backward, reps)[0]
    h_ms = host_ms(hessian, reps)[0]
    parts["forward_ms"] = f_ms
    parts["backward_ms"] = b_ms - f_ms
    parts["hessian_ms"] = h_ms - b_ms
    parts["trial_ms"] = host_ms(trial, reps)[0]
    parts["step_ms"] = h_ms + parts["trial_ms"]
    return parts


def step_moments(optimize, prob, spectrum, x, traj, reps):
    """One Newton step through the window moments, in parts."""
    from qnmfits_tpu_torch.ops import moments_cuda
    parts = {}
    parts["jets_ms"], jets = host_ms(
        lambda: spectrum.jets(x, 2), reps)
    omega = jets[0][0].contiguous()
    if "tau" in inspect.signature(moments_cuda.window_moments).parameters:
        # a tree whose wrapper takes the trapezoid weights
        def moments():
            return moments_cuda.window_moments(
                prob.times, prob.rows, omega, prob.t0s, prob.w, prob.tau,
                traj, 2)
    else:
        def moments():
            return moments_cuda.window_moments(
                prob.times, prob.rows, omega, prob.t0s, prob.w, traj, 2,
                grid=prob.grid)
    parts["moments_ms"] = host_ms(moments, reps)[0]
    parts["derivs_ms"] = host_ms(lambda: optimize._fit_derivs(
        prob, spectrum, x, traj, 2), reps)[0]
    parts["trial_ms"] = host_ms(lambda: optimize._fit_derivs(
        prob, spectrum, x + 1e-3, traj, 0), reps)[0]
    parts["step_ms"] = parts["derivs_ms"] + parts["trial_ms"]
    return parts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_optimiser_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import optimize
    from qnmfits_tpu_torch.engine import cached_evaluator
    from qnmfits_tpu_torch.testing import bench_mode_sets

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"{args.label}: qnmfits_tpu_torch from "
          f"{os.path.dirname(tq.__file__)}", flush=True)
    p = chip_smoke.build_problem(**chip_smoke.FULL)
    deep, sph = bench_mode_sets()[chip_smoke.DEEPEST], chip_smoke.SPH
    times, data, t0s_all, T = p["times"], p["data"], p["t0s"], p["T"]
    row = data[(2, 2)]
    MF, CHIF = chip_smoke.MF, chip_smoke.CHIF
    dev = torch.device("cuda")
    t0s, Ts = optimize._windows(times, t0s_all, T, "geq", True)[:2]
    n = len(t0s)
    moments = hasattr(optimize, "_fit_derivs")
    fixed = torch.as_tensor(
        cached_evaluator(chip_smoke.OPT_FIXED).omega(CHIF, MF), device=dev)
    w220 = complex(cached_evaluator([(2, 2, 0, 1)]).omega(CHIF, MF)[0])
    offs = torch.as_tensor(optimize._OFFS, device=dev)
    x0 = torch.tensor([MF, CHIF], dtype=torch.float64, device=dev)
    P = 1 + optimize.NPOL
    cases = {
        "O1": dict(
            call=lambda: tq.free_frequency_fit_array(
                times, row, t0s_all, modes=chip_smoke.OPT_FIXED, Mf=MF,
                chif=CHIF, T_array=T, maxiter=p["opt_maxiter"],
                return_mismatch=True),
            rows=np.asarray(row)[None],
            spectrum=optimize.free_frequency_spectrum(fixed),
            traj=torch.arange(n, device=dev),
            x=torch.tensor([[w220.real, w220.imag]], dtype=torch.float64,
                           device=dev).repeat(n, 1)),
        "O2": dict(
            call=lambda: tq.calculate_epsilon_array(
                times, data, deep, MF, CHIF, t0s_all, spherical_modes=sph,
                T_array=T, maxiter=p["opt_maxiter"], return_mismatch=True),
            rows=np.stack([data[lm] for lm in sph]),
            spectrum=optimize.epsilon_spectrum(cached_evaluator(deep, sph),
                                               sph, 1.0, dev),
            traj=torch.arange(n, device=dev).repeat_interleave(P),
            x=(x0 + offs[:P]).repeat(n, 1)),
    }
    out = dict(label=args.label, card=smi, windows=n,
               route="moments" if moments else "autograd")
    for key, case in cases.items():
        rec = dict(split=chip_smoke.device_split(case["call"], reps=2,
                                                 host_ops=False))
        wall, newton = newton_stage_ms(optimize, case["call"])
        rec.update(call_ms=wall, newton_stage_ms=newton,
                   seed_stage_and_rest_ms=wall - newton)
        prob = optimize._Problem(times, case["rows"], t0s, Ts, "geq", dev,
                                 None)
        spectrum, traj, x = case["spectrum"], case["traj"], case["x"]
        if moments:
            rec["step"] = step_moments(optimize, prob, spectrum, x, traj,
                                       args.reps)
        else:
            rec["step"] = step_autograd(
                optimize, lambda y: prob.mm(*spectrum(y), traj), x,
                args.reps)
        s = rec["split"]
        print(f"{key} ({len(traj)} trajectories): warm wall "
              f"{s['wall_ms']:.1f} ms, busy {s['busy_ms']:.1f} ms, idle "
              f"share {s['idle_share']:.3f}, peak {s['peak_gib']:.3f} GiB; "
              f"Newton stage {newton:.1f} ms of a {wall:.1f} ms call; one "
              "step: " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in rec["step"].items()),
              flush=True)
        out[key] = rec
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
