#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qnmfits_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them.  Phases, one
flushed line each with elapsed seconds:

1. the card's name and power limit (nvidia-smi);
2. the build of the solve kernel (csrc/chol_solve.cu, sm_90a) from this
   checkout into build/qnmfits_tpu_torch/, and ptxas's registers and
   spills for each system size (no spill allowed);
3. the kernel against its plain PyTorch version on the card, for every
   system size n = 2..16 on random batches with dead columns and padding,
   at B = 8208 and at batches that leave partial slabs (B = 1, 15, 17,
   1000), and at B = 131072 for n = 8;
4. the main path at the bench's full width (bench.py: K=2001 samples,
   spherical modes (2,2) and (3,2), the 16 mode sets padded to J=8,
   8192 start times on [-5, 46.2], T=100, seed 11) through the public
   ``mismatch_t0_mode_sets``, with and without window dedup: exactly one
   kernel launch per sweep, finite values of the right shape, the kernel
   path against the plain-solve path, and a stratified check against the
   NumPy oracle (ref_impl);
5. the kernel on the very systems each sweep gave it (8208 with dedup,
   131072 without): its backward error, and its device time beside its
   bound, its plain version's and torch.linalg's; and the sweep's fits/s;
6. a JSON line describing each kernel, and last the JSON ok line.

Any failure raises and exits non-zero before the last line.
"""

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
# bench.py's problem; SMALL is the same shape of problem cut to CPU size.
FULL = dict(t_range=(-50.0, 150.05), n_t0=8192, t0_range=(-5.0, 46.2),
            T=100.0, sets=tuple(range(16)))
SMALL = dict(t_range=(-10.0, 30.05), n_t0=64, t0_range=(-2.0, 10.0),
             T=20.0, sets=(1, 3, 9, 13))
STRATA = (-5.0, -1.0, 0.5, 2.5, 10.0, 25.0, 40.0)     # bench.py:160-179

MAIN_TOL = 1e-11      # kernel path vs plain-solve path, |mismatch| abs
# The same for t0 < 0, where windows start before the ringdown and the
# Grams are ill-conditioned up to the floor's cap: two backward-stable
# solvers differ there by ~1e-9, and the oracle itself moves ~1e-7.
PRE_TOL = 1e-8
ORACLE_TOL = 1e-10    # vs the NumPy oracle for t0 >= 0, |mismatch| abs
KERNEL_RTOL = 1e-12   # kernel vs plain solve, per-system relative
# Normwise backward error of the kernel's solutions on the main path's
# own systems.  A stable solve reads ~n eps; a kernel that drops the
# 500 J eps floor reads ~floor / ||A|| ~ 9e-13, so this bound sees it.
KERNEL_BWD_TOL = 1e-14

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP64 outside the
# tensor cores.  They assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


def log(msg):
    print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", flush=True)


def build_problem(t_range, n_t0, t0_range, T, sets):
    """The bench problem: a synthetic (2,2,n<8) ringdown with mixing
    into (2,2) and (3,2), sampled at 0.1 M."""
    from qnmfits_tpu_torch.testing import (bench_mode_sets,
                                           synthetic_multimode)
    times = np.arange(*t_range, 0.1)
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(8)],
                              spherical_modes=SPH, Mf=MF, chif=CHIF,
                              times=times, seed=11)
    all_sets = bench_mode_sets()
    return dict(times=times, data=syn["data_dict"],
                mode_sets=[all_sets[i] for i in sets],
                t0s=np.linspace(*t0_range, n_t0), T=T)


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


def run_main_path(problem, device):
    """Phase 4: drive the public sweep with and without dedup, count the
    kernel's launches in each, and check the results against the plain
    solve and the NumPy oracle.  Returns a dict of what it found; raises
    on any failure."""
    from qnmfits_tpu_torch import engine_real, ref_impl
    from qnmfits_tpu_torch.ops import chol_cuda

    S, B = len(problem["mode_sets"]), len(problem["t0s"])
    out = {}
    for dedup in (True, False):
        chol_cuda.launches = 0
        mm = sweep(problem, device, dedup)
        n_launch = chol_cuda.launches
        if mm.shape != (S, B) or not np.all(np.isfinite(mm)):
            raise RuntimeError(f"main path (dedup={dedup}) gave shape "
                               f"{mm.shape} or non-finite mismatches")
        if device != "cpu" and n_launch != 1:
            raise RuntimeError(f"main path (dedup={dedup}) launched the CUDA "
                               f"solve kernel {n_launch} times, not once")
        out[dedup] = dict(mm=mm, launches=n_launch)
    log(f"main path: mm {out[True]['mm'].shape}, kernel launches "
        f"{out[True]['launches']} with dedup, {out[False]['launches']} "
        f"without")

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
        captured = []

        def plain(G, b):
            captured.append((G, b))
            return engine_real._regularised_solve_plain(G, b)

        mm_plain = sweep(problem, device, dedup, solve=plain)
        checks[f"kernel vs plain solve (dedup={dedup})"] = diff(
            out[dedup]["mm"], mm_plain)
        if len(captured) != 1:
            raise RuntimeError(f"the sweep (dedup={dedup}) called its solve "
                               f"{len(captured)} times, not once")
        systems[dedup] = captured[0]
    checks["dedup vs per-t0"] = diff(out[True]["mm"], out[False]["mm"])
    for name, (d_in, d_pre) in checks.items():
        log(f"{name}: max |d mm| t0 >= 0: {d_in:.3e} (bound "
            f"{MAIN_TOL:.0e}); t0 < 0: {d_pre:.3e} (bound {PRE_TOL:.0e})")
        if not (d_in <= MAIN_TOL and d_pre <= PRE_TOL):
            raise RuntimeError(f"{name} disagree beyond {MAIN_TOL:.0e} "
                               f"(t0 >= 0) or {PRE_TOL:.0e} (t0 < 0)")

    t0s = problem["t0s"]
    dev_in, dev_pre = 0.0, 0.0
    for si, ms in enumerate(problem["mode_sets"]):
        for t0_val in STRATA:
            if not t0s[0] <= t0_val <= t0s[-1]:
                continue
            i = int(round((t0_val - t0s[0]) / (t0s[-1] - t0s[0])
                          * (len(t0s) - 1)))
            ref = ref_impl.multimode_ringdown_fit(
                problem["times"], problem["data"], ms, MF, CHIF,
                t0=float(t0s[i]), T=problem["T"], spherical_modes=SPH)
            d = abs(float(out[True]["mm"][si, i]) - ref["mismatch"])
            if t0_val >= 0.0:
                dev_in = max(dev_in, d)
            else:
                dev_pre = max(dev_pre, d)
    log(f"oracle (NumPy lstsq), {S} sets x strata {STRATA}: max |d mm| "
        f"t0 >= 0: {dev_in:.3e} (bound {ORACLE_TOL:.0e}); t0 < 0: "
        f"{dev_pre:.3e} (reported, conditioning floor)")
    if not dev_in <= ORACLE_TOL:
        raise RuntimeError("main path disagrees with the NumPy oracle")
    return dict(launches=out[True]["launches"],
                launches_nodedup=out[False]["launches"],
                mm=out[True]["mm"], systems=systems,
                oracle_in=dev_in, oracle_pre=dev_pre)


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


def device_ms(fn, reps=20):
    """Device time of one fn() call: the durations of the kernels it
    launches, summed, from torch.profiler (CUPTI) over reps calls.  The
    host's launch cost and the gaps between kernels are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if not us > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / reps


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
# batches that leave partial slabs and teams, at every n; 131072 (8192
# start times x 16 sets, the sweep without dedup) at the bench's n = 8.
CHECK_BATCHES = (8208, 1, 15, 17, 1000)
CHECK_LARGE = (131072, 8)


def check_build():
    """Phase 2: ptxas's registers and spills per system size.  Returns
    (registers by n, the largest spill in bytes); raises on a spill."""
    from qnmfits_tpu_torch.ops import chol_cuda
    report = chol_cuda.ptxas_report()
    spill = max(max(r["spill_stores"], r["spill_loads"])
                for r in report.values())
    regs = {n: r["registers"] for n, r in report.items()}
    log(f"ptxas: registers by n {regs}; largest spill {spill} bytes")
    if spill:
        raise RuntimeError(f"ptxas reports spills: {report}")
    return regs, spill


def check_kernel_sizes(device):
    """Phase 3: kernel vs plain on random systems with dead columns and
    padding, n = 2..16 at each of CHECK_BATCHES, and CHECK_LARGE.
    Returns {n: max |x_kernel - x_plain|}."""
    import torch
    from qnmfits_tpu_torch import engine_real
    from qnmfits_tpu_torch.ops import chol_cuda
    from qnmfits_tpu_torch.testing import random_hermitian_systems

    cases = [(B, n) for n in range(2, 17) for B in CHECK_BATCHES]
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
    log(f"kernel vs plain, n = 2..16 at B = {CHECK_BATCHES} and B = "
        f"{CHECK_LARGE[0]} at n = {CHECK_LARGE[1]} (dead columns, "
        f"padding): max relative error {worst:.3e} (bound "
        f"{KERNEL_RTOL:.0e})")
    return max_abs


def time_solves(G, b):
    """Device times (ms) of the kernel, its plain version and
    torch.linalg.cholesky_ex + cholesky_solve (on the equilibrated system
    only) on one batch, and the kernel's backward error beside the plain
    solve's, and its relative difference from it."""
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
            lambda: engine_real._regularised_solve_plain(G, b), reps=5),
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qnmfits_tpu_torch.ops import chol_cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    gpu = f"{kind} ({smi.split(',')[-1].strip()} limit)"
    log(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t = time.perf_counter()
    lib = chol_cuda.build()
    log(f"built {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t:.2f} s (sm_90a)")
    build = check_build()

    device = "cuda"
    max_abs = check_kernel_sizes(device)
    t = time.perf_counter()
    problem = build_problem(**FULL)
    log(f"bench problem built in {time.perf_counter() - t:.2f} s: "
        f"K={len(problem['times'])}, S={len(problem['mode_sets'])}, "
        f"B={len(problem['t0s'])}")
    main_path = run_main_path(problem, device)
    record = measure(problem, main_path, max_abs, build, device, gpu)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
