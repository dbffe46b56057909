#!/usr/bin/env python3
"""The Leaver CF kernel at every team size, on one GPU: time and error.

    python3 scripts/torch_cf_teams.py [--extended] [--out FILE]
    python3 scripts/torch_cf_teams.py --arrivals [--out FILE]
    python3 scripts/torch_cf_teams.py --host [--out FILE]

Builds ``qnmfits_tpu_torch/csrc/leaver_cf.cu`` (nvcc, sm_90a) and prints
ptxas's registers and spills for each instantiation.  Then, for each (B, N)
of SHAPES, on random inputs of phase 12's S1 distribution
(``chip_smoke.cf_inputs``: spins to chi = 0.999, n_inv 0..8), it runs the
kernel with every team of ``cf_cuda.TEAMS`` and prints, per team, the
segment length (steps a thread), the largest error against the plain
version on the same card relative to |U| + |T|, and the kernel's device
time (torch.profiler, ``chip_smoke.kernel_ms``), marking the team that
``cf_cuda.plan`` picks.  With ``--extended`` the same for the double-double
variant at SHAPES_DD, on S1-X's distribution (``chip_smoke.CF_DD_CHI``,
spins beyond chi = 0.985), against its plain version ``cf_dd``, at every
(team, blocks) of ``cf_cuda.dd_plans`` whose segment lies within
DD_SEGMENTS, marking the one ``cf_cuda.plan_dd`` picks, and at that one
a launch's cycles by phase (``cf_cuda.phase_cycles``).  With
``--arrivals`` it times the double-double wrapper's launch at ``plan_dd``'s
plan on the solver's launch shapes (SHAPES_ARRIVALS) with the stream's
arrival counters kept zero from launch to launch (``cached``) and with
counters zeroed for each launch (``zeroed``, one fill kernel more), in
turns: the card's time a launch (CUDA events around LAUNCHES launches
queued behind a sleep, so the card runs them back to back) and the
host's.  The card's name and power limit head the output.  Needs CUDA
and nvcc.

With ``--host`` it measures accuracy on the CPU instead: it builds the
kernel's host twin (the same source, ``g++ -ffp-contract=off``) and the
JAX package's 80-bit CF (``qnmfits_tpu/spectrum/csrc/cf_kernel.cpp``) into
``build/cf_host/`` and prints, at each depth of HOST_CASES, the largest
error against the 80-bit CF relative to |U| + |T| of the host twin at
teams 1, 8, 32 and 256 and of the plain version ``cf_parts``: S1's
distribution (spins to chi = 0.999) at the depths of a grid tier, and
spins at chi = 0.998-0.9995 at the solver's deep tiers and retries, where
it also reads the double-double variant (``cf_dd`` and its host twin) and
times ``cf_dd``; then ``cf_dd``'s seconds a call at B = 2, N = 32768 and
884736.  Then it solves F1's on-demand mode (5,2,8) on the s = -2 table's
spins on the CPU (``spectrum.solver.track_mode``) three times, its CF
evaluated by the FP64 host twin at every spin, by the host twins under
``cf_cuda.leaver_cf``'s rule (double-double beyond chi = 0.985), each with
the team ``cf_cuda.plan`` gives the launch on an H100's 132 SMs, and by
the 80-bit CF, and prints, for each depth tier of the fine pass, how many
points ended converged, softly converged or unconverged
(``chip_smoke.NewtonWatch``; a point unconverged after its tier's last
retry keeps the interpolated coarse track), and the largest gap between
each twin's track and the 80-bit one to chi = 0.985 and beyond.  Needs
g++.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The solver's shapes (B = 2 in the sequential continuation, F1's largest
# grid launch 792 x 8192) and phase 12's S1 corners.
SHAPES = ((1, 2000), (2, 2000), (2, 8192), (17, 2000), (1, 32768),
          (17, 32768), (400, 8192), (792, 8192), (4096, 2000),
          (4096, 32768))
# --extended: the double-double variant's (B, N): the solver's
# near-extremal tiers and their retries, and S1-X's corners.
SHAPES_DD = ((1, 8192), (2, 16384), (16, 8192), (6, 16384), (24, 32768),
             (256, 8192), (2, 98304), (6, 294912), (2, 884736),
             (256, 884736))
# --extended: (team, blocks) whose segment lies outside these steps are not
# timed (plan_dd picks none; a thread takes ~us a double-double step).
DD_SEGMENTS = (2, 1 << 13)
# --arrivals: F1's and a re-solved near-extremal row's double-double
# launch shapes (8 to 13 steps a thread at plan_dd's plan on an H100), and
# the launches timed at once.
SHAPES_ARRIVALS = ((2, 2920), (2, 12650), (16, 8192), (6, 16384),
                   (2, 32768))
LAUNCHES = 100
SEED = 14
# --host: (depth, spin range as chi, batch, seeds); n_inv 0..20.
HOST_CASES = [(N, (0.0, 0.999), 400, (1000, 1001, 1002, 1003))
              for N in (300, 2000, 3001, 8192)] + [
    (N, (0.998, 0.9995), B, (1000, 1001))
    for N, B in ((16384, 24), (49152, 24), (147456, 6), (442368, 2))]
HOST_TEAMS = (1, 8, 32, 256)


def host_builds():
    """The kernel's host twin and the 80-bit CF, built into build/cf_host/
    and bound with ctypes."""
    import ctypes
    from qnmfits_tpu_torch.ops import cf_cuda
    out_dir = os.path.join(ROOT, "build", "cf_host")
    os.makedirs(out_dir, exist_ok=True)
    cf80_so = os.path.join(out_dir, "libcf_kernel_80.so")
    cf80_src = os.path.join(ROOT, "qnmfits_tpu", "spectrum", "csrc",
                            "cf_kernel.cpp")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", cf80_so,
                    cf80_src], check=True, timeout=300)
    twin_so = os.path.join(out_dir, "libleaver_cf_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-ffp-contract=off",
                    "-O2", "-shared", "-fPIC", "-o", twin_so,
                    str(cf_cuda.SOURCE)], check=True, timeout=300)
    ptr = ctypes.c_void_p
    lib = ctypes.CDLL(twin_so)
    twin, twin_dd = lib.qnm_leaver_cf_host, lib.qnm_leaver_cf_dd_host
    for fn, ints in ((twin, 4), (twin_dd, 5)):
        fn.argtypes = ([ctypes.c_longlong] + [ptr] * 6 + [ctypes.c_int] * ints
                       + [ptr] * 3)
    cf80 = ctypes.CDLL(cf80_so).radial_cf_batch
    cf80.argtypes = ([ctypes.c_int] + [ptr] * 5 + [ctypes.c_int] * 2
                     + [ptr, ctypes.c_int, ptr, ptr])
    return twin, twin_dd, cf80


def host_accuracy(twin, twin_dd, cf80):
    """Records of the host twin's and the plain version's largest error
    against the 80-bit CF at each case of HOST_CASES (the --host mode); at
    the near-extremal cases also those of the double-double variant (its
    plain version ``cf_dd`` and its host twin at ``plan_dd``'s team and
    blocks on 132 SMs), and the plain double-double call's seconds."""
    import numpy as np
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    records = []
    for N, (chi_lo, chi_hi), B, seeds in HOST_CASES:
        worst, dd_s = {}, []
        for seed in seeds:
            rng = np.random.default_rng(seed)
            w = 2.0 * (0.3 + 0.6 * rng.random(B)
                       - 1j * (0.05 + 0.6 * rng.random(B)))
            a = 0.5 * (chi_lo + (chi_hi - chi_lo) * rng.random(B))
            A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
            n_inv = rng.integers(0, 21, B).astype(np.int32)
            ins = [np.ascontiguousarray(x) for x in
                   (w.real, w.imag, a, A.real, A.imag)]
            ref = np.empty((2, B))
            cf80(B, *(x.ctypes.data for x in ins), -2, 2, n_inv.ctypes.data,
                 N, ref[0].ctypes.data, ref[1].ctypes.data)
            ref = ref[0] + 1j * ref[1]
            U, T = cf_cuda.cf_parts(torch.as_tensor(w), torch.as_tensor(a),
                                    torch.as_tensor(A), -2, 2,
                                    torch.as_tensor(n_inv), N)
            scale = (U.abs() + T.abs()).numpy()
            errs = {"plain": (U - T).numpy()}
            for team in HOST_TEAMS:
                f = np.empty((3, B))
                if twin(B, *(x.ctypes.data for x in ins), n_inv.ctypes.data,
                        -2, 2, N, team, *(o.ctypes.data for o in f)):
                    raise RuntimeError(f"host twin refused N={N}")
                errs[f"team {team}"] = f[0] + 1j * f[1]
            if chi_lo > cf_cuda.CHI_EXTENDED:
                t = time.perf_counter()
                f_dd, _ = cf_cuda.cf_dd(torch.as_tensor(w), torch.as_tensor(a),
                                        torch.as_tensor(A), -2, 2,
                                        torch.as_tensor(n_inv), N)
                dd_s.append(time.perf_counter() - t)
                errs["plain dd"] = f_dd.numpy()
                f = np.empty((3, B))
                team, blocks, _ = cf_cuda.plan_dd(B, N, 132)
                if twin_dd(B, *(x.ctypes.data for x in ins),
                           n_inv.ctypes.data, -2, 2, N, team, blocks,
                           *(o.ctypes.data for o in f)):
                    raise RuntimeError(f"host twin refused N={N}")
                errs[f"dd team {team} x {blocks} blocks"] = f[0] + 1j * f[1]
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0),
                               float(np.max(np.abs(v - ref) / scale)))
        records.append(dict(N=N, chi=[chi_lo, chi_hi], batch=B,
                            seeds=list(seeds), plain_dd_s=dd_s, **worst))
        print(f"N={N:6d}, chi {chi_lo}-{chi_hi}, {len(seeds)} x {B}, "
              "against the 80-bit CF: " + ", ".join(
                  f"{k} {e:.2e}" for k, e in worst.items())
              + (f"; plain dd {max(dd_s):.2f} s a call" if dd_s else ""),
              flush=True)
    # The plain double-double call alone at the coarse pass's batch (B =
    # 2) at the deepest tier and at the retries' deepest depth.
    for N in (32768, 884736):
        rng = np.random.default_rng(N)
        w = torch.as_tensor(2.0 * (0.3 + 0.6 * rng.random(2)
                                   - 1j * (0.05 + 0.6 * rng.random(2))))
        a = torch.full((2,), 0.499, dtype=torch.float64)
        t = time.perf_counter()
        cf_cuda.cf_dd(w, a, torch.full((2,), 27.0 + 1.0j), -2, 2, 8, N)
        sec = time.perf_counter() - t
        records.append(dict(N=N, batch=2, plain_dd_s=[sec],
                            threads=torch.get_num_threads()))
        print(f"plain dd, B=2, N={N}: {sec:.2f} s a call "
              f"({torch.get_num_threads()} CPU threads)", flush=True)
    return records


def host_track(twin, twin_dd, cf80):
    """F1's (5,2,8) solved on the CPU through the host twins and through
    the 80-bit CF: each tier's convergence and the tracks' gaps (the --host
    mode).  "kernel" follows ``cf_cuda.leaver_cf``'s rule (the
    double-double twin beyond CHI_EXTENDED), "FP64 kernel" the FP64 twin
    at every spin."""
    import numpy as np
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    from qnmfits_tpu_torch.spectrum import solver, tables
    from chip_smoke import NewtonWatch

    def host_cf(by):
        def cf(omega, aL, A, s, m, n_inv, N):
            B = omega.shape[0]
            ins = [np.ascontiguousarray(np.broadcast_to(x, (B,)),
                                        dtype=np.float64)
                   for x in (omega.real.numpy(), omega.imag.numpy(),
                             torch.as_tensor(aL).numpy(), A.real.numpy(),
                             A.imag.numpy())]
            ni = np.ascontiguousarray(np.broadcast_to(
                torch.as_tensor(n_inv).numpy(), (B,)), dtype=np.int32)
            out = np.empty((3, B))
            if by == "80-bit":
                cf80(B, *(x.ctypes.data for x in ins), s, m, ni.ctypes.data,
                     N, out[0].ctypes.data, out[1].ctypes.data)
                return torch.complex(torch.as_tensor(out[0]),
                                     torch.as_tensor(out[1]))
            ext = (2.0 * ins[2] > cf_cuda.CHI_EXTENDED if by == "kernel"
                   else np.zeros(B, bool))
            for sel, fn in ((~ext, twin), (ext, twin_dd)):
                if not sel.any():
                    continue
                sub = [np.ascontiguousarray(x[sel]) for x in ins + [ni]]
                res = np.empty((3, int(sel.sum())))
                plan = (cf_cuda.plan_dd(len(res[0]), N, 132)[:2]
                        if fn is twin_dd
                        else cf_cuda.plan(len(res[0]), N, 132)[:1])
                if fn(len(res[0]), *(x.ctypes.data for x in sub), s, m, N,
                      *plan, *(o.ctypes.data for o in res)):
                    raise RuntimeError(f"host twin refused N={N}")
                out[:, sel] = res
            return torch.complex(torch.as_tensor(out[0]),
                                 torch.as_tensor(out[1]))
        return cf

    chi = np.load(tables.table_path(-2))["chi"]
    seeds = solver.schwarzschild_seeds(l_max=5, n_max=8, s=-2,
                                       n_max_low_l=0, device="cpu")
    tracks, record = {}, {}
    saved = solver.leaver_cf
    try:
        for by in ("FP64 kernel", "kernel", "80-bit"):
            solver.leaver_cf = host_cf(by)
            with NewtonWatch(solver) as watch:
                tracks[by] = solver.track_mode(5, 2, 8, seeds[(5, 8)], chi,
                                               s=-2, device="cpu")[0]
            record[by] = dict(tiers=watch.tiers(),
                              coarse_failed_chi=watch.coarse_failed_chi)
            for t in record[by]["tiers"]:
                print(f"(5,2,8) on the CPU, CF by the {by}: tier {t['tier']}"
                      ": " + "; ".join(
                          f"N={c['N']} {c['points']} points, "
                          f"{c['iterations']} iterations, {c['converged']}"
                          f" converged, {c['soft']} soft, "
                          f"{c['unconverged']} unconverged"
                          for c in t["calls"])
                      + f"; kept the coarse track at chi "
                      f"{t['fell_back_chi']}", flush=True)
    finally:
        solver.leaver_cf = saved
    lo = chi <= cf_cuda.CHI_EXTENDED
    for by in ("FP64 kernel", "kernel"):
        gap = np.abs(tracks[by] - tracks["80-bit"])
        record[by].update(gap_to_0985=float(gap[lo].max()),
                          gap_beyond=float(gap[~lo].max()))
        print(f"(5,2,8): the {by}'s track from the 80-bit one: "
              f"{record[by]['gap_to_0985']:.2e} to chi = 0.985, "
              f"{record[by]['gap_beyond']:.2e} beyond", flush=True)
    return record


def arrivals(rng, sms):
    """--arrivals: the double-double wrapper's launch on SHAPES_ARRIVALS
    with the counters ``cf_cuda._arrivals`` gives (``cached``: one zeroed
    buffer a stream, left zero by every launch) and with counters zeroed
    for each launch (``zeroed``), in turns cached, zeroed, zeroed,
    cached.  The LAUNCHES launches are queued behind torch.cuda._sleep, so
    the events between them time the card's work (the launch and the
    fill kernel) and not the host's."""
    import torch
    import chip_smoke
    from qnmfits_tpu_torch.ops import cf_cuda
    cached = cf_cuda._arrivals

    def zeroed(dev, stream, B):
        with torch.cuda.stream(stream):
            return torch.zeros(B, dtype=torch.int32, device=dev)

    records = []
    for B, N in SHAPES_ARRIVALS:
        inputs = chip_smoke.cf_inputs(rng, B, N, "cuda", chip_smoke.CF_DD_CHI)
        team, blocks, _ = cf_cuda.plan_dd(B, N, sms)
        ref, scale = cf_cuda.cf_dd(*inputs)
        for name, fn in (("cached", cached), ("zeroed", zeroed),
                         ("zeroed", zeroed), ("cached", cached)):
            cf_cuda._arrivals = fn
            try:
                def call():
                    return cf_cuda._launch(*inputs, team, extended=True,
                                           blocks=blocks)
                for _ in range(5):
                    f, _ = call()
                err = float(((f - ref).abs() / scale).max())
                es, e0, e1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
                torch.cuda.synchronize()
                es.record()
                torch.cuda._sleep(100_000_000)
                e0.record()
                t = time.perf_counter()
                for _ in range(LAUNCHES):
                    call()
                host_ms = 1e3 * (time.perf_counter() - t) / LAUNCHES
                e1.record()
                torch.cuda.synchronize()
                ms = e0.elapsed_time(e1) / LAUNCHES
            finally:
                cf_cuda._arrivals = cached
            # The card ran the launches back to back only if the host had
            # queued them all before the sleep ended.
            ahead = LAUNCHES * host_ms < es.elapsed_time(e0)
            records.append(dict(counters=name, batch=B, N=N, team=team,
                                blocks=blocks, ms=ms, host_ms=host_ms,
                                queued_ahead=ahead, rel_err=err))
            print(f"{name} B={B:3d} N={N:6d} ({team} x {blocks}): card "
                  f"{ms:.5f} ms a launch, host {host_ms:.4f} ms "
                  f"(queued ahead: {ahead}), {err:.2e} of |U| + |T|",
                  flush=True)
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records (JSON lines) here")
    ap.add_argument("--host", action="store_true",
                    help="measure the host twin's accuracy on the CPU")
    ap.add_argument("--extended", action="store_true",
                    help="the double-double variant on the card")
    ap.add_argument("--arrivals", action="store_true",
                    help="the double-double launch with cached against "
                         "per-launch zeroed arrival counters")
    args = ap.parse_args()

    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    if args.host:
        builds = host_builds()
        records = host_accuracy(*builds) + [host_track(*builds)]
        if args.out:
            _write(args.out, records)
        return 0
    if not torch.cuda.is_available():
        print("torch_cf_teams: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from qnmfits_tpu_torch.ops import cf_cuda

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    cf_cuda.build()
    print(f"ptxas by kernel and block: {cf_cuda.ptxas_report()}",
          flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)
    ext = args.extended
    if args.arrivals:
        records = arrivals(rng, sms)
        if args.out:
            _write(args.out, records)
        return 0
    records = []
    for B, N in SHAPES_DD if ext else SHAPES:
        inputs = chip_smoke.cf_inputs(rng, B, N, "cuda",
                                      chip_smoke.CF_DD_CHI if ext else None)
        w, a, A, s, m, n_inv, _ = inputs
        if ext:
            ref, ref_scale = cf_cuda.cf_dd(*inputs)
            chosen = cf_cuda.plan_dd(B, N, sms)[:2]
            plans = [p for p in cf_cuda.dd_plans()
                     if DD_SEGMENTS[0] <= -(-N // (p[0] * p[1]))
                     <= DD_SEGMENTS[1] or p == chosen]
        else:
            U, T = cf_cuda.cf_parts(*inputs)
            ref, ref_scale = U - T, U.abs() + T.abs()
            chosen = (cf_cuda.plan(B, N, sms)[0], 1)
            plans = [(team, 1) for team in cf_cuda.TEAMS]
        bound, _ = chip_smoke.cf_bound_ms(B, N, ext)
        for team, blocks in plans:
            def call():
                return cf_cuda._launch(*inputs, team, extended=ext,
                                       blocks=blocks)
            f, scale = call()
            err = float(((f - ref).abs() / ref_scale).max())
            err_scale = float(((scale - ref_scale).abs() / ref_scale).max())
            segment = -(-N // (team * blocks))
            ms = chip_smoke.kernel_ms(call, reps=20 if segment < 4096 else 3,
                                      kernel=chip_smoke._kernel_name(ext))
            rec = dict(extended=ext, batch=B, N=N, team=team, blocks=blocks,
                       segment=segment, planned=(team, blocks) == chosen,
                       rel_err=err, scale_err=err_scale, ms=ms,
                       bound_ms=bound, bound_share=bound / ms)
            records.append(rec)
            mark = "*" if rec["planned"] else " "
            print(f"B={B:5d} N={N:6d} team {team:5d} x {blocks:3d}{mark}"
                  f" segment {segment:5d}: {err:.3e} of |U| + |T| "
                  f"(scale {err_scale:.3e}), {ms:.5f} ms, bound share "
                  f"{rec['bound_share']:.3f}", flush=True)
            if ext and rec["planned"]:
                rec["phases"] = cf_cuda.phase_cycles(*inputs, team, blocks)
                print("  cycles by phase: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in
                    rec["phases"]["cycles"].items())
                    + f"; counts {rec['phases']['counts']}", flush=True)
    worst = {}
    for r in records:
        worst[r["segment"]] = max(worst.get(r["segment"], 0.0), r["rel_err"])
    print("largest error by segment length: " + ", ".join(
        f"{L}: {e:.2e}" for L, e in sorted(worst.items())), flush=True)
    if args.out:
        _write(args.out, records)
    return 0


def _write(path, records):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    sys.exit(main())
