#!/usr/bin/env python3
"""The Leaver CF kernel at every team size, on one GPU: time and error.

    python3 scripts/torch_cf_teams.py [--out FILE]
    python3 scripts/torch_cf_teams.py --host [--out FILE]

Builds ``qnmfits_tpu_torch/csrc/leaver_cf.cu`` (nvcc, sm_90a) and prints
ptxas's registers and spills for each instantiation.  Then, for each (B, N)
of SHAPES, on random inputs of phase 12's S1 distribution
(``chip_smoke.cf_inputs``: spins to chi = 0.999, n_inv 0..8), it runs the
kernel with every team of ``cf_cuda.TEAMS`` and prints, per team, the
segment length (steps a thread), the largest error against the plain
version on the same card relative to |U| + |T|, and the kernel's device
time (torch.profiler, ``chip_smoke.cf_kernel_ms``), marking the team that
``cf_cuda.plan`` picks.  The card's name and power limit head the output.
Needs CUDA and nvcc.

With ``--host`` it measures accuracy on the CPU instead: it builds the
kernel's host twin (the same source, ``g++ -ffp-contract=off``) and the
JAX package's 80-bit CF (``qnmfits_tpu/spectrum/csrc/cf_kernel.cpp``) into
``build/cf_host/`` and prints, at each depth of HOST_CASES, the largest
error against the 80-bit CF relative to |U| + |T| of the host twin at
teams 1, 8, 32 and 256 and of the plain version ``cf_parts``: S1's
distribution (spins to chi = 0.999) at the depths of a grid tier, and
spins at chi = 0.998-0.9995 at the solver's deep tiers and retries.
Then it solves F1's on-demand mode (5,2,8) on the s = -2 table's spins on
the CPU (``spectrum.solver.track_mode``) twice, its CF evaluated once by
the host twin (with the team ``cf_cuda.plan`` gives the launch on an
H100's 132 SMs) and once by the 80-bit CF, and prints, for each depth
tier of the fine pass, how many points ended converged, softly converged
or unconverged (``scripts/torch_cf_ab.py``'s ``NewtonWatch``; a point
unconverged after its tier's last retry keeps the interpolated coarse
track), and the largest gap between the two tracks to chi = 0.985 and
beyond.  Needs g++.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The solver's shapes (B = 2 in the sequential continuation, F1's largest
# grid launch 792 x 8192) and phase 12's S1 corners.
SHAPES = ((1, 2000), (2, 2000), (2, 8192), (17, 2000), (1, 32768),
          (17, 32768), (400, 8192), (792, 8192), (4096, 2000),
          (4096, 32768))
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
    twin = ctypes.CDLL(twin_so).qnm_leaver_cf_host
    twin.argtypes = ([ctypes.c_longlong] + [ptr] * 6 + [ctypes.c_int] * 4
                     + [ptr] * 3)
    cf80 = ctypes.CDLL(cf80_so).radial_cf_batch
    cf80.argtypes = ([ctypes.c_int] + [ptr] * 5 + [ctypes.c_int] * 2
                     + [ptr, ctypes.c_int, ptr, ptr])
    return twin, cf80


def host_accuracy(twin, cf80):
    """Records of the host twin's and the plain version's largest error
    against the 80-bit CF at each case of HOST_CASES (the --host mode)."""
    import numpy as np
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    records = []
    for N, (chi_lo, chi_hi), B, seeds in HOST_CASES:
        worst = {}
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
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0),
                               float(np.max(np.abs(v - ref) / scale)))
        records.append(dict(N=N, chi=[chi_lo, chi_hi], batch=B,
                            seeds=list(seeds), **worst))
        print(f"N={N:6d}, chi {chi_lo}-{chi_hi}, {len(seeds)} x {B}, "
              "against the 80-bit CF: " + ", ".join(
                  f"{k} {e:.2e}" for k, e in worst.items()), flush=True)
    return records


def host_track(twin, cf80):
    """F1's (5,2,8) solved on the CPU through the host twin and through the
    80-bit CF: each tier's convergence and the tracks' gap (the --host
    mode)."""
    import numpy as np
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    from qnmfits_tpu_torch.spectrum import solver, tables
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_cf_ab import NewtonWatch

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
            elif twin(B, *(x.ctypes.data for x in ins), ni.ctypes.data, s,
                      m, N, cf_cuda.plan(B, N, 132)[0],
                      *(o.ctypes.data for o in out)):
                raise RuntimeError(f"host twin refused N={N}")
            return torch.complex(torch.as_tensor(out[0]),
                                 torch.as_tensor(out[1]))
        return cf

    chi = np.load(tables.table_path(-2))["chi"]
    seeds = solver.schwarzschild_seeds(l_max=5, n_max=8, s=-2,
                                       n_max_low_l=0, device="cpu")
    tracks, record = {}, {}
    saved = solver.leaver_cf
    try:
        for by in ("kernel", "80-bit"):
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
    gap = np.abs(tracks["kernel"] - tracks["80-bit"])
    lo = chi <= 0.985
    record.update(gap_to_0985=float(gap[lo].max()),
                  gap_beyond=float(gap[~lo].max()))
    print(f"(5,2,8): the kernel's track from the 80-bit one: "
          f"{record['gap_to_0985']:.2e} to chi = 0.985, "
          f"{record['gap_beyond']:.2e} beyond", flush=True)
    return record


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the records (JSON lines) here")
    ap.add_argument("--host", action="store_true",
                    help="measure the host twin's accuracy on the CPU")
    args = ap.parse_args()

    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    if args.host:
        twin, cf80 = host_builds()
        records = host_accuracy(twin, cf80) + [host_track(twin, cf80)]
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
    print(f"ptxas by largest team: {cf_cuda.ptxas_report()}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(SEED)
    records = []
    for B, N in SHAPES:
        inputs = chip_smoke.cf_inputs(rng, B, N, "cuda")
        w, a, A, s, m, n_inv, _ = inputs
        U, T = cf_cuda.cf_parts(w, a, A, s, m, n_inv, N)
        ref, ref_scale = U - T, U.abs() + T.abs()
        chosen = cf_cuda.plan(B, N, sms)[0]
        bound, _ = chip_smoke.cf_bound_ms(B, N)
        for team in cf_cuda.TEAMS:
            f, scale = cf_cuda._launch(w, a, A, s, m, n_inv, N, team)
            err = float(((f - ref).abs() / ref_scale).max())
            err_scale = float(((scale - ref_scale).abs() / ref_scale).max())
            ms = chip_smoke.cf_kernel_ms(
                lambda: cf_cuda._launch(w, a, A, s, m, n_inv, N, team))
            rec = dict(batch=B, N=N, team=team, segment=-(-N // team),
                       planned=team == chosen, rel_err=err,
                       scale_err=err_scale, ms=ms, bound_ms=bound,
                       bound_share=bound / ms)
            records.append(rec)
            mark = "*" if team == chosen else " "
            print(f"B={B:5d} N={N:6d} team {team:5d}{mark}"
                  f" segment {rec['segment']:5d}: {err:.3e} of |U| + |T| "
                  f"(scale {err_scale:.3e}), {ms:.5f} ms, bound share "
                  f"{rec['bound_share']:.3f}", flush=True)
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
