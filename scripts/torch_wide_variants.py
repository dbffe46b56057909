#!/usr/bin/env python3
"""What the wide CUDA solve's second shared-memory stage is worth, on one GPU.

    python3 scripts/torch_wide_variants.py [--out FILE]

Builds ``qnmfits_tpu_torch/csrc/chol_solve.cu`` as it is and a variant
whose launch plan never takes two stages (one stage: the next system's
rows are copied in only after this one is solved), each with nvcc for
sm_90a into ``build/wide_variants/``.  For each it prints the plan (threads,
stages, grid) and the device time (torch.profiler, as
``chip_smoke.device_ms``) on random systems at the sweeps' own batches
(1539 at n = 17, 513 at n = 40 and 96) and at B = 8208 for n = 17, 40 and
64, in turns (as is, one stage, one stage, as is), after checking each
against the plain solve.  The card's name and power limit head the
output.  Needs CUDA and nvcc.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "wide_variants")
EDITS = {
    "as-is": [],
    "one-stage": [("if (!p->global && two <= optin) {", "if (false) {")],
}
SHAPES = ((1539, 17), (513, 40), (513, 96), (8208, 17), (8208, 40),
          (8208, 64))


def build_all():
    """Write and compile every variant in parallel; returns {name: (solve
    entry, plan entry)}."""
    from qnmfits_tpu_torch.ops import chol_cuda
    src = open(chol_cuda.SOURCE).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [chol_cuda._nvcc(), *chol_cuda.NVCC_FLAGS, "-o",
             os.path.join(OUT_DIR, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))
        solve, plan = lib.qnm_regularised_solve_wide, lib.qnm_wide_plan
        solve.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong]
        plan.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_longlong)]
        solve.restype = plan.restype = ctypes.c_int
        built[name] = (solve, plan)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from qnmfits_tpu_torch import engine_real
    from qnmfits_tpu_torch.testing import random_hermitian_systems

    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]]
    built = build_all()
    order = list(EDITS) + list(EDITS)[::-1]
    for B, n in SHAPES:
        G, b = random_hermitian_systems(B, n, seed=B + n, n_pad=n // 4)
        G = torch.as_tensor(G, dtype=torch.complex128, device="cuda")
        b = torch.as_tensor(b, dtype=torch.complex128, device="cuda")
        ref = engine_real._regularised_solve_plain(G, b)
        times = {name: [] for name in EDITS}
        for name in order:
            solve, plan = built[name]
            out = (ctypes.c_longlong * 6)()
            if plan(n, B, G.device.index, out):
                raise RuntimeError(f"{name}: plan failed at n={n}")
            if times[name] == []:
                lines.append(f"B={B} n={n} {name}: threads {out[0]}, stages "
                             f"{out[1]}, grid {out[3]}, shared "
                             f"{out[4]} bytes")
            x = torch.empty_like(b)

            def launch():
                err = solve(G.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                            G.device.index,
                            torch.cuda.current_stream().cuda_stream, None, 0)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            err = chip_smoke.rel_err(x, ref)
            if not err <= chip_smoke.KERNEL_RTOL:
                raise RuntimeError(f"{name} at B={B}, n={n}: relative "
                                   f"error {err}")
            times[name].append(chip_smoke.device_ms(launch))
        for name, ts in times.items():
            lines.append(f"B={B} n={n} {name}: "
                         + ", ".join(f"{t:.5f}" for t in ts)
                         + " ms (device time)")
    lines.append(f"profiles that dropped kernel records: "
                 f"{len(chip_smoke.DROPPED)}, most dropped in one: "
                 f"{max(chip_smoke.DROPPED, default=0)}")
    report = "\n".join(lines)
    print(report, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
