#!/usr/bin/env python3
"""What the CUDA solve kernel's design choices are worth, on one GPU.

    python3 scripts/torch_solve_variants.py [--out FILE]

Builds ``qnmfits_tpu_torch/csrc/chol_solve.cu`` as it is and three
variants made from it by a textual edit, each with nvcc for sm_90a into
``build/solve_variants/``:

* ``ieee``: the pivot's reciprocal square root and the reciprocal of the
  diagonal as IEEE-rounded ``1.0 / sqrt(x)`` and ``1.0 / x``, as the plain
  PyTorch version computes them;
* ``free-registers``: ``__launch_bounds__`` without its minimum of 4 blocks
  an SM, so ptxas picks the register count itself;
* ``copy-only``: no solve; each lane stores its entry of b as x, so the
  kernel only moves the data (its result is not checked).

For each it prints ptxas's registers and spills at n = 8 and the largest
spill over n = 1..16 (the team kernel; the wide kernel of n >= 17 is
built alongside and left out of the report), and the device time (torch.profiler, as
``chip_smoke.device_ms``) on random systems at the main path's shapes
(n = 8: 8208 systems with dedup, 131072 without), in turns (as is,
variants, variants, as is), after checking each against the plain solve.
The card's name and power limit head the output.  Needs CUDA and nvcc.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "solve_variants")
EDITS = {
    "as-is": [],
    "ieee": [("rsqrt(a[k].x)", "1.0 / sqrt(a[k].x)"),
             ("inv = fma(rs, fma(-a[k].x, rs, 1.0), rs);",
              "inv = 1.0 / a[k].x;")],
    "free-registers": [("__launch_bounds__(kThreads, 4)",
                        "__launch_bounds__(kThreads)")],
    "copy-only": [("// At most 128 registers a thread",
                   "template <int N>\n__device__ double2 copy_only("
                   "const double2*, const double2* r, int lane) {\n"
                   "  return r[lane < N ? lane : 0];\n}\n\n"
                   "// At most 128 registers a thread"),
                  ("const double2 xv = solve_system<N>(",
                   "const double2 xv = copy_only<N>(")],
}
SHAPES = ((8208, 8), (131072, 8))


def build_all():
    """Write and compile every variant in parallel; returns {name: (entry
    function, ptxas report {n: (registers, spill bytes)})}."""
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
        report = {}
        for block in log.split("Compiling entry function")[1:]:
            team = re.search(r"regularised_solve_kernelILi(\d+)E", block)
            if team is None:
                continue                       # the wide kernel
            n = int(team[1])
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", block)
            regs = int(re.search(r"Used (\d+) registers", block)[1])
            report[n] = (regs, max(int(spill[1]), int(spill[2])))
        fn = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so")
                         ).qnm_regularised_solve
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        built[name] = (fn, report)
    return built


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_solve_variants: no CUDA device", file=sys.stderr)
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
    for name, (_, report) in built.items():
        lines.append(f"{name}: n = 8 {report[8][0]} registers, spill "
                     f"{report[8][1]} bytes; largest spill over n = 1..16 "
                     f"{max(s for _, s in report.values())} bytes")
    order = list(EDITS) + list(EDITS)[::-1]
    for B, n in SHAPES:
        G, b = random_hermitian_systems(B, n, seed=B, n_pad=n // 4)
        G = torch.as_tensor(G, dtype=torch.complex128, device="cuda")
        b = torch.as_tensor(b, dtype=torch.complex128, device="cuda")
        ref = engine_real._regularised_solve_plain(G, b)
        times = {name: [] for name in EDITS}
        for name in order:
            fn = built[name][0]
            x = torch.empty_like(b)

            def launch():
                err = fn(G.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                         G.device.index,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            err = chip_smoke.rel_err(x, ref)
            if name != "copy-only" and not err <= chip_smoke.KERNEL_RTOL:
                raise RuntimeError(f"{name} at B={B}: relative error {err}")
            times[name].append(chip_smoke.device_ms(launch))
        for name, ts in times.items():
            lines.append(f"B={B} n={n} {name}: "
                         + ", ".join(f"{t:.5f}" for t in ts)
                         + " ms (device time)")
    report = "\n".join(lines)
    print(report, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
