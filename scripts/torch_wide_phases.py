#!/usr/bin/env python3
"""Where one system's time goes in the wide CUDA solve kernel, on one GPU.

    python3 scripts/torch_wide_phases.py [--out FILE]

Builds a copy of ``qnmfits_tpu_torch/csrc/chol_solve.cu`` with ``clock64``
read by thread 0 of every block at the phase boundaries of its first
system (start; copies landed; dead mask and equilibration done; the first
panel's diagonal block, rows below and trailing update done; factorisation
done; back substitution and output done) into ``build/wide_phases/``
with nvcc for sm_90a, checks it against the plain solve, and prints for
each shape the kernel's device time (torch.profiler, as
``chip_smoke.device_ms``) and the median over blocks of each phase in SM
cycles.  Shapes: one system alone (B = 1), one a block on every SM (B =
132), the sweeps' own batches (1539 at n = 17, 513 at n = 40, 64 and 96),
the last size in shared memory (513 at n = 167) and the global workspace
(1000 at n = 200).  The card's name and power limit head the output.
Needs CUDA and nvcc.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "wide_phases")
PHASES = ("copy", "mask+equilibrate", "diag block 0", "rows below 0",
          "trailing 0", "rest of factor", "back subst.")
# (anchor, text put after it): clock i is read where the i-th edit says.
EDITS = [
    ("template <int T, bool kGlobal>\n__global__",
     "__device__ long long g_clocks[4096 * 8];\n\n"),
    ("  const int warp = t / 32, lane = t & 31;\n",
     "  long long ck[8] = {}; ck[0] = clock64();\n"),
    ("      wait_copies<0>();\n    }\n    __syncthreads();\n",
     "    if (it == 0) ck[1] = clock64();\n"),
    ("    // L y = b', a panel of kPanel columns at a time.\n",
     "    if (it == 0) ck[2] = clock64();\n"),
    ("      __syncthreads();\n      const int k1 = k0 + kPanel;\n",
     "      if (it == 0 && k0 == 0) ck[3] = clock64();\n"),
    ("        rb[i] = r;\n      }\n      __syncthreads();\n",
     "      if (it == 0 && k0 == 0) ck[4] = clock64();\n"),
    ("          *p0 = a0;\n        }\n      }\n      __syncthreads();\n",
     "      if (it == 0 && k0 == 0) ck[5] = clock64();\n"),
    ("    // time from the last: the block's own triangle, then the rows "
     "above.\n", "    if (it == 0) ck[6] = clock64();\n"),
    ("    __syncthreads();   // the next copies overwrite this stage\n",
     "    if (it == 0 && t == 0 && blockIdx.x < 4096) {\n"
     "      ck[7] = clock64();\n"
     "      for (int q = 0; q < 8; ++q)\n"
     "        g_clocks[blockIdx.x * 8 + q] = ck[q];\n"
     "    }\n"),
]
FETCH = ('\nextern "C" int qnm_wide_clocks(long long* out, int blocks) {\n'
         '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
         '      out, g_clocks, blocks * 8 * sizeof(long long)));\n}\n')
SHAPES = ((1, 17), (1, 40), (132, 40), (1539, 17), (513, 40), (513, 64),
          (513, 96), (513, 167), (1000, 200))


def instrumented_source(src):
    """The source with the clock reads put in; each anchor must occur
    once (the first edit's text goes before its anchor)."""
    for i, (anchor, text) in enumerate(EDITS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} is not in the source once")
        src = src.replace(anchor, text + anchor if i == 0 else anchor + text)
    return src + FETCH


def build():
    """Compile the instrumented copy; returns the loaded library."""
    from qnmfits_tpu_torch.ops import chol_cuda
    os.makedirs(OUT_DIR, exist_ok=True)
    cu = os.path.join(OUT_DIR, "chol_solve_phases.cu")
    so = os.path.join(OUT_DIR, "libchol_solve_phases.so")
    with open(cu, "w") as f:
        f.write(instrumented_source(open(chol_cuda.SOURCE).read()))
    res = subprocess.run([chol_cuda._nvcc(), *chol_cuda.NVCC_FLAGS, "-o", so,
                          cu], capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"the instrumented kernel failed to build:\n"
                           f"{res.stderr[-4000:]}")
    lib = ctypes.CDLL(so)
    lib.qnm_wide_plan.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.qnm_regularised_solve_wide.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong])
    lib.qnm_wide_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from qnmfits_tpu_torch import engine_real
    from qnmfits_tpu_torch.testing import random_hermitian_systems

    lines = [subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]]
    print(lines[0], flush=True)
    lib = build()

    def solve(G, b):
        B, n = b.shape
        plan = (ctypes.c_longlong * 6)()
        if lib.qnm_wide_plan(n, B, 0, plan):
            raise RuntimeError("wide plan failed")
        work = torch.empty(max(plan[5], 1), dtype=torch.uint8, device="cuda")
        x = torch.empty_like(b)
        err = lib.qnm_regularised_solve_wide(
            G.data_ptr(), b.data_ptr(), x.data_ptr(), B, n, 0,
            torch.cuda.current_stream().cuda_stream, work.data_ptr(),
            plan[5])
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return x, list(plan)

    for B, n in SHAPES:
        G, b = random_hermitian_systems(B, n, seed=5, n_pad=n // 4)
        G = torch.as_tensor(G, dtype=torch.complex128, device="cuda")
        b = torch.as_tensor(b, dtype=torch.complex128, device="cuda")
        x, plan = solve(G, b)
        torch.cuda.synchronize()
        err = chip_smoke.rel_err(x, engine_real._regularised_solve_plain(G, b))
        if not err <= chip_smoke.KERNEL_RTOL:
            raise RuntimeError(f"instrumented kernel at n={n}, B={B}: "
                               f"relative error {err:.3e}")
        ms = chip_smoke.device_ms(lambda: solve(G, b), reps=10)
        solve(G, b)
        torch.cuda.synchronize()
        blocks = min(plan[3], 4096)
        buf = (ctypes.c_longlong * (blocks * 8))()
        if lib.qnm_wide_clocks(buf, blocks):
            raise RuntimeError("reading the clocks failed")
        ck = np.array(buf[:], dtype=np.int64).reshape(blocks, 8)
        med = np.median(np.diff(ck, axis=1), axis=0)
        line = (f"B={B} n={n} (threads {plan[0]}, stages {plan[1]}, grid "
                f"{plan[3]}): {ms:.4f} ms; median cycles of the first "
                "system: " + ", ".join(f"{p} {c:.0f}"
                                       for p, c in zip(PHASES, med))
                + f"; total {med.sum():.0f}")
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
