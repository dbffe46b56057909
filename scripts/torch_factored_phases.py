#!/usr/bin/env python3
"""Where a block's time goes in the factored sweep's systems kernel, on one
GPU, for one version of the port.

    python3 scripts/torch_factored_phases.py --label NAME [--root DIR]
                                             [--out FILE]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV | tar -x -C DIR``; this checkout by
default), records the systems kernel's inputs on factored paths (by
default the main path's two sweeps, ``chip_smoke.sweep`` at
``chip_smoke.FULL`` with dedup on and off; ``--path`` takes any keys of
``scripts/torch_factored_ab.py``, the first join group of each) through
``chip_smoke.recording_sweeps``, and times that version's kernel on them
by torch.profiler (``chip_smoke.kernel_ms``).  Then it builds a
copy of that version's ``csrc/factored_sweep.cu`` with ``clock64`` read by
thread 0 of every block at the phase boundaries into
``build/factored_phases/<label>/`` (nvcc, the version's own flags), swaps
it in for the version's library, checks its outputs against the plain
version, and prints for each sweep the median over blocks of each phase's
SM cycles, a phase's cycles added up over the block's passes and rounds:

* span: the chunk's (or, in the first version, the block's) windows and
  the samples they span;
* tile sums: the basis and its products over the block's share of the
  span, summed by tile (first version: the basis tile by tile);
* cluster sync: the waits on the cluster's barrier (before the first
  remote read of a pass, between passes, and before the block leaves;
  none in the first version);
* window sums: the round's windows, their common interior and their own
  whole tiles (first version: every window's sum of every sample);
* edges: the per-sample values of the round's head and tail tiles and
  the partial edge tiles (first version: the trapezoid's two edge
  samples, made again by each thread);
* mixing: the trapezoid, dnorm and mu^H . into rhs and rt;
* gram hoist: each window's phases and the (j, l) ladders and mixing
  (none in the first version);
* grams + writes: the Gram entries and their stores.

The card's name and power limit head the output, one JSON line ends it.
Run each version in its own process.  Needs CUDA and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("span", "tile sums", "cluster sync", "window sums", "edges",
          "mixing", "gram hoist", "grams + writes")
MAX_BLOCKS = 16384
LAP = "{ const long long n_ = clock64(); ck_[%d] += n_ - ck_t; ck_t = n_; }\n"
START = "long long ck_[8] = {}; long long ck_t = clock64();\n"
STORE = ("  if (threadIdx.x == 0) {\n"
         "    const long long b_ = (long long)blockIdx.y * gridDim.x"
         " + blockIdx.x;\n"
         "    if (b_ < %d)\n"
         "      for (int i_ = 0; i_ < 8; ++i_) g_clocks[b_ * 8 + i_] = ck_[i_];\n"
         "  }\n" % MAX_BLOCKS)
# (anchor, text, where): where is "before" or "after" the anchor, which
# must occur once in the source.
EDITS_TILED = [
    ("// The Gram values of pair g0 + e = (j, l)",
     "__device__ long long g_clocks[%d * 8];\n\n" % MAX_BLOCKS, "before"),
    ("  unsigned char* sm = shared_buffer();\n", START, "after"),
    ("  c.k_lo = misc[LO];\n", LAP % 0, "before"),
    ("      __syncthreads();                      // (an arrive is no barrier)\n",
     LAP % 1, "after"),
    ("        // The partial edge tiles from per-sample values, NSLOT at a "
     "time.\n", LAP % 3, "before"),
    ("        if (!waited) {                      // the cluster's tile sums\n",
     LAP % 4, "before"),
    ("          waited = true;\n", LAP % 2, "after"),
    ("        // The trapezoid: dlt times the window sum less half of the "
     "two\n", LAP % 3, "before"),
    ("        __syncthreads();                    // the round's smem is "
     "rewritten\n", LAP % 5, "after"),
    ("      if (!waited) cluster_wait();          // a block with no windows\n",
     LAP % 2, "after"),
    ("        cluster_arrive();\n        cluster_wait();\n", LAP % 2,
     "after"),
    ("  cluster_arrive();\n\n", LAP % 2, "after"),
    ("      // A thread takes one pair over vpt consecutive windows, and makes\n",
     LAP % 6, "before"),
    ("      __syncthreads();                      // levels and phases "
     "rewritten\n", LAP % 7, "after"),
    ("  cluster_wait();           // no block leaves while another reads its "
     "tiles\n", LAP % 2, "after"),
    ("\n}\n\nstruct Epilogue {", STORE, "before1"),
]
EDITS_FIRST = [
    ("__global__ void __launch_bounds__(THREADS)\nfactored_systems_kernel",
     "__device__ long long g_clocks[%d * 8];\n\n" % MAX_BLOCKS, "before"),
    ("  const int tid = threadIdx.x;\n  const int w = tid / NQ, q = tid % NQ;\n",
     START, "after"),
    ("  const int k_lo = span[0], k_hi = span[1];\n", LAP % 0, "before"),
    ("        __syncthreads();                    // the last tile is read\n",
     LAP % 3, "after"),
    ("        if (m > 0) {\n          const int kl", LAP % 1, "before"),
    ("      // The trapezoid: dlt times the window sum less half of the two "
     "edge\n", LAP % 3, "before"),
    ("      // rhs = mu^H pd, rt = mu^H pdt:", LAP % 4, "before"),
    ("      __syncthreads();                      // sm_pd is rewritten next "
     "pass\n", LAP % 5, "after"),
    ("  const int JJ = p.J * p.J;\n", LAP % 5, "before"),
    ("\n}\n\nstruct Epilogue {", LAP % 7 + STORE, "before1"),
]
FETCH = ('\nextern "C" int qnm_phase_clocks(long long* out, int blocks) {\n'
         '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
         '      out, g_clocks, blocks * 8 * sizeof(long long)));\n}\n'
         'extern "C" int qnm_phase_clear() {\n'
         '  static long long zero[%d * 8];\n'
         '  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero,\n'
         '      sizeof(zero)));\n}\n' % MAX_BLOCKS)


def instrumented_source(src):
    """The source with the clock reads put in: the tiled design's edits or
    the first version's, whichever the source is."""
    edits = EDITS_TILED if "make_products" in src else EDITS_FIRST
    for anchor, text, where in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} is not in the source once")
        if where == "after":
            src = src.replace(anchor, anchor + text)
        elif where == "before1":
            src = src.replace(anchor, "\n" + text + anchor[1:])
        else:
            src = src.replace(anchor, text + anchor)
    return src + FETCH


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--path", nargs="+", default=["main", "main_nodedup"],
                    help="the factored paths whose inputs to take "
                         "(scripts/torch_factored_ab.py's keys; the first "
                         "join group of each)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_factored_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, root)
    import qnmfits_tpu_torch
    from qnmfits_tpu_torch.ops import chol_cuda, sweep_cuda
    if not qnmfits_tpu_torch.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {qnmfits_tpu_torch.__file__}, not "
                           f"the package under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    chol_cuda.build()
    sweep_cuda.build()
    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    from torch_factored_ab import path_calls
    paths = path_calls(problem)
    inputs = {}
    for key in args.path:
        with chip_smoke.recording_sweeps() as calls:
            paths[key]()
        inputs[key] = calls["systems"][0][0]
    ms = {k: chip_smoke.kernel_ms(lambda a=a: sweep_cuda.factored_systems(*a),
                                  kernel="factored_systems_kernel")
          for k, a in inputs.items()}

    out_dir = os.path.join(ROOT, "build", "factored_phases", args.label)
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "factored_sweep_phases.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source(open(sweep_cuda.SOURCE).read()))
    # The version's wrapper builds and binds the instrumented copy.
    from pathlib import Path
    sweep_cuda.SOURCE = Path(cu)
    sweep_cuda.BUILD_DIR = Path(out_dir)
    sweep_cuda.BUILD_LOG = Path(out_dir) / "build.log"
    sweep_cuda._lib.cache_clear()
    lib = ctypes.CDLL(str(sweep_cuda.build()))
    lib.qnm_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    report = sweep_cuda.ptxas_report()

    record = dict(label=args.label, root=root, card=smi,
                  registers={k: v["registers"] for k, v in report.items()},
                  phases=PHASES, sweeps={})
    for key, a in inputs.items():
        if lib.qnm_phase_clear():
            raise RuntimeError("clearing the clocks failed")
        got = sweep_cuda.factored_systems(*a)
        torch.cuda.synchronize()
        ref = sweep_cuda.factored_systems_plain(*a)
        rel = max(chip_smoke.per_system_rel(x, y, 2 if y.dim() > 1 else 1)
                  for x, y in zip(got, ref))
        if not rel <= chip_smoke.SYSTEMS_RTOL:
            raise RuntimeError(f"instrumented kernel ({key}): "
                               f"{rel:.3e} from the plain version")
        buf = (ctypes.c_longlong * (MAX_BLOCKS * 8))()
        if lib.qnm_phase_clocks(buf, MAX_BLOCKS):
            raise RuntimeError("reading the clocks failed")
        ck = np.array(buf[:], dtype=np.int64).reshape(MAX_BLOCKS, 8)
        ck = ck[ck.sum(axis=1) > 0]           # blocks that ran to the end
        med = np.median(ck, axis=0)
        total = float(np.median(ck.sum(axis=1)))
        plan = getattr(sweep_cuda, "last_plan", None)
        record["sweeps"][key] = dict(
            windows=int(a[4].shape[0]), ms=ms[key], blocks=len(ck),
            median_cycles=dict(zip(PHASES, med.tolist())),
            median_total=total, rel=rel, plan=plan)
        print(f"{key} ({a[4].shape[0]} windows): {ms[key]:.4f} ms "
              f"(torch.profiler); {len(ck)} blocks; median cycles "
              + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, med))
              + f"; median total {total:.0f}", flush=True)
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
