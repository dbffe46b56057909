#!/usr/bin/env python3
"""The window moments kernel of one version of the port on one GPU, on
the array optimisers' own inputs.  For comparing two versions in turns.

    python3 scripts/torch_moments_ab.py --label NAME [--root DIR]
                                        [--phases] [--out FILE]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV qnmfits_tpu_torch | tar -x -C DIR``
with this checkout's ``qnmfits_tpu`` linked beside it; this checkout by
default) and drives it with this checkout's ``chip_smoke.py`` at
``chip_smoke.FULL``: O1 (``free_frequency_fit_array``) and O2
(``calculate_epsilon_array``) run once through their public entry points
with the moments' inputs recorded (``chip_smoke.recording_moments``).
Then the kernel is timed by CUDA events around 20 back-to-back launches
of its C entry (``chip_smoke.event_ms``) on four shapes:

* ``o2_order2``: O2's first Newton step (2565 trajectories, order 2);
* ``o2_order0``: O2's first seed stage (45657 trajectories, order 0);
* ``o1_order2``: O1's first Newton step (513 trajectories, order 2);
* ``o2_nonuniform_order2``: O2's Newton inputs on a grid the uniform gate
  refuses (``chip_smoke.nonuniform_copy``).

Each shape's record: ms of the variant the version's wrapper takes, each
variant's ms where the version has several, the bound
(``chip_smoke.moments_bound``, the same count for every version) and its
share, the variant's own bound and share where the version has variants,
and the largest gap from the plain version (of each moment's largest
entry).  A version whose wrapper still takes the trapezoid weights (the
first design) is given them.

With ``--phases``, a launch's cycles by phase on O2's two shapes: for a
version with ``moments_cuda.phase_cycles`` (a warp's, by the new
design's phases: set-up, anchors, operands, mma, epilogue), else (the
first, scalar design) a copy of the version's source with clock64
read by thread 0 of every block at its phase boundaries, built into
``build/moments_phases/<label>/`` (nvcc, the version's own flags): a
block's cycles in the phase build (phases of the tile), the tile loads
(data rows and weights, with the tile's barriers), the accumulation, and
the group reduction and stores (with the entries' set-up).

The JSON line carries the version's ptxas registers and spills where it
has variants.

Prints the card's name and power limit, then one JSON line.  Run each
version in its own process, in turns (A, B, B, A), within one call; the
spread of a version is the difference of its two turns.  Needs CUDA and
nvcc.
"""

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (anchor, text, where) edits of the first design's source for its
# phases: where is "before" or "after" the anchor, which must occur once.
LAP = "{ const long long n_ = clock64(); ck_[%d] += n_ - ck_t; ck_t = n_; }\n"
OLD_EDITS = [
    ("namespace {\n\nconstexpr int THREADS = 256;",
     "__device__ unsigned long long g_ck[8];\n\n", "before"),
    ("  const int n_entries = n_gram + I * J;\n",
     "  long long ck_[4] = {0, 0, 0, 0};\n  long long ck_t = clock64();\n",
     "after"),
    ("      const int nt = min(tile, cnt - kb);\n", LAP % 2, "after"),
    ("      for (int idx = tid; idx < nt * J; idx += THREADS) {\n",
     LAP % 1, "before"),
    ("      for (int idx = tid; idx < nt * I; idx += THREADS) {\n",
     LAP % 0, "before"),
    ("      if (active) {\n        for (int kk = g; kk < nt; kk += groups) {",
     LAP % 1, "before"),
    ("    // The groups' sums, in group order.\n", LAP % 2, "before"),
    ("}\n\ntemplate <int ORDER>\nint launch(",
     LAP % 3 + "  if (tid == 0) {\n"
     "    for (int i_ = 0; i_ < 4; ++i_)\n"
     "      atomicAdd(&g_ck[i_], (unsigned long long)ck_[i_]);\n"
     "    atomicAdd(&g_ck[7], 1ull);\n  }\n", "before"),
]
OLD_PHASES = ("phase build", "tile loads", "accumulation",
              "reduction and store")
OLD_READER = """
extern "C" int qnm_old_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {0};
    return (int)cudaMemcpyToSymbol(g_ck, zero, sizeof zero);
  }
  return (int)cudaMemcpyFromSymbol(out, g_ck, sizeof(unsigned long long) * 8);
}
"""


def record_inputs(problem):
    """{(key, order): the first recorded window_moments inputs} of O1 and
    O2 (``chip_smoke.optimiser_specs``' calls) on the card, as (times,
    rows, omega, t0s, w, win, order) whatever the version's wrapper
    takes."""
    import chip_smoke
    inputs = {}
    for spec in chip_smoke.optimiser_specs(problem, "cuda"):
        if spec["key"] not in ("o1", "o2"):
            continue
        with chip_smoke.recording_moments() as rec:
            spec["kernel"]()
        for order, args in rec.items():
            if len(args) == 8:     # the wrapper took tau before win
                args = args[:5] + args[6:]
            inputs[(spec["key"], order)] = args
    return inputs


def call_args(moments_cuda, a):
    """The version's window_moments arguments for inputs ``a`` (times,
    rows, omega, t0s, w, win, order): the windows' trapezoid weights
    before win where its wrapper takes them."""
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    if "tau" not in inspect.signature(moments_cuda.window_moments).parameters:
        return a
    times, rows, omega, t0s, w, win, order = a
    return (times, rows, omega, t0s, w, trapz_weights(times, w), win, order)


def old_phases(moments_cuda, label, shapes):
    """The first design's block cycles by phase (``OLD_PHASES``) on each
    of ``shapes`` ({name: args}), from an instrumented copy of its
    source."""
    import torch
    from qnmfits_tpu_torch.ops.chol_cuda import NVCC_FLAGS, _nvcc
    text = moments_cuda.SOURCE.read_text()
    for anchor, add, where in OLD_EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found once: {anchor!r}")
        text = text.replace(anchor, add + anchor if where == "before"
                            else anchor + add)
    out_dir = os.path.join(ROOT, "build", "moments_phases", label)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "window_moments_phases.cu")
    with open(src, "w") as f:
        f.write(text + OLD_READER)
    lib_path = os.path.join(out_dir, "libwindow_moments_phases.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, timeout=900)
    lib = ctypes.CDLL(lib_path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qnm_window_moments.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
    lib.qnm_old_phases.argtypes = [ptr, i32]
    res = {}
    for name, args in shapes.items():
        args = call_args(moments_cuda, args)
        times, rows, omega, t0s, w, tau, win, order = args
        first, count = (b.to(torch.int32)
                        for b in moments_cuda.window_bounds(w))
        S, P = moments_cuda.window_moments(*args)
        I, K = rows.shape
        M, J = omega.shape
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            err = lib.qnm_window_moments(
                times.data_ptr(), rows.data_ptr(), omega.data_ptr(),
                t0s.data_ptr(), tau.data_ptr(), first.data_ptr(),
                count.data_ptr(), win.data_ptr(), S.data_ptr(), P.data_ptr(),
                K, I, J, M, order, moments_cuda.tile(I, J, order), stream)
            if err:
                raise RuntimeError(f"instrumented launch failed: {err}")

        launch()
        out = (ctypes.c_ulonglong * 8)()
        lib.qnm_old_phases(out, 1)
        launch()
        torch.cuda.synchronize()
        lib.qnm_old_phases(out, 0)
        n = max(out[7], 1)
        res[name] = {p: out[i] / n for i, p in enumerate(OLD_PHASES)}
        res[name]["blocks"] = out[7]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    ap.add_argument("--phases", action="store_true",
                    help="also a launch's cycles by phase on O2's shapes")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_moments_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, root)
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.ops import moments_cuda
    if not tq.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {tq.__file__}, not the package "
                           f"under {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    variants = "grid" in inspect.signature(moments_cuda._launch).parameters
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    ptxas = moments_cuda.ptxas_report() if variants else None
    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    inputs = record_inputs(problem)
    shapes = {"o2_order2": inputs[("o2", 2)], "o2_order0": inputs[("o2", 0)],
              "o1_order2": inputs[("o1", 2)],
              "o2_nonuniform_order2": chip_smoke.nonuniform_copy(
                  inputs[("o2", 2)])}
    res = {}
    for name, a in shapes.items():
        times, rows, omega, t0s, w, win, order = a
        tau = trapz_weights(times, w)
        first, count = (b.to(torch.int32)
                        for b in moments_cuda.window_bounds(w))
        S, P = moments_cuda.window_moments(*call_args(moments_cuda, a))
        Sp, Pp = moments_cuda.window_moments_plain(*call_args(moments_cuda,
                                                              a))
        rel = max(float((x[:, v, p] - y[:, v, p]).abs().max()
                        / y[:, v, p].abs().max())
                  for x, y in ((S, Sp), (P, Pp)) for v in range(2)
                  for p in range(x.shape[2]))
        rec = dict(M=int(omega.shape[0]), order=order, rel=rel)
        I, K = rows.shape
        weights = 2
        if variants:
            rec["variant"] = moments_cuda.last_plan["variant"]
            grid = moments_cuda.moments_grid(times)
            grids = ({"uniform": grid, "general": (False, 0.0)} if grid[0]
                     else {"general": grid})
            rec["variant_ms"] = {
                v: chip_smoke.event_ms(lambda g=g: moments_cuda._launch(
                    times, rows, omega, t0s, None if g[0] else tau, first,
                    count, win, S, P, order, g))
                for v, g in grids.items()}
            rec["ms"] = rec["variant_ms"][rec["variant"]]
            weights = 1 if grid[0] else 2
        else:
            rec["ms"] = chip_smoke.event_ms(lambda: moments_cuda._launch(
                times, rows, omega, t0s, tau, first, count, win, S, P,
                order))
        for key, wts in (("", 2), ("variant_", weights)):
            flops, nbytes = chip_smoke.moments_bound(
                count.long(), win, K, t0s.shape[0], I, omega.shape[1], order,
                wts)
            rec[f"{key}bound_ms"] = max(
                flops / chip_smoke.FP64_FLOP_PER_S,
                nbytes / chip_smoke.HBM_BYTES_PER_S) * 1e3
            rec[f"{key}bound_share"] = rec[f"{key}bound_ms"] / rec["ms"]
        res[name] = rec
        print(f"{name}: {rec['ms']:.4f} ms ({rec.get('variant_ms', '')}), "
              f"bound {rec['bound_ms']:.4f} ms, share "
              f"{rec['bound_share']:.3f} (the variant's own "
              f"{rec['variant_bound_share']:.3f}), gap from plain {rel:.3e}",
              flush=True)
    phases = None
    if args.phases:
        o2 = {k: shapes[k] for k in ("o2_order2", "o2_order0")}
        if hasattr(moments_cuda, "phase_cycles"):
            phases = {k: moments_cuda.phase_cycles(*a) for k, a in o2.items()}
        else:
            phases = old_phases(moments_cuda, args.label, o2)
        for k, ph in phases.items():
            print(f"phases {k}: {ph}", flush=True)
    line = json.dumps(dict(label=args.label, root=root, card=smi,
                           ptxas=ptxas, shapes=res, phases=phases))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
