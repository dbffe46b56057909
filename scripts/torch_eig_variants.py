"""Time the angular eig kernel (``csrc/angular_eig.cu``) against variants of
its own source and launch on the card, each checked against the plain
version first.

Each variant is the source with text substitutions (``VARIANTS``) and/or
other launch settings (matrices a block), built with the wrapper's flags
into ``build/eig_variants/``; ptxas's registers and spills and the
subroutine calls and local-memory instructions in its SASS
(``cuobjdump -sass``) are printed beside its time.  With ``--phases``,
the base source instrumented with clock64 instead: a matrix's cycles in
the Hessenberg reduction, the QR sweeps, the split tests, the shifts and
in all (lane 0 of each warp, summed over a launch).  The shapes: a fine
pass's Newton step of the (2,2,0) row (800 matrices of n = 25, c from the
s = -2 table), the coarse pass's two matrices of n = 28, and 64 of n = 34.
Times by torch.profiler (``chip_smoke.kernel_ms``), in turns over the
variants.

    python3 scripts/torch_eig_variants.py [NAME ...] [--out FILE]
    python3 scripts/torch_eig_variants.py --phases [--out FILE]
"""

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from qnmfits_tpu_torch.ops import chol_cuda, eig_cuda  # noqa: E402
from qnmfits_tpu_torch.testing import eig_matching  # noqa: E402

# The kernel's own source, which each variant edits; the variants' builds
# log beside them, never over the wrapper's own build log.
SOURCE = eig_cuda.SOURCE
eig_cuda.BUILD_LOG = ROOT / "build" / "eig_variants" / "wrapper_build.log"
# name: (source substitutions, matrices a block, extra nvcc flags)
W = eig_cuda.WARPS
VARIANTS = {
    "base": ([], W, ()),
    "warps1": ([], 1, ()),
    "warps2": ([], 2, ()),
    # A higher register cap, and a minimum of one block an SM.
    "maxreg168": ([], W, ("-maxrregcount=168",)),
    # ptxas's default cap: without a minimum of one block an SM.
    "defaultcap": ([("__launch_bounds__(128, 1)", "__launch_bounds__(128)")],
                   W, ()),
    # zlahqr's scaled shift always (two square roots and four divisions
    # more a sweep).
    "scaled_shift": ([("  if (finite(x2u2)) {", "  if (false) {")], W, ()),
    # The Householder reduction over every row below the diagonal, not
    # the column's nonzero rows.
    "full_hessenberg": ([("    const int end = column_end(H, k, n, lane);",
                          "    const int end = n;")], W, ()),
    # The rotation's reciprocal square root by the card's rsqrt (not
    # correctly rounded; no slow path).
    "rsqrt": ([("const double u = 1.0 / sqrt(p);",
                "const double u = rsqrt(p);")], W, ()),
}


# The "phases" build: lane 0 of each warp adds clock64 cycles by phase
# into a device array that qnm_eig_phases copies out (PHASES names them).
PHASES = ("hessenberg", "qr sweeps", "split tests", "shifts", "solve",
          "rotations")
_PHASE_DEFS = """#include <cstdint>
#ifdef __CUDACC__
__device__ unsigned long long qnm_phase_cycles[8];
#endif
#ifdef __CUDA_ARCH__
#define QNM_TIC(v) const long long v = clock64();
#define QNM_TOC(v, i) \\
  if (lane == 0) \\
    atomicAdd(&qnm_phase_cycles[i], (unsigned long long)(clock64() - v));
#else
#define QNM_TIC(v)
#define QNM_TOC(v, i)
#endif
"""
_PHASE_ENTRY = """
#ifdef __CUDACC__
extern "C" int qnm_eig_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(qnm_phase_cycles, z, sizeof z);
  }
  return (int)cudaMemcpyFromSymbol(out, qnm_phase_cycles,
                                   8 * sizeof(unsigned long long));
}
#endif
"""
PHASE_SUBS = [
    ("#include <cstdint>\n", _PHASE_DEFS),
    ("      l = find_split(H, l, i, n, smlnum, lane);",
     "      QNM_TIC(t_split) l = find_split(H, l, i, n, smlnum, lane); "
     "QNM_TOC(t_split, 2)"),
    ("    rotation(f, g, &c, &s, &r);\n",
     "    rotation(f, g, &c, &s, &r);\n#ifdef __CUDA_ARCH__\n"
     "    if (lane == 0) atomicAdd(&qnm_phase_cycles[5], 1ull);\n#endif\n"),
    ("      ++kdefl;", "      QNM_TIC(t_shift) ++kdefl;"),
    ("      qr_sweep(H, l, i, shift, ops, lane);",
     "      QNM_TOC(t_shift, 3) QNM_TIC(t_sweep) "
     "qr_sweep(H, l, i, shift, ops, lane); QNM_TOC(t_sweep, 1)"),
    ("  hessenberg(H, V, n, &ops, lane);",
     "  QNM_TIC(t_hh) hessenberg(H, V, n, &ops, lane); QNM_TOC(t_hh, 0)"),
    ("  const Mat H{mem, n | 1};\n",
     "  QNM_TIC(t_solve) const Mat H{mem, n | 1};\n"),
    ("  if (sweeps >= 0) {\n", "  QNM_TOC(t_solve, 4) if (sweeps >= 0) {\n"),
]


def phases(label, s, m, c, nl):
    """Median-free totals: each phase's cycles summed over the warps of one
    launch (lane 0 of each), and per matrix."""
    import ctypes
    cu, rep = build_variant("phases", PHASE_SUBS, suffix=_PHASE_ENTRY)
    eig_cuda.SOURCE, eig_cuda.WARPS = cu, W
    eig_cuda._lib.cache_clear()
    lib = eig_cuda._lib()
    fn = lib.qnm_eig_phases
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    eig_cuda._launch(s, m, c, nl)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    fn(out, 1)
    eig_cuda._launch(s, m, c, nl)
    torch.cuda.synchronize()
    fn(out, 0)
    B = c.shape[0]
    sweeps = int(eig_cuda.last_info[:, 0].sum())
    per = {p: out[i] / B for i, p in enumerate(PHASES)}
    per.update(per_rotation=out[1] / max(out[5], 1),
               per_sweep_split_shift=(out[2] + out[3]) / max(sweeps, 1))
    print(f"{label} cycles a matrix by phase: "
          + ", ".join(f"{k} {v:.0f}" for k, v in per.items()), flush=True)
    return dict(registers=rep["registers"], cycles_per_matrix=per)


def build_variant(name, subs, flags=(), suffix=""):
    """The variant's library and ptxas report."""
    src = SOURCE.read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    src += suffix
    out_dir = ROOT / "build" / "eig_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"lib{name}.so"
    res = subprocess.run([chol_cuda._nvcc(), *eig_cuda.FLAGS, *flags, "-o",
                          str(lib), str(cu)], capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    regs = re.search(r"Used (\d+) registers", res.stderr)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      res.stderr)
    cuobjdump = Path(chol_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    calls = sorted(set(re.findall(r"CALL\.\w+(?:\.\w+)* [^;]*", sass)))
    lines = sass.splitlines()
    local = [i for i, x in enumerate(lines) if re.search(r"\b(?:STL|LDL)", x)]
    # Where the local-memory instructions sit: the function each is in.
    code = [x.split("*/", 1)[1].split(";")[0].strip() for x in lines
            if re.match(r"\s*/\*[0-9a-f]{4}\*/", x)]
    at = [i for i, x in enumerate(code) if re.match(r"(@\S+ )?(STL|LDL)", x)]
    context = ["\n".join(code[max(0, i - 6):i + 3]) for i in at]
    return cu, dict(registers=int(regs[1]), spill_stores=int(spill[1]),
                    spill_loads=int(spill[2]), sass_calls=calls,
                    local_instructions=len(local), local_context=context)


def shapes():
    z = chip_smoke._table_rows(-2)
    c220 = z["chi"] * z["omega"][z["keys"].index((2, 2, 0))]
    rng = np.random.default_rng(3)
    c34 = 0.68 * 2.39 * (1 + 0.1 * rng.random(64)) - 0.06j
    return [("fine 800 x 25", -2, 2, np.concatenate([c220, c220 + 1e-8]),
             25),
            ("coarse 2 x 28", -2, 2, np.array([0.5 - 0.8j, 0.5 - 0.8j]), 28),
            ("64 x 34", -2, 2, c34, 34)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", action="store_true",
                    help="instead, the base source's cycles by phase")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if args.phases:
        out = {label: phases(label, s, m, torch.as_tensor(c, device="cuda"),
                             nl) for label, s, m, c, nl in shapes()}
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(card=smi, phases=out), f, indent=1)
        return
    built = {}
    for name in args.names:
        subs, warps, flags = VARIANTS[name]
        built[name] = build_variant(name, subs, flags) + (warps,)
        print(name, {k: v for k, v in built[name][1].items()
                     if k != "local_context"}, flush=True)
    results = {name: {} for name in built}
    for label, s, m, c, nl in shapes():
        c = torch.as_tensor(c, device="cuda")
        ref = eig_cuda.eigvals_plain(s, m, c.cpu(), nl).numpy()
        for turn in range(2):
            for name in (built if turn == 0 else reversed(list(built))):
                cu, _, warps = built[name]
                eig_cuda.SOURCE, eig_cuda.WARPS = cu, warps
                eig_cuda._lib.cache_clear()
                ev = eig_cuda._launch(s, m, c, nl)[0]
                _, gap = eig_matching(ev.cpu().numpy(), ref)
                ms = chip_smoke.kernel_ms(
                    lambda: eig_cuda._launch(s, m, c, nl),
                    kernel="angular_eig_kernel")
                rec = results[name].setdefault(label, dict(ms=[]))
                rec["ms"].append(ms)
                rec["max_abs_err"] = float(gap.max())
                rec["sweeps_mean"] = float(
                    eig_cuda.last_info[:, 0].double().mean())
        for name in built:
            r = results[name][label]
            print(f"{label:>14} {name:>10}: {r['ms']} ms, err "
                  f"{r['max_abs_err']:.1e}, {r['sweeps_mean']:.1f} sweeps",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, build={k: v[1] for k, v in
                                            built.items()},
                           results=results), f, indent=1)


if __name__ == "__main__":
    main()
