"""Time the angular eig kernel (``csrc/angular_eig.cu``) against variants of
its own source and launch on the card, each checked against the plain
version first.

A variant is the source with text substitutions and/or another launch
plan (``VARIANTS``: matrices a block, warps a matrix), built with the
wrapper's flags into ``build/eig_variants/``; ptxas's registers and
spills and the subroutine calls and local-memory instructions in its SASS
(``cuobjdump -sass``) are printed beside its time.  With ``--phases``, a
matrix's cycles by phase instead, from the wrapper's phases build
(``eig_cuda.phase_cycles``), with one warp and with a team of two warps a
matrix.  The shapes: a fine pass's Newton step of the (2,2,0) row (800
matrices of n = 25, c from the s = -2 table), the coarse pass's one
matrix of n = 25 and two of n = 28, and 64 of n = 34.  Times by
torch.profiler (``chip_smoke.kernel_ms``), in turns over the variants.

    python3 scripts/torch_eig_variants.py [NAME ...] [--out FILE]
    python3 scripts/torch_eig_variants.py --phases [--out FILE]
"""

import argparse
import contextlib
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
VARIANT_DIR = ROOT / "build" / "eig_variants"


@contextlib.contextmanager
def wrapper_on(cu, warps):
    """eig_cuda launching the library of source ``cu`` (its build log in
    VARIANT_DIR) with at most ``warps`` warps a block; restored after."""
    saved = eig_cuda.SOURCE, eig_cuda.WARPS, eig_cuda.BUILD_LOG
    eig_cuda.SOURCE, eig_cuda.WARPS = cu, warps
    eig_cuda.BUILD_LOG = VARIANT_DIR / "wrapper_build.log"
    eig_cuda._lib.cache_clear()
    eig_cuda.plan.cache_clear()
    try:
        yield
    finally:
        eig_cuda.SOURCE, eig_cuda.WARPS, eig_cuda.BUILD_LOG = saved
        eig_cuda._lib.cache_clear()
        eig_cuda.plan.cache_clear()


# name: (source substitutions, warps a block, warps a matrix (None: the
# plan's), extra nvcc flags)
W = eig_cuda.WARPS
VARIANTS = {
    "base": ([], W, None, ()),
    # One warp a matrix at every batch (the plan's for more than
    # TEAM_MAX_B matrices), and a team of two at every batch.
    "team1": ([], W, 1, ()),
    "team2": ([], W, 2, ()),
    "warps1": ([], 1, 1, ()),
    "warps2": ([], 2, 1, ()),
    # ptxas's default cap: without a minimum of one block an SM.
    "defaultcap": ([("__launch_bounds__(128, 1)", "__launch_bounds__(128)")],
                   W, None, ()),
    # zlahqr's scaled shift always (two square roots and four divisions
    # more a sweep).
    "scaled_shift": ([("  if (finite(x2u2)) {", "  if (false) {")], W, 1,
                     ()),
    # Two columns and rows a lane below order 32 too (as from 32 to 63).
    "slots2": ([("  else\n    qr_sweep_slots<1>(H, l, i, shift, ops, lane);",
                 "  else\n    qr_sweep_slots<2>(H, l, i, shift, ops, lane);")],
               W, None, ()),
    # The rotation's reciprocal square root by IEEE sqrt and division, not
    # Newton's iteration.
    "ieee_rsqrt": ([("  const double u = rsqrt_newton(p);",
                     "  const double u = 1.0 / sqrt(p);")], W, None, ()),
}


def build_variant(name, subs, flags=()):
    """The variant's library and ptxas report."""
    src = SOURCE.read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in the source")
        src = src.replace(old, new)
    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    cu = VARIANT_DIR / f"{name}.cu"
    cu.write_text(src)
    lib = VARIANT_DIR / f"lib{name}.so"
    res = subprocess.run([chol_cuda._nvcc(), *eig_cuda.FLAGS, *flags, "-o",
                          str(lib), str(cu)], capture_output=True, text=True,
                         timeout=600)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr[-3000:]}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", res.stderr)]
    spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       res.stderr)
    cuobjdump = Path(chol_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    calls = sorted(set(re.findall(r"CALL\.\w+(?:\.\w+)* [^;]*", sass)))
    local = [x for x in sass.splitlines() if re.search(r"\b(?:STL|LDL)", x)]
    return cu, dict(registers=regs,
                    spill_bytes=sum(int(a) + int(b) for a, b in spill),
                    sass_calls=calls, local_instructions=len(local))


def shapes():
    z = chip_smoke._table_rows(-2)
    c220 = z["chi"] * z["omega"][z["keys"].index((2, 2, 0))]
    rng = np.random.default_rng(3)
    c34 = 0.68 * 2.39 * (1 + 0.1 * rng.random(64)) - 0.06j
    return [("fine 800 x 25", -2, 2, np.concatenate([c220, c220 + 1e-8]),
             25),
            ("coarse 1 x 25", -2, 2, c220[200:201], 25),
            ("coarse 2 x 28", -2, 2, np.array([0.5 - 0.8j, 0.5 - 0.8j]), 28),
            ("64 x 34", -2, 2, c34, 34)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", action="store_true",
                    help="instead, a matrix's cycles by phase")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if args.phases:
        out = {}
        for label, s, m, c, nl in shapes():
            c = torch.as_tensor(c, device="cuda")
            for team in (1, 2):
                cyc = eig_cuda.phase_cycles(s, m, c, nl, team=team)
                out[f"{label}, team {team}"] = cyc
                print(f"{label}, team {team}, cycles a matrix by phase: "
                      + ", ".join(f"{k} {v:.0f}" for k, v in cyc.items()
                                  if v is not None), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(card=smi, phases=out), f, indent=1)
        return
    built = {}
    for name in args.names:
        subs, warps, team, flags = VARIANTS[name]
        built[name] = build_variant(name, subs, flags) + (warps, team)
        print(name, built[name][1], flush=True)
    results = {name: {} for name in built}
    for label, s, m, c, nl in shapes():
        c = torch.as_tensor(c, device="cuda")
        ref = eig_cuda.eigvals_plain(s, m, c.cpu(), nl).numpy()
        for turn in range(2):
            for name in (built if turn == 0 else reversed(list(built))):
                cu, _, warps, team = built[name]
                with wrapper_on(cu, warps):
                    ev = eig_cuda._launch(s, m, c, nl, team=team)[0]
                    _, gap = eig_matching(ev.cpu().numpy(), ref)
                    ms = chip_smoke.kernel_ms(
                        lambda: eig_cuda._launch(s, m, c, nl, team=team),
                        kernel=eig_cuda.KERNELS)
                    sweeps = float(eig_cuda.last_info[:, 0].double().mean())
                    plan = dict(eig_cuda.last_plan)
                rec = results[name].setdefault(label, dict(ms=[]))
                rec["ms"].append(ms)
                rec.update(max_abs_err=float(gap.max()), sweeps_mean=sweeps,
                           plan=plan)
        for name in built:
            r = results[name][label]
            print(f"{label:>14} {name:>12}: {r['ms']} ms, err "
                  f"{r['max_abs_err']:.1e}, {r['sweeps_mean']:.1f} sweeps, "
                  f"team {r['plan']['team']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, build={k: v[1] for k, v in
                                            built.items()},
                           results=results), f, indent=1)


if __name__ == "__main__":
    main()
