#!/usr/bin/env python3
"""The angular eig kernel's launches and F1's on-demand solve with one
version of the port on one GPU: each launch's kernel and call time, and
F1's wall split into the angular eig, the CF and the rest.  For comparing
two versions of the eig kernel (or the version before it), in turns.

    python3 scripts/torch_eig_ab.py --label NAME [--root DIR] [--out FILE]
        [--no-f1] [--s4]

Imports ``qnmfits_tpu_torch`` from DIR (another commit's tree, e.g.
``mkdir -p DIR && git archive REV qnmfits_tpu_torch | tar -x -C DIR`` with
this checkout's ``qnmfits_tpu`` linked beside it for the tables; this
checkout by default) and takes the problem from this checkout's
``chip_smoke.py``.  It builds that version's kernels, warms the card with
the bench's main path and a short on-demand track of (2,2,0) (17 spins to
chi = 0.6), then runs F1 (the bench's (2,2,n<4) set with the on-demand
(5,2,8) through ``mismatch_t0_mode_sets``, dedup on) in a fresh track
cache.  The eig is timed by CUDA events around each call of whichever eig
function that version's solver calls (``angular_eigvals`` /
``angular_eigpair``, or ``_batched_angular_eig``), the CF by CUDA events
around each ``leaver_cf`` call; the rest is the wall less both.  Before F1
(where the version has the kernel) it times the kernel's launches
(``launch_shapes``): the coarse pass's one matrix of n = 25 and two of n =
28, one of n = 28 and two of n = 25, a fine pass's Newton step of 800 x 25
and 64 x 34, in values mode, each held to the plain version
(``chip_smoke.EIG_TOL``), its device time by torch.profiler
(``chip_smoke.kernel_ms``) and the wrapper call's by CUDA events
(``chip_smoke._timed_ms``), with the launch's plan and the wrapper's host
time a call by stage (``host_split``: its checks and allocations, the
kernel's launch, the info's read-back, which waits for the kernel, and
its check), taken by timing the wrapper's calls of its library and of
``check_info`` from outside.

With ``--s4`` it then runs ``chip_smoke.py``'s S4, the m = 2 multiplets'
march (``multiplet_tracks(2, ...)`` on the s = -2 table's spins up to chi
= 0.3), split the same way.

Prints the card's name and power limit, then one JSON line.  Run each
version in its own process, in turns (A, B, B, A), within one call.
Needs CUDA and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EIG_FUNCTIONS = ("angular_eigvals", "angular_eigpair", "_batched_angular_eig")


def launch_shapes(chip_smoke):
    """(label, s, m, c, nl) of each timed launch (values mode): the small
    launches of ``chip_smoke.eig_launch_shapes``, a fine pass's 800 x 25
    along the (2,2,0) row and 64 x 34."""
    import numpy as np
    z = chip_smoke._table_rows(-2)
    c220 = z["chi"] * z["omega"][z["keys"].index((2, 2, 0))]
    rng = np.random.default_rng(3)
    c34 = 0.68 * 2.39 * (1 + 0.1 * rng.random(64)) - 0.06j
    return chip_smoke.eig_launch_shapes() + [
        ("800 x 25", -2, 2, np.concatenate([c220, c220 + 1e-8]), 25),
        ("64 x 34", -2, 2, c34, 34)]


def host_split(eig_cuda, call, reps=20):
    """The wrapper's host ms a call by stage, over reps calls: "prepare"
    (from the call to its library's launch: checks, allocations, the
    guess, the plan), "launch" (the C entry), "read_back" (from there to
    ``check_info``: the info's copy to the host, which waits for the
    kernel) and "check" (the rest).  Times the wrapper's calls of
    ``_lib()`` and ``check_info`` from outside; None where the version
    has no ``check_info``."""
    import time
    if not hasattr(eig_cuda, "check_info"):
        return None
    marks = []
    lib = eig_cuda._lib()
    saved_lib, saved_check = eig_cuda._lib, eig_cuda.check_info

    class Timed:
        def qnm_angular_eig(self, *a):
            marks.append(time.perf_counter())
            err = lib.qnm_angular_eig(*a)
            marks.append(time.perf_counter())
            return err

    def check(*a, **k):
        marks.append(time.perf_counter())
        return saved_check(*a, **k)

    eig_cuda._lib, eig_cuda.check_info = (lambda *a, **k: Timed()), check
    try:
        split = dict(prepare=0.0, launch=0.0, read_back=0.0, check=0.0)
        for _ in range(reps):
            marks.clear()
            t0 = time.perf_counter()
            call()
            t4 = time.perf_counter()
            t1, t2, t3 = marks
            for k, dt in (("prepare", t1 - t0), ("launch", t2 - t1),
                          ("read_back", t3 - t2), ("check", t4 - t3)):
                split[k] += 1e3 * dt / reps
        return split
    finally:
        eig_cuda._lib, eig_cuda.check_info = saved_lib, saved_check


def time_launches(chip_smoke, eig_cuda):
    """Each of ``launch_shapes``' launches: kernel and call ms, the plan,
    the mean QR iterations, the gap to the plain version, and the
    wrapper's host ms by stage (``host_split``)."""
    import numpy as np
    import torch
    from qnmfits_tpu_torch.testing import eig_matching
    out = {}
    for label, s, m, c, nl in launch_shapes(chip_smoke):
        c = torch.as_tensor(c, device="cuda")
        ev = eig_cuda._launch(s, m, c, nl)[0]
        M = eig_cuda.angular_matrices(s, m, c.cpu(), nl)
        fro = np.maximum(1.0, torch.linalg.matrix_norm(M).numpy())
        _, gap = eig_matching(ev.cpu().numpy(),
                              eig_cuda.eigvals_plain(s, m, c.cpu(), nl)
                              .numpy())
        rel = float((gap / fro).max())
        if rel > chip_smoke.EIG_TOL:
            raise RuntimeError(f"{label}: kernel vs plain {rel:.1e}")
        rec = dict(
            ms=chip_smoke.kernel_ms(
                lambda: eig_cuda._launch(s, m, c, nl),
                kernel=getattr(eig_cuda, "KERNELS", "angular_eig_kernel")),
            call_ms=chip_smoke._timed_ms(
                lambda: eig_cuda._launch(s, m, c, nl), "cuda", 20),
            rel_err=rel, plan=eig_cuda.last_plan,
            iterations_mean=float(eig_cuda.last_info[:, 0].double().mean()),
            host_ms=host_split(eig_cuda,
                               lambda: eig_cuda._launch(s, m, c, nl)))
        out[label] = rec
        print(f"{label}: kernel {rec['ms']:.4f} ms, call "
              f"{rec['call_ms']:.4f} ms, {rec['iterations_mean']:.1f} "
              f"iterations, {rel:.1e}; {rec.get('host_ms')}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--root", help="the tree whose qnmfits_tpu_torch to "
                                   "import (default: this checkout)")
    ap.add_argument("--out", help="also append the JSON line to this file")
    ap.add_argument("--no-f1", action="store_true",
                    help="time the kernel's launches only")
    ap.add_argument("--s4", action="store_true",
                    help="also run S4, the m = 2 multiplets' march")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_eig_ab: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root or ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("qnmfits_tpu_torch")]:
        del sys.modules[name]
    import qnmfits_tpu_torch as qt
    from qnmfits_tpu_torch import engine
    from qnmfits_tpu_torch.ops import cf_cuda, chol_cuda, sweep_cuda
    from qnmfits_tpu_torch.spectrum import solver, tables
    if not qt.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {qt.__file__}, not the package under "
                           f"{root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if not args.no_f1:
        for mod in (chol_cuda, cf_cuda, sweep_cuda):
            mod.build()
    try:
        from qnmfits_tpu_torch.ops import eig_cuda
        eig_cuda.build()
    except ImportError:
        eig_cuda = None
    launched = None if eig_cuda is None else time_launches(chip_smoke,
                                                           eig_cuda)
    if args.no_f1:
        line = json.dumps(dict(label=args.label, root=root, card=smi,
                               launches=launched))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        return 0

    problem = chip_smoke.build_problem(**chip_smoke.FULL)
    kw = dict(T_array=problem["T"], spherical_modes=chip_smoke.SPH,
              dedup=True, device="cuda")
    warm_sets = [chip_smoke.F1_SET[:-1]]
    qt.mismatch_t0_mode_sets(problem["times"], problem["data"], warm_sets,
                             chip_smoke.MF, chip_smoke.CHIF, problem["t0s"],
                             **kw)
    seeds = solver.schwarzschild_seeds(l_max=2, n_max=0, s=-2,
                                       device="cuda")
    solver.track_mode(2, 2, 0, seeds[(2, 0)],
                      solver.default_chi_grid(17, 0.6), device="cuda")
    torch.cuda.synchronize()

    events = {"eig": [], "cf": []}
    calls = {"eig": 0, "cf": 0}

    def timed(kind, fn):
        def run(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            events[kind].append(ev)
            calls[kind] += 1
            return out
        return run

    saved = {n: getattr(solver, n) for n in EIG_FUNCTIONS + ("leaver_cf",)
             if hasattr(solver, n)}
    for name, fn in saved.items():
        setattr(solver, name, timed("cf" if name == "leaver_cf" else "eig",
                                    fn))
    if eig_cuda is not None:
        eig_cuda.launches = 0
    tables.TRACK_CACHE = tempfile.mkdtemp(prefix="qnm_track_cache_")
    if (5, 2, 8) in engine.default_tables().row:
        raise RuntimeError("F1: (5,2,8) is already in the tables")
    t = time.perf_counter()
    mm = qt.mismatch_t0_mode_sets(problem["times"], problem["data"],
                                  [chip_smoke.F1_SET], chip_smoke.MF,
                                  chip_smoke.CHIF, problem["t0s"], **kw)
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    secs = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
            for k, v in events.items()}
    f1_calls = dict(calls)
    f1_launches = None if eig_cuda is None else eig_cuda.launches
    s4 = None
    if args.s4:
        from qnmfits_tpu_torch.spectrum.multiplets import multiplet_tracks
        z = chip_smoke._table_rows(-2)
        chi = z["chi"][z["chi"] <= 0.3]
        for v in events.values():
            v.clear()
        made = None if eig_cuda is None else eig_cuda.launches
        t = time.perf_counter()
        tracks = multiplet_tracks(2, chi, s=-2, verbose=False,
                                  device="cuda")
        s4_wall = time.perf_counter() - t
        torch.cuda.synchronize()
        s4_secs = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                   for k, v in events.items()}
        s4 = dict(wall_s=s4_wall, eig_s=s4_secs["eig"], cf_s=s4_secs["cf"],
                  rest_s=s4_wall - s4_secs["eig"] - s4_secs["cf"],
                  labels=sorted(tracks),
                  eig_launches=None if made is None
                  else eig_cuda.launches - made)
    for name, fn in saved.items():
        setattr(solver, name, fn)
    line = json.dumps(dict(
        label=args.label, root=root, card=smi, wall_s=wall,
        eig_s=secs["eig"], cf_s=secs["cf"],
        rest_s=wall - secs["eig"] - secs["cf"], eig_calls=f1_calls["eig"],
        cf_calls=f1_calls["cf"], eig_launches=f1_launches,
        launches=launched, s4=s4,
        finite=bool(np.all(np.isfinite(mm)))))
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
