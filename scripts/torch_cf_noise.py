#!/usr/bin/env python3
"""Why lockstep Newton stalls near extremal spin: the Leaver CF's rounding
noise against its derivative, in FP64 and in double-double, at the
on-demand (5,2,8)'s and at (3,-3,5)'s points beyond chi = 0.985.

    python3 scripts/torch_cf_noise.py --host [--out FILE]   # the CPU
    python3 scripts/torch_cf_noise.py [--out FILE]          # one GPU

At each of the s = -2 table's 12 spins beyond ``cf_cuda.CHI_EXTENDED``,
omega and A are the 80-bit roots (the (5,2,8) pins of
``chip_smoke.PIN_528``, from the JAX package's 80-bit solve; (3,-3,5) the
table's row, which that solve baked) and the depth is the fine pass's tier
there (``solver.track_mode``).  For the FP64 and the double-double CF (the
kernel's host twins, built by g++ into ``build/cf_host/``, with ``--host``;
the kernel itself on the card, each with ``cf_cuda.plan``'s team, or
``plan_dd``'s team and blocks) it prints:

* S = |U| + |T| and |f| at the root;
* |f'| by the solver's quotient (h = 1e-8, A re-solved at omega + h by
  ``solver._angular_pair``, as ``_newton_coupled_vec_a`` does);
* the spread of f over omega + j ulp(Re omega), j = -4..4, at A(omega),
  less f' j ulp: the largest difference between two of the nine;
* the quotient's relative error against a centred difference (h = 1e-6)
  of the 80-bit CF (``--host``) or of the double-double kernel (the card);
* spread / |f'| beside the step the soft bar accepts, 1e-9 max(1,
  |omega_L|) (omega_L = 2 omega).

The card's name and power limit head the card's output.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H = 1e-8            # solver.py's quotient step
H_CENTRED = 1e-6
ULPS = 4


def host_cfs():
    """The FP64 and double-double host twins and the 80-bit CF, each as
    f(w, a, A, s, m, n_inv, N) -> (f, |U| + |T| or None) on numpy."""
    from qnmfits_tpu_torch.ops import cf_cuda
    out_dir = os.path.join(ROOT, "build", "cf_host")
    os.makedirs(out_dir, exist_ok=True)
    cf80_so = os.path.join(out_dir, "libcf_kernel_80.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", cf80_so,
                    os.path.join(ROOT, "qnmfits_tpu", "spectrum", "csrc",
                                 "cf_kernel.cpp")], check=True, timeout=300)
    twin_so = os.path.join(out_dir, "libleaver_cf_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-ffp-contract=off",
                    "-O2", "-shared", "-fPIC", "-o", twin_so,
                    str(cf_cuda.SOURCE)], check=True, timeout=300)
    ptr = ctypes.c_void_p
    twin = ctypes.CDLL(twin_so)
    cf80 = ctypes.CDLL(cf80_so).radial_cf_batch
    cf80.argtypes = ([ctypes.c_int] + [ptr] * 5 + [ctypes.c_int] * 2
                     + [ptr, ctypes.c_int, ptr, ptr])

    def bind(fn, extended):
        fn.argtypes = ([ctypes.c_longlong] + [ptr] * 6
                       + [ctypes.c_int] * (5 if extended else 4) + [ptr] * 3)

        def run(w, a, A, s, m, n_inv, N):
            B = len(w)
            ins = [np.ascontiguousarray(x, dtype=np.float64)
                   for x in (w.real, w.imag, a, A.real, A.imag)]
            ni = np.full(B, n_inv, dtype=np.int32)
            out = np.empty((3, B))
            plan = (cf_cuda.plan_dd(B, N, 132)[:2] if extended
                    else cf_cuda.plan(B, N, 132)[:1])
            if fn(B, *(x.ctypes.data for x in ins), ni.ctypes.data, s, m, N,
                  *plan, *(o.ctypes.data for o in out)):
                raise RuntimeError(f"host twin refused N={N}")
            return out[0] + 1j * out[1], out[2]
        return run

    def run80(w, a, A, s, m, n_inv, N):
        B = len(w)
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.full(B, n_inv, dtype=np.int32)
        out = np.empty((2, B))
        cf80(B, *(x.ctypes.data for x in ins), s, m, ni.ctypes.data, N,
             out[0].ctypes.data, out[1].ctypes.data)
        return out[0] + 1j * out[1], None

    return dict(fp64=bind(twin.qnm_leaver_cf_host, False),
                dd=bind(twin.qnm_leaver_cf_dd_host, True)), run80


def card_cfs():
    """The kernel's two variants on the card, and the double-double one as
    the centred difference's reference."""
    import torch
    from qnmfits_tpu_torch.ops import cf_cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bind(extended):
        def run(w, a, A, s, m, n_inv, N):
            B = len(w)
            team, blocks = (cf_cuda.plan_dd(B, N, sms)[:2] if extended
                            else (cf_cuda.plan(B, N, sms)[0], 1))
            f, scale = cf_cuda._launch(
                torch.as_tensor(w, device="cuda"),
                torch.as_tensor(a, device="cuda"),
                torch.as_tensor(A, device="cuda"), s, m, n_inv, N, team,
                extended=extended, blocks=blocks)
            return f.cpu().numpy(), scale.cpu().numpy()
        return run

    return dict(fp64=bind(False), dd=bind(True)), bind(True)


def points():
    """(mode, chi, omega (M = 1), A, tier) at the table's spins beyond
    CHI_EXTENDED."""
    import chip_smoke
    from qnmfits_tpu_torch.ops import cf_cuda
    z = chip_smoke._table_rows(-2)
    row = z["keys"].index((3, -3, 5))
    out = []
    for i, chi in enumerate(z["chi"]):
        if chi <= cf_cuda.CHI_EXTENDED:
            continue
        b = np.sqrt(max(1.0 - chi * chi, 1e-12))
        tier = int(2 ** np.ceil(np.log2(max(6000, int(800.0 / b)))))
        w528, A528 = chip_smoke.PIN_528[float(chi)]
        out.append(((5, 2, 8), float(chi), w528, A528, tier))
        out.append(((3, -3, 5), float(chi), complex(z["omega"][row][i]),
                    complex(z["A"][row][i]), tier))
    return out


def measure(cfs, ref, device):
    import torch
    from qnmfits_tpu_torch.spectrum import angular, solver
    records = []
    for (l, m, n), chi, w, A, N in points():
        aL, wL = chi / 2.0, 2.0 * w
        nl = l - angular.lmin(-2, m) + 1 + 24

        def coupled(w0, w1):
            """A at w0 (nearest the root's) and at w1 (nearest that)."""
            A0, A1 = solver._angular_pair(
                -2, l, m, torch.as_tensor([aL * w0], device=device),
                torch.as_tensor([aL * w1], device=device), nl,
                torch.as_tensor([A], device=device))
            return complex(A0[0]), complex(A1[0])

        Aq0, Aq1 = coupled(wL, wL + H)
        Ac0, Ac1 = coupled(wL - H_CENTRED, wL + H_CENTRED)
        ulp = np.spacing(abs(wL.real))
        js = np.arange(-ULPS, ULPS + 1)
        ws = np.concatenate([wL + js * ulp, [wL + H]])
        As = np.concatenate([np.full(len(js), Aq0), [Aq1]])
        fc, _ = ref(np.array([wL - H_CENTRED, wL + H_CENTRED]),
                    np.full(2, aL), np.array([Ac0, Ac1]), -2, m, n, N)
        d_ref = (fc[1] - fc[0]) / (2.0 * H_CENTRED)
        bar = 1e-9 * max(1.0, abs(wL))
        rec = dict(mode=[l, m, n], chi=chi, N=N, omega_L=[wL.real, wL.imag],
                   bar=bar, df_ref=abs(d_ref))
        for name, cf in cfs.items():
            f, scale = cf(ws, np.full(len(ws), aL), As, -2, m, n, N)
            f_root = f[ULPS]
            # The quotient at A(omega), A(omega + h); the ulp points at
            # A(omega), less the derivative's share.
            df = (f[-1] - f_root) / H
            g = f[:-1] - f_root - d_ref * (ws[:-1] - wL)
            spread = float(np.max(np.abs(g[:, None] - g[None, :])))
            rec[name] = dict(
                scale=float(scale[ULPS]), f=float(abs(f_root)),
                df=float(abs(df)), spread=spread,
                quotient_err=float(abs(df - d_ref) / abs(d_ref)),
                noise_step=spread / abs(df))
        records.append(rec)
        print(f"({l},{m},{n}) chi={chi:.5f} N={N}: bar {bar:.2e}; "
              + "; ".join(
                  f"{k} S {r['scale']:.3e} |f| {r['f']:.2e} |f'| "
                  f"{r['df']:.3e} spread {r['spread']:.2e} quotient err "
                  f"{r['quotient_err']:.1e} spread/|f'| {r['noise_step']:.2e}"
                  for k, r in ((k, rec[k]) for k in cfs)), flush=True)
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", action="store_true",
                    help="the host twins and the 80-bit CF on the CPU")
    ap.add_argument("--out", help="also write the records (JSON lines) here")
    args = ap.parse_args()
    if args.host:
        cfs, ref = host_cfs()
        device = "cpu"
    else:
        import torch
        if not torch.cuda.is_available():
            print("torch_cf_noise: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0],
            flush=True)
        cfs, ref = card_cfs()
        device = "cuda"
    records = measure(cfs, ref, device)
    for name in cfs:
        ratio = [r[name]["noise_step"] / r["bar"] for r in records]
        print(f"{name}: spread / |f'| above the bar at "
              f"{sum(x > 1.0 for x in ratio)} of {len(records)} points; "
              f"largest {max(ratio):.2e} x the bar", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
