"""Where the port and the JAX package part on the bench's 8-overtone ladder
along chip_smoke.py's remnant tracks (the input of
tests/test_torch_dynamic.py::test_deep_ladder_oracle_gap_is_the_jax_packages).

For each start time it prints: how far the port's systems
(``engine.dynamic_fit_systems`` on the samples its sweep uses) are from
the JAX package's (the operations of ``engine.dynamic_fit_core``),
relative to each quantity's largest entry; the equilibrated Gram's
condition number; the mismatch of each package's solve (``gram_cholesky``)
on each package's systems; the test's first-order rounding bound; and the
gap to the NumPy oracle.  CPU only; imports both packages.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_deep_ladder_gap.py
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
from qnmfits_tpu import batched as jb  # noqa: E402
from qnmfits_tpu import fitting as jf  # noqa: E402
from qnmfits_tpu.ops.solve import gram_cholesky as jax_solve  # noqa: E402
import qnmfits_tpu_torch as tq  # noqa: E402
from qnmfits_tpu_torch import batched as tb  # noqa: E402
from qnmfits_tpu_torch import engine as te  # noqa: E402
from qnmfits_tpu_torch import ref_impl as tref  # noqa: E402
from qnmfits_tpu_torch.ops.solve import gram_cholesky as port_solve  # noqa: E402
from qnmfits_tpu_torch.ops.windows import window_geq  # noqa: E402
from qnmfits_tpu_torch.testing import bench_mode_sets  # noqa: E402
from test_torch_dynamic import (SPH, _jax_dynamic_systems,  # noqa: E402
                                _mismatch_rounding_bound)


def mismatch(C, G_tau, r_tau, data_norm):
    num = np.real(np.vdot(C, r_tau))
    return 1.0 - num / np.sqrt(np.real(np.vdot(C, G_tau @ C)) * data_norm)


def main():
    p = chip_smoke.build_problem(**dict(chip_smoke.FULL, events=2))
    deep = bench_mode_sets()[chip_smoke.DEEPEST]
    t0s = np.array([0.5, 10.0, 25.0])
    args = (p["times"], p["data"], [deep], p["Mf_t"], p["chif_t"], t0s)
    kw = dict(T_array=p["T"], spherical_modes=SPH, dynamic=True)
    mm = tq.mismatch_t0_mode_sets(*args, device="cpu", **kw)[0]
    mm_j = np.asarray(jf.mismatch_t0_mode_sets(*args, **kw))[0]
    times, rows, sph = jb._prep(p["times"], p["data"], SPH)
    eval_tracks, _ = jb._modesets_spectrum_dynamic_fn(
        (tuple(jb._canon(deep)),), sph)
    om, mu = (np.array(x[0]) for x in eval_tracks(p["chif_t"], p["Mf_t"]))
    tt = torch.as_tensor(times)
    lo, hi = tb._window_spans(tt, torch.as_tensor(t0s),
                              torch.full((len(t0s),), p["T"]))
    print("t0 | systems gap | kappa(A) | mm: jax sys+solve | jax sys, "
          "port solve | port sys, jax solve | port sys+solve | sweeps' gap "
          "| bound | oracle gap")
    for b, t0 in enumerate(t0s):
        w = window_geq(tt, t0, p["T"])
        sys_j = _jax_dynamic_systems(times, rows, om, mu, t0, w.numpy())
        a, e = int(lo[b]), int(hi[b])
        sys_t = [x.numpy() for x in te.dynamic_fit_systems(
            tt[a:e], torch.as_tensor(rows[:, a:e]), torch.as_tensor(om[a:e]),
            torch.as_tensor(mu[:, a:e]), torch.tensor(t0), w[a:e])]
        gap = max(np.max(np.abs(x - y)) / np.max(np.abs(y))
                  for x, y in zip(sys_t, sys_j))
        d = np.sqrt(np.real(np.diag(sys_j[0])))
        kappa = np.linalg.cond(sys_j[0] / d[:, None] / d[None, :])
        mms = []
        for G, rhs, *rest in (sys_j, sys_t):
            for solve in ("jax", "port"):
                C = (np.asarray(jax_solve(jnp.asarray(G), jnp.asarray(rhs)))
                     if solve == "jax" else
                     port_solve(torch.as_tensor(G),
                                torch.as_tensor(rhs)).numpy())
                mms.append(mismatch(C, *rest))
        ref = tref.dynamic_multimode_ringdown_fit(
            p["times"], p["data"], deep, p["Mf_t"], p["chif_t"], t0, T=p["T"],
            spherical_modes=SPH)["mismatch"]
        print(f"{t0} | {gap:.2e} | {kappa:.3e} | "
              + " | ".join(f"{m:.15e}" for m in mms)
              + f" | {abs(mm[b] - mm_j[b]):.3e} | "
              f"{_mismatch_rounding_bound(*sys_j):.3e} | "
              f"{abs(mm_j[b] - ref):.3e}")


if __name__ == "__main__":
    main()
