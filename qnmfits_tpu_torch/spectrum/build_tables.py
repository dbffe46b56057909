"""Building whole Kerr QNM spectrum tables (port of
qnmfits_tpu/spectrum/build_tables.py).

Runs the solver (``solver.py``, the CF kernel on the card) for every mode
and writes one ``.npz`` artifact in the layout ``tables.SpectrumTables``
reads:

    chi          : (P,) float64, shared spin grid
    keys         : (M, 3) int32, rows (l, m, n), all m in [-l, l]
    omega        : (M, P) complex128, M = 1 units (Re > 0 convention)
    A            : (M, P) complex128, angular separation constants
    mu           : (M, P, K) complex128, spherical-spheroidal mixing
                   C_{l'} for l' = max(|s|,|m|) .. max(|s|,|m|)+K-1
    s, n_mu      : scalars

The artifact and the per-mode track cache go to ``tables.track_cache_dir()``
and its parent (outside the repository) unless given; load the result with
``SpectrumTables(path)``.  A full table takes hours.

Usage:  python -m qnmfits_tpu_torch.spectrum.build_tables [--lmax 5 --nmax 7]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from .solver import default_chi_grid, schwarzschild_seeds, track_mode
from .tables import track_cache_dir


def _load_or(cache: Path, solve):
    """The arrays of ``cache`` if it exists, else ``solve()``'s dict of
    arrays, saved there."""
    if cache.exists():
        with np.load(cache) as z:
            return {k: z[k] for k in z.files}
    arrays = solve()
    np.savez(cache, **arrays)
    return arrays


def build(l_max: int = 5, n_max: int = 7, s: int = -2,
          n_chi: int = 400, n_mu: int = 12,
          out: Path | None = None, verbose: bool = True,
          l2_extension: bool = True, device="cuda") -> Path:
    """Solve every (l, m, n) with |s| <= l <= l_max, n <= n_max (and, for
    s = -2, the l = 2 multiplets and extended ladder) on ``device``, and
    write the artifact to ``out`` (default: qnm_tables_s{s}.npz beside the
    track cache).  Returns its path."""
    chi = default_chi_grid(n_chi)
    seeds = schwarzschild_seeds(l_max=l_max, n_max=n_max, s=s, device=device)
    cache_dir = track_cache_dir()
    cache_dir.mkdir(parents=True, exist_ok=True)

    keys, omegas, As, mus = [], [], [], []

    def add(key, w, A, C):
        K = min(n_mu, C.shape[1])
        mu = np.zeros((len(chi), n_mu), complex)
        mu[:, :K] = C[:, :K]
        keys.append(key)
        omegas.append(w)
        As.append(A)
        mus.append(mu)

    t_start = time.time()
    # Every m in [-l, l] is solved directly: m < 0 is the retrograde
    # branch (Re > 0), not a symmetry image of m > 0.
    for l in range(abs(s), l_max + 1):
        # The regular l = 2, s = -2 ladder stops at n = 7: continuation
        # walks into the algebraically special omega = -2i at n = 8; n >= 8
        # comes from the l = 2 extension below.
        n_top = min(n_max, 7) if (s == -2 and l == 2 and l2_extension) \
            else n_max
        for m in range(-l, l + 1):
            for n in range(0, n_top + 1):
                t0 = time.time()

                def solve(l=l, m=m, n=n):
                    w, A, C = track_mode(l, m, n, seeds[(l, n)], chi, s=s,
                                         device=device)
                    return dict(w=w, A=A, C=C)

                z = _load_or(cache_dir / f"s{s}_l{l}_m{m}_n{n}_P{n_chi}.npz",
                             solve)
                add((l, m, n), z["w"], z["A"], z["C"])
                if verbose:
                    print(f"  ({l},{m},{n}) done in {time.time()-t0:.1f}s "
                          f"[total {time.time()-t_start:.0f}s]", flush=True)

    # The l = 2 multiplets (n = 8, 9) and the extended ladder (n >= 10):
    # where the reference needs Cook & Zalutskiy data (qnm.py:56-87).
    if l2_extension and s == -2:
        from .multiplets import multiplet_tracks
        for m in range(-2, 3):
            t0 = time.time()

            def solve(m=m):
                tracks = multiplet_tracks(m, chi, s=s, verbose=verbose,
                                          device=device)
                save = {"labels": np.array(sorted(tracks), np.int32)}
                for n, (w, A, C) in tracks.items():
                    save.update({f"w{n}": w, f"A{n}": A, f"C{n}": C})
                return save

            z = _load_or(cache_dir / f"s{s}_l2ext_m{m}_n20_P{n_chi}.npz",
                         solve)
            for n in sorted(int(n) for n in z["labels"]):
                add((2, m, n), z[f"w{n}"], z[f"A{n}"], z[f"C{n}"])
            if verbose:
                print(f"  l=2 extension m={m} done in {time.time()-t0:.1f}s",
                      flush=True)

    if out is None:
        out = cache_dir.parent / f"qnm_tables_s{s}.npz"
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out, chi=chi, keys=np.array(keys, dtype=np.int32),
        omega=np.array(omegas), A=np.array(As), mu=np.array(mus),
        s=np.int32(s), n_mu=np.int32(n_mu))
    if verbose:
        print(f"wrote {out} ({out.stat().st_size/1e6:.1f} MB, "
              f"{len(keys)} modes)")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lmax", type=int, default=5)
    p.add_argument("--nmax", type=int, default=7)
    p.add_argument("--nchi", type=int, default=400)
    p.add_argument("--nmu", type=int, default=12)
    p.add_argument("--s", type=int, default=-2)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the plain CF)")
    p.add_argument("--no-l2ext", action="store_true",
                   help="skip the l=2 n>=8 multiplet/extension tracks")
    args = p.parse_args(argv)
    build(l_max=args.lmax, n_max=args.nmax, s=args.s, n_chi=args.nchi,
          n_mu=args.nmu, l2_extension=not args.no_l2ext,
          device=args.device)


if __name__ == "__main__":
    main()
