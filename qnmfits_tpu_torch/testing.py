"""Synthetic waveforms for tests and the smoke run (port of
qnmfits_tpu/testing.py's synthetic_single and synthetic_multimode), and
``run_world``, which
runs a function on the ranks of a fresh torch.distributed process group
(the mesh's tests and the smoke run's mesh phase)."""

from __future__ import annotations

import numpy as np

from .engine import SpectrumEvaluator

__all__ = ["bench_mode_sets", "eig_matching", "random_factored_sweep",
           "random_hermitian_systems", "random_window_moments", "run_world",
           "synthetic_multimode", "synthetic_single"]


def default_time_grid(t_min=-50.0, t_max=150.0, dt=0.1):
    return np.arange(t_min, t_max, dt)


def synthetic_single(modes=None, amplitudes=None, Mf=0.952, chif=0.692,
                     times=None, noise=0.0, seed=0):
    """Single-series synthetic ringdown h(t) = sum C_j exp(-i w_j t) for t
    >= 0, zero before, with the tables' frequencies (``qnm_api``).
    Amplitudes default to complex normals from
    np.random.default_rng(seed); ``noise`` adds white complex noise of that
    scale from np.random.default_rng(seed + 1).  Returns dict(times, data,
    modes, amplitudes, frequencies, Mf, chif)."""
    from .qnm_api import get_qnm
    from .ref_impl import ringdown

    if modes is None:
        modes = [(2, 2, n, 1) for n in range(3)]
    if amplitudes is None:
        rng = np.random.default_rng(seed)
        amplitudes = (rng.standard_normal(len(modes))
                      + 1j * rng.standard_normal(len(modes)))
    if times is None:
        times = default_time_grid()

    freqs = np.array(get_qnm().omega_list(modes, chif, Mf))
    data = ringdown(times, 0.0, amplitudes, freqs)
    if noise:
        rng = np.random.default_rng(seed + 1)
        data = data + noise * (rng.standard_normal(len(times))
                               + 1j * rng.standard_normal(len(times)))
    return dict(times=times, data=data, modes=modes,
                amplitudes=np.asarray(amplitudes, complex),
                frequencies=freqs, Mf=Mf, chif=chif)


def synthetic_multimode(modes=None, spherical_modes=None, amplitudes=None,
                        Mf=0.952, chif=0.692, times=None, seed=0):
    """Spherical-harmonic-decomposed synthetic ringdown with mixing:
    h_lm(t) = sum_j mu_{lm,j}(chif) C_j exp(-i w_j t) for t >= 0, zero
    before -- data exactly representable by the multimode model.
    Amplitudes default to complex normals from np.random.default_rng(seed).
    """
    if modes is None:
        modes = [(2, 2, n, 1) for n in range(2)] + [(3, 2, 0, 1)]
    if spherical_modes is None:
        spherical_modes = [(2, 2), (3, 2)]
    if amplitudes is None:
        rng = np.random.default_rng(seed)
        amplitudes = (rng.standard_normal(len(modes))
                      + 1j * rng.standard_normal(len(modes)))
    amplitudes = np.asarray(amplitudes, complex)
    if times is None:
        times = default_time_grid()

    ev = SpectrumEvaluator(modes, spherical_modes)
    freqs = ev.omega(chif, Mf)
    mus = ev.mu(chif)                                    # (I, J)
    data_dict = {}
    tpos = np.where(times >= 0, times, 0.0)
    for lm, mu in zip(spherical_modes, mus):
        h = (mu[None, :] * amplitudes[None, :]
             * np.exp(-1j * freqs[None, :] * tpos[:, None])).sum(1)
        data_dict[tuple(lm)] = np.where(times >= 0, h, 0.0)
    return dict(times=times, data_dict=data_dict, modes=modes,
                spherical_modes=spherical_modes, amplitudes=amplitudes,
                frequencies=freqs, Mf=Mf, chif=chif)


def bench_mode_sets():
    """The bench's 16 mode sets (bench.py:46-58): (2,2) overtone ladders
    n < 1..8, the first four with the (2,2,0) mirror mode added, and the
    first four with (3,2,0) and (3,2,1) added; widths 1..8."""
    sets = [[(2, 2, n, 1) for n in range(nmax)] for nmax in range(1, 9)]
    sets += [[(2, 2, n, 1) for n in range(nmax)] + [(2, 2, 0, -1)]
             for nmax in range(1, 5)]
    sets += [[(2, 2, n, 1) for n in range(nmax)]
             + [(3, 2, 0, 1), (3, 2, 1, 1)] for nmax in range(1, 5)]
    return sets


def random_hermitian_systems(B, n, seed=0, n_pad=0):
    """B Hermitian positive-definite systems G x = b (complex128 numpy):
    random Grams with column scales spread over 1e-3..1e3 (what the
    equilibration undoes), a dead column (scale 1e-30) in every other
    system, and the last n_pad columns identity padding with zero rhs,
    as the sweep pads ragged mode sets."""
    rng = np.random.default_rng(seed)
    M = (rng.standard_normal((B, n, 2 * n))
         + 1j * rng.standard_normal((B, n, 2 * n)))
    G = M @ np.conj(np.swapaxes(M, -1, -2)) + np.eye(n)[None]
    b = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    scale = 10.0 ** rng.uniform(-3.0, 3.0, (B, n))
    live = n - n_pad
    scale[np.arange(0, B, 2), rng.integers(0, live, (B + 1) // 2)] = 1e-30
    G = G * scale[:, :, None] * scale[:, None, :]
    b = b * scale
    G[:, live:, :] = 0.0
    G[:, :, live:] = 0.0
    G[:, range(live, n), range(live, n)] = 1.0
    b[:, live:] = 0.0
    return G, b


def eig_matching(ev, ref):
    """Each row of eigenvalues ev (B, n) matched one to one with the same
    row of ref, minimising the sum of the |differences| (scipy's
    linear_sum_assignment).  Returns perm (B, n), ev[b, i] matched with
    ref[b, perm[b, i]], and the largest |difference| of each row (B,)."""
    from scipy.optimize import linear_sum_assignment
    ev, ref = np.atleast_2d(ev), np.atleast_2d(ref)
    perm = np.empty(ev.shape, dtype=np.int64)
    gap = np.empty(ev.shape[0])
    for b in range(ev.shape[0]):
        d = np.abs(ev[b][:, None] - ref[b][None, :])
        rows, cols = linear_sum_assignment(d)
        perm[b, rows] = cols
        gap[b] = d[rows, cols].max()
    return perm, gap


def random_factored_sweep(K, I, S, J, B, seed=0, n_pad=0, layout="random"):
    """Inputs of one join group of the factored sweep (numpy): times (K,)
    a uniform grid of step 0.1 from -5, data (I, K), omegas (S, J) damped,
    mus (S, I, J), col_masks (S, J) with the last n_pad columns padding
    (zero frequency and mixing), and B sorted start times t0s with window
    lengths Ts (B,).  ``layout`` places the windows:

    * "random": start times anywhere on the grid, lengths up to 0.05 K,
      among them a window too short to hold a sample, one that starts
      past the grid (empty) and one that runs off the grid's end;
    * "dedup": one sample apart from a tenth of the grid on, each
      ~0.1 K samples long (the main path's layout with dedup);
    * "per_sample": 16 windows a sample, ~0.1 K samples long (the main
      path's layout without dedup);
    * "short": start times anywhere, 0 to 25 samples long (windows with
      no whole tile of the systems kernel inside);

    in the last three, one window of one sample, the last two starting
    past the grid and running off its end."""
    rng = np.random.default_rng(seed)
    times = -5.0 + 0.1 * np.arange(K)
    data = rng.standard_normal((I, K)) + 1j * rng.standard_normal((I, K))
    omegas = (rng.uniform(0.2, 1.5, (S, J))
              - 1j * rng.uniform(0.05, 0.6, (S, J)))
    mus = rng.standard_normal((S, I, J)) + 1j * rng.standard_normal((S, I, J))
    masks = np.ones((S, J), bool)
    if n_pad:
        masks[:, J - n_pad:] = False
        omegas[:, J - n_pad:] = 0.0
        mus[:, :, J - n_pad:] = 0.0
    if layout == "random":
        t0s = rng.uniform(times[0], times[-1], B)
        Ts = rng.uniform(0.5, 0.05 * K, B)
        t0s[0], Ts[0] = times[K // 3] + 0.01, 0.05
        if B > 1:
            t0s[1] = times[-1] + 1.0
        if B > 2:
            t0s[2], Ts[2] = times[-1] - 0.35, 50.0
    else:
        if layout == "dedup":
            t0s = times[K // 10] + 0.003 + 0.1 * np.arange(B)
        elif layout == "per_sample":
            t0s = times[K // 10] + 0.003 + 0.1 / 16 * np.arange(B)
        elif layout == "short":
            t0s = np.sort(rng.uniform(times[0], times[-1], B))
        else:
            raise ValueError(f"unknown layout {layout!r}")
        Ts = (rng.uniform(0.0, 2.5, B) if layout == "short"
              else np.full(B, 0.01 * K))
        Ts[B // 2] = 0.1                      # one sample
        if B > 2:
            t0s[-1] = times[-1] + 1.0         # past the grid: empty
            t0s[-2], Ts[-2] = times[-1] - 0.35, 50.0
    order = np.argsort(t0s, kind="stable")
    return dict(times=times, data=data, omegas=omegas, mus=mus,
                col_masks=masks, t0s=t0s[order], Ts=Ts[order])


def random_window_moments(K, N, M, I, J, seed=0, grid="uniform"):
    """Inputs of the window moments (numpy): times (K,) on a ``grid``,
    "uniform" (-5 + 0.1 k, which ``batched._uniform_spacing`` passes, so
    the kernel takes its uniform variant), "near-uniform" (-5 plus the
    running sum of steps of 0.1, off by more rounding than the gate
    allows: the general variant) or "random" (steps of 0.05-0.15 drawn at
    random), data rows (I, K), M trajectories' damped omega (M, J) and
    windows win (M,) among N 'geq' windows (t0s, Ts (N,)) anywhere on the
    grid up to a fifth of it long; among them (N >= 4) one too short to
    hold a sample, one that starts past the grid (empty), one that runs
    off the grid's end and one of one sample, and every window has a
    trajectory."""
    rng = np.random.default_rng(seed)
    if grid == "uniform":
        times = -5.0 + 0.1 * np.arange(K)
    elif grid in ("near-uniform", "random"):
        steps = (np.full(K - 1, 0.1) if grid == "near-uniform"
                 else rng.uniform(0.05, 0.15, K - 1))
        times = -5.0 + np.concatenate([[0.0], np.cumsum(steps)])
    else:
        raise ValueError(f"unknown grid {grid!r}")
    span = times[-1] - times[0]
    data = rng.standard_normal((I, K)) + 1j * rng.standard_normal((I, K))
    omega = rng.uniform(0.2, 1.5, (M, J)) - 1j * rng.uniform(0.02, 0.6,
                                                              (M, J))
    t0s = rng.uniform(times[0], times[-1], N)
    Ts = rng.uniform(min(0.5, 0.1 * span), 0.2 * span, N)
    if N >= 4:
        k = K // 3
        t0s[0], Ts[0] = times[k] + 0.01, 0.01 * (times[k + 1] - times[k])
        t0s[1] = times[-1] + 1.0
        t0s[2], Ts[2] = times[-1] - 0.35, 50.0
        t0s[3], Ts[3] = times[k], 0.5 * (times[k + 1] - times[k])
    win = np.concatenate([np.arange(min(N, M)),
                          rng.integers(0, N, max(M - N, 0))])
    return dict(times=times, data=data, omega=omega, t0s=t0s, Ts=Ts,
                win=rng.permutation(win))


def _rank_main(fn, rank, world, backend, tmp, args):
    """One rank of ``run_world``: sends its standard error to
    ``rank<r>.stderr`` in ``tmp``, joins the group through a file store in
    ``tmp`` (no network), runs fn(*args) and pickles its result, or its
    traceback, into ``tmp``.  The cached meshes, and with them the last
    references to the mesh's process groups, go before the group is
    destroyed (``parallel.mesh.release_meshes``)."""
    import os
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    from .parallel.mesh import TIMEOUT, release_meshes
    err_fd = os.open(os.path.join(tmp, f"rank{rank}.stderr"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err_fd, 2)
    os.close(err_fd)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend,
                                init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            out = fn(*args)
        finally:
            release_meshes()
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, world, args=(), backend="gloo", timeout=300.0):
    """fn(*args) on ``world`` spawned processes, the ranks of one process
    group (``backend``; every collective times out after
    ``parallel.mesh.TIMEOUT``, and each process runs one CPU thread).
    fn must be importable by name (a module-level function).  Waits at
    most ``timeout`` seconds in all, kills every rank still running when
    one fails or the time is up, and raises RuntimeError with the failed
    ranks' tracebacks; for a rank that died without one, its exit code,
    whether it had written its result, and the tail of its standard
    error.  Returns the ranks' results, in rank order."""
    import os
    import pickle
    import shutil
    import tempfile
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="qnm_world_")
    procs = []
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if (time.monotonic() > deadline
                    or any(p.exitcode not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                wrote = os.path.exists(os.path.join(tmp, f"rank{r}.pkl"))
                tail = ""
                log = os.path.join(tmp, f"rank{r}.stderr")
                if os.path.exists(log):
                    with open(log, errors="replace") as f:
                        tail = f.read()[-2000:]
                errors.append(f"rank {r}: exit {p.exitcode}, result "
                              f"{'written' if wrote else 'not written'}; "
                              f"stderr ends:\n{tail}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed "
                               f"(or were stopped after {timeout:.0f} s):\n"
                               + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
