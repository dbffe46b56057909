"""The port's CUDA kernels on the card (marked ``cuda``; they skip where
torch.cuda.is_available() is false).  This file imports no JAX, so on a
machine without it run it alone:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from qnmfits_tpu_torch import engine_real
from qnmfits_tpu_torch.ops import chol_cuda
from qnmfits_tpu_torch.testing import random_hermitian_systems

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _rel(x, ref):
    return float(((x - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


# B = 1, 15 and 17 leave partial slabs and partial teams at every n; 1000
# spans several slabs; 131072 is the bench sweep's batch without dedup,
# more slabs than the persistent grid has blocks.  n = 1..16 run the team
# kernel, every larger n the wide kernel, whose thresholds sit at 32/33
# and 96/97 (threads a block), 118/119 (two stages fit the shared memory
# or one) and 167/168 (shared memory or the global workspace); at n > 32
# B = 1000 is more than one wave of blocks, at n <= 32 B = 4000 is; 8208
# is the 40-mode path's batch with the main path's 16 sets.
WIDE_N = (65, 80, 96, 97, 118, 119, 128, 167, 168, 200)


@pytest.mark.parametrize("n,B", [(n, B) for n in range(1, 65)
                                 for B in (1, 15, 17, 1000)]
                         + [(n, B) for n in WIDE_N for B in (1, 15, 17, 1000)]
                         + [(17, 4000), (32, 4000), (40, 8208), (8, 131072),
                            (40, 131072)])
def test_kernel_matches_plain(cuda, n, B):
    G, b = random_hermitian_systems(B, n, seed=n + B, n_pad=n // 4)
    G = torch.as_tensor(G, dtype=torch.complex128, device=cuda)
    b = torch.as_tensor(b, dtype=torch.complex128, device=cuda)
    before, wide = chol_cuda.launches, chol_cuda.wide_launches
    x = chol_cuda.regularised_solve(G, b)
    assert chol_cuda.launches == before + 1
    assert chol_cuda.wide_launches == wide + (n > 16)
    ref = engine_real._regularised_solve_plain(G, b)
    torch.cuda.synchronize()
    assert _rel(x, ref) <= 1e-12


def test_kernel_does_not_spill(cuda):
    report = chol_cuda.ptxas_report()
    assert set(report) == ({f"team<{n}>" for n in range(1, 17)}
                           | {"wide<32>", "wide<128>", "wide<256>",
                              "wide_global<256>"})
    for n, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (n, r)


def test_kernel_rejects_misaligned_input(cuda):
    """A complex128 view 8 bytes into its storage cannot feed the bulk
    copies: the wrapper raises rather than launch or fall back."""
    n, B = 4, 3
    G0, b0 = random_hermitian_systems(B, n, seed=1)
    G0 = torch.as_tensor(G0, dtype=torch.complex128, device=cuda)
    b0 = torch.as_tensor(b0, dtype=torch.complex128, device=cuda)
    raw = torch.empty(G0.numel() * 16 + 8, dtype=torch.uint8, device=cuda)
    G = torch.empty(0, dtype=torch.complex128, device=cuda).set_(
        raw.untyped_storage()[8:], 0, G0.shape, G0.stride())
    G.copy_(G0)
    assert G.is_contiguous() and G.data_ptr() % 16 == 8
    before = chol_cuda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        chol_cuda.regularised_solve(G, b0)
    assert chol_cuda.launches == before
    x = chol_cuda.regularised_solve(G.clone(), b0)
    assert _rel(x, engine_real._regularised_solve_plain(G0, b0)) <= 1e-12


def test_kernel_rejects_bad_input(cuda):
    G = torch.eye(4, dtype=torch.complex128, device=cuda)[None]
    b = torch.zeros((1, 4), dtype=torch.complex128, device=cuda)
    before = chol_cuda.launches
    with pytest.raises(ValueError, match="n=0"):
        chol_cuda.regularised_solve(G[:, :0, :0], b[:, :0])
    with pytest.raises(TypeError, match="complex128"):
        chol_cuda.regularised_solve(G.to(torch.complex64),
                                    b.to(torch.complex64))
    assert chol_cuda.launches == before


def test_wide_plan_thresholds(cuda):
    """The wide kernel's launch on each side of its thresholds: threads a
    block, the stages of its arena, and the global workspace, which stays
    within 256 MiB or one arena an SM."""
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan(n, B=1):
        return chol_cuda.wide_plan(n, B, dev)

    assert [plan(n)["threads"] for n in (17, 32, 33, 96, 97, 167)] == [
        32, 32, 128, 128, 256, 256]
    assert plan(118)["stages"] == 2 and plan(119)["stages"] == 1
    assert plan(167)["global"] == 0 and plan(167)["work_bytes"] == 0
    p = plan(168, 10000)
    assert p["global"] == 1 and p["smem_bytes"] == 0
    arena = p["work_bytes"] // p["grid"]
    assert 0 < p["work_bytes"] <= max(256 << 20, sms * arena)
    assert plan(40, 513)["grid"] == 513         # one wave for the 40-mode path


def test_sweep_through_kernel_matches_plain(cuda):
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    keep = problem["t0s"] >= 0
    for dedup in (True, False):
        chol_cuda.launches = 0
        mm = chip_smoke.sweep(problem, "cuda", dedup=dedup)
        assert chol_cuda.launches == 1           # one solve per sweep
        mm_plain = chip_smoke.sweep(
            problem, "cuda", dedup=dedup,
            solve=engine_real._regularised_solve_plain)
        assert np.max(np.abs(mm - mm_plain)[:, keep]) <= 1e-11


def test_paths_through_kernel_match_plain(cuda):
    """Every path of the static-spectrum surface at a small size
    (chip_smoke.py's phase 6): its launches, the kernel route against the
    plain-solve route, and the NumPy oracle."""
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    paths = chip_smoke.run_paths(problem, "cuda")
    assert {p["key"] for p in paths} >= {"closest", "remnant", "bucket",
                                         "n1", "n17", "n40", "n96"}
    assert sum(p["wide_launches"] for p in paths) == 3


def test_closest_dedup_keys_on_device(cuda):
    """The 'closest' dedup keys of adversarial start times (exact sample
    midpoints, their ulp neighbours) group them as the device's own
    window argmins do."""
    import chip_smoke
    times = np.arange(-5.0, 30.05, 0.1)
    dt = times[1] - times[0]
    mids = 0.5 * (times[40:200:3] + times[41:201:3])
    rng = np.random.default_rng(7)
    t0s = np.sort(np.concatenate([
        mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
        times[40] + dt * rng.uniform(0.49, 0.51, 100)]))
    for T in (20.0, 20.05):
        chip_smoke.check_closest_keys(dict(times=times, t0s=t0s, T=T), cuda)


def test_dynamic_paths_through_kernel_match_plain(cuda):
    """chip_smoke.py's phase 7 dynamic paths (D1-D3) at a small size:
    exactly one launch each (the wide kernel's for the 17-mode set), the
    kernel route against the plain-solve route, the NumPy oracle, and the
    kernel's backward error on D1's and D2's systems."""
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    specs = [s for s in chip_smoke.dynamic_specs(problem, "cuda")
             if not s["key"].startswith("d4")]
    paths = chip_smoke.run_specs(specs, "cuda")
    assert [p["key"] for p in paths] == ["d1", "d2", "d3_geq", "d3_closest"]
    assert [(p["launches"], p["wide_launches"]) for p in paths] == [
        (1, 0), (1, 1), (1, 0), (1, 0)]
    assert all(p["backward_err"] <= chip_smoke.KERNEL_BWD_TOL
               for p in paths[:2])


def test_events_through_kernel_match_plain(cuda):
    """chip_smoke.py's phase 7 event batch (D4) at a small size, one
    launch; engine='fast' on the card runs the 'batched' sweep (summed
    Grams), on a grid that is not uniform too: the same results."""
    import chip_smoke
    import qnmfits_tpu_torch as tq
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    specs = [s for s in chip_smoke.dynamic_specs(problem, "cuda")
             if s["key"].startswith("d4")]
    paths = chip_smoke.run_specs(specs, "cuda")
    assert [(p["launches"], p["wide_launches"]) for p in paths] == [(1, 0)]
    cat = problem["catalog"]
    times = cat["times"] + 1e-3 * np.sin(np.arange(len(cat["times"])))
    args = (times, cat["rows"], chip_smoke.EVENT_MODES, cat["Mfs"],
            cat["chifs"], cat["t0s"])
    for grid in (cat["times"], times):
        args = (grid,) + args[1:]
        mm_f, C_f = tq.fit_events(*args, T=cat["T"], engine="fast")
        mm_b, C_b = tq.fit_events(*args, T=cat["T"])
        assert np.all(np.isfinite(mm_f))
        np.testing.assert_array_equal(mm_f, mm_b)
        np.testing.assert_array_equal(C_f, C_b)


@pytest.mark.parametrize("n", [1, 5, 8, 16, 17])
def test_solve_gradients_through_kernel_match_plain(cuda, n):
    """RegularisedSolve on the card: the gradient and a Hessian-vector
    product of a real loss of the solution through the kernel (one launch
    forward, one in the first backward, two in the second) against
    autograd through the plain solve, on random Hermitian batches with
    dead columns and padding (n = 16 / 17: the team / wide switch)."""
    G0, b0 = random_hermitian_systems(64, n, seed=n, n_pad=n // 4)
    G0 = torch.as_tensor(G0, dtype=torch.complex128, device=cuda)
    b0 = torch.as_tensor(b0, dtype=torch.complex128, device=cuda)
    w = torch.linspace(0.5, 1.5, n, dtype=torch.float64, device=cuda)

    def grads(solve, counts):
        M = G0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        chol_cuda.launches = 0
        x = solve((M + M.mH) / 2, b)
        counts.append(chol_cuda.launches)
        loss = (w * x.abs() ** 2).sum() + x.real.sum()
        gM, gb = torch.autograd.grad(loss, (M, b), create_graph=True)
        counts.append(chol_cuda.launches)
        hv = torch.autograd.grad(gM.real.sum() + gb.imag.sum(), (M, b))
        counts.append(chol_cuda.launches)
        return [t.detach() for t in (gM, gb) + hv]

    counts, plain_counts = [], []
    got = grads(engine_real._regularised_solve, counts)
    ref = grads(engine_real._regularised_solve_plain, plain_counts)
    assert counts == [1, 2, 4] and plain_counts == [0, 0, 0]
    for a, c in zip(got, ref):
        assert float((a - c).abs().max()) <= 1e-10 * float(c.abs().max())


def test_kernel_wrapper_refuses_grad_tensors(cuda):
    G, b = random_hermitian_systems(4, 5, seed=3)
    G = torch.as_tensor(G, dtype=torch.complex128, device=cuda)
    b = torch.as_tensor(b, dtype=torch.complex128, device=cuda)
    before = chol_cuda.launches
    for args in ((G.clone().requires_grad_(True), b),
                 (G, b.clone().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="RegularisedSolve"):
            chol_cuda.regularised_solve(*args)
    assert chol_cuda.launches == before


@pytest.mark.parametrize("n", [1, 4, 8])
def test_factor_and_inverse_on_card_match_cpu(cuda, n):
    from qnmfits_tpu_torch.ops.chol import (complex_cholesky_factor,
                                            complex_lower_inverse)
    G, _ = random_hermitian_systems(513, n, seed=n)
    d = np.sqrt(np.abs(np.diagonal(G, axis1=1, axis2=2)))
    A = torch.as_tensor(G / d[:, :, None] / d[:, None, :]
                        + 500 * (n + 1) * 2.2e-16 * np.eye(n))
    L = complex_cholesky_factor(A)
    X = complex_lower_inverse(L)
    L_c = complex_cholesky_factor(A.to(cuda))
    X_c = complex_lower_inverse(L_c)
    assert _rel(L_c.reshape(513, -1).cpu(), L.reshape(513, -1)) <= 1e-13
    assert _rel(X_c.reshape(513, -1).cpu(), X.reshape(513, -1)) <= 1e-13


def test_optimiser_paths_through_kernel_match_plain(cuda):
    """chip_smoke.py's phase 8 at a small size: O1-O3 and the one-window
    L-BFGS-B paths, each with the launches derived from the code, held
    against its plain route and its oracle, with O1's and O2's gradients
    and Hessians through both routes and autograd, and the window moments
    kernel held to its plain version on their own inputs."""
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    paths, solves, _, moments = chip_smoke.run_optimisers(problem, "cuda")
    assert [p["key"] for p in paths] == ["o1", "o2", "o3", "single"]
    assert [p["launches"] == p["expected_launches"] for p in paths] == [
        True] * 4
    assert [p["moments_launches"] == p["expected_moments_launches"]
            for p in paths] == [True] * 4
    assert paths[2]["launches"] == 0 and paths[0]["launches"] > 0
    assert paths[0]["moments_launches"] > 0 and paths[1]["moments_launches"]
    assert solves
    assert moments["max_rel_err"] <= chip_smoke.MOMENTS_RTOL


SPH_CUDA = [(2, 2), (3, 2)]


def test_stacked_grid_through_kernel_matches_plain(cuda):
    """The stacked spectrum sweep on the card: one launch for the grid (two
    with a join budget of half the grid), the kernel route against the
    plain solve on the same systems."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.testing import synthetic_multimode
    rng = np.random.default_rng(3)
    Q, J, I, K = 257, 6, 2, 301
    times = torch.arange(K, dtype=torch.float64, device=cuda) * 0.1 + 0.7
    data = torch.as_tensor(rng.standard_normal((I, K))
                           + 1j * rng.standard_normal((I, K)), device=cuda)
    omegas = torch.as_tensor((0.5 + rng.random((Q, J)))
                             - 1j * (0.05 + 0.3 * rng.random((Q, J))),
                             device=cuda)
    mus = torch.as_tensor(rng.standard_normal((Q, I, J))
                          + 1j * rng.standard_normal((Q, I, J)), device=cuda)
    args = (times, data, omegas, mus, 0.74)
    for budget, launches in ((engine_real.JOIN_BYTES, 1),
                             (128 * 2 * J * J * 16, 3)):
        old = engine_real.JOIN_BYTES
        engine_real.JOIN_BYTES = budget
        try:
            chol_cuda.launches = 0
            C, mm = engine_real.sweep_spectra_stacked_real(*args, chunk=64)
            assert chol_cuda.launches == launches
        finally:
            engine_real.JOIN_BYTES = old
        C_p, mm_p = engine_real.sweep_spectra_stacked_real(
            *args, chunk=64, solve=engine_real._regularised_solve_plain)
        assert float((mm - mm_p).abs().max()) <= 1e-11
        assert _rel(C, C_p) <= 1e-9

    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(3)],
                              times=np.arange(-10.0, 30.05, 0.1), seed=4)
    args = (syn["times"], syn["data_dict"], syn["modes"], (0.9, 1.0),
            (0.6, 0.8), 0.74)
    for method in ("geq", "closest"):
        kw = dict(t0_method=method, T=20.0, res=12, spherical_modes=SPH_CUDA)
        chol_cuda.launches = 0
        mm = tq.mismatch_M_chi_grid(*args, engine="fast", **kw)
        assert chol_cuda.launches == 1
        mm_p = tq.mismatch_M_chi_grid(*args, engine="fast", device="cpu",
                                      **kw)
        mm_b = tq.mismatch_M_chi_grid(*args, **kw)
        assert np.max(np.abs(mm - mm_p)) <= 1e-11
        assert np.max(np.abs(mm - mm_b)) <= 1e-11


def test_amplitude_stability_through_kernel_matches_plain(cuda):
    """amplitude_stability on the card: one launch (dedup on), the kernel
    route against the plain-solve route and the CPU."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.testing import synthetic_multimode
    syn = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(3)],
                              times=np.arange(-10.0, 30.05, 0.1), seed=4)
    t0s = np.linspace(-2.0, 10.0, 241)
    args = (syn["times"], syn["data_dict"], syn["modes"], 0.952, 0.692, t0s)
    kw = dict(T_array=20.0, spherical_modes=SPH_CUDA)
    chol_cuda.launches = 0
    out = tq.amplitude_stability(*args, **kw)
    assert chol_cuda.launches == 1
    plain = tq.amplitude_stability(
        *args, solve=engine_real._regularised_solve_plain, **kw)
    cpu = tq.amplitude_stability(*args, device="cpu", **kw)
    keep = t0s >= 0
    for ref in (plain, cpu):
        assert np.max(np.abs(out["mm"] - ref["mm"])[keep]) <= 1e-11
        for key in ("C", "A", "rel_std", "scatter", "phase_std"):
            assert (np.max(np.abs(out[key] - ref[key]))
                    <= 1e-9 * np.max(np.abs(ref[key]))), key


def test_diagnostic_paths_through_kernel_match_plain(cuda):
    """chip_smoke.py's phase 9 at a small size: G1, G2 and S1 with the
    launches derived from the code, R1, U1 and F1 without a launch, each
    held against its plain route and its oracle."""
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    paths, solves, _ = chip_smoke.run_diagnostics(problem, "cuda")
    assert [p["key"] for p in paths] == ["g1_oracle", "g1", "g1_set", "g2",
                                         "s1", "r1", "u1", "f1"]
    assert [p["launches"] for p in paths] == [1, 1, 1, 1, 1, 0, 0, 0]
    assert sorted(solves) == ["g1", "g2", "s1"]


def test_mapping_paths_through_kernel_match_plain(cuda):
    """chip_smoke.py's phase 10 at a small size: M1 (J = 11, the team
    kernel) and M2 (J = 18, the wide kernel) with the launches derived
    from the code, each within 1e-11 of its plain route for t0 >= 0 and
    with the kernel's backward error gated; Q1, SKY and U2 launch
    nothing."""
    import chip_smoke
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    paths, solves, _ = chip_smoke.run_mapping(problem, "cuda")
    assert [p["key"] for p in paths] == ["m1_fast", "m1_fast_nodedup",
                                         "m1_batched", "m2_fast", "q1",
                                         "sky", "u2"]
    sweeps = [("m1", "fast", True), ("m1", "fast", False),
              ("m1", "batched", True), ("m2", "fast", True)]
    for p, (key, engine, dedup) in zip(paths, sweeps):
        n = chip_smoke.mapping_launches(problem, key, engine, dedup)
        assert (p["launches"], p["wide_launches"]) == (
            n, n if key == "m2" else 0)
        assert p["plain_in"] <= 1e-11
        assert p["backward_err"] <= chip_smoke.KERNEL_BWD_TOL
    assert [p["launches"] for p in paths[4:]] == [0, 0, 0]
    assert sorted(solves) == ["m1_fast", "m2_fast"]


@pytest.mark.parametrize("engine", ["fast", "batched"])
def test_mapping_sweep_launches_one_per_join_group(cuda, monkeypatch,
                                                   engine):
    """With the join budget cut, the J = 18 mapping sweep makes one wide
    launch per join group, as chip_smoke.mapping_launches derives them,
    and still matches the plain route; called without device= it runs
    on the card."""
    import chip_smoke
    from qnmfits_tpu_torch import spatial
    problem = chip_smoke.build_problem(**dict(chip_smoke.SMALL, n_t0=512))
    monkeypatch.setattr(engine_real, "JOIN_BYTES", 150 * 2 * 18 * 18 * 16)
    modes, mapped = chip_smoke.MAP_MODELS["m2"]
    data = chip_smoke.build_mapping(problem["times"])
    args = (problem["times"], data, modes, chip_smoke.MF, chip_smoke.CHIF,
            problem["t0s"], mapped)
    kw = dict(T_array=problem["T"], spherical_modes=chip_smoke.MAP_SPH,
              engine=engine, dedup=False)
    n = chip_smoke.mapping_launches(problem, "m2", engine, False)
    assert n > 1
    chol_cuda.launches = chol_cuda.wide_launches = 0
    mm = spatial.mapping_mismatch_t0_array(*args, **kw)
    assert (chol_cuda.launches, chol_cuda.wide_launches) == (n, n)
    mm_plain = spatial.mapping_mismatch_t0_array(
        *args, solve=engine_real._regularised_solve_plain, **kw)
    keep = problem["t0s"] >= 0
    assert np.max(np.abs(mm - mm_plain)[keep]) <= 1e-11


def test_waveform_dynamic_sweep_through_kernel_matches_plain(cuda):
    """chip_smoke.py's phase 11 W1 dynamic sweep at a small size: the BBH
    fixture through the port's SXS loader, ``mismatch_t0_array`` on its
    own Moft / chioft tracks with the (2,2,n<8) ladder over 33 start
    times.  The derived launch, each window within its bound of the plain
    route (the larger of 1e-11 / 1e-8 for t0 >= 0 / t0 < 0 and
    ``gram_bound``, the ladder being ill-conditioned near the peak), and
    the kernel's backward error on the sweep's systems."""
    import chip_smoke
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, ref_impl
    w1, _ = chip_smoke.load_w1()
    deep = chip_smoke.W1_LADDERS[-1]
    chit = np.clip(w1.chioft_mag, 0.0, 0.99)
    t0s = np.linspace(-5.0, 46.2, 33)
    T = chip_smoke.W1_DYN_T
    args = (w1.times, w1.h[2, 2], deep, w1.Moft, chit, t0s)
    chol_cuda.launches = chol_cuda.wide_launches = 0
    mm = tq.mismatch_t0_array(*args, T_array=T)
    assert (chol_cuda.launches, chol_cuda.wide_launches) == (
        chip_smoke.dynamic_launches(w1.times, t0s, deep, 1), 0)
    plain = chip_smoke.PlainSolve()
    mm_p = batched.batch_mismatch_t0_dynamic(*args, T_array=T,
                                             device="cuda", solve=plain)
    bound = np.array([
        max(1e-11 if t0 >= 0 else 1e-8, chip_smoke.gram_bound(
            ref_impl.dynamic_ringdown_fit(w1.times, w1.h[2, 2], deep,
                                          w1.Moft, chit, t0, T=T), 8))
        for t0 in t0s])
    assert np.all(np.isfinite(mm)) and np.all(np.abs(mm - mm_p) <= bound)
    for G, b in plain.systems:
        x = chol_cuda.regularised_solve(G, b)
        assert chip_smoke.backward_err(G, b, x) <= chip_smoke.KERNEL_BWD_TOL


def test_debug_nans_sees_the_kernels_output(cuda, monkeypatch):
    """The kernel writes through raw pointers, which no torch function
    mode sees: with ``check_nans`` on (``utils.debug_nans`` sets it) its
    wrapper checks the solution itself (a NaN in G gives a NaN solution);
    with it off, nothing is checked.  Under ``debug_nans`` the NaN raises
    already where the torch function mode sees it."""
    from qnmfits_tpu_torch.utils import debug_nans
    Gn, bn = random_hermitian_systems(4, 5, seed=3)
    Gn[1, 2, 2] = np.nan
    G = torch.as_tensor(Gn, device=cuda)
    b = torch.as_tensor(bn, device=cuda)
    assert bool(torch.isnan(chol_cuda.regularised_solve(G, b)).any())
    monkeypatch.setattr(chol_cuda, "check_nans", True)
    with pytest.raises(FloatingPointError, match="CUDA solve kernel"):
        chol_cuda.regularised_solve(G, b)
    monkeypatch.setattr(chol_cuda, "check_nans", False)
    with debug_nans():
        with pytest.raises(FloatingPointError, match="NaN"):
            chol_cuda.regularised_solve(G, b)
    assert not chol_cuda.check_nans


def _cf_inputs(B, seed, n_inv_max=8, chi=(0.0, 0.999)):
    """CF inputs near real modes: (Leaver-unit) omega, spin (chi in the
    range ``chi``), A, n_inv."""
    rng = np.random.default_rng(seed)
    w = 2.0 * (0.3 + 0.6 * rng.random(B) - 1j * (0.05 + 0.6 * rng.random(B)))
    a = 0.5 * (chi[0] + (chi[1] - chi[0]) * rng.random(B))
    A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
    return w, a, A, rng.integers(0, n_inv_max + 1, B)


# B = 2 at N = 2000 is the coarse continuation's launch, 792 x 8192 F1's
# largest; 50 x 777 and 3 x 3001 take depths no team divides.
@pytest.mark.parametrize("B,N", [(1, 2000), (2, 2000), (17, 2000),
                                 (400, 8192), (792, 8192), (17, 32768),
                                 (50, 777), (3, 3001)])
def test_cf_kernel_matches_plain(cuda, B, N):
    """The Leaver CF kernel against its plain version on the same card,
    relative to |U| + |T| (U - T cancels near a root), with the plan the
    wrapper reports the one it picks (``plan`` for FP64, ``plan_dd`` for
    double-double): the FP64 elements against ``cf_parts``, those beyond
    CHI_EXTENDED (launched after them) against the double-double
    ``cf_dd``."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda)
                      for x in _cf_inputs(B, seed=B + N))
    ext = 2.0 * a > cf_cuda.CHI_EXTENDED
    n_ext = int(ext.sum())
    before = cf_cuda.launches, cf_cuda.dd_launches
    f, scale = cf_cuda.leaver_cf(w, a, A, -2, 2, n_inv, N, with_scale=True)
    assert cf_cuda.launches == before[0] + (n_ext < B)
    assert cf_cuda.dd_launches == before[1] + (n_ext > 0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n_ext < B:
        team, segment = cf_cuda.last_plan
        assert (team, segment) == cf_cuda.plan(B - n_ext, N, sms)
        assert team in cf_cuda.TEAMS and segment == -(-N // team)
    if n_ext:
        team, blocks, segment = cf_cuda.last_dd_plan
        assert (team, blocks, segment) == cf_cuda.plan_dd(n_ext, N, sms)
        assert (team, blocks) in cf_cuda.dd_plans()
    if n_ext < B:
        U, T = cf_cuda.cf_parts(w[~ext], a[~ext], A[~ext], -2, 2,
                                n_inv[~ext], N)
        torch.cuda.synchronize()
        assert float(((f[~ext] - (U - T)).abs() / scale[~ext]).max()) \
            <= 1e-13
        assert float(((scale[~ext] - (U.abs() + T.abs())).abs()
                      / scale[~ext]).max()) <= 1e-13
    if n_ext:
        g, g_scale = cf_cuda.cf_dd(w[ext], a[ext], A[ext], -2, 2, n_inv[ext],
                                   N)
        assert float(((f[ext] - g).abs() / g_scale).max()) <= 1e-17


def test_cf_kernel_every_team_agrees(cuda):
    """Every team size, on n_inv from 0 to past the first segments and a
    depth no team divides: the teams agree with each other to 1e-13 of
    |U| + |T| and with the plain version to chip_smoke's CF_TOL (near
    extremal spin the plain version's own rounding reaches 2.5e-13 on
    these inputs; tests/test_torch_cf_host.py holds the kernel's
    arithmetic to the 80-bit CF there)."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda)
                      for x in _cf_inputs(24, seed=256, n_inv_max=20))
    U, T = cf_cuda.cf_parts(w, a, A, -2, 2, n_inv, 3001)
    out = {}
    for team in cf_cuda.TEAMS:
        out[team] = cf_cuda._launch(w, a, A, -2, 2, n_inv, 3001, team)
        assert cf_cuda.last_plan == (team, -(-3001 // team))
    torch.cuda.synchronize()
    f0, scale = out[cf_cuda.TEAMS[0]]
    assert float(((f0 - (U - T)).abs() / scale).max()) <= 1e-12
    for team, (f, _) in out.items():
        assert float(((f - f0).abs() / scale).max()) <= 1e-13, team


@pytest.mark.parametrize("B,N", [(1, 8192), (2, 16384), (24, 32768),
                                 (256, 8192), (2, 98304), (2, 884736)])
def test_cf_dd_kernel_matches_plain(cuda, B, N):
    """The double-double variant at spins beyond CHI_EXTENDED, the solver's
    near-extremal tiers and retries, against its plain version: both carry
    ~106 bits and round once (chip_smoke's CF_DD_TOL)."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda) for x in _cf_inputs(
        B, seed=B + N, n_inv_max=20, chi=(0.985, 0.9995)))
    before = cf_cuda.launches, cf_cuda.dd_launches
    f, scale = cf_cuda.leaver_cf(w, a, A, -2, 2, n_inv, N, with_scale=True)
    assert (cf_cuda.launches, cf_cuda.dd_launches) == (before[0],
                                                       before[1] + 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert cf_cuda.last_dd_plan == cf_cuda.plan_dd(B, N, sms)
    g, g_scale = cf_cuda.cf_dd(w, a, A, -2, 2, n_inv, N)
    torch.cuda.synchronize()
    assert float(((f - g).abs() / g_scale).max()) <= 1e-17
    assert float(((scale - g_scale).abs() / g_scale).max()) <= 1e-17


def test_cf_dd_kernel_every_team_agrees(cuda):
    """Every (team, blocks) the double-double kernel takes, on a depth no
    segment count divides, against its plain version."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda) for x in _cf_inputs(
        24, seed=257, n_inv_max=20, chi=(0.985, 0.9995)))
    g, g_scale = cf_cuda.cf_dd(w, a, A, -2, 2, n_inv, 3001)
    for team, blocks in cf_cuda.dd_plans():
        f, _ = cf_cuda._launch(w, a, A, -2, 2, n_inv, 3001, team,
                               extended=True, blocks=blocks)
        assert cf_cuda.last_dd_plan == (team, blocks,
                                        -(-3001 // (team * blocks)))
        assert float(((f - g).abs() / g_scale).max()) <= 1e-17, (team,
                                                                  blocks)


@pytest.mark.parametrize("B,N,plans", [
    (2, 98304, ((128, 1), (128, 16), (128, 128), (256, 256))),
    (6, 294912, ((128, 64), (256, 32))),
    (16, 8192, ((64, 1), (128, 8), (256, 4)))])
def test_cf_dd_kernel_spread_over_blocks_agrees(cuda, B, N, plans):
    """An element over many blocks, at the near-extremal retries' depths
    and F1's largest launch: within 1e-17 of the plain version at each
    (team, blocks)."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda) for x in _cf_inputs(
        B, seed=B + N, n_inv_max=20, chi=(0.985, 0.9995)))
    g, g_scale = cf_cuda.cf_dd(w, a, A, -2, 2, n_inv, N)
    for team, blocks in plans:
        f, scale = cf_cuda._launch(w, a, A, -2, 2, n_inv, N, team,
                                   extended=True, blocks=blocks)
        assert float(((f - g).abs() / g_scale).max()) <= 1e-17, (team,
                                                                  blocks)
        assert float(((scale - g_scale).abs() / g_scale).max()) <= 1e-17


def test_cf_dd_kernel_is_its_host_twin_bit_for_bit(cuda, tmp_path):
    """The card's double-double arithmetic is its host twin's (the same
    source built by g++ -ffp-contract=off on this machine, with T = team x
    blocks segments), bit for bit, whichever block of an element comes
    last: the row-split tree products, the fused sums, the
    terms and the finish."""
    import ctypes
    import shutil
    import subprocess
    from qnmfits_tpu_torch.ops import cf_cuda
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's host twin")
    lib = tmp_path / "libleaver_cf_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-ffp-contract=off",
                    "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(cf_cuda.SOURCE)], check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).qnm_leaver_cf_dd_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    for B, N, plans in ((5, 3001, ((1, 1), (8, 1), (128, 4), (256, 256))),
                        (4, 40, ((128, 2), (128, 128))),
                        (2, 98304, ((128, 64), (256, 32)))):
        w, a, A, n_inv = _cf_inputs(B, seed=B + N, n_inv_max=20,
                                    chi=(0.985, 0.9995))
        if N == 40:
            n_inv[:3] = (N, N + 3, N - 1)
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        for team, blocks in plans:
            out = np.empty((3, B))
            assert fn(B, *(x.ctypes.data for x in ins), ni.ctypes.data, -2,
                      2, N, team, blocks, *(o.ctypes.data for o in out)) == 0
            f, scale = cf_cuda._launch(
                *(torch.as_tensor(x, device=cuda) for x in (w, a, A)), -2, 2,
                torch.as_tensor(n_inv, device=cuda), N, team, extended=True,
                blocks=blocks)
            assert np.array_equal(f.cpu().numpy(), out[0] + 1j * out[1]), \
                (B, N, team, blocks)
            assert np.array_equal(scale.cpu().numpy(), out[2])


def test_cf_dd_arrival_counters_reset(cuda):
    """The workspace's arrival counters: back-to-back launches on one
    stream, and launches on two streams at once (each with its own
    counters), give the same bits as a lone launch, and leave every
    counter 0; a refused launch drops its stream's counters, and the next
    launch there gives the same bits."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda) for x in _cf_inputs(
        6, seed=6, n_inv_max=20, chi=(0.985, 0.9995)))

    def run():
        return cf_cuda._launch(w, a, A, -2, 2, n_inv, 16384, 128,
                               extended=True, blocks=16)[0]

    first = run()
    again = [run() for _ in range(5)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize(cuda)
    both = []
    for st in streams:
        with torch.cuda.stream(st):
            both.append([run() for _ in range(3)])
    torch.cuda.synchronize(cuda)
    for f in again + [f for fs in both for f in fs]:
        assert torch.equal(f, first)
    keys = {(cf_cuda._index(w.device), st.cuda_stream) for st in streams}
    assert keys <= set(cf_cuda._ARRIVALS)
    for buf in cf_cuda._ARRIVALS.values():
        assert int(buf.abs().sum()) == 0
    key = (cf_cuda._index(w.device),
           torch.cuda.current_stream(cuda).cuda_stream)
    assert key in cf_cuda._ARRIVALS
    with pytest.raises(RuntimeError):
        cf_cuda._launch(w, a, A, -2, 2, n_inv, 16384, 128, extended=True,
                        blocks=3)
    assert key not in cf_cuda._ARRIVALS
    assert torch.equal(run(), first)


def test_cf_dd_phase_cycles(cuda):
    """The phases build on a spread launch: every segment block, warp,
    element's terms and (the segments being longer than the terms) every
    element's last block counted, each phase's cycles positive."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, a, A, n_inv = (torch.as_tensor(x, device=cuda) for x in _cf_inputs(
        2, seed=2, n_inv_max=20, chi=(0.985, 0.9995)))
    rec = cf_cuda.phase_cycles(w, a, A, -2, 2, n_inv, 98304, 128, 4)
    assert rec["counts"] == {"segment blocks": 8, "warps": 32,
                             "last blocks": 2, "terms": 4}
    assert all(v > 0 for v in rec["cycles"].values()), rec


def test_cf_mixed_batch_keeps_fp64_bit_for_bit(cuda):
    """A batch straddling CHI_EXTENDED: one launch of each variant, each
    element bit for bit a call of its own arithmetic alone."""
    from qnmfits_tpu_torch.ops import cf_cuda
    w, _, A, n_inv = (torch.as_tensor(x, device=cuda)
                      for x in _cf_inputs(64, seed=64))
    a = torch.as_tensor(0.5 * np.linspace(0.97, 0.999, 64), device=cuda)
    ext = 2.0 * a > cf_cuda.CHI_EXTENDED
    before = cf_cuda.launches, cf_cuda.dd_launches
    f = cf_cuda.leaver_cf(w, a, A, -2, 2, n_inv, 8192)
    assert (cf_cuda.launches - before[0], cf_cuda.dd_launches - before[1]) \
        == (1, 1)
    for sel in (~ext, ext):
        g = cf_cuda.leaver_cf(w[sel], a[sel], A[sel], -2, 2, n_inv[sel], 8192)
        assert torch.equal(f[sel], g)


def test_gram_cholesky_jitter_launches_the_kernel(cuda):
    """``jitter_scale`` goes through the team and wide kernels, within
    1e-12 of the plain route on the CPU."""
    from qnmfits_tpu_torch.ops import solve
    for n in (6, 20):
        G, b = random_hermitian_systems(64, n, seed=n, n_pad=1)
        before = chol_cuda.launches, chol_cuda.wide_launches
        x = solve.gram_cholesky(torch.as_tensor(G, device=cuda),
                                torch.as_tensor(b, device=cuda),
                                jitter_scale=1e-6)
        assert chol_cuda.launches == before[0] + 1
        assert chol_cuda.wide_launches == before[1] + (n > 16)
        ref = solve.gram_cholesky(torch.as_tensor(G), torch.as_tensor(b),
                                  jitter_scale=1e-6)
        assert _rel(x.cpu(), ref) <= 1e-12


def test_cf_kernel_does_not_spill(cuda):
    from qnmfits_tpu_torch.ops import cf_cuda
    report = cf_cuda.ptxas_report()
    assert set(report) == set(cf_cuda.KERNELS)
    for name, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)


def test_radial_cf_and_solve_omega_launch_the_kernel(cuda):
    """The scalar-spin radial_cf takes one kernel launch on the card, and
    solve_omega runs there by default, two launches a Newton step."""
    from qnmfits_tpu_torch.ops import cf_cuda
    from qnmfits_tpu_torch.spectrum import radial
    w, _, A, _ = (torch.as_tensor(x, device=cuda)
                  for x in _cf_inputs(12, seed=3))
    before = cf_cuda.launches
    f = radial.radial_cf(w.reshape(3, 4), 0.21, A.reshape(3, 4), -2, 2, 1,
                         3000)
    assert cf_cuda.launches == before + 1 and f.shape == (3, 4) and f.is_cuda
    U, T = cf_cuda.cf_parts(w, 0.21, A, -2, 2, 1, 3000)
    assert float(((f.reshape(-1) - (U - T)).abs()
                  / (U.abs() + T.abs())).max()) <= 1e-13
    A_fn = lambda w: torch.full(w.shape, 4.0 + 0j,              # noqa: E731
                                dtype=torch.complex128, device=w.device)
    before = cf_cuda.launches
    wt, At, ok = radial.solve_omega(0.75 - 0.18j, 0.0, -2, 2, 0, A_fn, N=800)
    wc, Ac, okc = radial.solve_omega(0.75 - 0.18j, 0.0, -2, 2, 0, A_fn, N=800,
                                     device="cpu")
    assert ok and okc and abs(wt - wc) <= 1e-12
    assert cf_cuda.launches > before and (cf_cuda.launches - before) % 2 == 0


def test_cf_kernel_rejects_bad_input(cuda):
    from qnmfits_tpu_torch.ops import cf_cuda
    w = torch.ones(4, dtype=torch.complex64, device=cuda)
    with pytest.raises(TypeError, match="complex128"):
        cf_cuda.leaver_cf(w, 0.1, 4.0, -2, 2, 0, 100)
    with pytest.raises(TypeError, match="complex128"):
        cf_cuda.leaver_cf(w.to(torch.complex128).reshape(2, 2), 0.1, 4.0, -2,
                          2, 0, 100)
    w = w.to(torch.complex128)
    with pytest.raises(RuntimeError, match="launch failed"):
        cf_cuda._launch(w, 0.1, 4.0, -2, 2, 0, 100, 48)
    for team, blocks in ((128, 3), (64, 2), (128, 256), (256, 512)):
        with pytest.raises(RuntimeError, match="launch failed"):
            cf_cuda._launch(w, 0.499, 4.0, -2, 2, 0, 100, team,
                            extended=True, blocks=blocks)
    with pytest.raises(ValueError, match="depths"):
        cf_cuda.leaver_cf(w, 0.1, 4.0, -2, 2, 0, cf_cuda.MAX_N + 1)


def test_on_demand_solve_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """One small on-demand solve through the tables on the card, every CF
    through the kernel, against the same solve on the CPU."""
    from qnmfits_tpu_torch.ops import cf_cuda
    from qnmfits_tpu_torch.spectrum import tables
    from qnmfits_tpu_torch.spectrum.solver import default_chi_grid
    chi = default_chi_grid(17, 0.6)
    keys = np.array([(2, 2, 0)], np.int32)
    rows = dict(omega=np.ones((1, 17), complex),
                mu=np.ones((1, 17, 12), complex))
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(tables, "TRACK_CACHE", tmp_path / dev)
        t = tables.SpectrumTables.from_arrays(chi, keys, rows["omega"],
                                              rows["mu"], -2, 12)
        before = cf_cuda.launches
        with tables.solve_on(dev):
            ms = t.compile_modes([(3, 1, 0, 1)])
        out[dev] = (cf_cuda.launches - before, t.omega_np(ms, chi)[0],
                    t.mu_np([(3, 1, 3, 1, 0, 1)], chi)[0])
    assert out["cpu"][0] == 0 and out["cuda"][0] > 0
    assert np.max(np.abs(out["cuda"][1] - out["cpu"][1])) <= 1e-12
    assert np.max(np.abs(out["cuda"][2] - out["cpu"][2])) <= 1e-10


def _nccl_rank(dedup):
    """A one-rank NCCL mesh's main path (test_one_rank_nccl_mesh...): the
    mismatches and the rank's solve launches."""
    import chip_smoke
    from qnmfits_tpu_torch import mismatch_t0_mode_sets
    from qnmfits_tpu_torch.parallel.mesh import sweep_mesh
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    mesh = sweep_mesh(device_type="cuda")
    chol_cuda.launches = 0
    mm = mismatch_t0_mode_sets(
        problem["times"], problem["data"], problem["mode_sets"],
        chip_smoke.MF, chip_smoke.CHIF, problem["t0s"],
        T_array=problem["T"], spherical_modes=chip_smoke.SPH, dedup=dedup,
        mesh=mesh, device="cuda")
    return mm, chol_cuda.launches


def test_one_rank_nccl_mesh_matches_unsharded(cuda):
    """The main path on a one-rank NCCL mesh on the card (complex results
    gathered through their real view) against mesh=None: one solve launch
    on the rank, <= 1e-12 in mismatch for t0 >= 0."""
    import chip_smoke
    from qnmfits_tpu_torch.testing import run_world
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    keep = problem["t0s"] >= 0
    for dedup in (True, False):
        (mm, launches), = run_world(_nccl_rank, 1, (dedup,),
                                    backend="nccl", timeout=240)
        ref = chip_smoke.sweep(problem, "cuda", dedup=dedup)
        assert launches == 1
        assert np.max(np.abs(mm - ref)[:, keep]) <= 1e-12
        assert np.max(np.abs(mm - ref)) <= 1e-8


# ---------------------------------------------------------------------------
# The factored sweep's kernels (csrc/factored_sweep.cu)
# ---------------------------------------------------------------------------

# (K, I, S, J, B, chunk, n_pad): several chunks each with its own anchor,
# partial blocks and chunks, padded sets, one to five data rows and 16, 17
# and 40 (past a pass's 16 columns a mode's rows take several passes), and
# J = 1, 8, 17, 40 and 96 (the team and the wide solve's sizes).
FACTORED_CASES = [(300, 2, 3, 8, 70, 16, 2), (300, 1, 2, 1, 33, 7, 0),
                  (400, 5, 2, 17, 45, 20, 4), (250, 3, 1, 40, 19, 6, 8),
                  (250, 2, 1, 96, 9, 4, 0), (2001, 2, 16, 8, 513, 128, 0),
                  (300, 16, 2, 5, 40, 12, 1), (300, 17, 2, 8, 40, 12, 2),
                  (250, 40, 2, 17, 25, 8, 3), (250, 40, 1, 96, 9, 4, 0)]


def _factored_args(case, device, seed=0):
    from qnmfits_tpu_torch.testing import random_factored_sweep
    K, I, S, J, B, chunk, n_pad = case
    r = random_factored_sweep(K, I, S, J, B, seed=seed, n_pad=n_pad)
    return ([torch.as_tensor(r[k], device=device) for k in
             ("times", "data", "omegas", "mus", "t0s", "Ts", "col_masks")],
            chunk)


@pytest.mark.parametrize("case", FACTORED_CASES)
def test_factored_kernels_match_plain(cuda, case):
    """Each kernel against its plain version on the same inputs: the
    systems relative to each system's largest entry, the epilogue on the
    plain solve's amplitudes of the plain systems."""
    import chip_smoke
    from qnmfits_tpu_torch.ops import sweep_cuda
    (times, data, om, mus, t0s, Ts, masks), chunk = _factored_args(case,
                                                                   cuda)
    S, J, B = om.shape[0], om.shape[1], t0s.shape[0]
    before = sweep_cuda.systems_launches, sweep_cuda.epilogue_launches
    got = sweep_cuda.factored_systems(times, data, om, mus, t0s, Ts, masks,
                                      chunk)
    ref = sweep_cuda.factored_systems_plain(times, data, om, mus, t0s, Ts,
                                            masks, chunk)
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        assert chip_smoke.per_system_rel(x, r, 2 if r.dim() > 1 else 1) \
            <= 1e-12
    C0 = engine_real._regularised_solve_plain(
        ref[0].reshape(S * B, J, J), ref[2].reshape(S * B, J)).reshape(S, B, J)
    C, mm = sweep_cuda.mismatch_rephase(C0, ref[1], ref[3], ref[4], om, t0s,
                                        chunk)
    C_ref, mm_ref = sweep_cuda.mismatch_rephase_plain(
        C0, ref[1], ref[3], ref[4], om, t0s, chunk)
    torch.cuda.synchronize()
    assert (sweep_cuda.systems_launches, sweep_cuda.epilogue_launches) == (
        before[0] + 1, before[1] + 1)
    assert chip_smoke.per_system_rel(C, C_ref, 2) <= 1e-12
    # Random fits are ill-conditioned: mm's two orders of summation are
    # held to the rounding of its sums.
    nan = torch.isnan(mm_ref)
    assert torch.equal(nan, torch.isnan(mm))
    bound = chip_smoke.epilogue_bound(C0, ref[1], ref[3], mm_ref)
    assert bool(((mm - mm_ref).abs() <= bound)[~nan].all())


# (K, I, S, J, B, chunk, n_pad, layout, variant): the host twin's layouts
# (tests/test_torch_factored_kernel.py) at the card's sizes: the main
# path's with dedup (513 windows one sample apart, a last chunk of one
# window) and without (16 windows a sample), chunks of one window, a chunk
# that fills three of the cluster's eight blocks, windows with no whole
# tile inside, the global workspace forced and chosen (a long grid), and
# J = 40 with 17 rows; variant None lets ``plan`` choose.
FACTORED_LAYOUTS = [
    (2001, 2, 16, 8, 513, 128, 0, "dedup", None),
    (2001, 2, 16, 8, 8192, 256, 0, "per_sample", None),
    (300, 2, 2, 8, 6, 1, 2, "dedup", None),
    (300, 2, 1, 8, 37, 16, 0, "dedup", None),
    (250, 3, 2, 5, 40, 16, 1, "short", None),
    (2001, 2, 4, 8, 300, 64, 1, "dedup", "global"),
    (40001, 2, 2, 8, 64, 16, 1, "random", None),
    (400, 17, 2, 40, 40, 8, 3, "per_sample", None)]


@pytest.mark.parametrize("case", FACTORED_LAYOUTS)
def test_factored_layouts_match_plain(cuda, case):
    """The systems kernel against its plain version on each layout, each
    system relative to its largest entry; a one-sample window's G2, rt
    and dnorm exactly 0; the long grid in the global workspace."""
    import chip_smoke
    from qnmfits_tpu_torch.ops import sweep_cuda
    from qnmfits_tpu_torch.testing import random_factored_sweep
    K, I, S, J, B, chunk, n_pad, layout, variant = case
    r = random_factored_sweep(K, I, S, J, B, seed=sum(case[:7]),
                              n_pad=n_pad, layout=layout)
    args = [torch.as_tensor(r[k], device=cuda) for k in
            ("times", "data", "omegas", "mus", "t0s", "Ts", "col_masks")]
    got = sweep_cuda._factored_systems(*args, chunk, variant=variant)
    ref = sweep_cuda.factored_systems_plain(*args, chunk)
    torch.cuda.synchronize()
    assert sweep_cuda.last_plan["variant"] == (
        variant or ("global" if K >= 40001 else "shared"))
    for x, y in zip(got, ref):
        assert chip_smoke.per_system_rel(x, y, 2 if y.dim() > 1 else 1) \
            <= 1e-12
    a = np.searchsorted(r["times"], r["t0s"], side="left")
    one = torch.as_tensor(np.searchsorted(r["times"], r["t0s"] + r["Ts"],
                                          side="left") - a == 1, device=cuda)
    assert bool(one.any()) == (layout != "random")
    assert not got[1][:, one].any() and not got[3][:, one].any()
    assert not got[4][one].any()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("case", [(2001, 2, 4, 8, 300, 64, 1, "dedup"),
                                  (600, 5, 2, 17, 90, 32, 2, "per_sample")])
def test_factored_cluster_sizes_match_plain(cuda, case, cluster):
    """Every cluster size the wrapper may choose, forced, against the plain
    version: one pass (J = 8, I = 2) and several (J = 17, I = 5: three
    passes, a whole cluster barrier between them)."""
    import chip_smoke
    from qnmfits_tpu_torch.ops import sweep_cuda
    from qnmfits_tpu_torch.testing import random_factored_sweep
    K, I, S, J, B, chunk, n_pad, layout = case
    r = random_factored_sweep(K, I, S, J, B, seed=cluster, n_pad=n_pad,
                              layout=layout)
    args = [torch.as_tensor(r[k], device=cuda) for k in
            ("times", "data", "omegas", "mus", "t0s", "Ts", "col_masks")]
    got = sweep_cuda._factored_systems(*args, chunk, cluster=cluster)
    ref = sweep_cuda.factored_systems_plain(*args, chunk)
    torch.cuda.synchronize()
    assert sweep_cuda.last_plan["cluster"] == cluster
    for x, y in zip(got, ref):
        assert chip_smoke.per_system_rel(x, y, 2 if y.dim() > 1 else 1) \
            <= 1e-12


def test_factored_kernels_do_not_spill(cuda):
    from qnmfits_tpu_torch.ops import sweep_cuda
    report = sweep_cuda.ptxas_report()
    assert set(report) == set(sweep_cuda.KERNELS)
    for name, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)


def test_main_path_sweep_launches_each_kernel_once(cuda):
    """One main-path sweep, with and without dedup: one launch of the
    systems kernel, one of the solve and one of the epilogue (and none of
    the window moments), and the result within 1e-11 of the all-plain
    route for t0 >= 0."""
    import chip_smoke
    from qnmfits_tpu_torch.ops import sweep_cuda
    problem = chip_smoke.build_problem(**chip_smoke.SMALL)
    keep = problem["t0s"] >= 0
    for dedup in (True, False):
        mm, n, _, _, fac = chip_smoke.drive(
            lambda: chip_smoke.sweep(problem, "cuda", dedup=dedup))
        assert (n, *fac) == (1, 1, 1, 0)
        before = sweep_cuda.systems_launches, sweep_cuda.epilogue_launches
        with chip_smoke.all_plain():
            mm_plain = chip_smoke.sweep(
                problem, "cuda", dedup=dedup,
                solve=engine_real._regularised_solve_plain)
        assert (sweep_cuda.systems_launches,
                sweep_cuda.epilogue_launches) == before
        assert np.max(np.abs(mm - mm_plain)[:, keep]) <= 1e-11


def test_factored_kernels_reject_bad_input(cuda):
    """Wrong dtype, a tensor on another device and a misaligned complex128
    view raise; nothing launches and nothing falls back."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    (times, data, om, mus, t0s, Ts, masks), chunk = _factored_args(
        FACTORED_CASES[0], cuda)
    before = sweep_cuda.systems_launches
    with pytest.raises(TypeError):
        sweep_cuda.factored_systems(times.float(), data, om, mus, t0s, Ts,
                                    masks, chunk)
    with pytest.raises(ValueError):
        sweep_cuda.factored_systems(times, data.cpu(), om, mus, t0s, Ts,
                                    masks, chunk)
    raw = torch.empty(data.numel() * 16 + 8, dtype=torch.uint8, device=cuda)
    skew = torch.empty(0, dtype=torch.complex128, device=cuda).set_(
        raw.untyped_storage()[8:], 0, data.shape, data.stride())
    skew.copy_(data)
    with pytest.raises(ValueError, match="aligned"):
        sweep_cuda.factored_systems(times, skew, om, mus, t0s, Ts, masks,
                                    chunk)
    assert sweep_cuda.systems_launches == before


def test_debug_nans_sees_the_factored_kernels_output(cuda, monkeypatch):
    """With ``check_nans`` on (``utils.debug_nans``), a NaN in the data
    raises in the systems kernel's wrapper; with it off, nothing is
    checked."""
    from qnmfits_tpu_torch.ops import sweep_cuda
    (times, data, om, mus, t0s, Ts, masks), chunk = _factored_args(
        FACTORED_CASES[0], cuda)
    data[0, 40:60] = float("nan")
    rhs = sweep_cuda.factored_systems(times, data, om, mus, t0s, Ts, masks,
                                      chunk)[2]
    assert bool(torch.isnan(rhs).any())
    monkeypatch.setattr(chol_cuda, "check_nans", True)
    with pytest.raises(FloatingPointError, match="factored_systems"):
        sweep_cuda.factored_systems(times, data, om, mus, t0s, Ts, masks,
                                    chunk)


# The angular eigen-kernel (csrc/angular_eig.cu) against its plain version
# (torch.linalg.eig of the CPU copy): s, m, nl and |c| as the CPU tests of
# its host build (tests/test_torch_angular_eig.py) take them, B = 1 and 33
# (a partial block), and at the solver's orders with s = -2, m = 2 also
# 800 (a fine pass's Newton step of 400 spins).
EIG_NLS = (1, 2, 5, 25, 28, 34, 64)


def _eig_held(s, l, m, c, nl, variant=None, team=None):
    """Both modes of the kernel on the CUDA c against the plain version of
    its CPU copy: eigenvalues as a set within 1e-12 max(1, ||M||_F); the
    selected eigenvalue and vector (the guess near the eigenvalue whose
    vector has the largest entry l - lmin) within 1e-12 and 1e-10; the
    residual within 1e-13 ||M||_F."""
    from qnmfits_tpu_torch.ops import eig_cuda
    from qnmfits_tpu_torch.testing import eig_matching
    sel = l - max(abs(s), abs(m))
    cc = c.cpu()
    M = eig_cuda.angular_matrices(s, m, cc, nl)
    fro = torch.linalg.matrix_norm(M).numpy()
    A_all, C_all = torch.linalg.eig(M)
    k = torch.argmax(C_all[:, sel, :].abs(), dim=1)
    guess = A_all[torch.arange(len(cc)), k] + 1e-4
    before = eig_cuda.launches
    ev, _, _ = eig_cuda._launch(s, m, c, nl, variant=variant, team=team)
    _, A, C = eig_cuda._launch(s, m, c, nl, guess.to(c.device), sel,
                               variant=variant, team=team)
    torch.cuda.synchronize()
    assert eig_cuda.launches == before + 2
    _, gap = eig_matching(ev.cpu().numpy(), eig_cuda.eigvals_plain(
        s, m, cc, nl).numpy())
    assert np.all(gap <= 1e-12 * np.maximum(1.0, fro))
    Ap, Cp = eig_cuda.eigpair_plain(s, l, m, cc, nl, guess)
    A, C = A.cpu(), C.cpu()
    assert np.all((A - Ap).abs().numpy() <= 1e-12 * np.maximum(1.0, fro))
    assert float((C - Cp).abs().max()) <= 1e-10
    res = torch.linalg.vector_norm(
        torch.einsum("bij,bj->bi", M, C) - A[:, None] * C, dim=1).numpy()
    assert np.all(res <= 1e-13 * fro)


@pytest.mark.parametrize("m", range(-3, 4))
@pytest.mark.parametrize("s", [-2, -1, 0])
def test_angular_eig_kernel_matches_plain(cuda, s, m):
    rng = np.random.default_rng(100 * (s + 2) + m + 7)
    for nl in EIG_NLS:
        big = (s, m) == (-2, 2) and nl in (25, 28, 34)
        for B in (1, 33, 800) if big else (1, 33):
            c = 5.0 * rng.random(B) * np.exp(2j * np.pi * rng.random(B))
            _eig_held(s, max(abs(s), abs(m)) + min(2, nl - 1), m,
                      torch.as_tensor(c, device=cuda), nl)


@pytest.mark.parametrize("team", [1, 2])
@pytest.mark.parametrize("variant", ["shared", "global"])
@pytest.mark.parametrize("nl", [25, 28, 34])
@pytest.mark.parametrize("B", [1, 2])
def test_angular_eig_kernel_small_launches_match_plain(cuda, B, nl, variant,
                                                       team):
    """The coarse pass's launches, one and two matrices, at the solver's
    orders under every plan the wrapper can take (shared memory, or the
    workspace's kernel; a team of two warps a matrix, one a block, as the
    plan takes for such launches, or one warp a matrix), c of the coarse
    pass's kind."""
    from qnmfits_tpu_torch.ops import eig_cuda
    rng = np.random.default_rng(10 * nl + B)
    c = (0.5 + rng.random(B)) * np.exp(-1j * (0.3 + rng.random(B)))
    assert eig_cuda.plan(nl, B)["team"] == 2
    _eig_held(-2, 5, 2, torch.as_tensor(c, device=cuda), nl, variant, team)
    assert eig_cuda.last_plan["variant"] == variant
    assert eig_cuda.last_plan["team"] == team
    assert eig_cuda.last_plan["blocks"] == (1 if team == 1 else B)


@pytest.mark.parametrize("nl,variant", [(28, "global"), (130, None)])
def test_angular_eig_kernel_workspace_matches_plain(cuda, nl, variant):
    """The global workspace, forced at nl = 28 and past the shared memory
    at nl = 130."""
    from qnmfits_tpu_torch.ops import eig_cuda
    rng = np.random.default_rng(nl)
    c = 3.0 * rng.random(40) * np.exp(2j * np.pi * rng.random(40))
    _eig_held(-2, 5, 2, torch.as_tensor(c, device=cuda), nl, variant)
    assert eig_cuda.last_plan["variant"] == "global"


def test_angular_eig_kernel_on_tracked_rows(cuda):
    """c along the baked (2,2,0) and (2,2,7) tracks to chi = 0.9995."""
    from qnmfits_tpu_torch.spectrum.tables import table_path
    with np.load(table_path(-2)) as z:
        keys = [tuple(k) for k in z["keys"]]
        for n in (0, 7):
            c = z["chi"] * z["omega"][keys.index((2, 2, n))]
            _eig_held(-2, 2, 2, torch.as_tensor(c, device=cuda), 25)


def test_angular_eig_never_reaches_torch_linalg(cuda, tmp_path, monkeypatch):
    """With torch.linalg.eig and eigvals made to raise, the wrappers and a
    short on-demand track on the card run through the kernel alone."""
    from qnmfits_tpu_torch.ops import eig_cuda
    from qnmfits_tpu_torch.spectrum import solver

    def refuse(*a, **k):
        raise AssertionError("a CUDA c reached torch.linalg")

    monkeypatch.setattr(torch.linalg, "eig", refuse)
    monkeypatch.setattr(torch.linalg, "eigvals", refuse)
    c = torch.full((3,), 0.3 - 0.1j, dtype=torch.complex128, device=cuda)
    before = eig_cuda.launches
    eig_cuda.angular_eigvals(-2, 2, c, 25)
    eig_cuda.angular_eigpair(-2, 2, 2, c, 25, torch.full_like(c, 4.0))
    seeds = solver.schwarzschild_seeds(l_max=2, n_max=0, s=-2,
                                       device="cuda")
    w, A, C = solver.track_mode(2, 2, 0, seeds[(2, 0)],
                                solver.default_chi_grid(17, 0.6),
                                device="cuda")
    assert eig_cuda.launches > before + 2
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(C))


def test_angular_eig_kernel_cap_and_bad_input_raise(cuda):
    from qnmfits_tpu_torch.ops import eig_cuda
    c = torch.tensor([0.0, 2.0 - 1.0j], dtype=torch.complex128, device=cuda)
    with pytest.raises(RuntimeError, match="did not converge within 0"):
        eig_cuda._launch(-2, 2, c, 25, max_its=0)
    with pytest.raises(RuntimeError, match="not finite"):
        eig_cuda.angular_eigvals(-2, 2, torch.full_like(c, complex("nan")),
                                 25)
    with pytest.raises(TypeError, match="complex128"):
        eig_cuda.angular_eigvals(-2, 2, c.to(torch.complex64), 25)
    with pytest.raises(ValueError, match="shared memory"):
        eig_cuda._launch(-2, 2, c, 130, variant="shared")
    raw = torch.empty(3 * 16 + 8, dtype=torch.uint8, device=cuda)
    odd = torch.empty(0, dtype=torch.complex128, device=cuda).set_(
        raw.untyped_storage()[8:], 0, (3,), (1,))
    before = eig_cuda.launches
    with pytest.raises(ValueError, match="aligned"):
        eig_cuda.angular_eigvals(-2, 2, odd, 25)
    assert eig_cuda.launches == before


def test_angular_eig_kernel_does_not_spill(cuda):
    from qnmfits_tpu_torch.ops import eig_cuda
    for name, r in eig_cuda.ptxas_report().items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)


def test_angular_eig_kernel_counts_operations(cuda):
    """The launch's info reports the FP64 operations of the kernel's loops
    (the bound's count), as the host build does: a 2 x 2's sweep is one
    rotation of 4 pairs (20 operations each); an order-28 matrix adds to
    its sweeps the reduction's (2n - k - 1)(16 len_k + 6) a step, len_k =
    min(k + 2, n - k - 1)."""
    from qnmfits_tpu_torch.ops import eig_cuda
    rng = np.random.default_rng(3)
    c = torch.as_tensor(3.0 * rng.random(6)
                        * np.exp(2j * np.pi * rng.random(6)), device=cuda)
    eig_cuda._launch(-2, 2, c, 2)
    info = eig_cuda.last_info.cpu().numpy()
    assert np.all(info[:, 0] > 0)
    assert np.array_equal(info[:, 1], 80 * info[:, 0])
    n = 28
    eig_cuda._launch(-2, 2, c, n)
    info = eig_cuda.last_info.cpu().numpy()
    hess = sum((2 * n - k - 1) * (16 * min(k + 2, n - k - 1) + 6)
               for k in range(n - 2))
    sweeps = info[:, 1] - hess
    assert np.all(sweeps % 20 == 0) and np.all(sweeps >= 80 * info[:, 0])


# ---------------------------------------------------------------------------
# The window moments kernel (csrc/window_moments.cu)
# ---------------------------------------------------------------------------

def _moments_inputs(device, K, N, M, I, J, seed, grid="uniform"):
    """window_moments' arguments (before the order) on ``device``, from
    ``testing.random_window_moments`` on its ``grid``."""
    from qnmfits_tpu_torch.ops.windows import window_geq
    from qnmfits_tpu_torch.testing import random_window_moments
    r = random_window_moments(K, N, M, I, J, seed=seed, grid=grid)
    times = torch.as_tensor(r["times"], device=device)
    t0s = torch.as_tensor(r["t0s"], device=device)
    w = window_geq(times, t0s[:, None],
                   torch.as_tensor(r["Ts"], device=device)[:, None])
    return (times, torch.as_tensor(r["data"], device=device),
            torch.as_tensor(r["omega"], device=device), t0s, w,
            torch.as_tensor(r["win"], device=device))


def _moments_gap(out, ref):
    """The largest |difference| of each moment (S or P, weight, power)
    over that moment's largest entry, the largest over the moments."""
    gap = 0.0
    for a, b in zip(out, ref):
        for v in range(2):
            for p in range(a.shape[2]):
                gap = max(gap, float((a[:, v, p] - b[:, v, p]).abs().max()
                                     / b[:, v, p].abs().max()))
    return gap


def _moments_variant(args, order, uniform):
    """One launch of the kernel's variant (``uniform``: the uniform one,
    with the grid's step, tau not passed; else the general one) on the
    wrapper's arguments, through its C entry: S, P and the plan it ran."""
    from qnmfits_tpu_torch.ops import moments_cuda
    from qnmfits_tpu_torch.ops.windows import trapz_weights
    times, rows, omega, t0s, w, win = args
    grid = moments_cuda.moments_grid(times) if uniform else (False, 0.0)
    assert grid[0] == uniform
    tau = None if uniform else trapz_weights(times, w)
    first, count = (b.to(torch.int32) for b in moments_cuda.window_bounds(w))
    M, J = omega.shape
    I = rows.shape[0]
    S = torch.full((M, 2, order + 1, J, J), complex("nan+nanj"),
                   dtype=torch.complex128, device=omega.device)
    P = torch.full((M, 2, order + 1, I, J), complex("nan+nanj"),
                   dtype=torch.complex128, device=omega.device)
    moments_cuda._launch(times, rows, omega, t0s, tau, first, count, win, S,
                         P, order, grid)
    return (S, P), moments_cuda.last_plan


# The grid of random_window_moments a J takes: two in three uniform (the
# uniform variant), the rest near-uniform or random (the general one).
_GRID_OF = {0: "random", 1: "uniform", 2: "uniform"}


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("J", range(1, 17))
def test_window_moments_kernel_matches_plain(cuda, order, J):
    """Orders 0-2, J = 1..16 with I = 1..3 rows, on a uniform grid of 2001
    samples and (every third J) a random or near-uniform one: the wrapper
    launches the variant of the grid's gate (``last_plan``), every moment
    within 1e-12 of its largest entry (two orders of summation over <= 400
    samples), the Gram Hermitian with a real diagonal."""
    from qnmfits_tpu_torch.ops import moments_cuda
    grid = _GRID_OF[J % 3] if J % 6 else "near-uniform"
    args = _moments_inputs(cuda, 2001, 40, 97, 1 + J % 3, J, seed=J,
                           grid=grid)
    before = moments_cuda.launches
    S, P = moments_cuda.window_moments(*args, order)
    assert moments_cuda.launches == before + 1
    assert moments_cuda.last_plan["variant"] == (
        "uniform" if grid == "uniform" else "general")
    ref = moments_cuda.window_moments_plain(*args, order)
    torch.cuda.synchronize()
    assert S.shape == ref[0].shape and P.shape == ref[1].shape
    assert _moments_gap((S, P), ref) <= 1e-12
    assert torch.equal(S, S.mH)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("I", [1, 2, 3])
@pytest.mark.parametrize("J", [1, 3, 8, 9, 17])
def test_window_moments_variants_match_plain(cuda, order, I, J):
    """Both variants on a uniform grid (the general one forced through the
    C entry), and the general one on a near-uniform grid that the gate
    refuses, each within 1e-12 of the plain version; the empty, one-sample
    and off-the-end windows of ``random_window_moments`` among them."""
    from qnmfits_tpu_torch.ops import moments_cuda
    for grid, variants in (("uniform", (True, False)),
                           ("near-uniform", (False,))):
        args = _moments_inputs(cuda, 2001, 24, 61, I, J,
                               seed=100 * order + 10 * I + J, grid=grid)
        assert moments_cuda.moments_grid(args[0])[0] == (grid == "uniform")
        ref = moments_cuda.window_moments_plain(*args, order)
        for uniform in variants:
            out, plan = _moments_variant(args, order, uniform)
            torch.cuda.synchronize()
            assert plan == moments_cuda.plan(I, J, order, uniform, 61)
            assert _moments_gap(out, ref) <= 1e-12, (grid, uniform)
            assert torch.equal(out[0], out[0].mH)


@pytest.mark.parametrize("K,N,M,I,J,order", [
    (20001, 12, 64, 2, 8, 2), (20001, 6, 30, 3, 16, 1),
    (20001, 9, 513, 1, 4, 0), (7, 4, 9, 2, 3, 2), (2001, 513, 2565, 2, 8, 2),
    (2001, 40, 300, 3, 40, 1), (2001, 20, 40, 17, 5, 2)])
def test_window_moments_kernel_shapes_match_plain(cuda, K, N, M, I, J,
                                                  order):
    """Long grids (windows of up to 4000 samples), a grid shorter than a
    tile, O2's Newton shape (2565 trajectories on 513 windows), many units
    a trajectory (J = 40: five mode groups) and 17 data rows (stage
    buffers past 48 KiB of shared memory, by opt-in), in the uniform
    variant the wrapper picks and in the general one."""
    from qnmfits_tpu_torch.ops import moments_cuda
    args = _moments_inputs(cuda, K, N, M, I, J, seed=K + J)
    out = moments_cuda.window_moments(*args, order)
    assert moments_cuda.last_plan["variant"] == "uniform"
    ref = moments_cuda.window_moments_plain(*args, order)
    general, plan = _moments_variant(args, order, False)
    torch.cuda.synchronize()
    assert plan["variant"] == "general"
    assert _moments_gap(out, ref) <= 1e-12
    assert _moments_gap(general, ref) <= 1e-12


def test_window_moments_trajectories_sharing_windows(cuda):
    """64 trajectories on 3 windows (the seeds' layout: many a window),
    each omega given to two trajectories on the same window: their moments
    are equal bit for bit, and match the plain version, in both variants."""
    from qnmfits_tpu_torch.ops import moments_cuda
    times, rows, omega, t0s, w, _ = _moments_inputs(
        cuda, 2001, 3, 32, 2, 8, seed=5)
    omega = torch.cat([omega, omega])
    win = torch.as_tensor(np.tile(np.arange(32) % 3, 2), device=cuda)
    args = (times, rows, omega, t0s, w, win)
    for order in (0, 2):
        ref = moments_cuda.window_moments_plain(*args, order)
        for uniform in (True, False):
            (S, P), _ = _moments_variant(args, order, uniform)
            torch.cuda.synchronize()
            assert torch.equal(S[:32], S[32:]) and torch.equal(P[:32], P[32:])
            assert _moments_gap((S, P), ref) <= 1e-12


def test_window_moments_kernel_counts_and_rejects_bad_input(cuda):
    """One count a launch, none for an empty batch or a refused call; a
    wrong dtype, shape, order, device mix, a non-contiguous input or more
    data rows than a block's shared memory holds (49) raises before any
    launch; a grid given (``moments_grid``) is the one launched."""
    from qnmfits_tpu_torch.ops import moments_cuda
    args = list(_moments_inputs(cuda, 301, 5, 11, 2, 3, seed=1))
    before = moments_cuda.launches
    moments_cuda.window_moments(*args, 1)
    assert moments_cuda.launches == before + 1
    assert moments_cuda.last_plan["variant"] == "uniform"
    moments_cuda.window_moments(*args, 1, grid=(False, 0.0))
    assert moments_cuda.last_plan["variant"] == "general"
    assert moments_cuda.launches == before + 2
    empty = list(args)
    empty[2], empty[5] = args[2][:0], args[5][:0]
    S, _ = moments_cuda.window_moments(*empty, 1)
    assert S.shape == (0, 2, 2, 3, 3)
    assert moments_cuda.launches == before + 2
    bad = [((2, args[2].to(torch.complex64)), TypeError, "complex128"),
           ((5, args[5].to(torch.int32)), TypeError, "int64"),
           ((1, args[1].T.contiguous().T), ValueError, "contiguous"),
           ((2, args[2].T.contiguous().T), ValueError, "contiguous"),
           ((4, args[4][:, :-1]), ValueError, "shapes"),
           ((0, args[0].cpu()), ValueError, "tensors on")]
    for (i, t), exc, match in bad:
        call = list(args)
        call[i] = t
        with pytest.raises(exc, match=match):
            moments_cuda.window_moments(*call, 1)
    with pytest.raises(ValueError, match="order 3"):
        moments_cuda.window_moments(*args, 3)
    many = list(args)
    many[1] = args[1].repeat(25, 1)[:49]
    with pytest.raises(ValueError, match="shared memory"):
        moments_cuda.window_moments(*many, 1)
    assert moments_cuda.launches == before + 2


def test_window_moments_kernel_does_not_spill(cuda):
    """Neither variant spills at any order, nor does the phases build."""
    from qnmfits_tpu_torch.ops import moments_cuda
    for phases in (False, True):
        report = moments_cuda.ptxas_report(phases)
        assert set(report) == {f"{v}_order{p}" for v in moments_cuda.VARIANTS
                               for p in (0, 1, 2)}
        for name, r in report.items():
            assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (name, r)


def test_window_moments_phase_cycles(cuda):
    """The phases build runs and reads a warp's cycles by phase, in the
    variant the grid takes."""
    from qnmfits_tpu_torch.ops import moments_cuda
    for grid in ("uniform", "near-uniform"):
        args = _moments_inputs(cuda, 2001, 24, 61, 2, 8, seed=3, grid=grid)
        per = moments_cuda.phase_cycles(*args, 2)
        assert per["variant"] == ("uniform" if grid == "uniform"
                                  else "general")
        assert per["warps"] == 61 and per["mma"] > 0


def test_array_optimisers_launch_the_moments_kernel(cuda):
    """The Newton stage's fits and derivatives on the card go through the
    moments kernel and the solve kernel: f, g and H against the plain
    moments and plain solve, and against autograd (``optimize._grad``),
    on 50 trajectories over several windows."""
    from qnmfits_tpu_torch import optimize
    from qnmfits_tpu_torch.engine import cached_evaluator
    from qnmfits_tpu_torch.ops import moments_cuda
    from qnmfits_tpu_torch.testing import synthetic_multimode
    s = synthetic_multimode(modes=[(2, 2, n, 1) for n in range(4)],
                            spherical_modes=SPH_CUDA,
                            times=np.arange(-10.0, 30.0, 0.1), seed=21)
    data = np.stack([s["data_dict"][lm] for lm in SPH_CUDA])
    modes = [(2, 2, n, 1) for n in range(3)]
    spectrum = optimize.epsilon_spectrum(
        cached_evaluator(modes, SPH_CUDA), SPH_CUDA, 1.0, cuda)
    rng = np.random.default_rng(5)
    t0s = np.array([0.0, 2.0, 5.0, 12.0, 25.0])
    win = torch.as_tensor(rng.integers(0, 5, 50), device=cuda)
    x = torch.as_tensor(np.stack([rng.uniform(0.8, 1.1, 50),
                                  rng.uniform(0.5, 0.98, 50)], 1),
                        device=cuda)
    out = {}
    for name, solve in (("kernel", None),
                        ("plain", engine_real._regularised_solve_plain)):
        prob = optimize._Problem(s["times"], data, t0s, np.full(5, 20.0),
                                 "geq", cuda, solve)
        saved = moments_cuda.window_moments
        if name == "plain":
            moments_cuda.window_moments = (
                lambda *a, grid=None: moments_cuda.window_moments_plain(*a))
        try:
            before = moments_cuda.launches
            out[name] = optimize._fit_derivs(prob, spectrum, x, win, 2)
            assert moments_cuda.launches == before + (name == "kernel")
        finally:
            moments_cuda.window_moments = saved
    g, H = optimize._grad(lambda y: prob.mm(*spectrum(y), win), x,
                          hessian=True)
    for a, b in zip(out["kernel"], out["plain"]):
        assert _rel(a.reshape(1, -1), b.reshape(1, -1)) <= 1e-10
    assert _rel(out["kernel"][1].reshape(1, -1), g.reshape(1, -1)) <= 1e-8
    assert _rel(out["kernel"][2].reshape(1, -1), H.reshape(1, -1)) <= 1e-8
