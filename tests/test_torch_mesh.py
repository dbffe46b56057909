"""The port's mesh (qnmfits_tpu_torch.parallel.mesh and every ``mesh=`` /
engine='sharded' route) against the JAX package's, on the CPU.

The cases mirror tests/test_parallel.py case by case.  The JAX function
runs on the conftest's virtual 8-device CPU mesh; the port on a gloo
world of four CPU ranks (``testing.run_world``), launched once for the
module: one rank function runs every case on the meshes (4, 1), (2, 2)
and (1, 4) of that world and returns NumPy arrays, with the port's
unsharded results beside them.  Both get the same numpy inputs, made
here from seeds.  Bounds: port against JAX <= 1e-11 in mismatch for
t0 >= 0 (JAX's own route before the ringdown: 1e-8), amplitudes <= 1e-11
of the largest, optimiser parameters <= 1e-6; sharded against the port's
unsharded <= 1e-12 (the optimisers' parameters, whose lock-step batches
differ in size, 1e-6).  The ranks import neither jax nor qnmfits_tpu: this
module imports them only inside fixtures and tests, never at its top,
because a spawned rank imports the module of its function.

test_parallel.py's ``__graft_entry__`` dry run and its JAX-platform
hardening test, and its test of the jitted runner's cache, have no
counterpart: the port has no graft entry, no platform plugin and nothing
to compile.
"""

import numpy as np
import pytest

MM_TOL = 1e-11          # port vs JAX, mismatch, t0 >= 0
PRE_TOL = 1e-8          # the same before the ringdown
AMP_TOL = 1e-11         # amplitudes, of the largest
PARAM_TOL = 1e-6        # optimiser parameters
SHARD_TOL = 1e-12       # sharded vs the port's unsharded
SHAPES = ((4, 1), (2, 2), (1, 4))
WORLD = 4
EPS_T0S = np.linspace(0.0, 12.0, 6)          # 6 % 4 != 0: pad and trim


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


def _close(x, ref, tol):
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# The inputs (numpy, from seeds) and the ranks' results
# ---------------------------------------------------------------------------

def _two_d_times(times):
    """Start times whose windows (T = 40) start and end inside, on and
    across the shard boundaries of 2 and 4 time shards."""
    K = len(times)
    edges = [times[K // 4], times[K // 2], times[3 * K // 4]]
    t0s = [2.0, edges[0], edges[0] + 0.05, edges[1] - 40.0,
           edges[1] - 40.05, edges[1], edges[2] - 40.0, 20.0]
    return np.sort(np.asarray(t0s))


@pytest.fixture(scope="module")
def inputs():
    from qnmfits_tpu.engine import SpectrumEvaluator
    from qnmfits_tpu.testing import synthetic_multimode
    from qnmfits_tpu_torch.testing import synthetic_single
    import chip_smoke

    syn = synthetic_multimode(seed=41)
    ev = SpectrumEvaluator(syn["modes"], syn["spherical_modes"])
    data = np.stack([syn["data_dict"][lm] for lm in syn["spherical_modes"]])
    data = data + 1e-3 * np.exp(-0.05 * np.abs(syn["times"]))
    K = len(syn["times"]) // 8 * 8
    base = dict(times=syn["times"][:K], data=data[:, :K],
                omega=np.asarray(ev.omega(syn["chif"], syn["Mf"])),
                mu=np.asarray(ev.mu(syn["chif"])))
    rng = np.random.default_rng(17)
    t = np.arange(-10.0, 110.0, 0.1)
    Q, J, I = 11, 4, 2
    spectra = dict(times=t, omegas=rng.uniform(0.3, 0.9, (Q, J))
                   - 1j * rng.uniform(0.05, 0.5, (Q, J)),
                   mus=rng.normal(size=(Q, I, J))
                   + 1j * rng.normal(size=(Q, I, J)),
                   rows=rng.normal(size=(I, t.size))
                   + 1j * rng.normal(size=(I, t.size)))
    rng = np.random.default_rng(23)
    t_nu = t + 0.01 * np.sin(np.arange(t.size))
    gate = dict(times=t_nu, omega=rng.uniform(0.3, 0.9, 4)
                - 1j * rng.uniform(0.05, 0.5, 4),
                mu=rng.normal(size=(2, 4)) + 1j * rng.normal(size=(2, 4)),
                data=rng.normal(size=(2, t.size))
                + 1j * rng.normal(size=(2, t.size)))
    gate["omegas"] = (rng.uniform(0.3, 0.9, (9, 4))
                      - 1j * rng.uniform(0.05, 0.5, (9, 4)))
    gate["mus"] = (rng.normal(size=(9, 2, 4))
                   + 1j * rng.normal(size=(9, 2, 4)))

    s43 = synthetic_multimode(seed=43)
    s21 = synthetic_multimode(seed=21)
    g21 = synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                           noise=1e-4, seed=21)
    d17 = synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                           noise=1e-6, seed=17)
    tt = d17["times"]
    f7 = synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                          noise=0.0, seed=7)
    e5 = synthetic_single(modes=[(2, 2, n, 1) for n in range(3)],
                          noise=0.0, seed=5)
    m3 = synthetic_multimode(seed=3)
    rng = np.random.default_rng(42)
    ev_t = np.arange(-5.0, 35.0, 0.1)
    E = 10                                         # 10 % 4 != 0: pad+trim
    map_times = np.arange(-10.0, 60.0, 0.1)
    return dict(
        base=base, spectra=spectra, gate=gate,
        s43=dict(times=s43["times"], data=s43["data_dict"],
                 modes=s43["modes"], sph=s43["spherical_modes"],
                 Mf=s43["Mf"], chif=s43["chif"]),
        s21=dict(times=s21["times"], data=s21["data_dict"],
                 sph=s21["spherical_modes"], Mf=s21["Mf"],
                 chif=s21["chif"]),
        g21=dict(times=g21["times"], data=g21["data"], modes=g21["modes"],
                 Mf=g21["Mf"], chif=g21["chif"]),
        d17=dict(times=tt, data=d17["data"],
                 Mf_t=d17["Mf"] * (1.0 + 0.02 * np.tanh(tt / 20.0)),
                 chif_t=np.clip(d17["chif"] * (1.0 - 0.03 * np.exp(
                     -tt / 30.0)), 0.0, 0.99)),
        f7=dict(times=f7["times"], data=f7["data"], Mf=f7["Mf"],
                chif=f7["chif"]),
        e5=dict(times=e5["times"], data=e5["data"], modes=e5["modes"],
                Mf=e5["Mf"], chif=e5["chif"]),
        m3=dict(times=m3["times"], data=m3["data_dict"], modes=m3["modes"],
                sph=m3["spherical_modes"], Mf=m3["Mf"], chif=m3["chif"]),
        events=dict(times=ev_t, rows=rng.normal(size=(E, ev_t.size))
                    + 1j * rng.normal(size=(E, ev_t.size)),
                    Mfs=rng.uniform(0.90, 0.99, E),
                    chifs=rng.uniform(0.45, 0.85, E),
                    t0s=rng.uniform(0.0, 6.0, E)),
        mapping=dict(times=map_times,
                     data=chip_smoke.build_mapping(map_times)))


def _rank_cases(inp):
    """Every case on the meshes of a four-rank world, with the port's
    unsharded results beside the sharded ones (NumPy arrays)."""
    import torch
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch import batched, engine, engine_real
    from qnmfits_tpu_torch import spatial_engine
    from qnmfits_tpu_torch.parallel import mesh as pm

    def real(x):
        return torch.as_tensor(np.asarray(x, float), dtype=torch.float64)

    def cplx(x):
        return torch.as_tensor(np.asarray(x, complex),
                               dtype=torch.complex128)

    def np_(*xs):
        return tuple(x.numpy() for x in xs)

    b = inp["base"]
    times, data = real(b["times"]), cplx(b["data"])
    omega, mu = cplx(b["omega"]), cplx(b["mu"])
    t47 = real(np.linspace(0.0, 30.0, 47))
    T47 = real(np.full(47, 60.0))
    J = omega.shape[0]
    masks = torch.ones((2, J), dtype=torch.bool)
    masks[1, J // 2:] = False
    sets = (torch.stack([omega, omega]), torch.stack([mu, mu]))
    t11 = real(np.linspace(0.0, 18.0, 11))
    T11 = real(np.full(11, 60.0))
    tb = b["times"]
    t_cl = real([tb[40] + 0.4 * (tb[41] - tb[40])])
    w3 = ((times >= 3.0) & (times < 63.0)).to(torch.float64)
    t2d = real(_two_d_times(b["times"]))
    T2d = real(np.full(len(t2d), 40.0))
    times_nu = times + 0.01 * torch.sin(torch.arange(times.shape[0],
                                                     dtype=torch.float64))
    pad = (torch.cat([omega, cplx([0.0])]),
           torch.cat([mu, torch.zeros((mu.shape[0], 1),
                                      dtype=torch.complex128)], dim=1),
           torch.tensor([True] * J + [False]))

    out = dict(rank=pm.dist.get_rank(), unsharded={})
    u = out["unsharded"]
    u["fact"] = np_(*engine_real.sweep_t0_factored_real(
        times, data, omega, mu, t47, T47, chunk=4))
    u["modesets"] = np_(*engine_real.sweep_t0_modesets_factored_real(
        times, data, *sets, t11, T11, masks, chunk=2))
    u["closest"] = np_(*batched.sweep_t0_core(times, data, omega, mu, t_cl,
                                               real([60.0]), "closest"))
    u["fit"] = np_(*engine.fit_core(times, data, omega, mu,
                                    torch.tensor(3.0, dtype=torch.float64),
                                    w3))
    for nu, tt in (("u", times), ("nu", times_nu)):
        u[f"2d_{nu}"] = np_(*engine_real.sweep_t0_factored_real(
            tt, data, omega, mu, t2d, T2d, chunk=4))
    u["2d_pad"] = np_(*engine_real.sweep_t0_factored_real(
        times, data, pad[0], pad[1], t2d, T2d, col_mask=pad[2], chunk=4))

    for shape in SHAPES:
        mesh = pm.sweep_mesh(*shape)
        r = out[shape] = {}
        r["fact"] = np_(*pm.sharded_t0_sweep_factored(
            times, data, omega, mu, t47, T47, mesh, chunk=4))
        r["modesets"] = np_(*pm.sharded_t0_sweep_modesets_factored(
            times, data, *sets, t11, T11, masks, mesh, chunk=2))
        r["closest"] = np_(*pm.sharded_t0_sweep(
            times, data, omega, mu, t_cl, real([60.0]), mesh,
            t0_method="closest"))
        r["closest_geq"] = np_(*pm.sharded_t0_sweep_real(
            times, data, omega, mu, t_cl, real([60.0]), mesh))
        r["fit"] = np_(*pm.sharded_fit_core_real(times, data, omega, mu, 3.0,
                                                 w3, mesh))
        for analytic in (False, True):
            for nu, tt in (("u", times), ("nu", times_nu)):
                r[f"2d_{nu}_{analytic}"] = np_(
                    *pm.sharded_t0_sweep_factored_2d(
                        tt, data, omega, mu, t2d, T2d, mesh, chunk=4,
                        analytic=analytic))
        r["2d_pad"] = np_(*pm.sharded_t0_sweep_factored_2d(
            times, data, pad[0], pad[1], t2d, T2d, mesh, col_mask=pad[2],
            chunk=4, analytic=True))

    # The public entry points, on the (4, 1) mesh (the optimiser with
    # fixed modes on (2, 2): 'sweep' shards, 'time' repeats).
    mesh, mesh22 = pm.sweep_mesh(4, 1), pm.sweep_mesh(2, 2)
    p = out["public"] = {}
    s = inp["s43"]
    t9 = np.linspace(0.0, 24.0, 9)
    p["t0_array"] = tq.mismatch_t0_array(
        s["times"], s["data"], s["modes"], s["Mf"], s["chif"], t9,
        spherical_modes=s["sph"], engine="sharded", mesh=mesh, device="cpu")
    mode_sets = [[(2, 2, n, 1) for n in range(nmax)] for nmax in (1, 3)]
    t10 = np.linspace(0.0, 16.0, 10)
    for m, key in ((mesh, "modesets"), (None, "modesets_1")):
        p[key] = batched.batch_mismatch_t0_modesets(
            s["times"], s["data"], mode_sets, s["Mf"], s["chif"], t10,
            T_array=70.0, spherical_modes=s["sph"], mesh=m, device="cpu")

    s = inp["s21"]
    dense = [[(2, 2, 0, 1)], [(2, 2, 0, 1), (2, 2, 1, 1)]]
    t247 = np.linspace(0.0, 12.0, 247)
    for m, dedup, key in ((mesh, True, "dense"), (None, True, "dense_1"),
                          (None, False, "dense_0")):
        p[key] = batched.batch_mismatch_t0_modesets(
            s["times"], s["data"], dense, s["Mf"], s["chif"], t247,
            T_array=60.0, spherical_modes=s["sph"], return_amplitudes=True,
            mesh=m, dedup=dedup, device="cpu")

    g = inp["g21"]
    kw = dict(t0=5.0, T=80.0, res=9, device="cpu")
    for engine_, m, key in (("sharded", mesh, "mchi"), ("fast", None,
                                                         "mchi_1")):
        p[key] = tq.mismatch_M_chi_grid(g["times"], g["data"], g["modes"],
                                        (0.8, 1.1), (0.4, 0.9),
                                        engine=engine_, mesh=m, **kw)
    for engine_, m, key in (("sharded", mesh, "omega"),
                            ("fast", None, "omega_1"),
                            ("fast-full", mesh, "omega_full")):
        p[key] = tq.mismatch_omega_grid(
            g["times"], g["data"], g["modes"][:1], g["Mf"], g["chif"],
            (0.3, 0.8), (-0.4, -0.05), engine=engine_, mesh=m, **kw)

    sp = inp["spectra"]
    p["spectra"] = pm.sharded_spectra_sweep(
        sp["times"], sp["rows"], sp["omegas"], sp["mus"], 3.0, 70.0, mesh,
        chunk=4, device="cpu")
    ga = inp["gate"]
    t8 = np.linspace(2.0, 20.0, 8)
    p["gate_fact"] = np_(*pm.sharded_t0_sweep_factored(
        real(ga["times"]), cplx(ga["data"]), cplx(ga["omega"]),
        cplx(ga["mu"]), real(t8), real(np.full(8, 40.0)), mesh, chunk=4,
        analytic=True))
    p["gate_spectra"] = pm.sharded_spectra_sweep(
        ga["times"], ga["data"], ga["omegas"], ga["mus"], 3.0, 70.0, mesh,
        chunk=4, device="cpu")

    d = inp["d17"]
    for m, key in ((mesh, "dyn"), (None, "dyn_1")):
        p[key] = tq.mismatch_t0_mode_sets(
            d["times"], d["data"], mode_sets, d["Mf_t"], d["chif_t"], t10,
            T_array=70.0, dynamic=True, mesh=m, return_amplitudes=True,
            device="cpu")
    p["dyn_track"] = tq.mismatch_t0_array(
        d["times"], d["data"], mode_sets[1], d["Mf_t"], d["chif_t"], t10,
        T_array=70.0, t0_method="closest", mesh=mesh, device="cpu")

    e = inp["events"]
    for m, key in ((mesh, "events"), (None, "events_1")):
        p[key] = tq.fit_events(e["times"], e["rows"], mode_sets[1], e["Mfs"],
                               e["chifs"], e["t0s"], T=25.0, mesh=m,
                               device="cpu")

    f = inp["f7"]
    for m, key in ((mesh, "ff"), (None, "ff_1")):
        p[key] = tq.free_frequency_fit_array(
            f["times"], f["data"], t10 * 18.0 / 16.0, return_mismatch=True,
            mesh=m, device="cpu")
    fixed = dict(modes=[(2, 2, 0, 1)], Mf=f["Mf"], chif=f["chif"])
    t5 = np.linspace(0.0, 10.0, 5)
    for m, key in ((mesh22, "ff_fixed"), (None, "ff_fixed_1")):
        p[key] = tq.free_frequency_fit_array(f["times"], f["data"], t5,
                                             mesh=m, device="cpu", **fixed)
    t13 = np.linspace(0.0, 0.9, 13)
    for m, dedup, key in ((mesh, True, "ff_dedup"), (None, False,
                                                     "ff_dedup_0")):
        p[key] = tq.free_frequency_fit_array(
            f["times"], f["data"], t13, mesh=m, dedup=dedup,
            return_mismatch=True, device="cpu")

    e5 = inp["e5"]
    for m, key in ((mesh, "eps"), (None, "eps_1")):
        p[key] = tq.calculate_epsilon_array(
            e5["times"], e5["data"], e5["modes"], e5["Mf"], e5["chif"],
            EPS_T0S, maxiter=8, mesh=m, device="cpu")
    m3 = inp["m3"]
    for m, key in ((mesh, "eps_dict"), (None, "eps_dict_1")):
        p[key] = tq.calculate_epsilon_array(
            m3["times"], m3["data"], m3["modes"], m3["Mf"], m3["chif"],
            np.linspace(0.0, 8.0, 3), spherical_modes=m3["sph"], maxiter=6,
            mesh=m, device="cpu")

    mp_ = inp["mapping"]
    import chip_smoke
    modes, mapped = chip_smoke.MAP_MODELS["m1"]
    t_map = np.linspace(-1.0, 11.0, 33)
    for engine_, key in (("sharded", "map"), ("fast", "map_1")):
        p[key] = spatial_engine.mapping_mismatch_t0_array(
            mp_["times"], mp_["data"], modes, 0.952, 0.692, t_map, mapped,
            T_array=40, spherical_modes=chip_smoke.MAP_SPH, engine=engine_,
            mesh=mesh if engine_ == "sharded" else None,
            return_amplitudes=True, device="cpu")

    # The errors, each as (type name, message).
    def err(fn):
        try:
            fn()
        except Exception as exc:            # noqa: BLE001 (recorded)
            return type(exc).__name__, str(exc)
        return None

    meta = torch.empty(times.shape, device="meta")
    s = inp["s43"]
    out["errors"] = dict(
        unsorted=err(lambda: pm.sharded_t0_sweep_factored(
            times, data, omega, mu, t47.flip(0), T47, mesh)),
        K=err(lambda: pm.sharded_fit_core(times[:-1], data[:, :-1], omega,
                                          mu, 3.0, w3[:-1],
                                          pm.sweep_mesh(1, 4))),
        K2d=err(lambda: pm.sharded_t0_sweep_factored_2d(
            times[:-1], data[:, :-1], omega, mu, t47, T47, mesh22)),
        closest=err(lambda: batched.batch_mismatch_t0_modesets(
            s["times"], s["data"], mode_sets, s["Mf"], s["chif"], t10,
            spherical_modes=s["sph"], t0_method="closest", mesh=mesh,
            device="cpu")),
        cdtype=err(lambda: pm.sharded_t0_sweep(
            times, data, omega, mu, t47, T47, mesh,
            cdtype=torch.complex64)),
        cdtype_fit=err(lambda: pm.sharded_fit_core(
            times, data, omega, mu, 3.0, w3, mesh, cdtype=torch.complex64)),
        device=err(lambda: pm.resolve_mesh(mesh, "cuda")),
        device_fn=err(lambda: pm.sharded_t0_sweep_factored(
            meta, data, omega, mu, t47, T47, mesh)),
        world=err(lambda: pm.sweep_mesh(3, 1)))
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """The four ranks' results (one launch for the module)."""
    from qnmfits_tpu_torch.testing import run_world
    return run_world(_rank_cases, WORLD, (inputs,), timeout=240)


@pytest.fixture(scope="module")
def port(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def jax_mesh():
    import jax
    from qnmfits_tpu.parallel.mesh import sweep_mesh
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return dict(m8=sweep_mesh(n_sweep=8, n_time=1, devices=devs[:8]),
                m4=sweep_mesh(n_sweep=4, n_time=1, devices=devs[:4]),
                m2=sweep_mesh(n_sweep=2, n_time=1, devices=devs[:2]),
                m24=sweep_mesh(n_sweep=2, n_time=4, devices=devs[:8]),
                m42=sweep_mesh(n_sweep=4, n_time=2, devices=devs[:8]),
                devs=devs)


def _split(inputs):
    b = inputs["base"]
    return (b["times"], b["data"].real, b["data"].imag, b["omega"].real,
            b["omega"].imag, b["mu"].real, b["mu"].imag)


def _shard_gap(port, key, shape):
    """Sharded against the port's unsharded, mismatch (last entry)."""
    return float(np.max(np.abs(port[shape][key][-1]
                               - port["unsharded"][key][-1])))


# ---------------------------------------------------------------------------
# The mesh-level functions
# ---------------------------------------------------------------------------

def test_ranks_agree(ranks):
    """Every rank returns the whole result (the gather is all-gather)."""
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    for r in ranks[1:]:
        for shape in SHAPES:
            for key, val in ranks[0][shape].items():
                for a, b in zip(val, r[shape][key]):
                    _close(a, b, SHARD_TOL)
        for key in ("modesets", "t0_array", "omega", "mchi"):
            _close(ranks[0]["public"][key], r["public"][key], SHARD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_factored_sweep_matches_jax(port, inputs, jax_mesh, shape):
    """The factored sweep sharded over 'sweep', 47 start times (not a
    multiple of 4 x chunk: pad and trim)."""
    from qnmfits_tpu.parallel.mesh import sharded_t0_sweep_factored
    t0s = np.linspace(0.0, 30.0, 47)
    Cre, Cim, mm_j = sharded_t0_sweep_factored(
        *_split(inputs), t0s, np.full(47, 60.0), mesh=jax_mesh["m8"],
        chunk=4)
    C, mm = port[shape]["fact"]
    _close(mm, mm_j, MM_TOL)
    assert _rel(C, np.asarray(Cre) + 1j * np.asarray(Cim)) <= AMP_TOL
    assert _shard_gap(port, "fact", shape) <= SHARD_TOL
    assert _rel(C, port["unsharded"]["fact"][0]) <= SHARD_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_modesets_sweep_matches_jax(port, inputs, jax_mesh, shape):
    """Two mode sets (one masked) x 11 start times, chunk 2."""
    from qnmfits_tpu.parallel.mesh import sharded_t0_sweep_modesets_factored
    times, dre, dim, wr, wi, mre, mim = _split(inputs)
    J = wr.shape[0]
    masks = np.ones((2, J), bool)
    masks[1, J // 2:] = False
    t0s = np.linspace(0.0, 18.0, 11)
    Cre, Cim, mm_j = sharded_t0_sweep_modesets_factored(
        times, dre, dim, *(np.stack([x, x]) for x in (wr, wi, mre, mim)),
        t0s, np.full(11, 60.0), masks, mesh=jax_mesh["m4"], chunk=2)
    C, mm = port[shape]["modesets"]
    _close(mm, mm_j, MM_TOL)
    assert _rel(C, np.asarray(Cre) + 1j * np.asarray(Cim)) <= AMP_TOL
    assert _shard_gap(port, "modesets", shape) <= SHARD_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_t0_sweep_closest_method(port, inputs, jax_mesh, shape):
    """t0_method='closest' switches the windows: t0 between samples, where
    'closest' keeps sample 40 and 'geq' starts at 41."""
    import jax.numpy as jnp
    from qnmfits_tpu.parallel.mesh import sharded_t0_sweep
    b = inputs["base"]
    t0s = np.array([b["times"][40] + 0.4 * (b["times"][41]
                                            - b["times"][40])])
    C_j, mm_j = sharded_t0_sweep(b["times"], b["data"], b["omega"], b["mu"],
                                 t0s, np.array([60.0]), mesh=jax_mesh["m2"],
                                 cdtype=jnp.complex128, t0_method="closest")
    C, mm = port[shape]["closest"]
    _close(mm, mm_j, MM_TOL)
    assert _rel(C, C_j) <= AMP_TOL
    assert _shard_gap(port, "closest", shape) <= SHARD_TOL
    assert abs(port[shape]["closest_geq"][1][0] - mm[0]) > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_time_sharded_fit_matches_jax(port, inputs, jax_mesh, shape):
    """The time-sharded fit at n_time = 1, 2 and 4: partial Grams summed
    over 'time', trapezoid weights from the global grid."""
    from qnmfits_tpu.engine_real import fit_core_real
    from qnmfits_tpu.parallel.mesh import sharded_fit_core_real
    times = inputs["base"]["times"]
    w = ((times >= 3.0) & (times < 63.0)).astype(float)
    Cre, Cim, mm_j = sharded_fit_core_real(*_split(inputs), np.float64(3.0),
                                           w, mesh=jax_mesh["m42"])
    Cre1, Cim1, mm1 = fit_core_real(*_split(inputs), 3.0, w)
    C, mm = port[shape]["fit"]
    assert abs(float(mm) - float(mm_j)) <= MM_TOL
    assert abs(float(mm) - float(mm1)) <= MM_TOL
    assert _rel(C, np.asarray(Cre) + 1j * np.asarray(Cim)) <= AMP_TOL
    assert _shard_gap(port, "fit", shape) <= SHARD_TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("grid", ["u", "nu"])
@pytest.mark.parametrize("analytic", [False, True])
def test_factored_2d_matches_jax(port, inputs, jax_mesh, shape, grid,
                                 analytic):
    """Both mesh axes live: windows starting and ending inside, on and
    across the shard boundaries of 2 and 4 time shards; analytic and
    summation Grams, on the uniform grid and a non-uniform one (where
    analytic=True runs the summation)."""
    from qnmfits_tpu.parallel.mesh import sharded_t0_sweep_factored_2d
    times, *rest = _split(inputs)
    if grid == "nu":
        times = times + 0.01 * np.sin(np.arange(len(times)))
    t0s = _two_d_times(inputs["base"]["times"])
    Cre, Cim, mm_j = sharded_t0_sweep_factored_2d(
        times, *rest, t0s, np.full(len(t0s), 40.0), mesh=jax_mesh["m24"],
        chunk=4, analytic=analytic)
    C, mm = port[shape][f"2d_{grid}_{analytic}"]
    _close(mm, mm_j, MM_TOL)
    assert _rel(C, np.asarray(Cre) + 1j * np.asarray(Cim)) <= AMP_TOL
    C1, mm1 = port["unsharded"][f"2d_{grid}"]
    _close(mm, mm1, SHARD_TOL)
    assert _rel(C, C1) <= SHARD_TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_factored_2d_padded_set_matches_jax(port, inputs, jax_mesh, shape):
    """A padded (masked, nu = 0) column under the per-shard edge weights of
    the analytic 2D sweep."""
    from qnmfits_tpu.parallel.mesh import sharded_t0_sweep_factored_2d
    times, dre, dim, wr, wi, mre, mim = _split(inputs)
    z = np.zeros((mre.shape[0], 1))
    mask = np.array([True] * wr.shape[0] + [False])
    t0s = _two_d_times(times)
    _, _, mm_j = sharded_t0_sweep_factored_2d(
        times, dre, dim, np.append(wr, 0.0), np.append(wi, 0.0),
        np.concatenate([mre, z], 1), np.concatenate([mim, z], 1), t0s,
        np.full(len(t0s), 40.0), mesh=jax_mesh["m24"], col_mask=mask,
        chunk=4, analytic=True)
    _close(port[shape]["2d_pad"][1], mm_j, MM_TOL)
    _close(port[shape]["2d_pad"][1], port["unsharded"]["2d_pad"][1],
           SHARD_TOL)
    assert np.all(port[shape]["2d_pad"][0][:, -1] == 0)


# ---------------------------------------------------------------------------
# The public entry points
# ---------------------------------------------------------------------------

def test_public_sharded_engine_matches_jax(port, inputs, jax_mesh):
    """mismatch_t0_array(engine='sharded') against JAX's and the loop."""
    from qnmfits_tpu import mismatch_t0_array, ref_impl
    s = inputs["s43"]
    t0s = np.linspace(0.0, 24.0, 9)
    args = (s["times"], s["data"], s["modes"], s["Mf"], s["chif"], t0s)
    mm_j = mismatch_t0_array(*args, spherical_modes=s["sph"],
                             engine="sharded", mesh=jax_mesh["m8"])
    _close(port["public"]["t0_array"], mm_j, MM_TOL)
    _close(port["public"]["t0_array"],
           ref_impl.mismatch_t0_array(*args, spherical_modes=s["sph"]),
           MM_TOL)


def test_public_modesets_mesh_matches_jax(port, inputs, jax_mesh):
    """batch_mismatch_t0_modesets(mesh=) == JAX's == mesh=None."""
    from qnmfits_tpu.batched import batch_mismatch_t0_modesets
    s = inputs["s43"]
    mode_sets = [[(2, 2, n, 1) for n in range(nmax)] for nmax in (1, 3)]
    mm_j = batch_mismatch_t0_modesets(
        s["times"], s["data"], mode_sets, s["Mf"], s["chif"],
        np.linspace(0.0, 16.0, 10), T_array=70.0, spherical_modes=s["sph"],
        mesh=jax_mesh["m8"])
    _close(port["public"]["modesets"], mm_j, MM_TOL)
    _close(port["public"]["modesets"], port["public"]["modesets_1"],
           SHARD_TOL)


def test_sharded_modesets_dense_grid_dedup_matches_jax(port, inputs,
                                                       jax_mesh):
    """Window dedup composed with the mesh: 247 start times finer than the
    sampling shard only their distinct windows; the scattered and
    rephased result == the port's unsharded dedup and per-t0 sweeps and
    JAX's mesh sweep."""
    from qnmfits_tpu.batched import batch_mismatch_t0_modesets
    s = inputs["s21"]
    dense = [[(2, 2, 0, 1)], [(2, 2, 0, 1), (2, 2, 1, 1)]]
    mm_j, C_j = batch_mismatch_t0_modesets(
        s["times"], s["data"], dense, s["Mf"], s["chif"],
        np.linspace(0.0, 12.0, 247), T_array=60.0, spherical_modes=s["sph"],
        return_amplitudes=True, mesh=jax_mesh["m8"], dedup=True)
    p = port["public"]
    mm, C = p["dense"]
    _close(mm, mm_j, MM_TOL)
    for key in ("dense_1", "dense_0"):
        _close(mm, p[key][0], SHARD_TOL)
    for a, b, c in zip(C, C_j, p["dense_0"][1]):
        assert a.shape == b.shape == c.shape
        assert _rel(a, b) <= AMP_TOL and _rel(a, c) <= AMP_TOL


def test_sharded_grid_sweeps_match_jax(port, inputs, jax_mesh):
    """engine='sharded' grids: the (Mf, chif) grid over the stacked
    engine, the free-frequency grid over the bordered one, and
    'fast-full' with a mesh."""
    from qnmfits_tpu import fitting
    g = inputs["g21"]
    kw = dict(t0=5.0, T=80.0, res=9)
    mm_j = fitting.mismatch_M_chi_grid(g["times"], g["data"], g["modes"],
                                       (0.8, 1.1), (0.4, 0.9),
                                       engine="sharded", mesh=jax_mesh["m8"],
                                       **kw)
    p = port["public"]
    _close(p["mchi"], mm_j, MM_TOL)
    _close(p["mchi"], p["mchi_1"], SHARD_TOL)
    mm_jo = fitting.mismatch_omega_grid(
        g["times"], g["data"], g["modes"][:1], g["Mf"], g["chif"],
        (0.3, 0.8), (-0.4, -0.05), engine="sharded", mesh=jax_mesh["m8"],
        **kw)
    _close(p["omega"], mm_jo, MM_TOL)
    _close(p["omega"], p["omega_1"], SHARD_TOL)
    _close(p["omega_full"], mm_jo, MM_TOL)


def test_sharded_grid_analytic_matches_summation(port, inputs):
    """The sharded spectra sweep on a uniform contiguous window (each rank
    the stacked engine, closed-form Grams) == JAX's summation kernel."""
    import jax.numpy as jnp
    from qnmfits_tpu.engine_real import sweep_spectra_real
    sp = inputs["spectra"]
    t, om, mu, rows = sp["times"], sp["omegas"], sp["mus"], sp["rows"]
    w = ((t >= 3.0) & (t < 73.0)).astype(float)
    Cre, Cim, mm_s = sweep_spectra_real(
        t, rows.real, rows.imag, om.real, om.imag, mu.real, mu.imag, 3.0,
        jnp.asarray(w), chunk=4, analytic=False)
    C, mm = port["public"]["spectra"]
    _close(mm, mm_s, MM_TOL)
    assert _rel(C, np.asarray(Cre) + 1j * np.asarray(Cim)) <= AMP_TOL


def test_mesh_analytic_gated_on_nonuniform_grid(port, inputs):
    """analytic=True on a non-uniform grid runs the summation kernels (the
    _analytic_ok gate, and the grids' own routing): the factored sweep and
    the spectra sweep against JAX's summation kernels."""
    import jax.numpy as jnp
    from qnmfits_tpu.engine_real import (sweep_spectra_real,
                                         sweep_t0_factored_real)
    g = inputs["gate"]
    t, d, om, mu = g["times"], g["data"], g["omega"], g["mu"]
    t0s = np.linspace(2.0, 20.0, 8)
    _, _, mm_ref = sweep_t0_factored_real(
        jnp.asarray(t), jnp.asarray(d.real), jnp.asarray(d.imag),
        jnp.asarray(om.real), jnp.asarray(om.imag), jnp.asarray(mu.real),
        jnp.asarray(mu.imag), jnp.asarray(t0s), jnp.asarray(np.full(8, 40.)),
        chunk=4)
    _close(port["public"]["gate_fact"][1], mm_ref, MM_TOL)
    oms, mus = g["omegas"], g["mus"]
    w = ((t >= 3.0) & (t < 73.0)).astype(float)
    _, _, mm_s = sweep_spectra_real(
        t, d.real, d.imag, oms.real, oms.imag, mus.real, mus.imag, 3.0,
        jnp.asarray(w), chunk=4, analytic=False)
    _close(port["public"]["gate_spectra"][1], mm_s, MM_TOL)


def test_public_modesets_dynamic_mesh_matches_jax(port, inputs, jax_mesh):
    """mismatch_t0_mode_sets(dynamic=True, mesh=) == JAX's == mesh=None:
    10 start times (pad and trim), ragged sets; and mismatch_t0_array with
    tracks and a mesh, 'closest' windows."""
    from qnmfits_tpu.fitting import mismatch_t0_array, mismatch_t0_mode_sets
    d = inputs["d17"]
    mode_sets = [[(2, 2, n, 1) for n in range(nmax)] for nmax in (1, 3)]
    t0s = np.linspace(0.0, 16.0, 10)
    mm_j, C_j = mismatch_t0_mode_sets(
        d["times"], d["data"], mode_sets, d["Mf_t"], d["chif_t"], t0s,
        T_array=70.0, dynamic=True, mesh=jax_mesh["m8"],
        return_amplitudes=True)
    p = port["public"]
    mm, C = p["dyn"]
    _close(mm, mm_j, MM_TOL)
    _close(mm, p["dyn_1"][0], SHARD_TOL)
    for a, b in zip(C, C_j):
        assert a.shape == b.shape and _rel(a, b) <= AMP_TOL
    mm_t = mismatch_t0_array(d["times"], d["data"], mode_sets[1], d["Mf_t"],
                             d["chif_t"], t0s, T_array=70.0,
                             t0_method="closest")
    _close(p["dyn_track"], mm_t, MM_TOL)


def test_sharded_event_batch_matches_jax(port, inputs, jax_mesh):
    """fit_events(mesh=) on 10 events (pad and trim) == JAX's mesh batch."""
    from qnmfits_tpu.batched import batch_fit_events
    e = inputs["events"]
    modes = [(2, 2, n, 1) for n in range(3)]
    mm_j, C_j = batch_fit_events(e["times"], e["rows"], modes, e["Mfs"],
                                 e["chifs"], e["t0s"], T=25.0,
                                 mesh=jax_mesh["m8"])
    (mm, C), (mm1, C1) = port["public"]["events"], port["public"]["events_1"]
    _close(mm, mm_j, MM_TOL)
    assert _rel(C, C_j) <= AMP_TOL
    _close(mm, mm1, SHARD_TOL)
    assert _rel(C, C1) <= SHARD_TOL


def test_sharded_free_frequency_sweep_matches_jax(port, inputs, jax_mesh):
    """free_frequency_fit_array(mesh=) on 10 start times (pad and trim)."""
    from qnmfits_tpu.optimize import free_frequency_fit_array
    f = inputs["f7"]
    t0s = np.linspace(0.0, 18.0, 10)
    w_j, mm_j, ok_j = free_frequency_fit_array(
        f["times"], f["data"], t0s, mesh=jax_mesh["m8"],
        return_mismatch=True)
    (w, mm, ok), (w1, mm1, ok1) = port["public"]["ff"], port["public"]["ff_1"]
    _close(w, w_j, PARAM_TOL)
    _close(mm, mm_j, MM_TOL)
    _close(w, w1, PARAM_TOL)
    _close(mm, mm1, SHARD_TOL)
    np.testing.assert_array_equal(ok, ok1)


def test_sharded_free_frequency_sweep_fixed_modes(port, inputs, jax_mesh):
    """With a fixed QNM (the bordered seed stage) on the (2, 2) mesh:
    'sweep' shards, 'time' repeats."""
    from qnmfits_tpu.optimize import free_frequency_fit_array
    f = inputs["f7"]
    w_j = free_frequency_fit_array(
        f["times"], f["data"], np.linspace(0.0, 10.0, 5),
        modes=[(2, 2, 0, 1)], Mf=f["Mf"], chif=f["chif"],
        mesh=jax_mesh["m42"])
    _close(port["public"]["ff_fixed"], w_j, PARAM_TOL)
    _close(port["public"]["ff_fixed"], port["public"]["ff_fixed_1"],
           PARAM_TOL)


def test_sharded_free_frequency_dedup_matches_direct(port):
    """Dedup composed with the mesh: 13 start times finer than the
    sampling shrink to their distinct windows (not a multiple of 4), and
    the scattered result == the unsharded per-t0 sweep."""
    (w, mm, ok), (w0, mm0, ok0) = (port["public"]["ff_dedup"],
                                   port["public"]["ff_dedup_0"])
    _close(w, w0, PARAM_TOL)
    _close(mm, mm0, 1e-10)
    np.testing.assert_array_equal(ok, ok0)


def test_sharded_epsilon_sweep_matches_jax(port, inputs, jax_mesh):
    """calculate_epsilon_array(mesh=): the array data route against JAX's
    mesh sweep and mesh=None, the dict route (both rows) against mesh=None
    (tests/test_torch_optimize.py holds that route to JAX)."""
    from qnmfits_tpu.optimize import calculate_epsilon_array
    e5 = inputs["e5"]
    out_j = calculate_epsilon_array(
        e5["times"], e5["data"], e5["modes"], e5["Mf"], e5["chif"],
        EPS_T0S, maxiter=8, mesh=jax_mesh["m8"])
    p = port["public"]
    for a, b, c in zip(p["eps"], out_j, p["eps_1"]):
        _close(a, b, PARAM_TOL)
        _close(a, c, PARAM_TOL)
    for a, c in zip(p["eps_dict"], p["eps_dict_1"]):
        _close(a, c, PARAM_TOL)


def test_sharded_mapping_matches_jax(port, inputs, jax_mesh):
    """mapping_mismatch_t0_array(engine='sharded') on phase 10's J = 11
    model, with dedup, against JAX's sharded engine and the port's
    'fast'."""
    import chip_smoke
    from qnmfits_tpu import spatial_engine
    mp_ = inputs["mapping"]
    modes, mapped = chip_smoke.MAP_MODELS["m1"]
    t0s = np.linspace(-1.0, 11.0, 33)
    mm_j, C_j = spatial_engine.mapping_mismatch_t0_array(
        mp_["times"], mp_["data"], modes, 0.952, 0.692, t0s, mapped,
        T_array=40, spherical_modes=chip_smoke.MAP_SPH, engine="sharded",
        mesh=jax_mesh["m8"], return_amplitudes=True)
    (mm, C), (mm1, C1) = port["public"]["map"], port["public"]["map_1"]
    pre = t0s < 0
    assert np.max(np.abs(mm - mm_j)[~pre]) <= MM_TOL
    assert np.max(np.abs(mm - mm_j)[pre]) <= PRE_TOL
    assert _rel(C[~pre], C_j[~pre]) <= 1e-9       # test_torch_spatial's
    _close(mm, mm1, SHARD_TOL)
    assert _rel(C, C1) <= SHARD_TOL


# ---------------------------------------------------------------------------
# The contract's errors, and the edge weights of the closed-form Grams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,kind,match", [
    ("unsorted", "ValueError", "sorted ascending"),
    ("K", "ValueError", "not divisible by mesh time=4"),
    ("K2d", "ValueError", "not divisible by mesh time=2"),
    ("closest", "ValueError", "t0_method='geq'"),
    ("cdtype", "NotImplementedError", "complex128"),
    ("cdtype_fit", "NotImplementedError", "complex128"),
    ("device", "ValueError", "does not match the mesh"),
    ("device_fn", "ValueError", "does not match the mesh"),
    ("world", "ValueError", "does not cover the 4 ranks")])
def test_mesh_errors(port, case, kind, match):
    import re
    got = port["errors"][case]
    assert got is not None and got[0] == kind and re.search(match, got[1])


def test_sweep_mesh_needs_a_process_group():
    """No silent one-rank mesh: without torch.distributed initialised,
    sweep_mesh and mesh='auto' raise, naming init_process_group."""
    import qnmfits_tpu_torch as tq
    from qnmfits_tpu_torch.parallel.mesh import sweep_mesh
    with pytest.raises(ValueError, match="init_process_group"):
        sweep_mesh()
    times = np.arange(0.0, 10.0, 0.1)
    with pytest.raises(ValueError, match="init_process_group"):
        tq.mismatch_t0_mode_sets(times, np.zeros(100, complex),
                                 [[(2, 2, 0, 1)]], 0.95, 0.69,
                                 np.array([0.0, 1.0]), mesh="auto",
                                 device="cpu")


def _edge_inputs(seed):
    rng = np.random.default_rng(seed)
    J, B, K = 5, 12, 64
    wr = rng.uniform(0.2, 1.2, J)
    wi = -rng.uniform(0.02, 0.6, J)
    dlt = 0.1
    m = rng.integers(0, K + 1, B)
    s = rng.uniform(0.0, 3.0, B)
    ef = rng.integers(0, 2, B).astype(float)[:, None, None]
    el = rng.integers(0, 2, B).astype(float)[:, None, None]
    return J, K, wr, wi, dlt, m, s, ef, el


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_geom_grams_edge_weights_match_jax(seed):
    """engine_real._geom_grams_core's edge_first / edge_last on random
    partial windows (0 or 1 at each edge, empty windows among them)
    against the JAX package's."""
    import jax.numpy as jnp
    import torch
    from qnmfits_tpu.engine_real import _geom_grams_core as jgg
    from qnmfits_tpu_torch.engine_real import _geom_grams_core as tgg
    J, K, wr, wi, dlt, m, s, ef, el = _edge_inputs(seed)
    g_re, g_im, gt_re, gt_im = jgg(dlt, K, jnp.asarray(wr), jnp.asarray(wi),
                                   jnp.asarray(s), jnp.asarray(m),
                                   edge_first=jnp.asarray(ef),
                                   edge_last=jnp.asarray(el))
    f64 = torch.float64
    Gt, Gtau = tgg(dlt, K, torch.as_tensor(wr, dtype=f64)[None],
                   torch.as_tensor(wi, dtype=f64)[None],
                   torch.as_tensor(s, dtype=f64), torch.as_tensor(m),
                   torch.as_tensor(ef, dtype=f64),
                   torch.as_tensor(el, dtype=f64))
    scale = np.max(np.abs(np.asarray(g_re)))
    for x, ref in ((Gt[0], np.asarray(g_re) + 1j * np.asarray(g_im)),
                   (Gtau[0], np.asarray(gt_re) + 1j * np.asarray(gt_im))):
        assert np.max(np.abs(x.numpy() - ref)) <= 1e-14 * scale


def test_geom_grams_without_edges_unchanged():
    """With the edge weights None the closed-form Grams are bit for bit
    those of weights 1 (a factor of 1.0 is exact): the edge arguments
    leave every existing caller's Grams as they were."""
    import torch
    from qnmfits_tpu_torch.engine_real import _geom_grams_core
    J, K, wr, wi, dlt, m, s, _, _ = _edge_inputs(4)
    f64 = torch.float64
    args = (dlt, K, torch.as_tensor(wr, dtype=f64)[None],
            torch.as_tensor(wi, dtype=f64)[None],
            torch.as_tensor(s, dtype=f64), torch.as_tensor(m))
    ones = torch.ones((len(m), 1, 1), dtype=f64)
    for a, b in zip(_geom_grams_core(*args),
                    _geom_grams_core(*args, ones, ones)):
        assert torch.equal(a, b)
