"""Near-extremal spin: the Leaver CF in double-double beyond
``ops/cf_cuda.CHI_EXTENDED`` (chi = 0.985), on the CPU.

Beyond that spin an FP64 CF's rounding noise over |f'| exceeds the step
(1e-9 |omega|) the solver's lockstep Newton accepts, so the FP64 port left
points on the interpolated coarse track where the JAX package, whose native
CF runs in 80-bit long double (``spectrum/csrc/cf_kernel.cpp``), converges
them.  Here the port's lockstep Newton, the plain double-double CF
``cf_cuda.cf_dd`` and the kernel's host twin (the same source as the card's,
``g++ -ffp-contract=off``) are held to the JAX package's 80-bit Newton and
CF, each built from its source into the test's temporary directory.

``PYTHONPATH=. python tests/test_torch_extremal.py`` prints the pins below (and
chip_smoke.py's ``PIN_528``): the JAX package's ``track_mode`` of (5,2,8)
on the s = -2 table's spins, its CF the 80-bit native kernel.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import solver as jsolver
from qnmfits_tpu_torch.ops import cf_cuda
from qnmfits_tpu_torch.spectrum import solver

CF_80 = Path(jsolver.__file__).parent / "csrc" / "cf_kernel.cpp"
S, L, M, N_OVERTONE = -2, 5, 2, 8
NL = L - 2 + 1 + 24                     # track_mode's angular width for m = 2
TOL = 1e-12                             # track_mode's Newton tolerance
# The JAX package's 80-bit (5,2,8) (omega in M = 1 units, A) at the two
# spins of the s = -2 table where the FP64 port's Newton stalled (on the
# card at 0.99698, on the CPU at 0.9995), with each spin's depth tier
# (track_mode: the next power of two above 800 / sqrt(1 - chi^2)).
PINS = {
    0.9969824310148806: (1.07129039863154 - 0.8357522828049027j,
                         27.247335221564715 + 1.0808790959822385j, 16384),
    0.9995: (1.0681572880044379 - 0.8349959552720283j,
             27.24864776250752 + 1.0824205784939513j, 32768),
}
# The guesses: the pinned root moved by 1e-6 (Leaver units).
NUDGE = 1e-6 * (1.0 - 1.0j)
# Double-double against the 80-bit CF, of |U| + |T|: the 80-bit CF's own
# rounding reaches ~1e-17 at these depths; FP64 reads ~1e-14.
TOL_80 = 1e-15
# The plain double-double version against the kernel's host twin: both
# carry ~106 bits and round once; they differ by less than one FP64
# rounding of the result.
TOL_TWIN = 1e-17


def _build(tmp_path_factory, source, name, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CF from its source")
    lib_path = tmp_path_factory.mktemp("cf_extremal") / name
    subprocess.run([gxx, *flags, "-O2", "-shared", "-fPIC", "-o",
                    str(lib_path), str(source)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


def _bind_80(lib):
    """The 80-bit CF as the JAX solver's ``_cf(omega, aL, A, s, m, n_inv,
    N)`` (numpy arrays)."""
    fn = lib.radial_cf_batch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = None

    def cf(omega, aL, A, s, m, n_inv, N):
        omega = np.asarray(omega, complex)
        B = omega.shape[0]
        ins = [np.ascontiguousarray(np.broadcast_to(x, (B,)),
                                    dtype=np.float64)
               for x in (omega.real, omega.imag, aL, np.real(A),
                         np.imag(A))]
        ni = np.ascontiguousarray(np.broadcast_to(n_inv, (B,)),
                                  dtype=np.int32)
        out = np.empty((2, B))
        fn(B, *(x.ctypes.data for x in ins), s, m, ni.ctypes.data, N,
           out[0].ctypes.data, out[1].ctypes.data)
        return out[0] + 1j * out[1]

    return cf


@pytest.fixture(scope="module")
def cf_80(tmp_path_factory):
    return _bind_80(_build(tmp_path_factory, CF_80, "libcf_kernel_80.so"))


@pytest.fixture(scope="module")
def twin_dd(tmp_path_factory):
    """The kernel's double-double host twin as f(w, a, A, n_inv, N, team,
    blocks=1) -> (U - T, |U| + |T|) for s = -2, m = 2: T = team x blocks
    segments."""
    lib = _build(tmp_path_factory, cf_cuda.SOURCE, "libleaver_cf_host.so",
                 "-x", "c++", "-std=c++17", "-ffp-contract=off")
    fn = lib.qnm_leaver_cf_dd_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(w, a, A, n_inv, N, team, blocks=1):
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        out = np.empty((3, len(w)))
        assert fn(len(w), *(x.ctypes.data for x in ins), ni.ctypes.data, -2,
                  2, N, team, blocks, *(o.ctypes.data for o in out)) == 0
        return out[0] + 1j * out[1], out[2]

    return run


def _inputs(B, seed, chi=(0.985, 0.9995), n_inv_max=20):
    """S1's distribution (chip_smoke.cf_inputs) at spins in ``chi``."""
    rng = np.random.default_rng(seed)
    w = 2.0 * (0.3 + 0.6 * rng.random(B) - 1j * (0.05 + 0.6 * rng.random(B)))
    a = 0.5 * (chi[0] + (chi[1] - chi[0]) * rng.random(B))
    A = 4.0 + 2.0 * rng.random(B) + 0.2j * (rng.random(B) - 0.5)
    return w, a, A, rng.integers(0, n_inv_max + 1, B)


def _dd_plain(w, a, A, n_inv, N):
    f, scale = cf_cuda.cf_dd(torch.as_tensor(w), torch.as_tensor(a),
                             torch.as_tensor(A), -2, 2,
                             torch.as_tensor(n_inv), N)
    return f.numpy(), scale.numpy()


@pytest.mark.parametrize("chi", sorted(PINS))
def test_lockstep_newton_converges_where_fp64_stalled(cf_80, monkeypatch,
                                                      chi):
    """The port's lockstep Newton at a stalled spin and its tier, on the
    CPU, converges (``ok``) and lands within 1e-9 |omega| of the JAX
    package's, run with its 80-bit CF from the same guesses."""
    w_pin, A_pin, N = PINS[chi]
    w0 = np.array([2.0 * w_pin + NUDGE])
    a = np.array([chi / 2.0])
    A0 = np.array([A_pin])
    monkeypatch.setattr(jsolver, "_cf", cf_80)
    w_jax, _, _, ok_jax = jsolver._newton_coupled_vec_a(
        w0, a, A0, S, L, M, N_OVERTONE, NL, N, TOL)
    w, _, _, ok = solver._newton_coupled_vec_a(
        torch.as_tensor(w0), torch.as_tensor(a), torch.as_tensor(A0), S, L,
        M, N_OVERTONE, NL, N, TOL)
    assert ok_jax[0] and bool(ok[0])
    assert abs(complex(w[0]) - w_jax[0]) <= 1e-9 * abs(w_jax[0])


# HOST_CASES' deep depths (scripts/torch_cf_teams.py): the solver's tier
# 16384, its retries at 3x and 9x, and 27x; one seed each.
DEEP = [(16384, 24), (49152, 24), (147456, 6), (442368, 2)]


@pytest.mark.parametrize("N,B", DEEP)
def test_plain_dd_matches_the_80_bit_cf(cf_80, N, B):
    w, _, A, n_inv = _inputs(B, seed=1000)
    a = 0.5 * (0.998 + 0.0015 * np.random.default_rng(1001).random(B))
    f, scale = _dd_plain(w, a, A, n_inv, N)
    assert np.max(np.abs(f - cf_80(w, a, A, S, M, n_inv, N)) / scale) \
        <= TOL_80


# (B, N, largest n_inv, teams): a coarse-pass shape, a tier, a depth no
# team divides, and (N = 40) n_inv at or past N, the product empty.
TWIN_CASES = [(2, 2000, 8, (1, 256)), (12, 8192, 20, (8, 64)),
              (5, 3001, 20, (32, 256)), (4, 40, 8, (1, 32))]


@pytest.mark.parametrize("B,N,n_inv_max,teams", TWIN_CASES)
def test_plain_dd_matches_the_kernels_host_twin(twin_dd, B, N, n_inv_max,
                                                teams):
    w, a, A, n_inv = _inputs(B, seed=N + B, n_inv_max=n_inv_max)
    if N == 40:
        n_inv[:3] = (N, N + 3, N - 1)
    f, scale = _dd_plain(w, a, A, n_inv, N)
    for team in teams:
        g, g_scale = twin_dd(w, a, A, n_inv, N, team)
        assert np.max(np.abs(g - f) / scale) <= TOL_TWIN
        assert np.max(np.abs(g_scale - scale) / scale) <= TOL_TWIN


def test_mixed_batch_keeps_fp64_bit_for_bit():
    """A batch straddling CHI_EXTENDED: its FP64 elements are bit for bit
    today's (the plain FP64 version on the whole batch), the others the
    double-double version's."""
    B, N = 16, 3000
    w, _, A, n_inv = _inputs(B, seed=5, n_inv_max=8)
    a = 0.5 * np.linspace(0.97, 0.999, B)
    a[3] = 0.5 * cf_cuda.CHI_EXTENDED           # at the threshold: FP64
    w_t, a_t, A_t, n_t = (torch.as_tensor(x) for x in (w, a, A, n_inv))
    f, scale = cf_cuda.leaver_cf(w_t, a_t, A_t, -2, 2, n_t, N,
                                 with_scale=True)
    ext = 2.0 * a_t > cf_cuda.CHI_EXTENDED
    assert 0 < int(ext.sum()) < B and not bool(ext[3])
    U, T = cf_cuda.cf_parts(w_t, a_t, A_t, -2, 2, n_t, N)
    assert torch.equal(f[~ext], (U - T)[~ext])
    assert torch.equal(scale[~ext], (U.abs() + T.abs())[~ext])
    f_dd, scale_dd = cf_cuda.cf_dd(w_t[ext], a_t[ext], A_t[ext], -2, 2,
                                   n_t[ext], N)
    assert torch.equal(f[ext], f_dd) and torch.equal(scale[ext], scale_dd)
    # A scalar spin takes one arithmetic for the whole batch.
    assert torch.equal(cf_cuda.leaver_cf(w_t, 0.4985, A_t, -2, 2, 4, 500),
                       cf_cuda.cf_dd(w_t, 0.4985, A_t, -2, 2, 4, 500)[0])
    at = 0.5 * cf_cuda.CHI_EXTENDED
    U, T = cf_cuda.cf_parts(w_t, at, A_t, -2, 2, 4, 500)
    assert torch.equal(cf_cuda.leaver_cf(w_t, at, A_t, -2, 2, 4, 500), U - T)


def _pins_from_jax():
    """(chi, omega, A) of the JAX package's 80-bit (5,2,8) track on the
    s = -2 table's spins (the command in the module's docstring)."""
    import tempfile
    from qnmfits_tpu.spectrum.tables import DEFAULT_TABLE
    with tempfile.TemporaryDirectory() as tmp:
        lib = Path(tmp) / "libcf_kernel_80.so"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib),
                        str(CF_80)], check=True, timeout=300)
        jsolver._cf = _bind_80(ctypes.CDLL(str(lib)))
        chi = np.load(DEFAULT_TABLE)["chi"]
        seeds = jsolver.schwarzschild_seeds(l_max=L, n_max=N_OVERTONE, s=S,
                                            n_max_low_l=0)
        w, A, _ = jsolver.track_mode(L, M, N_OVERTONE, seeds[(L, N_OVERTONE)],
                                     chi, s=S)
    return chi, w, A


if __name__ == "__main__":
    chi, w, A = _pins_from_jax()
    for c, wi, Ai in zip(chi, w, A):
        if c > cf_cuda.CHI_EXTENDED:
            print(f"{float(c)!r}: ({complex(wi)!r}, {complex(Ai)!r}),")
