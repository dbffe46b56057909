"""The double-double Leaver CF spread over many blocks an element, on the
CPU: the kernel's host twin (the same source as the card's, ``g++
-ffp-contract=off``) at the segmentations ``cf_cuda.plan_dd`` gives the
card, where T = team x blocks segments combine by one pairwise tree,
against the plain double-double version ``cf_cuda.cf_dd`` and the JAX
package's 80-bit CF (``qnmfits_tpu/spectrum/csrc/cf_kernel.cpp``), both
built from their sources into the test's temporary directory; and
``plan_dd``'s rule.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qnmfits_tpu.spectrum import solver as jsolver
from qnmfits_tpu_torch.ops import cf_cuda

CF_80 = Path(jsolver.__file__).parent / "csrc" / "cf_kernel.cpp"
# tests/test_torch_extremal.py's bars: the host twin against the plain
# double-double version (both ~106 bits, rounded once), and double-double
# against the 80-bit CF, relative to |U| + |T|.
TOL_TWIN = 1e-17
TOL_80 = 1e-15


def _build(tmp_path_factory, source, name, *flags):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CF from its source")
    lib_path = tmp_path_factory.mktemp("cf_spread") / name
    subprocess.run([gxx, *flags, "-O2", "-shared", "-fPIC", "-o",
                    str(lib_path), str(source)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def twin_lib(tmp_path_factory):
    return _build(tmp_path_factory, cf_cuda.SOURCE, "libleaver_cf_host.so",
                  "-x", "c++", "-std=c++17", "-ffp-contract=off")


@pytest.fixture(scope="module")
def twin_dd(twin_lib):
    """The double-double host twin as f(w, a, A, n_inv, N, team, blocks)
    -> (U - T, |U| + |T|) for s = -2, m = 2, or None where it refuses."""
    fn = twin_lib.qnm_leaver_cf_dd_host
    fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    def run(w, a, A, n_inv, N, team, blocks):
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        out = np.empty((3, len(w)))
        if fn(len(w), *(x.ctypes.data for x in ins), ni.ctypes.data, -2, 2,
              N, team, blocks, *(o.ctypes.data for o in out)):
            return None
        return out[0] + 1j * out[1], out[2]

    return run


@pytest.fixture(scope="module")
def cf_80(tmp_path_factory):
    """The JAX package's 80-bit CF (U - T) for s = -2, m = 2."""
    fn = _build(tmp_path_factory, CF_80, "libcf_kernel_80.so").radial_cf_batch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    fn.restype = None

    def run(w, a, A, n_inv, N):
        ins = [np.ascontiguousarray(x, dtype=np.float64)
               for x in (w.real, w.imag, a, A.real, A.imag)]
        ni = np.ascontiguousarray(n_inv, dtype=np.int32)
        out = np.empty((2, len(w)))
        fn(len(w), *(x.ctypes.data for x in ins), -2, 2, ni.ctypes.data, N,
           out[0].ctypes.data, out[1].ctypes.data)
        return out[0] + 1j * out[1]

    return run


def _inputs(B, seed, chi=(0.985, 0.9995), n_inv_max=20):
    """S1-X's distribution (chip_smoke.cf_inputs at CF_DD_CHI), n_inv
    0..n_inv_max."""
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


# (B, N, (team, blocks) segmentations): plan_dd's plans on 132 SMs for F1's
# largest launch (16 x 8192) and the coarse pass's pair, spreads up to the
# kernel's largest (256 x 256); 3001 is a depth no segment count divides,
# and at N = 40 n_inv reaches N and past it (the product empty) with most
# segments empty.  Then more of the launches F1's solve and a re-solved
# near-extremal row send (12 and 13 steps a segment at their plans).
SPREAD_CASES = [
    (16, 8192, ("plan", (128, 64), (256, 8))),
    (2, 2000, ("plan", (128, 2), (256, 256))),
    (5, 3001, ("plan", (128, 4), (128, 128), (256, 32))),
    (4, 40, ((128, 2), (256, 256))),
    (2, 98304, ("plan", (128, 128))),
    (2, 2920, ("plan",)),
    (2, 12650, ("plan",)),
    (14, 8192, ("plan",)),
]


@pytest.mark.parametrize("B,N,plans", SPREAD_CASES)
def test_twin_spread_over_blocks_matches_plain_dd(twin_dd, B, N, plans):
    w, a, A, n_inv = _inputs(B, seed=N + B)
    if N == 40:
        n_inv[:3] = (N, N + 3, N - 1)
    f, scale = _dd_plain(w, a, A, n_inv, N)
    for team, blocks in (cf_cuda.plan_dd(B, N, 132)[:2] if p == "plan"
                         else p for p in plans):
        assert (team, blocks) in cf_cuda.dd_plans()
        g, g_scale = twin_dd(w, a, A, n_inv, N, team, blocks)
        assert np.max(np.abs(g - f) / scale) <= TOL_TWIN, (team, blocks)
        assert np.max(np.abs(g_scale - scale) / scale) <= TOL_TWIN


# The solver's deep tiers near extremal spin (tests/test_torch_extremal.py's
# DEEP): the tier 16384, its retries at 3x and 9x, and 27x.
DEEP = [(16384, 24), (49152, 24), (147456, 6), (442368, 2)]


@pytest.mark.parametrize("spread", ["plan", (256, 256)])
@pytest.mark.parametrize("N,B", DEEP)
def test_twin_spread_at_the_solvers_deep_tiers(twin_dd, cf_80, N, B,
                                               spread):
    """plan_dd's segmentation of each deep launch on 132 SMs, and the
    kernel's widest, against the 80-bit CF at spins chi = 0.998-0.9995."""
    w, _, A, n_inv = _inputs(B, seed=1000)
    a = 0.5 * (0.998 + 0.0015 * np.random.default_rng(1001).random(B))
    team, blocks = (cf_cuda.plan_dd(B, N, 132)[:2] if spread == "plan"
                    else spread)
    f, scale = twin_dd(w, a, A, n_inv, N, team, blocks)
    assert np.max(np.abs(f - cf_80(w, a, A, n_inv, N)) / scale) <= TOL_80


@pytest.mark.parametrize("sm_count", [1, 132])
def test_plan_dd_fills_the_card_with_segments_kept(sm_count):
    """The double-double plan: T = team x blocks a power of two that
    dd_plans lists; the fewest segments whose threads give each SM
    THREADS_PER_SM, else the most that keep DD_MIN_SEGMENT steps a
    segment (or the kernel's widest); no fewer as B falls."""
    want = cf_cuda.THREADS_PER_SM * sm_count
    widest = cf_cuda.TEAMS[-1] * cf_cuda.MAX_BLOCKS
    for N in (40, 300, 2000, 8192, 32768, 294912, 884736, cf_cuda.MAX_N):
        last = None
        for B in (4096, 256, 24, 16, 6, 2, 1):
            team, blocks, segment = cf_cuda.plan_dd(B, N, sm_count)
            T = team * blocks
            assert (team, blocks) in cf_cuda.dd_plans()
            assert T & (T - 1) == 0 and segment == -(-N // T)
            if T > 1:
                assert B * (T // 2) < want
                assert segment >= cf_cuda.DD_MIN_SEGMENT
            assert (B * T >= want or T == widest
                    or -(-N // (2 * T)) < cf_cuda.DD_MIN_SEGMENT)
            assert last is None or T >= last
            last = T


def test_plan_dd_spreads_the_near_extremal_launches():
    """On an H100's 132 SMs: one element at the card's depth limit fills
    the card, as do S1-X's deepest launches; a launch that fills the card
    with one block an element keeps one."""
    want = cf_cuda.THREADS_PER_SM * 132
    team, blocks, segment = cf_cuda.plan_dd(1, cf_cuda.MAX_N, 132)
    assert team * blocks >= want and blocks > 1
    assert segment == math.ceil(cf_cuda.MAX_N / (team * blocks))
    for B, N in ((2, 884736), (6, 294912)):
        team, blocks, _ = cf_cuda.plan_dd(B, N, 132)
        assert B * team * blocks >= want and blocks > 1
    assert cf_cuda.plan_dd(4096, 8192, 132)[1] == 1


def test_twin_refuses_what_the_kernel_cannot_take(twin_dd):
    w, a, A, n_inv = _inputs(2, seed=3)
    for N, team, blocks in ((0, 128, 2), (cf_cuda.MAX_N + 1, 128, 2),
                            (100, 0, 1), (100, 128, 0)):
        assert twin_dd(w, a, A, n_inv, N, team, blocks) is None
    assert twin_dd(w, a, A, n_inv, 100, 256, 256) is not None
