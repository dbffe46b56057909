"""Sweeps sharded over a ('sweep', 'time') mesh of torch.distributed ranks
(port of qnmfits_tpu/parallel/mesh.py).

The workload's parallel axes are those of the JAX module:

* ``sweep`` -- data parallelism over fit configurations (start times,
  grid points, events, optimiser windows); the only communication is the
  gather of the results;
* ``time`` -- the time-sample axis K of the Gram contractions: each rank
  sums its slice of K and the partial sums are added over the axis.

JAX's ``shard_map`` runs one program over every device of a mesh.  Here
every rank of the default process group calls the same function with the
same arguments (SPMD, as under ``torchrun``), computes its block on its own
device, and the blocks are all-gathered over 'sweep', so every rank
returns the whole arrays, as the JAX function does.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("sweep", "time")`` (``sweep_mesh``).  Blocks are padded
with edge values to equal sizes, so that every rank's block is the same
size, and the gathered arrays trimmed (``_pad_to``).  The J x J solves run
on every rank (the CUDA kernel on the card); the collectives go through
the mesh's groups, NCCL (one rank a card) or gloo (the CPU, or ranks that
share a card).

Precision is x64 only: ``cdtype=torch.complex64`` raises (the JAX
package's f32 path is a TPU workaround).  The functions named ``*_real``
take the port's complex128 tensors, as ``engine_real`` does.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import CDTYPE, RDTYPE
from ..engine import _masked, fit_mismatch
from ..engine_real import (_as_complex, _as_real, _fitted_step,
                           _geom_grams_core, _mismatch_rephase,
                           _regularised_solve, join_groups,
                           sweep_omega_grid_bordered_real,
                           sweep_t0_modesets_factored_real)
from ..ops.cmath import damped_phase
from ..ops.solve import gram_cholesky
from ..ops.windows import window_geq

__all__ = ["sweep_mesh", "sharded_t0_sweep", "sharded_fit_core",
           "sharded_t0_sweep_real", "sharded_fit_core_real",
           "sharded_t0_sweep_factored",
           "sharded_t0_sweep_modesets_factored", "sharded_spectra_sweep",
           "sharded_event_batch", "sharded_t0_sweep_factored_2d",
           "sharded_omega_grid_bordered",
           "sharded_t0_sweep_modesets_dynamic", "resolve_mesh",
           "release_meshes", "gather_sweep", "sum_time", "TIMEOUT"]

# The timeout a caller gives init_process_group, so that a collective
# whose peer died raises instead of waiting for ever.
TIMEOUT = timedelta(seconds=60)

_MESHES = {}


def _host_trapz(times, w):
    """Trapezoid weights on the global time grid (host NumPy): segment
    weights straddle shard boundaries, so they are made before sharding.
    The weights of ``ops.windows.trapz_weights`` (mesh.py:40)."""
    t = np.asarray(times)
    wv = np.asarray(w, t.dtype)
    seg = wv[:-1] * wv[1:] * (t[1:] - t[:-1]) * 0.5
    tau = np.zeros_like(t)
    tau[:-1] += seg
    tau[1:] += seg
    return tau


def sweep_mesh(n_sweep: int | None = None, n_time: int = 1,
               device_type: str | None = None):
    """The ('sweep', 'time') mesh over the ranks of the default process
    group (mesh.py:53): rank r sits at (r // n_time, r % n_time).
    n_sweep defaults to world_size // n_time, and n_sweep * n_time must be
    the world size.  device_type is where each rank computes: 'cuda' (its
    current device) or 'cpu'; by default 'cuda' under NCCL and 'cpu'
    otherwise.  Every rank must call it, in the same order (the mesh
    makes one process group for each row and column).

    Without an initialised process group it raises ValueError: there is
    no silent one-rank mesh (JAX's 'auto' takes the local devices).
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "a mesh needs an initialised torch.distributed process group: "
            "call torch.distributed.init_process_group (or launch under "
            "torchrun) on every rank before asking for one")
    world = dist.get_world_size()
    if n_sweep is None:
        n_sweep = world // n_time
    if n_sweep < 1 or n_sweep * n_time != world:
        raise ValueError(f"mesh ({n_sweep}, {n_time}) does not cover the "
                         f"{world} ranks of the process group")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    # One mesh (and one set of its process groups) a shape and a group:
    # 'auto' on every call would otherwise make new groups each time.
    key = (n_sweep, n_time, device_type)
    group, mesh = _MESHES.get(key, (None, None))
    if group is not dist.group.WORLD:
        from torch.distributed.device_mesh import DeviceMesh
        if device_type == "cuda":
            torch.cuda.init()       # the rank's current device, as it is
        mesh = DeviceMesh(device_type,
                          torch.arange(world).reshape(n_sweep, n_time),
                          mesh_dim_names=("sweep", "time"))
        _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


def release_meshes():
    """Forget the meshes that ``sweep_mesh`` cached.  A DeviceMesh holds
    its row and column process groups, so a cached mesh keeps them alive
    after ``torch.distributed.destroy_process_group``, until the
    interpreter's own teardown frees them; gloo's groups freed there can
    abort the process ("terminate called without an active exception").
    Call it before destroy_process_group, with no other reference to the
    meshes left."""
    _MESHES.clear()


def resolve_mesh(mesh, device):
    """The mesh an entry point runs on: mesh='auto' is
    ``sweep_mesh(n_time=1)`` on the device's type; a mesh's device type
    must be that of ``device`` (ValueError)."""
    dev = torch.device(device)
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be a DeviceMesh or 'auto', not "
                             f"{mesh!r}")
        mesh = sweep_mesh(n_time=1, device_type=dev.type)
    _check_device(mesh, dev)
    return mesh


def _check_device(mesh, device):
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"device {device} does not match the mesh's "
                         f"device type {mesh.device_type!r}")


def _size(mesh, name):
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _wire(x, group):
    """x as the group's backend carries it, and the map back: complex
    through its real view (NCCL has no complex type), bool as uint8, CUDA
    tensors through the host under gloo."""
    dev, dtype = x.device, x.dtype
    y = x.to(torch.uint8) if dtype == torch.bool else x
    if y.is_complex():
        y = torch.view_as_real(y)
    if y.is_cuda and dist.get_backend(group) == "gloo":
        y = y.cpu()

    def back(z):
        z = z.to(dev)
        if dtype.is_complex:
            z = torch.view_as_complex(z.contiguous())
        return z.to(dtype)

    return y.contiguous(), back


def gather_sweep(mesh, x, dim=0):
    """The blocks x of the ranks along 'sweep', concatenated along ``dim``
    in mesh order (all_gather on the axis' group): every rank gets the
    whole."""
    group = mesh.get_group("sweep")
    y, back = _wire(x.movedim(dim, 0), group)
    parts = [torch.empty_like(y) for _ in range(_size(mesh, "sweep"))]
    dist.all_gather(parts, y, group=group)
    return back(torch.cat(parts)).movedim(0, dim)


def sum_time(mesh, x):
    """The sum of x over the ranks along 'time' (all_reduce on the axis'
    group, JAX's psum); x is not modified."""
    group = mesh.get_group("time")
    y, back = _wire(x.clone(), group)
    dist.all_reduce(y, group=group)
    return back(y)


def _pad_to(x, mult, axis=0):
    """x padded along ``axis`` with copies of its last entry to a multiple
    of ``mult`` (NumPy's mode='edge'), and the original length
    (mesh.py:64).  NumPy arrays or tensors."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths, mode="edge"), n
    last = x.narrow(axis, n - 1, 1)
    return torch.cat([x, last.expand(*[pad if d == axis % x.dim() else s
                                       for d, s in enumerate(last.shape)])],
                     dim=axis), n


def _block(mesh, x, axis=0):
    """This rank's contiguous block of x (padded to a multiple of the
    'sweep' size) along ``axis``."""
    n = _size(mesh, "sweep")
    size = x.shape[axis] // n
    r = mesh.get_local_rank("sweep")
    if isinstance(x, np.ndarray):
        return np.take(x, np.arange(r * size, (r + 1) * size), axis=axis)
    return x.narrow(axis, r * size, size)


def _clamped_chunk(t0s, wi, chunk):
    """``batched._safe_chunk``'s |Im w| * chunk-span budget, applied to the
    global sorted start times before they are split, so that every rank's
    chunks keep it (mesh.py:218).  Clamping twice changes nothing."""
    from ..batched import _safe_chunk
    t0s = np.asarray(torch.as_tensor(t0s).cpu(), float)
    wi = np.asarray(torch.as_tensor(wi).cpu())
    if t0s.size == 0 or wi.size == 0:
        return chunk
    return _safe_chunk(t0s, float(np.max(np.abs(wi))), chunk)


def _analytic_ok(times, analytic):
    """The closed-form Grams only on a uniform time grid: analytic=True on
    a non-uniform one runs the summation kernels (mesh.py:235)."""
    if not analytic:
        return False
    from ..batched import _uniform_spacing
    return bool(_uniform_spacing(np.asarray(torch.as_tensor(times).cpu())))


def _sorted_t0s(t0s, Ts):
    if bool(torch.any(torch.diff(t0s) < 0)):
        raise ValueError("t0_array must be sorted ascending")
    return t0s, torch.broadcast_to(torch.as_tensor(Ts, dtype=t0s.dtype,
                                                   device=t0s.device),
                                   t0s.shape)


def _x64(cdtype):
    if cdtype != CDTYPE:
        raise NotImplementedError(
            f"cdtype={cdtype}: qnmfits_tpu_torch computes in complex128 "
            "only; the JAX package's f32 mesh path is a TPU workaround")


# ---------------------------------------------------------------------------
# Data parallel over windows: the complex window sweep
# ---------------------------------------------------------------------------

def sharded_t0_sweep(times, data, omega, mu, t0s, Ts, mesh,
                     cdtype=CDTYPE, t0_method: str = "geq", solve=None):
    """The complex window sweep (``batched.sweep_t0_core``, any window
    method) with the start times sharded over 'sweep' (mesh.py:74).

    times (K,), data (I, K), omega (J,), mu (I, J), t0s/Ts (B,): tensors on
    the rank's device.  Returns C (B, J) and mm (B,), gathered."""
    from ..batched import sweep_t0_core
    _x64(cdtype)
    _check_device(mesh, times.device)
    Ts = torch.broadcast_to(torch.as_tensor(Ts, dtype=t0s.dtype,
                                            device=t0s.device), t0s.shape)
    n = _size(mesh, "sweep")
    t0p, B = _pad_to(t0s, n)
    Tp, _ = _pad_to(Ts, n)
    C, mm = sweep_t0_core(times, data, omega, mu, _block(mesh, t0p),
                          _block(mesh, Tp), t0_method, solve=solve)
    return gather_sweep(mesh, C)[:B], gather_sweep(mesh, mm)[:B]


def sharded_t0_sweep_real(times, data, omega, mu, t0s, Ts, mesh,
                          solve=None):
    """``sharded_t0_sweep`` with 'geq' windows (mesh.py:183; the JAX
    function's split-complex arrays are the port's complex128 tensors).
    Returns C (B, J) and mm (B,)."""
    return sharded_t0_sweep(times, data, omega, mu, t0s, Ts, mesh,
                            solve=solve)


# ---------------------------------------------------------------------------
# One fit with the time axis sharded
# ---------------------------------------------------------------------------

def sharded_fit_core(times, data, omega, mu, t0, w, mesh, cdtype=CDTYPE,
                     col_mask=None, solve=None):
    """One fit with the time axis sharded over 'time' (mesh.py:106): each
    rank holds K / n_time samples of (times, data, w), makes the partial
    Gram, projections and norms, and they are summed over 'time'; the
    J x J solve runs on every rank.  The trapezoid weights come from the
    global grid (``_host_trapz``).

    times (K,), data (I, K), omega (J,), mu (I, J), w (K,) {0,1}: tensors
    on the rank's device; t0 a float.  K must divide by the 'time' size.
    Returns C (J,) and mm (0-d)."""
    _x64(cdtype)
    _check_device(mesh, times.device)
    n_time = _size(mesh, "time")
    K = times.shape[0]
    if K % n_time:
        raise ValueError(f"time axis {K} not divisible by mesh time={n_time}")
    tau = torch.as_tensor(_host_trapz(times.cpu().numpy(),
                                      w.cpu().numpy()), device=times.device)
    Kl = K // n_time
    sl = slice(mesh.get_local_rank("time") * Kl,
               (mesh.get_local_rank("time") + 1) * Kl)
    t, d, wl, tl = times[sl], data[:, sl], w[sl], tau[sl]
    phi = damped_phase(omega[None, :], ((t - t0) * wl)[:, None])   # (Kl, J)
    phiw = phi * wl[:, None]
    phit = phi * tl[:, None]
    I, J = mu.shape
    parts = [phiw.mH @ phiw, phit.mH @ phi,
             (d * wl).to(CDTYPE) @ phiw.conj(), d.to(CDTYPE) @ phit.conj(),
             (tl * (d.real ** 2 + d.imag ** 2)).sum().to(CDTYPE)[None]]
    Z = sum_time(mesh, torch.cat([p.reshape(-1) for p in parts]))
    Gt, Gt_tau = Z[:J * J].reshape(J, J), Z[J * J:2 * J * J].reshape(J, J)
    pd = Z[2 * J * J:2 * J * J + I * J].reshape(I, J)
    pdt = Z[2 * J * J + I * J:-1].reshape(I, J)
    Mmu = mu.mH @ mu
    G, rhs = _masked(Mmu * Gt, (mu.conj() * pd).sum(dim=0), col_mask)
    C = gram_cholesky(G, rhs, solve)
    r_tau = (mu.conj() * pdt).sum(dim=0)
    return C, fit_mismatch(C, Mmu * Gt_tau, r_tau, Z[-1].real)


def sharded_fit_core_real(times, data, omega, mu, t0, w, mesh, solve=None):
    """``sharded_fit_core`` (mesh.py:341; the split-complex arrays of the
    JAX function are the port's complex128 tensors).  Returns C (J,) and
    mm."""
    return sharded_fit_core(times, data, omega, mu, t0, w, mesh,
                            solve=solve)


# ---------------------------------------------------------------------------
# The factored sweeps: start times sharded over 'sweep'
# ---------------------------------------------------------------------------

def sharded_t0_sweep_modesets_factored(times, data, omegas, mus, t0s, Ts,
                                       col_masks, mesh, chunk: int = 64,
                                       analytic: bool = False, solve=None):
    """The t0 x mode-set sweep with the start times sharded over 'sweep'
    (mesh.py:297): each rank runs
    ``engine_real.sweep_t0_modesets_factored_real`` on a contiguous block
    of the sorted start times, padded to a multiple of n_sweep * chunk
    after the chunk budget is applied to the global start times
    (``_clamped_chunk``), so each rank's chunks start where the
    unsharded sweep's do only up to the padding: its results agree to
    rounding.

    times (K,), data (I, K), omegas (S, J), mus (S, I, J), col_masks
    (S, J) bool, t0s/Ts (B,) (t0s ascending): tensors on the rank's
    device.  Returns C (S, B, J) and mm (S, B), gathered."""
    _check_device(mesh, times.device)
    analytic = _analytic_ok(times, analytic)
    t0s, Ts = _sorted_t0s(t0s, Ts)
    chunk = _clamped_chunk(t0s, omegas.imag, chunk)
    n = _size(mesh, "sweep")
    t0p, B = _pad_to(t0s, n * chunk)
    Tp, _ = _pad_to(Ts, n * chunk)
    C, mm = sweep_t0_modesets_factored_real(
        times, data, omegas, mus, _block(mesh, t0p), _block(mesh, Tp),
        col_masks, chunk=chunk, analytic=analytic, solve=solve)
    return (gather_sweep(mesh, C, dim=1)[:, :B],
            gather_sweep(mesh, mm, dim=1)[:, :B])


def sharded_t0_sweep_factored(times, data, omega, mu, t0s, Ts, mesh,
                              col_mask=None, chunk: int = 64,
                              analytic: bool = False, solve=None):
    """The factored sweep of one mode set sharded over 'sweep'
    (mesh.py:250): omega (J,), mu (I, J), col_mask (J,) or None.  Returns
    C (B, J) and mm (B,)."""
    if col_mask is None:
        col_mask = torch.ones(omega.shape, dtype=torch.bool,
                              device=omega.device)
    C, mm = sharded_t0_sweep_modesets_factored(
        times, data, omega[None], mu[None], t0s, Ts, col_mask[None], mesh,
        chunk=chunk, analytic=analytic, solve=solve)
    return C[0], mm[0]


def _shard_partials(t, tp, tn, d, wr, wi, t0c, Tc, analytic):
    """This time shard's part of the sums of one chunk of windows of the
    factored kernel (mesh.py:646-723), packed as real rows (Bc, P):
    [pd | Gt] with the window weights, [pdt | Gtau] with the trapezoid
    weights, and the data norm; the sum over 'time' is the unsharded
    chunk's.  t (Kl,) with its global neighbours tp / tn (the grid shifted
    by one, repeated at the global edges: no halo exchange); d (I, Kl)."""
    Kl, J, I, Bc = t.shape[0], wr.shape[0], d.shape[0], t0c.shape[0]
    tref = t0c[0]
    dt0 = torch.clamp(t - tref, min=0.0)[:, None]
    E = torch.exp(wi[None, :] * dt0)
    ph = wr[None, :] * dt0
    phi0 = torch.complex(E * torch.cos(ph), -E * torch.sin(ph))   # (Kl, J)
    R = phi0.conj()[:, None, :] * d.T[:, :, None]                 # (Kl, I, J)
    S2 = (d.real ** 2 + d.imag ** 2).sum(dim=0)[:, None]

    def win(x):
        return window_geq(x[None, :], t0c[:, None], Tc[:, None])

    W, Wp, Wn = win(t), win(tp), win(tn)
    # tau_k = seg(k-1, k) + seg(k, k+1), each from the neighbour's time.
    Tau = (W * Wn * (tn - t) + Wp * W * (t - tp)) * 0.5
    nR = 2 * I * J
    if analytic:
        X = torch.cat([_as_real(R), S2], dim=1)
        WX, TX = W @ X, Tau @ X
        # The local in-window range is contiguous: its own geometric
        # series.  A half-weight edge term is taken off only where the
        # shard owns the window's global edge (the neighbour sample is
        # outside the window, or it is the grid's edge, dt = 0).
        a = (t[None, :] < t0c[:, None]).sum(dim=1)
        m = (W > 0.5).sum(dim=1)
        ai = torch.clamp(a, 0, Kl - 1)
        ei = torch.clamp(a + m - 1, 0, Kl - 1)
        rows = torch.arange(Bc, device=t.device)
        own_s = ((Wp[rows, ai] == 0) | ((t - tp)[ai] == 0)).to(t.dtype)
        own_e = ((Wn[rows, ei] == 0) | ((tn - t)[ei] == 0)).to(t.dtype)
        s = torch.clamp(t[ai] - tref, min=0.0)
        Gt, Gtau = _geom_grams_core(_fitted_step(t), Kl, wr[None], wi[None],
                                    s, m, own_s[:, None, None],
                                    own_e[:, None, None])
        return torch.cat([WX[:, :nR], _as_real(Gt[0]), TX[:, :nR],
                          _as_real(Gtau[0]), TX[:, -1:]], dim=1)
    A = phi0.conj()[:, :, None] * phi0[:, None, :]              # (Kl, J, J)
    X = torch.cat([_as_real(R), _as_real(A), S2], dim=1)
    WX, TX = W @ X, Tau @ X
    return torch.cat([WX[:, :-1], TX], dim=1)


def sharded_t0_sweep_factored_2d(times, data, omega, mu, t0s, Ts, mesh,
                                 col_mask=None, chunk: int = 64,
                                 analytic: bool = False, solve=None):
    """The factored sweep with both mesh axes live (mesh.py:578): start
    times sharded over 'sweep' and the samples over 'time', the chunk
    sums added over 'time' (``_shard_partials``).  Each rank's chunks are
    joined into as few solves as ``engine_real.JOIN_BYTES`` allows, one
    sum over 'time' a join group; the solve is ``_regularised_solve``, the
    CUDA kernel on the card.  analytic=True takes the closed-form Grams
    shard by shard, on uniform grids where every shard holds at least two
    samples; elsewhere the summation kernel runs.

    times (K,), data (I, K), omega (J,), mu (I, J), t0s/Ts (B,) (t0s
    ascending), col_mask (J,) or None: tensors on the rank's device.  K
    must divide by the 'time' size.  Returns C (B, J) and mm (B,)."""
    _check_device(mesh, times.device)
    n_sweep, n_time = _size(mesh, "sweep"), _size(mesh, "time")
    K = times.shape[0]
    if K % n_time:
        raise ValueError(f"time axis {K} not divisible by mesh time={n_time}")
    analytic = K // n_time >= 2 and _analytic_ok(times, analytic)
    t0s, Ts = _sorted_t0s(t0s, Ts)
    chunk = _clamped_chunk(t0s, omega.imag, chunk)
    t0p, B = _pad_to(t0s, n_sweep * chunk)
    Tp, _ = _pad_to(Ts, n_sweep * chunk)
    t0b, Tb = _block(mesh, t0p), _block(mesh, Tp)

    Kl = K // n_time
    sl = slice(mesh.get_local_rank("time") * Kl,
               (mesh.get_local_rank("time") + 1) * Kl)
    t_prev = torch.cat([times[:1], times[:-1]])
    t_next = torch.cat([times[1:], times[-1:]])
    shard = (times[sl], t_prev[sl], t_next[sl], data[:, sl])

    I, J = mu.shape
    nR = 2 * I * J
    M = mu.mH @ mu
    keep = (torch.ones(J, dtype=torch.bool, device=times.device)
            if col_mask is None else col_mask)
    solve = _regularised_solve if solve is None else solve
    bounds = [(lo, min(lo + chunk, t0b.shape[0]))
              for lo in range(0, t0b.shape[0], chunk)]
    Cs, mms = [], []
    for g0, g1 in join_groups([hi - lo for lo, hi in bounds],
                              2 * J * J * 16):
        Z = sum_time(mesh, torch.cat([
            _shard_partials(*shard, omega.real, omega.imag, t0b[lo:hi],
                            Tb[lo:hi], analytic)
            for lo, hi in bounds[g0:g1]]))
        n = Z.shape[0]
        pd = _as_complex(Z[:, :nR], n, I, J)
        Gt = _as_complex(Z[:, nR:nR + 2 * J * J], n, J, J)
        o = nR + 2 * J * J
        pdt = _as_complex(Z[:, o:o + nR], n, I, J)
        Gtau = _as_complex(Z[:, o + nR:-1], n, J, J)
        G, rhs = _masked(M * Gt, torch.einsum("ij,bij->bj", mu.conj(), pd),
                         keep)
        C0 = solve(G, rhs)
        rt = torch.einsum("ij,bij->bj", mu.conj(), pdt)
        lo, hi = bounds[g0][0], bounds[g1 - 1][1]
        trefs = torch.cat([t0b[a:a + 1].expand(b - a)
                           for a, b in bounds[g0:g1]])
        C, mm = _mismatch_rephase(C0[None], (M * Gtau)[None], rt[None],
                                  Z[:, -1], omega[None], t0b[lo:hi], trefs)
        Cs.append(C[0])
        mms.append(mm[0])
    C, mm = torch.cat(Cs), torch.cat(mms)
    return gather_sweep(mesh, C)[:B], gather_sweep(mesh, mm)[:B]


# ---------------------------------------------------------------------------
# Grids, dynamic spectra and events: data parallel over items
# ---------------------------------------------------------------------------

def sharded_spectra_sweep(times, rows, omegas, mus, t0, T, mesh,
                          t0_method: str = "geq", chunk=None,
                          device="cuda", solve=None):
    """The fits of Q spectra on one window with the grid points sharded
    over 'sweep' (mesh.py:416): each rank runs ``batched._run_spectra_sweep``
    on its block (the stacked engine on a uniform contiguous window, else
    the summed-Gram ``_grid_sweep``).

    Host arrays, as in the batched layer: times (K,), rows (I, K), omegas
    (Q, J), mus (Q, I, J); t0, T floats.  Returns C (Q, J) and mm (Q,) as
    NumPy arrays, gathered."""
    from ..batched import _run_spectra_sweep
    dev = torch.device(device)
    _check_device(mesh, dev)
    n = _size(mesh, "sweep")
    om, Q = _pad_to(np.asarray(omegas), n)
    mu, _ = _pad_to(np.asarray(mus), n)
    C, mm = _run_spectra_sweep(times, rows, _block(mesh, om),
                               _block(mesh, mu), t0, T, t0_method, dev,
                               solve, chunk)
    C = gather_sweep(mesh, torch.as_tensor(C, dtype=CDTYPE, device=dev))
    mm = gather_sweep(mesh, torch.as_tensor(mm, dtype=RDTYPE, device=dev))
    return C[:Q].cpu().numpy(), mm[:Q].cpu().numpy()


def sharded_omega_grid_bordered(times, d, fixed, re_axis, im_axis, t0, w,
                                mesh, a_chunk: int = 8,
                                analytic: bool = False):
    """The bordered free-frequency grid with the Re axis sharded over
    'sweep' (mesh.py:457): each rank runs
    ``engine_real.sweep_omega_grid_bordered_real`` on its block of Re
    values, the fixed block factored on every rank.

    times/w (K,), d (K,) complex, fixed (Jf,) complex, re_axis (A,),
    im_axis (B,), t0 a 0-d tensor: on the rank's device.  Returns C
    (A * B, Jf + 1) and mm (A * B,) in q = a * B + b order."""
    _check_device(mesh, times.device)
    analytic = _analytic_ok(times, analytic)
    re_p, A = _pad_to(re_axis, _size(mesh, "sweep"))
    C, mm = sweep_omega_grid_bordered_real(times, d, fixed,
                                           _block(mesh, re_p), im_axis, t0,
                                           w, a_chunk=a_chunk,
                                           analytic=analytic)
    Q = A * im_axis.shape[0]
    return gather_sweep(mesh, C)[:Q], gather_sweep(mesh, mm)[:Q]


def sharded_t0_sweep_modesets_dynamic(times, data, omegas_t, mus_t, t0s, Ts,
                                      col_masks, mesh,
                                      t0_method: str = "geq",
                                      chunk: int = 16, solve=None):
    """The dynamic-spectrum (set x t0) sweep with the start times sharded
    over 'sweep' (mesh.py:498): the tracks do not depend on t0 and every
    rank holds them; each runs ``batched.sweep_t0_modesets_dynamic_real``
    on its block.  omegas_t (S, K, J), mus_t (S, I, K, J), t0s/Ts (B,) in
    any order, col_masks (S, J).  Returns C (S, B, J) and mm (S, B)."""
    from ..batched import sweep_t0_modesets_dynamic_real
    _check_device(mesh, times.device)
    Ts = torch.broadcast_to(torch.as_tensor(Ts, dtype=t0s.dtype,
                                            device=t0s.device), t0s.shape)
    n = _size(mesh, "sweep")
    t0p, B = _pad_to(t0s, n)
    Tp, _ = _pad_to(Ts, n)
    C, mm = sweep_t0_modesets_dynamic_real(
        times, data, omegas_t, mus_t, _block(mesh, t0p), _block(mesh, Tp),
        col_masks, t0_method, chunk=chunk, solve=solve)
    return (gather_sweep(mesh, C, dim=1)[:, :B],
            gather_sweep(mesh, mm, dim=1)[:, :B])


def sharded_event_batch(times, data, omegas, t0s, Ts, mesh, chunk: int = 64,
                        t0_method: str = "geq", solve=None):
    """The per-event fit batch with the events sharded over 'sweep'
    (mesh.py:540): each rank runs ``batched.sweep_events_real`` (summed
    Grams) on its block.  times (K,); data (E, K), omegas (E, J), t0s/Ts
    (E,).  Returns C (E, J) and mm (E,)."""
    from ..batched import sweep_events_real
    _check_device(mesh, times.device)
    n = _size(mesh, "sweep")
    parts = [_pad_to(x, n)[0] for x in (data, omegas, t0s, Ts)]
    E = t0s.shape[0]
    C, mm = sweep_events_real(times, *[_block(mesh, x) for x in parts],
                              chunk=chunk, t0_method=t0_method, solve=solve)
    return gather_sweep(mesh, C)[:E], gather_sweep(mesh, mm)[:E]
