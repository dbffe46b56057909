// The factored start-time sweep's systems and its mismatch epilogue as
// hand-written FP64 kernels for Hopper (sm_90a).
//
// They replace what the JAX package computes, as XLA programs, in
// qnmfits_tpu/engine_real.py::_chunk_sweep_factored (analytic=True): the
// phase basis, the data projections with their trapezoid edge
// corrections, the closed-form window Grams of _analytic_grams /
// _geom_grams_core / _geom_series_eval and the mixing contraction up to
// the solve; and, after it, the mismatch and the rephasing of the
// amplitudes (:826-842).  None of these is a Pallas kernel.  The plain
// PyTorch versions are engine_real._chunk_systems(analytic=True) and
// engine_real._mismatch_rephase (through ops/sweep_cuda.py).
//
// factored_systems_kernel: one launch covers a join group of chunks of
// start times.  A chunk is `chunk` consecutive windows whose basis is
// referenced to tref = the chunk's first start time.  One thread-block
// cluster of 1 to 8 blocks takes one (mode set, chunk); the wrapper sizes
// the cluster to the grid (ops/sweep_cuda.py cluster_size: at least 8
// windows a block, the clusters on the card at once, but at least 4).
//   * Tile sums.  The samples the chunk's windows span are cut into tiles
//     of TK; each block of the cluster takes a contiguous share of the
//     tiles.  For each pass of NQ (row i, mode j) columns it evaluates the
//     basis conj(phi0_j(t_k)) = exp(Im w_j dt) (cos, sin)(Re w_j dt) once
//     for each (mode, sample) of its share, multiplies it by each row, and
//     stores each tile's sum of every column (and of |d|^2 for dnorm).
//     The basis is thus made once a (set, chunk, mode, sample), not once a
//     block of windows and row.
//   * Window sums from tile sums.  A block takes a contiguous share of the
//     chunk's windows, WR a round, one (window, column) a thread.  Each
//     window adds its two partial edge tiles from per-sample values that
//     the block makes for the round's head tiles and tail tiles only;
//     then, having waited on the cluster's barrier, the tiles inside
//     every window of the round (their common interior) once a column
//     and its own whole tiles outside it, read from the other blocks'
//     shared memory (map_shared_rank).  Every window sum is a sum of the
//     same terms as the plain version's W @ X, in another order; no prefix
//     sums are differenced, which would lose up to e^18 eps of a window's
//     sum (the chunk's |Im w| x span <= 18).
//   * The cluster's barrier is split: a block arrives once its tile sums
//     are made and waits only before its first remote read (after its
//     first round's edges); after its last remote read it arrives, makes
//     its Grams, and waits before it leaves, so no block leaves while
//     another reads its shared memory.  Between passes (J > NQ / I) a
//     whole barrier keeps the next pass's tile sums from being made while
//     the last pass's are read.
//   * The trapezoid (dlt times the window sum less half of the two edge
//     samples) and the mixing mu^H . as before.
//   * The Grams.  What depends on (set, j, l) only is made once a block in
//     shared memory: the expm1 ladder's nbits levels of u(z^(2^i)), from
//     den = u(z), and the mixing M = mu^H mu.  Each window's leading
//     factor exp(nu s) is the product of its J basis values, exp(-i w_j s)
//     conj(exp(-i w_l s)), so a window costs J transcendentals, not J^2.
//     A thread takes one (j, l) over a few consecutive windows and makes
//     S_m = u(z^m) / u(z) and z^(m-1) (the bits of m, two complex
//     divisions) only where m changes.  The divisions stay divisions: a
//     reciprocal would not give the exact zero G2 of a one-sample window.
// With many tiles (a long grid) the tile sums go to a global workspace
// the wrapper allocates (Sweep::ws non-null) instead of shared memory; the
// cluster, its barriers and the rest are the same.  All shared memory is
// one dynamic buffer, laid out by make_layout; the kernel is held to 64
// registers, four blocks an SM (tref and dlt live in shared memory, not
// in registers across the passes).
//
// What bounds it on an H100: its latency.  At the main path's shapes (J =
// 8, I = 2, m ~ 1000 samples a window) the outputs' (2 J^2 + 2 J) x 16
// bytes a system without dedup, 268 MB, would take 0.09 ms; a block's
// chain of dependent steps (the span, the basis and its tile sums, the
// round's edges and window sums, the Grams), each a transcendental or a
// remote read deep with a barrier behind it, takes longer.  A first
// version made the basis again in every block of 16 windows and every
// row, and added every window's ~1000 samples from shared memory.
//
// mismatch_rephase_kernel: one warp a (set, window) system after the
// solve: num = Re sum conj(C0) rt, model = Re C0^H G2 C0 (the J x J entries
// read in order by the lanes), mm = 1 - num / sqrt(model dnorm), and
// C = C0 exp(-i w (t0 - tref)).  It reads G2 once: bound by bytes.
//
// Both are built with nvcc into a library with a plain C interface, bound
// with ctypes; each C entry returns cudaGetLastError() of its launch.
// Without __CUDACC__ the file gives the kernels alone, for a host build
// that supplies the CUDA names (the cluster, its barrier, map_shared_rank
// and each block's dynamic shared buffer) and launches them itself (the
// CPU test of their arithmetic, tests/test_torch_factored_kernel.py).

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace cg = cooperative_groups;

#ifdef __CUDACC__
// A block's dynamic shared memory, and the cluster's barrier in its two
// halves: arrive (releasing this thread's writes) and wait (acquiring
// every thread's) (the host build supplies its own).
extern __shared__ __align__(16) unsigned char qnm_shared[];
__device__ inline unsigned char* shared_buffer() { return qnm_shared; }
__device__ inline void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
#endif

namespace {

constexpr int NQ = 16;            // columns (i, j) a pass
constexpr int TK = 16;            // samples a tile
constexpr int THREADS = 256;      // threads a block of the systems kernel
constexpr int WR = THREADS / NQ;  // windows a round: a (window, column) a thread
constexpr int NSLOT = 8;          // tiles of per-sample values made at once
constexpr int SLAB = NSLOT * TK;
constexpr int STRIPES = THREADS / (NQ + 1);   // partial sums of a column
constexpr int NPAIR = 256;        // Gram (j, l) pairs hoisted at once
constexpr int PHASE_BYTES = 16384;            // a Gram round's window phases
constexpr int GWIN = 64;          // windows a Gram round, at most
constexpr int EPI_WARPS = 4;      // systems a block of the epilogue

// Integers a block keeps: the round's windows (their m for a Gram round
// too) and the chunk's span; then two doubles, tref and dlt (kept here,
// not in registers across the passes).
constexpr int I_A = 0, I_M = WR, I_F0 = WR + GWIN, I_F1 = 2 * WR + GWIN,
              I_MISC = 3 * WR + GWIN, I_DBL = I_MISC + 8,
              N_INTS = I_DBL + 4;
enum { TREF, DLT };                             // I_DBL + these
// I_MISC + these: the chunk's span, and of a round's non-empty windows
// the common interior [max f0, min f1) and the tiles of their first
// samples (head tiles) and last samples (tail tiles).
enum { LO, HI, CF0, CF1, TA_LO, TA_HI, TE_LO, TE_HI };

// Byte offsets into a block's dynamic shared memory.  The Grams reuse the
// passes' bytes (after the last pass nothing there is read again).
struct Layout {
  int cluster;                    // blocks a cluster: one (set, chunk)
  int tpb;                        // tile sums a block holds, at most
  int npair, gwin, nbits;         // Gram pairs a group, windows a round
  int tiles, ints;                // tile sums (shared variant), integers
  int slab, sq, pd, pdt, part, cs, wsq;       // the passes
  int levels, mix, keep, phase;               // the Grams
  int bytes;
  long long ws;                   // workspace double2s a cluster (global)
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int K, int J, int nbits,
                                              int cluster, bool global) {
  Layout L;
  L.cluster = cluster;
  L.nbits = nbits;
  const int nt = (K + TK - 1) / TK;
  L.tpb = (nt + cluster - 1) / cluster;
  L.npair = J * J < NPAIR ? J * J : NPAIR;
  const int gw = PHASE_BYTES / (16 * J);
  L.gwin = gw < 1 ? 1 : (gw > GWIN ? GWIN : gw);
  int o = 0;
  L.tiles = o;
  if (!global) o += align16(L.tpb * (NQ + 1) * 16);
  L.ints = o;
  o += align16(N_INTS * 4);
  const int base = o;
  L.slab = o;   o += SLAB * NQ * 16;
  L.sq = o;     o += SLAB * 8;
  L.pd = o;     o += WR * NQ * 16;
  L.pdt = o;    o += WR * NQ * 16;
  L.part = o;   o += STRIPES * (NQ + 1) * 16;
  L.cs = o;     o += (NQ + 1) * 16;
  L.wsq = o;    o += WR * 16;
  const int passes = o;
  o = base;
  L.levels = o; o += L.npair * nbits * 16;
  L.mix = o;    o += L.npair * 16;
  L.keep = o;   o += align16(L.npair * 4);
  L.phase = o;  o += L.gwin * J * 16;
  L.bytes = o > passes ? o : passes;
  L.ws = global ? (long long)cluster * L.tpb * (NQ + 1) : 0;
  return L;
}

struct Sweep {
  const double* times;            // (K,)
  const double2* data;            // (I, K)
  const double2* omegas;          // (S, J)
  const double2* mus;             // (S, I, J)
  const unsigned char* keep;      // (S, J) live columns
  const double* t0s;              // (B,)
  const double* Ts;               // (B,)
  double2* G;                     // (S, B, J, J)
  double2* G2;                    // (S, B, J, J)
  double2* rhs;                   // (S, B, J)
  double2* rt;                    // (S, B, J)
  double* dnorm;                  // (B,)
  double2* ws;                    // tile sums (global variant), else null
  long long B;
  int K, I, J, chunk;
  Layout L;
};

// Samples strictly before x on the ascending grid: the plain version's
// sum(times < x).  The uniform step's guess, then a step or two to the
// exact count: a few loads, where a binary search makes log2 K dependent
// ones, in a chain every block walks several times.
__device__ int count_below(const double* times, int K, double x,
                           double dlt) {
  const double g = (x - times[0]) / dlt;
  int k = g > 0.0 ? (g < (double)K ? (int)ceil(g) : K) : 0;
  while (k > 0 && !(times[k - 1] < x)) --k;
  while (k < K && times[k] < x) ++k;
  return k;
}

// conj(phi0(t)) = exp(Im w dt) (cos, sin)(Re w dt), phi0 = exp(-i w dt).
__device__ double2 conj_phase(double2 w, double dt) {
  const double E = exp(w.y * dt);
  double sn, cs;
  sincos(w.x * dt, &sn, &cs);
  return make_double2(E * cs, E * sn);
}

__device__ double sq_norm(const Sweep& p, int k) {
  double acc = 0.0;
  for (int i = 0; i < p.I; ++i) {
    const double2 d = p.data[(long long)i * p.K + k];
    acc += d.x * d.x + d.y * d.y;
  }
  return acc;
}

// What a block knows of its (set, chunk) and its pass.
struct Chunk {
  int s, k_lo, k_hi, tpt;         // set; span [k_lo, k_hi); tiles a block
  int j0, i0, RP, JP;             // the pass's modes and rows
  bool with_sq;                   // the pass adds up |d|^2 (dnorm)
  const double* dc;               // tref, dlt
};

// Two runs of tiles, [lo1, lo1 + n1) then [lo2, lo2 + n2).
struct Runs {
  int lo1, n1, lo2, n2;
  __device__ int at(int i) const { return i < n1 ? lo1 + i : lo2 + i - n1; }
};

// A round's bounds before its windows' atomics.
__device__ inline void init_round(int* misc, int nt) {
  misc[CF0] = 0;
  misc[CF1] = nt;
  misc[TA_LO] = misc[TE_LO] = nt;
  misc[TA_HI] = misc[TE_HI] = -1;
}

// Per-sample values of the pass's columns (q = jm * RP + r: row i0 + r of
// mode j0 + jm) at the TK samples of tiles first..first+n-1 of the runs:
// the basis once a (mode, sample), times each row; zero past the span or
// past I and J.  With the pass's with_sq, also sum_i |d_i|^2 a sample.
// Ends with a barrier.
__device__ void make_products(const Sweep& p, const Chunk& c,
                              const Runs& runs, int first, int n,
                              double2* P, double* sq) {
  for (int e = threadIdx.x; e < n * TK * c.JP; e += THREADS) {
    const int jm = e % c.JP, idx = e / c.JP;
    const int k = c.k_lo + runs.at(first + idx / TK) * TK + idx % TK;
    const int j = c.j0 + jm;
    double2* out = P + idx * NQ + jm * c.RP;
    if (k < c.k_hi && j < p.J) {
      const double2 b = conj_phase(p.omegas[(long long)c.s * p.J + j],
                                   fmax(p.times[k] - c.dc[TREF], 0.0));
      for (int r = 0; r < c.RP; ++r) {
        const int i = c.i0 + r;
        double2 v = make_double2(0.0, 0.0);
        if (i < p.I) {
          const double2 d = p.data[(long long)i * p.K + k];
          v = make_double2(b.x * d.x - b.y * d.y, b.x * d.y + b.y * d.x);
        }
        out[r] = v;
      }
    } else {
      for (int r = 0; r < c.RP; ++r) out[r] = make_double2(0.0, 0.0);
    }
  }
  if (c.with_sq) {
    for (int e = threadIdx.x; e < n * TK; e += THREADS) {
      const int k = c.k_lo + runs.at(first + e / TK) * TK + e % TK;
      sq[e] = k < c.k_hi ? sq_norm(p, k) : 0.0;
    }
  }
  __syncthreads();
}

// A window's samples in the slab's tiles first..first+n-1 of the runs:
// its head [a, h1) in tile ta, where its first sample lies, and its tail
// [h2, a + m) in tile te, where its last lies, added to *acc; its first
// and last samples added to *edge (so *edge ends as their sum, added in
// that order); with do_sq the same of |d|^2 into wsq (.x, .y).
__device__ void add_edges(const Chunk& c, const Runs& runs, int first, int n,
                          int a, int m, int f0, int f1, int q, bool do_sq,
                          const double2* P, const double* sq, double2* acc,
                          double2* edge, double2* wsq) {
  const int ta = (a - c.k_lo) / TK, te = (a + m - 1 - c.k_lo) / TK;
  const int ia = ta - runs.lo1 - first;
  const int ie = (te - runs.lo1 < runs.n1 ? te - runs.lo1
                                          : runs.n1 + te - runs.lo2) - first;
  double2 s = *acc, g = *edge, w = do_sq ? *wsq : make_double2(0.0, 0.0);
  if (ia >= 0 && ia < n) {
    const int u = ia * TK - (c.k_lo + ta * TK);
    for (int k = a; k < min(a + m, c.k_lo + f0 * TK); ++k) {
      s.x += P[(u + k) * NQ + q].x;
      s.y += P[(u + k) * NQ + q].y;
      if (do_sq) w.x += sq[u + k];
    }
    g.x += P[(u + a) * NQ + q].x;
    g.y += P[(u + a) * NQ + q].y;
    if (do_sq) w.y += sq[u + a];
  }
  if (ie >= 0 && ie < n) {
    const int u = ie * TK - (c.k_lo + te * TK);
    for (int k = max(a, c.k_lo + max(f0, f1) * TK); k < a + m; ++k) {
      s.x += P[(u + k) * NQ + q].x;
      s.y += P[(u + k) * NQ + q].y;
      if (do_sq) w.x += sq[u + k];
    }
    g.x += P[(u + a + m - 1) * NQ + q].x;
    g.y += P[(u + a + m - 1) * NQ + q].y;
    if (do_sq) w.y += sq[u + a + m - 1];
  }
  *acc = s;
  *edge = g;
  if (do_sq) *wsq = w;
}

// The workspace of this block's cluster (global variant).
__device__ inline double2* cluster_ws(const Sweep& p) {
  const long long nchunk = gridDim.x / p.L.cluster;
  return p.ws + ((long long)blockIdx.y * nchunk + blockIdx.x / p.L.cluster)
                * p.L.ws;
}

// The tile sums block `rank` of the cluster keeps, NQ + 1 a tile.
__device__ inline double2* tiles_of(const Sweep& p, unsigned char* sm,
                                    int rank) {
  if (p.ws) return cluster_ws(p) + (long long)rank * p.L.tpb * (NQ + 1);
  return cg::this_cluster().map_shared_rank(
      reinterpret_cast<double2*>(sm + p.L.tiles), (unsigned)rank);
}

// Tile t's NQ + 1 sums, the chunk's tiles dealt tpt a block.
__device__ inline const double2* tile_sums(const Sweep& p, unsigned char* sm,
                                           int tpt, int t) {
  const int r = t / tpt;
  return tiles_of(p, sm, r) + (t - r * tpt) * (NQ + 1);
}

// The Gram values of pair g0 + e = (j, l) that depend on (set, j, l)
// alone, into slot e: the ladder's levels u(z^(2^i)), i < nbits, from
// u(z) = z - 1 (a level above m's top bit may overflow for growing modes
// and is never used), the mixing M = sum_i conj(mu_ij) mu_il and whether
// both columns are live.
__device__ void hoist_pair(const Sweep& p, int s, double dlt, int g0, int e,
                           double2* levels, double2* mix, int* kept) {
  const int J = p.J, j = (g0 + e) / J, l = (g0 + e) % J;
  const double2 wj = p.omegas[(long long)s * J + j];
  const double2 wl = p.omegas[(long long)s * J + l];
  const double nu_re = wj.y + wl.y, nu_im = wj.x - wl.x;
  const double ex = exp(nu_re * dlt);
  const double sh = sin(nu_im * dlt * 0.5);
  double u_re = expm1(nu_re * dlt) - 2.0 * ex * (sh * sh);
  double u_im = ex * sin(nu_im * dlt);
  for (int i = 0; i < p.L.nbits; ++i) {
    levels[i * p.L.npair + e] = make_double2(u_re, u_im);
    const double r = u_re * u_re - u_im * u_im + 2.0 * u_re;
    u_im = 2.0 * u_re * u_im + 2.0 * u_im;
    u_re = r;
  }
  double2 M = make_double2(0.0, 0.0);
  for (int i = 0; i < p.I; ++i) {
    const double2 uj = p.mus[((long long)s * p.I + i) * J + j];
    const double2 ul = p.mus[((long long)s * p.I + i) * J + l];
    M.x += uj.x * ul.x + uj.y * ul.y;
    M.y += uj.x * ul.y - uj.y * ul.x;
  }
  mix[e] = M;
  kept[e] = p.keep[(long long)s * J + j] && p.keep[(long long)s * J + l];
}

__global__ void __launch_bounds__(THREADS, 4)
factored_systems_kernel(Sweep p) {
  const Layout& L = p.L;
  const int CL = L.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x;
  unsigned char* sm = shared_buffer();
  int* ints = reinterpret_cast<int*>(sm + L.ints);
  int* win_a = ints + I_A;
  int* win_m = ints + I_M;
  int* win_f0 = ints + I_F0;
  int* win_f1 = ints + I_F1;
  int* misc = ints + I_MISC;

  double* dc = reinterpret_cast<double*>(ints + I_DBL);

  Chunk c;
  c.s = blockIdx.y;
  c.dc = dc;
  // Windows c_lo + [0, nwc) of the chunk.
  const long long c_lo = (long long)(blockIdx.x / CL) * p.chunk;
  const int nwc = (int)min((long long)p.chunk, p.B - c_lo);
  double2* P = reinterpret_cast<double2*>(sm + L.slab);
  double* sq = reinterpret_cast<double*>(sm + L.sq);
  double2* sm_pd = reinterpret_cast<double2*>(sm + L.pd);
  double2* sm_pdt = reinterpret_cast<double2*>(sm + L.pdt);
  double2* part = reinterpret_cast<double2*>(sm + L.part);
  double2* cs = reinterpret_cast<double2*>(sm + L.cs);
  double2* wsq = reinterpret_cast<double2*>(sm + L.wsq);

  // The samples the chunk's non-empty windows span, the same in every
  // block of the cluster.
  if (tid == 0) {
    misc[LO] = p.K;
    misc[HI] = 0;
    dc[TREF] = p.t0s[c_lo];
    // The fitted uniform step, as engine_real._fitted_step.
    dc[DLT] = (p.times[p.K - 1] - p.times[0]) / (p.K - 1);
  }
  __syncthreads();
  {
    int lo = p.K, hi = 0;
    const double dlt = dc[DLT];
    for (int v = tid; v < nwc; v += THREADS) {
      const double t0 = p.t0s[c_lo + v];
      const int a = count_below(p.times, p.K, t0, dlt);
      const int e = count_below(p.times, p.K, t0 + p.Ts[c_lo + v], dlt);
      if (e > a) {
        lo = min(lo, a);
        hi = max(hi, e);
      }
    }
    atomicMin(&misc[LO], lo);
    atomicMax(&misc[HI], hi);
  }
  __syncthreads();
  c.k_lo = misc[LO];
  c.k_hi = misc[HI];
  const int nt = c.k_hi > c.k_lo ? (c.k_hi - c.k_lo + TK - 1) / TK : 0;
  c.tpt = max((nt + CL - 1) / CL, 1);
  const int t_first = min(rank * c.tpt, nt);
  const int t_last = min(t_first + c.tpt, nt);
  // This block's windows: c_lo + [w_first, w_last).
  const int wpb = (p.chunk + CL - 1) / CL;
  const int w_first = min(rank * wpb, nwc);
  const int w_last = min(w_first + wpb, nwc);

  const int w = tid / NQ, q = tid % NQ;     // a round's (window, column)
  // A pass takes RP rows of each of JP modes: whole modes (RP = I, JP =
  // NQ / I) while I <= NQ, else NQ rows of one mode, whose mixing then
  // adds up over the mode's ceil(I / NQ) passes in rhs and rt themselves.
  c.RP = min(p.I, NQ);
  c.JP = NQ / c.RP;
  const int NC = c.JP * c.RP;
  for (c.j0 = 0; c.j0 < p.J; c.j0 += c.JP) {
    for (c.i0 = 0; c.i0 < p.I; c.i0 += c.RP) {
      c.with_sq = c.j0 == 0 && c.i0 == 0 && c.s == 0;
      const bool live = q < NC && c.j0 + q / c.RP < p.J
                        && c.i0 + q % c.RP < p.I;
      const bool do_sq = c.with_sq && q == 0;

      // Tile sums of this block's share, NSLOT tiles at a time.
      for (int t0 = t_first; t0 < t_last; t0 += NSLOT) {
        const int n = min(NSLOT, t_last - t0);
        make_products(p, c, Runs{t0, n, 0, 0}, 0, n, P, sq);
        for (int e = tid; e < n * (NQ + 1); e += THREADS) {
          const int u = e / (NQ + 1), col = e % (NQ + 1);
          double2 acc = make_double2(0.0, 0.0);
          if (col < NC) {
            for (int kk = 0; kk < TK; ++kk) {
              const double2 r = P[(u * TK + kk) * NQ + col];
              acc.x += r.x;
              acc.y += r.y;
            }
          } else if (col == NQ && c.with_sq) {
            for (int kk = 0; kk < TK; ++kk) acc.x += sq[u * TK + kk];
          }
          tiles_of(p, sm, rank)[(t0 - t_first + u) * (NQ + 1) + col] = acc;
        }
        __syncthreads();                    // the slab is made again
      }
      if (tid == 0) init_round(misc, nt);
      __syncthreads();                      // (an arrive is no barrier)
      // This block's tile sums are made; it waits for the others' only
      // before its first remote read, after its first round's edges.
      cluster_arrive();
      bool waited = false;

      for (int r0 = w_first; r0 < w_last; r0 += WR) {
        const int nwr = min(WR, w_last - r0);
        if (tid < nwr) {
          const double t0 = p.t0s[c_lo + r0 + tid];
          const double dlt = dc[DLT];
          const int a = count_below(p.times, p.K, t0, dlt);
          const int e = count_below(p.times, p.K, t0 + p.Ts[c_lo + r0 + tid],
                                    dlt);
          const int m = max(e - a, 0);
          win_a[tid] = a;
          win_m[tid] = m;
          // Whole tiles [f0, f1) of the chunk's tiling inside the window.
          win_f0[tid] = m > 0 ? (a - c.k_lo + TK - 1) / TK : 0;
          win_f1[tid] = m > 0 ? (a + m - c.k_lo) / TK : 0;
          if (m > 0) {
            atomicMax(&misc[CF0], win_f0[tid]);
            atomicMin(&misc[CF1], win_f1[tid]);
            atomicMin(&misc[TA_LO], (a - c.k_lo) / TK);
            atomicMax(&misc[TA_HI], (a - c.k_lo) / TK);
            atomicMin(&misc[TE_LO], (a + m - 1 - c.k_lo) / TK);
            atomicMax(&misc[TE_HI], (a + m - 1 - c.k_lo) / TK);
          }
        }
        __syncthreads();
        // The head tiles and the tail tiles as two runs, one where they
        // touch (the lowest head tile is at most the lowest tail tile).
        int cf0 = misc[CF0], cf1 = misc[CF1];
        if (cf1 <= cf0) cf0 = cf1 = 0;
        Runs runs{misc[TA_LO], misc[TA_HI] - misc[TA_LO] + 1, misc[TE_LO],
                  misc[TE_HI] - misc[TE_LO] + 1};
        if (misc[TA_HI] < 0) {              // no non-empty window
          runs = Runs{0, 0, 0, 0};
        } else if (runs.lo2 <= misc[TA_HI] + 1) {
          runs.n1 = max(misc[TA_HI], misc[TE_HI]) - runs.lo1 + 1;
          runs.lo2 = runs.lo1 + runs.n1;
          runs.n2 = 0;
        }
        const bool mine = w < nwr;
        const int m = mine ? win_m[w] : 0;
        const bool adds = mine && m > 0 && live;
        // The window's sums live in shared memory across the edge batches
        // (in registers they would live across make_products): sm_pd its
        // sum, sm_pdt its two edge samples' sum, wsq the same of |d|^2.
        if (mine && live) {
          sm_pd[w * NQ + q] = make_double2(0.0, 0.0);
          sm_pdt[w * NQ + q] = make_double2(0.0, 0.0);
          if (do_sq) wsq[w] = make_double2(0.0, 0.0);
        }
        // The partial edge tiles from per-sample values, NSLOT at a time.
        for (int e0 = 0; e0 < runs.n1 + runs.n2; e0 += NSLOT) {
          const int n = min(NSLOT, runs.n1 + runs.n2 - e0);
          make_products(p, c, runs, e0, n, P, sq);
          if (adds)
            add_edges(c, runs, e0, n, win_a[w], m, win_f0[w], win_f1[w], q,
                      do_sq, P, sq, sm_pd + w * NQ + q, sm_pdt + w * NQ + q,
                      wsq + w);
          __syncthreads();                  // the slab is made again
        }
        if (!waited) {                      // the cluster's tile sums
          cluster_wait();
          waited = true;
        }
        // The common interior's sums: STRIPES partial sums a column.
        if (cf1 > cf0) {
          if (tid < STRIPES * (NQ + 1)) {
            const int col = tid % (NQ + 1), st = tid / (NQ + 1);
            double2 acc = make_double2(0.0, 0.0);
            for (int t = cf0 + st; t < cf1; t += STRIPES) {
              const double2 r = tile_sums(p, sm, c.tpt, t)[col];
              acc.x += r.x;
              acc.y += r.y;
            }
            part[st * (NQ + 1) + col] = acc;
          }
          __syncthreads();
          if (tid < NQ + 1) {
            double2 acc = make_double2(0.0, 0.0);
            for (int st = 0; st < STRIPES; ++st) {
              acc.x += part[st * (NQ + 1) + tid].x;
              acc.y += part[st * (NQ + 1) + tid].y;
            }
            cs[tid] = acc;
          }
          __syncthreads();
        }
        if (adds) {
          // Whole tiles: the common interior once, then the window's own,
          // [f0, f1) = [f0, cf0) + the interior [cf0, cf1) + [cf1, f1).
          const int f0 = win_f0[w], f1 = win_f1[w];
          const bool common = cf1 > cf0;
          double2 acc = sm_pd[w * NQ + q];
          double acc_sq = do_sq ? wsq[w].x : 0.0;
          if (common) {
            acc.x += cs[q].x;
            acc.y += cs[q].y;
            if (do_sq) acc_sq += cs[NQ].x;
          }
          for (int half = 0; half < 2; ++half) {
            const int t_lo = half == 0 ? f0 : (common ? cf1 : f1);
            const int t_hi = half == 0 ? (common ? cf0 : f1) : f1;
            for (int t = t_lo; t < t_hi; ++t) {
              const double2* ts = tile_sums(p, sm, c.tpt, t);
              acc.x += ts[q].x;
              acc.y += ts[q].y;
              if (do_sq) acc_sq += ts[NQ].x;
            }
          }
          sm_pd[w * NQ + q] = acc;
          if (do_sq) wsq[w].x = acc_sq;
        }

        // The trapezoid: dlt times the window sum less half of the two
        // edge samples, zero for an empty window.
        const double nonempty = m > 0 ? 1.0 : 0.0;
        const double dlt = dc[DLT];
        if (mine && live) {
          const double2 acc = sm_pd[w * NQ + q], edge = sm_pdt[w * NQ + q];
          sm_pdt[w * NQ + q] = make_double2(
              (dlt * acc.x - 0.5 * dlt * edge.x) * nonempty,
              (dlt * acc.y - 0.5 * dlt * edge.y) * nonempty);
        }
        if (mine && do_sq)
          p.dnorm[c_lo + r0 + w] =
              (dlt * wsq[w].x - 0.5 * dlt * wsq[w].y) * nonempty;
        __syncthreads();
        if (tid == 0) init_round(misc, nt);   // each thread read it above
        // rhs = mu^H pd, rt = mu^H pdt: this pass's rows of mode j added to
        // the passes' before; zero rhs on a dead column.
        const int j = c.j0 + q;
        if (mine && q < c.JP && j < p.J) {
          const long long o = ((long long)c.s * p.B + c_lo + r0 + w) * p.J
                              + j;
          double2 r1 = c.i0 > 0 ? p.rhs[o] : make_double2(0.0, 0.0);
          double2 r2 = c.i0 > 0 ? p.rt[o] : make_double2(0.0, 0.0);
          const int i1 = min(c.i0 + c.RP, p.I);
          for (int i = c.i0; i < i1; ++i) {
            const double2 mu = p.mus[((long long)c.s * p.I + i) * p.J + j];
            const double2 v1 = sm_pd[w * NQ + q * c.RP + i - c.i0];
            const double2 v2 = sm_pdt[w * NQ + q * c.RP + i - c.i0];
            r1.x += mu.x * v1.x + mu.y * v1.y;
            r1.y += mu.x * v1.y - mu.y * v1.x;
            r2.x += mu.x * v2.x + mu.y * v2.y;
            r2.y += mu.x * v2.y - mu.y * v2.x;
          }
          p.rhs[o] = p.keep[(long long)c.s * p.J + j]
                         ? r1 : make_double2(0.0, 0.0);
          p.rt[o] = r2;
        }
        __syncthreads();                    // the round's smem is rewritten
      }
      if (!waited) cluster_wait();          // a block with no windows
      // The next pass makes its tile sums again: none may be read still.
      // After the last pass the block only waits before it leaves, after
      // its Grams.
      if (c.j0 + c.JP < p.J || c.i0 + c.RP < p.I) {
        cluster_arrive();
        cluster_wait();
      }
    }
  }
  cluster_arrive();

  // The Grams: each (window, j, l) mixed by M = mu^H mu; identity rows and
  // columns for dead columns in G.  What depends on (j, l) alone is made
  // once a block (a group of npair pairs at a time); a window's factor
  // exp(nu s) is its phases' product.
  double2* levels = reinterpret_cast<double2*>(sm + L.levels);
  double2* mix = reinterpret_cast<double2*>(sm + L.mix);
  int* kept = reinterpret_cast<int*>(sm + L.keep);
  double2* phase = reinterpret_cast<double2*>(sm + L.phase);
  const int J = p.J, JJ = J * J, nbits = L.nbits;
  for (int r0 = w_first; r0 < w_last; r0 += L.gwin) {
    const int nwr = min(L.gwin, w_last - r0);
    // The round's phases, and with them the first group's (j, l) values
    // where they are made again (every round when there are several
    // groups, else the first round only).
    const bool hoist = JJ > L.npair || r0 == w_first;
    const int n_phase = nwr * J;
    for (int e = tid; e < n_phase + (hoist ? min(L.npair, JJ) : 0);
         e += THREADS) {
      if (e < n_phase) {
        const int v = e / J, j = e % J;
        const double t0 = p.t0s[c_lo + r0 + v], dlt = dc[DLT];
        const int a = count_below(p.times, p.K, t0, dlt);
        if (j == 0) {
          const int e1 = count_below(p.times, p.K, t0 + p.Ts[c_lo + r0 + v],
                                     dlt);
          win_m[v] = max(e1 - a, 0);
        }
        const double sv = fmax(p.times[min(a, p.K - 1)] - dc[TREF], 0.0);
        phase[e] = conj_phase(p.omegas[(long long)c.s * J + j], sv);
      } else {
        hoist_pair(p, c.s, dc[DLT], 0, e - n_phase, levels, mix, kept);
      }
    }
    __syncthreads();
    for (int g0 = 0; g0 < JJ; g0 += L.npair) {
      const int np = min(L.npair, JJ - g0);
      if (g0 > 0) {
        for (int e = tid; e < np; e += THREADS)
          hoist_pair(p, c.s, dc[DLT], g0, e, levels, mix, kept);
        __syncthreads();
      }
      // A thread takes one pair over vpt consecutive windows, and makes
      // S_m and z^(m-1) again only where m changes (each window's terms
      // are the same operations as if it made them alone).
      const int vpt = (nwr * np + THREADS - 1) / THREADS;
      const double dlt = dc[DLT];
      for (int e = tid; e < np * ((nwr + vpt - 1) / vpt); e += THREADS) {
        const int pi = e % np, v0 = e / np * vpt;
        const int j = (g0 + pi) / J, l = (g0 + pi) % J;
        const double2 den = levels[pi], M = mix[pi];
        const bool live = kept[pi];
        int m_made = -1;
        double S_re = 0.0, S_im = 0.0, zb_re = 0.0, zb_im = 0.0;
        for (int v = v0; v < min(v0 + vpt, nwr); ++v) {
          const int mv = win_m[v];
          if (mv != m_made) {
            m_made = mv;
            // u(z^m) = z^m - 1 by the bits of m.
            double um_re = 0.0, um_im = 0.0;
            for (int i = 0; i < nbits && (mv >> i) != 0; ++i) {
              if ((mv >> i) & 1) {
                const double2 u = levels[i * L.npair + pi];
                const double cm_re = um_re * u.x - um_im * u.y + u.x;
                const double cm_im = um_re * u.y + um_im * u.x + u.y;
                um_re += cm_re;
                um_im += cm_im;
              }
            }
            // S_m = u(z^m) / u(z); nu = 0 has the exact limit S_m = m.
            if (den.x * den.x + den.y * den.y > 0.0) {
              const double d2 = den.x * den.x + den.y * den.y;
              S_re = (um_re * den.x + um_im * den.y) / d2;
              S_im = (um_im * den.x - um_re * den.y) / d2;
            } else {
              S_re = (double)mv;
              S_im = 0.0;
            }
            // z^(m-1) = (u(z^m) + 1) / z.
            const double zm_re = um_re + 1.0, zm_im = um_im;
            const double z_re = den.x + 1.0, z_im = den.y;
            const double z2 = z_re * z_re + z_im * z_im;
            zb_re = (zm_re * z_re + zm_im * z_im) / z2;
            zb_im = (zm_im * z_re - zm_re * z_im) / z2;
          }
          // exp(nu s) = conj(phi0_j(s)) phi0_l(s).
          const double2 Pj = phase[v * J + j], Pl = phase[v * J + l];
          const double F_re = Pj.x * Pl.x + Pj.y * Pl.y;
          const double F_im = Pj.y * Pl.x - Pj.x * Pl.y;
          const double gt_re = F_re * S_re - F_im * S_im;
          const double gt_im = F_re * S_im + F_im * S_re;
          // The last term F z^(m-1).
          const double tb_re = F_re * zb_re - F_im * zb_im;
          const double tb_im = F_re * zb_im + F_im * zb_re;
          const double nonempty = mv > 0 ? 1.0 : 0.0;
          const double gtau_re =
              dlt * (gt_re - 0.5 * (F_re + tb_re)) * nonempty;
          const double gtau_im =
              dlt * (gt_im - 0.5 * (F_im + tb_im)) * nonempty;
          const long long o = ((long long)c.s * p.B + c_lo + r0 + v) * JJ
                              + g0 + pi;
          p.G[o] = live ? make_double2(M.x * gt_re - M.y * gt_im,
                                       M.x * gt_im + M.y * gt_re)
                        : make_double2(j == l ? 1.0 : 0.0, 0.0);
          p.G2[o] = make_double2(M.x * gtau_re - M.y * gtau_im,
                                 M.x * gtau_im + M.y * gtau_re);
        }
      }
      __syncthreads();                      // levels and phases rewritten
    }
  }
  cluster_wait();           // no block leaves while another reads its tiles
}

struct Epilogue {
  const double2* C0;              // (S, B, J)
  const double2* G2;              // (S, B, J, J)
  const double2* rt;              // (S, B, J)
  const double* dnorm;            // (B,)
  const double2* omegas;          // (S, J)
  const double* t0s;              // (B,)
  double2* C;                     // (S, B, J)
  double* mm;                     // (S, B)
  long long B, systems;
  int J, chunk;
};

__device__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * EPI_WARPS)
mismatch_rephase_kernel(Epilogue p) {
  const long long sys = (long long)blockIdx.x * EPI_WARPS + threadIdx.x / 32;
  // A warp past the last system stays to the end: every lane of a warp
  // takes part in its sums.
  const bool active = sys < p.systems;
  const int lane = threadIdx.x % 32;
  const long long s = sys / p.B, b = sys % p.B;
  const double2* c0 = p.C0 + sys * p.J;
  const double2* g2 = p.G2 + sys * p.J * p.J;
  const double2* rt = p.rt + sys * p.J;
  const int J = active ? p.J : 0;
  double num = 0.0, model = 0.0;
  for (int j = lane; j < J; j += 32) {
    const double2 c = c0[j], r = rt[j];
    num += c.x * r.x + c.y * r.y;
  }
  for (int e = lane; e < J * J; e += 32) {
    const int j = e / J, l = e % J;
    const double2 g = g2[e], cl = c0[l], cj = c0[j];
    const double vr = g.x * cl.x - g.y * cl.y, vi = g.x * cl.y + g.y * cl.x;
    model += cj.x * vr + cj.y * vi;
  }
  num = warp_sum(num);
  model = warp_sum(model);
  if (active && lane == 0) p.mm[sys] = 1.0 - num / sqrt(model * p.dnorm[b]);
  if (!active) return;
  // C = C0 exp(-i w (t0 - tref)), tref the first start time of the chunk.
  const double delta = p.t0s[b] - p.t0s[(b / p.chunk) * p.chunk];
  for (int j = lane; j < J; j += 32) {
    const double2 w = p.omegas[s * p.J + j];
    const double g = exp(w.y * delta);
    double sn, cs;
    sincos(w.x * delta, &sn, &cs);
    const double rr = g * cs, ri = -g * sn;
    const double2 c = c0[j];
    p.C[sys * p.J + j] = make_double2(c.x * rr - c.y * ri, c.x * ri + c.y * rr);
  }
}

}  // namespace

#ifdef __CUDACC__
extern "C" {

// The dynamic shared bytes a block of the systems kernel takes, the
// workspace double2s a cluster of the global variant takes (0 for the
// shared one) and the tile sums a block holds, for a grid of K samples,
// J modes, nbits = ceil(log2(K + 1)) and clusters of `cluster` blocks.
int qnm_factored_plan(int K, int J, int nbits, int cluster, int global,
                      long long* out) {
  const Layout L = make_layout(K, J, nbits, cluster, global != 0);
  out[0] = L.bytes;
  out[1] = L.ws;
  out[2] = L.tpb;
  return 0;
}

// Systems of B windows (chunks of `chunk`, each referenced to its first
// start time) for S mode sets: G, G2 (S, B, J, J), rhs, rt (S, B, J)
// complex128 and dnorm (B,) float64.  nbits = ceil(log2(K + 1)).  One
// cluster of `cluster` blocks a (set, chunk); the tile sums in shared
// memory, or in `workspace` (S * nchunk clusters of qnm_factored_plan's
// out[1] double2s) where it is not null.
int qnm_factored_systems(const void* times, const void* data,
                         const void* omegas, const void* mus,
                         const void* keep, const void* t0s, const void* Ts,
                         void* G, void* G2, void* rhs, void* rt, void* dnorm,
                         void* workspace, long long B, int K, int I, int J,
                         int S, int chunk, int nbits, int cluster,
                         void* stream) {
  Sweep p;
  p.times = static_cast<const double*>(times);
  p.data = static_cast<const double2*>(data);
  p.omegas = static_cast<const double2*>(omegas);
  p.mus = static_cast<const double2*>(mus);
  p.keep = static_cast<const unsigned char*>(keep);
  p.t0s = static_cast<const double*>(t0s);
  p.Ts = static_cast<const double*>(Ts);
  p.G = static_cast<double2*>(G);
  p.G2 = static_cast<double2*>(G2);
  p.rhs = static_cast<double2*>(rhs);
  p.rt = static_cast<double2*>(rt);
  p.dnorm = static_cast<double*>(dnorm);
  p.ws = static_cast<double2*>(workspace);
  p.B = B;
  p.K = K;
  p.I = I;
  p.J = J;
  p.chunk = chunk;
  p.L = make_layout(K, J, nbits, cluster, workspace != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      factored_systems_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.L.bytes);
  if (err != cudaSuccess) return (int)err;
  const long long nchunk = (B + chunk - 1) / chunk;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(nchunk * cluster), (unsigned)S);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = p.L.bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, factored_systems_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The epilogue of S * B solved systems: C (S, B, J) complex128 and
// mm (S, B) float64.
int qnm_mismatch_rephase(const void* C0, const void* G2, const void* rt,
                         const void* dnorm, const void* omegas,
                         const void* t0s, void* C, void* mm, long long B,
                         int S, int J, int chunk, void* stream) {
  Epilogue p;
  p.C0 = static_cast<const double2*>(C0);
  p.G2 = static_cast<const double2*>(G2);
  p.rt = static_cast<const double2*>(rt);
  p.dnorm = static_cast<const double*>(dnorm);
  p.omegas = static_cast<const double2*>(omegas);
  p.t0s = static_cast<const double*>(t0s);
  p.C = static_cast<double2*>(C);
  p.mm = static_cast<double*>(mm);
  p.B = B;
  p.systems = B * S;
  p.J = J;
  p.chunk = chunk;
  const long long blocks = (p.systems + EPI_WARPS - 1) / EPI_WARPS;
  mismatch_rephase_kernel<<<(unsigned)blocks, 32 * EPI_WARPS, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // __CUDACC__
