// Window moments of damped phases, FP64, for Hopper (sm_90a).
//
// For trajectory m on window n = win[m] (start time t0 = t0s[n], samples
// first[n] .. first[n] + count[n] - 1 where its {0,1} weight is 1,
// that run's trapezoid weights tau[n, k], offsets s_k = t_k - t0 and phases
// phi_jk = exp(-i omega_mj s_k)), and for v in {w, tau}, p = 0 .. ORDER:
//
//   S[m, v, p, j, l] = sum_k v_k s_k^p conj(phi_jk) phi_lk   (Hermitian)
//   P[m, v, p, i, j] = sum_k v_k s_k^p conj(phi_jk) h_ik
//
// What it replaces.  No Pallas kernel: the JAX package takes the exact
// gradient and Hessian of a windowed fit's mismatch with jax.grad and
// jax.hessian of engine.fit_core (qnmfits_tpu/optimize.py:177-209 over
// qnmfits_tpu/engine.py:198), which XLA runs over (M, K, J) designs.
// With these moments the fit and its derivatives in the two parameters
// follow from J x J algebra a trajectory (optimize._fit_derivs), and no
// design is written.  Plain PyTorch version: ops/moments_cuda.py
// window_moments_plain.
//
// The sums on the FP64 tensor cores.  For one trajectory the moments are
// one complex product over the window's samples: rows a_jk = conj(phi_jk),
// columns b_k = [v_k s_k^p phi_lk | v_k s_k^p h_ik].  It is taken as real
// products on mma.sync m16n8k16 (FP64; m16n8k8 in the general variant,
// whose k16 build spills at order 2): the A
// operand's 16 rows are the real and the imaginary parts of eight modes'
// phases (a "mode group"), each B operand's 8 columns the real or the
// imaginary parts of one weighted group of phases, or of data columns
// laid out (v, p, i, re/im).  A lane's A elements are the phases of mode
// 8 q + lane / 4 at samples 4 u + lane % 4 of the k-step (u < 4), and so
// are the phases its B elements of the same mode group need: each lane
// makes exactly one phase a (mode group, sample), no operand goes through
// shared memory, and the four real blocks (re re, re im, im re, im im)
// of every output land in the same lane, which combines them in
// registers.
//
// Work units.  A unit is a row mode group q with one column mode group
// q2 >= q (the Gram's upper block triangle; the lower blocks are written
// as conjugates), and up to NH of the data column fragments; data
// fragments that no mode-group unit of row q has room for get units of
// their own (q2 = -1).  At J <= 8 with the optimisers' I a trajectory is
// one unit.  A launch of many units gives each a warp, which passes once
// over its window (four units a block, no barrier); one of fewer than
// SPLIT_BELOW units gives each a block, whose four warps take contiguous
// shares of the window's tiles and add their sums in warp order through
// shared memory at the end.  A warp copies each tile's times, trapezoid
// weights (any grid) and data rows into shared memory by cp.async, one
// tile ahead of its products, each lane one sample of each.
//
// Two variants.
//  * Uniform grid (UNI, ops/moments_cuda.py picks it with the port's gate
//    batched._uniform_spacing): a phase is A_j E_j(b), an anchor A_j =
//    exp(-i omega_j s_a) at each tile's first sample a (s_a = times[a] -
//    t0, read exactly) times a step E_j(b) = exp(-i omega_j b dlt) from a
//    table built once a warp (b < TILE, dlt the fitted step that the
//    wrapper takes from engine_real._fitted_step): one complex product a
//    sample, no
//    recurrence.  A lane computes the anchors of four of its warp's tiles
//    at once, one each, and takes each tile's from its neighbours by
//    shuffle.  Only the w moments are summed: on a uniform grid the
//    trapezoid weights are dlt w less dlt/2 at the window's two end
//    samples (engine_real.py's _chunk_systems uses the same identity), so
//    the tau moments are dlt times the w moments less half of the two end
//    samples' terms, which the epilogue adds from their own phases.  tau
//    is never read (the caller may pass none): the tau moments are those
//    of the window's trapezoid weights, whatever tau would hold.
//  * Any grid: each lane's phase from its own sincos and exp a (mode
//    group, sample), and the tau moments summed beside the w moments.
//
// Bound.  ops/moments_cuda.py and chip_smoke.moments_bound count the
// function's work as the first (scalar) design did it: a (trajectory,
// sample, entry) its conj product and 2 (ORDER + 1) weighted sums.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

// Built with -DQNM_MOMENTS_PHASES (moments_cuda.phase_cycles), lane 0 of
// each warp that runs the epilogue adds its clock64 cycles by phase into
// qnm_moments_cycles[0..4] (moments_cuda.PHASES) and counts itself in
// [5], which qnm_moments_phases reads: the clock reads slow what they
// time.
#if defined(QNM_MOMENTS_PHASES) && defined(__CUDACC__)
__device__ unsigned long long qnm_moments_cycles[6];
#endif
#if defined(QNM_MOMENTS_PHASES) && defined(__CUDA_ARCH__)
#define QNM_CLOCK() long long ck_t = clock64(); long long ck_[5] = {};
#define QNM_LAP(idx)                   \
  {                                    \
    const long long n_ = clock64();    \
    ck_[idx] += n_ - ck_t;             \
    ck_t = n_;                         \
  }
#define QNM_STORE()                                                   \
  if (lane == 0) {                                                    \
    for (int i_ = 0; i_ < 5; ++i_)                                    \
      atomicAdd(&qnm_moments_cycles[i_],                              \
                static_cast<unsigned long long>(ck_[i_]));            \
    atomicAdd(&qnm_moments_cycles[5], 1ull);                          \
  }
#else
#define QNM_CLOCK()
#define QNM_LAP(idx)
#define QNM_STORE()
#endif

#ifdef __CUDACC__
// A block's dynamic shared memory: the uniform variant's step tables, each
// lane reading only its own slots (the host build supplies its own).
extern __shared__ __align__(16) unsigned char qnm_shared[];
__device__ inline double2* step_slots() {
  return reinterpret_cast<double2*>(qnm_shared);
}

// Asynchronous copies of 8 or 16 bytes from global into shared memory
// (cp.async), their group's commit, and the wait for all but the newest
// group; the host build supplies its own.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// D = A B + D on the FP64 tensor cores, K = 4 KS (8 or 16): A 16 x K
// (a[2 u]: row lane / 4, a[2 u + 1]: row 8 + lane / 4; column lane % 4 +
// 4 u), B K x 8
// (b[u]: row lane % 4 + 4 u, column lane / 4), D 16 x 8 (d0, d1: row lane
// / 4, columns 2 (lane % 4) + {0, 1}; d2, d3 the same columns of row 8 +
// lane / 4).  The host build supplies its own.
template <int KS>
__device__ __forceinline__ void mma_16x8(double (&d)[4],
                                         const double (&a)[2 * KS],
                                         const double (&b)[KS]) {
  static_assert(KS == 2 || KS == 4, "m16n8k8 or m16n8k16");
#ifdef __CUDA_ARCH__
  if constexpr (KS == 2) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]),
          "d"(b[3]));
  }
#endif
}
#endif

namespace {

constexpr int WARPS = 4;            // warps a block, one unit each
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;            // samples between anchors (UNI)
// Launches of fewer (trajectory, unit) pairs than this give each pair a
// block, its warps sharing the window; larger ones a warp each.  The
// port builds it as it stands; the host tests build it with 0 to reach
// the warp-a-unit path at their small shapes.
#ifndef QNM_MOMENTS_SPLIT_BELOW
#define QNM_MOMENTS_SPLIT_BELOW 2048
#endif
constexpr long long SPLIT_BELOW = QNM_MOMENTS_SPLIT_BELOW;
constexpr long long SMEM_MAX = 232448;   // a block's opt-in shared bytes

struct Moments {
  const double* times;
  const double2* rows;
  const double2* omega;
  const double* t0s;
  const double* tau;
  const int* first;
  const int* count;
  const long long* win;
  double2* S;
  double2* P;
  long long M;
  int K, I, J;
  double dlt;   // the grid's fitted step (engine_real._fitted_step)
};

// A unit of a trajectory's work: row mode group q, column mode group q2
// (-1: data columns only), data fragments hb0 .. hb0 + nh - 1.
struct Unit {
  int q, q2, hb0, nh;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Data column fragments: 8 columns each, (v, p, i, re/im) packed.
__host__ __device__ inline int h_frags(int I, int order, int nv) {
  return cdiv(2 * nv * (order + 1) * I, 8);
}

// The data-only units of row group q (Q groups, HF data fragments, NH a
// unit): what the Q - q mode-group units leave.
__host__ __device__ inline int h_only(int Q, int q, int HF, int NH) {
  const int rest = HF - (Q - q) * NH;
  return rest > 0 ? cdiv(rest, NH) : 0;
}

__host__ __device__ inline int unit_count(int J, int HF, int NH) {
  const int Q = cdiv(J, 8);
  int U = 0;
  for (int q = 0; q < Q; ++q) U += Q - q + h_only(Q, q, HF, NH);
  return U;
}

__host__ __device__ inline Unit unit_of(int u, int J, int HF, int NH) {
  const int Q = cdiv(J, 8);
  Unit un{0, -1, 0, 0};
  for (int q = 0; q < Q; ++q) {
    const int n_phi = Q - q, n = n_phi + h_only(Q, q, HF, NH);
    if (u < n) {
      un.q = q;
      un.q2 = u < n_phi ? q + u : -1;
      un.hb0 = u * NH;
      const int left = HF - un.hb0;
      un.nh = left < 0 ? 0 : (left < NH ? left : NH);
      return un;
    }
    u -= n;
  }
  return un;
}

__device__ inline double2 phase(double2 w, double s) {
  double sn, cs;
  sincos(w.x * s, &sn, &cs);
  const double mag = exp(w.y * s);
  return make_double2(mag * cs, -(mag * sn));
}

__device__ inline double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ inline double2 cjmul(double2 a, double2 b) {  // conj(a) b
  return make_double2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ inline double2 shfl2(double2 v, int src) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, src),
                      __shfl_sync(0xffffffffu, v.y, src));
}

__device__ inline double power(double s, int p) {
  return p == 0 ? 1.0 : (p == 1 ? s : s * s);
}

// Gram entry (j, l) of a plane of J x J and its mirror (l, j), the
// conjugate; the diagonal real.
__device__ inline void store_gram(double2* Sm, int J, int j, int l,
                                  double2 x) {
  if (j == l) {
    Sm[static_cast<long long>(j) * J + j] = make_double2(x.x, 0.0);
  } else {
    Sm[static_cast<long long>(j) * J + l] = x;
    Sm[static_cast<long long>(l) * J + j] = make_double2(x.x, -x.y);
  }
}

// NV = 1: the uniform variant (w moments summed, tau's from the identity);
// NV = 2: any grid (w and tau moments summed).
template <int ORDER, int NV>
__global__ void __launch_bounds__(THREADS)
window_moments_kernel(const Moments p, int units, int split) {
  constexpr int NP = ORDER + 1;
  constexpr int NF = 2 * NV * NP;   // mode-group column fragments
  constexpr int NH = NV + 1;        // data fragments a unit
  constexpr int NA = 4 * (NF + NH);  // accumulators a lane
  constexpr bool UNI = NV == 1;
  // A lane's samples a product, samples a product (a k-step), k-steps a
  // tile.
  constexpr int KS = UNI ? 4 : 2;
  constexpr int SPAN = 4 * KS;
  constexpr int STEPS = TILE / SPAN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // split 1: a warp a (trajectory, unit); else a block a (trajectory,
  // unit), its warps taking contiguous shares of the window's tiles.
  long long gw = blockIdx.x;
  int seg = warp;
  if (split == 1) {
    gw = static_cast<long long>(blockIdx.x) * WARPS + warp;
    seg = 0;
    if (gw >= p.M * units) return;
  }
  QNM_CLOCK();
  const long long m = gw / units;
  const int I = p.I, J = p.J, K = p.K;
  const int HF = h_frags(I, ORDER, NV);
  const Unit un = unit_of(static_cast<int>(gw % units), J, HF, NH);
  const int g = lane >> 2, r = lane & 3;
  const long long n = p.win[m];
  const int k0 = p.first[n], cnt = p.count[n];
  const double t0 = p.t0s[n];
  const bool cols = un.q2 >= 0;
  const bool two = cols && un.q2 != un.q;
  const int jr = 8 * un.q + g;                  // this lane's row mode
  const int jc = 8 * (cols ? un.q2 : un.q) + g;  // and column mode
  const bool live_r = jr < J, live_c = jc < J;
  const double2* om = p.omega + m * J;
  const double2 wr = om[live_r ? jr : 0];
  const double2 wc = om[live_c ? jc : 0];
  const double dlt = p.dlt;

  // This lane's data columns: fragment f's column 8 (hb0 + f) + lane / 4,
  // packed (v, p, i, re/im): row h_row's re or im part.
  int h_row[NH], h_vp[NH], h_im[NH];
  bool h_live[NH];
#pragma unroll
  for (int f = 0; f < NH; ++f) {
    const int c = 8 * (un.hb0 + f) + g, t = c >> 1;
    h_row[f] = t % I;
    h_im[f] = c & 1;
    h_vp[f] = t / I;
    h_live[f] = f < un.nh && h_vp[f] < NV * NP;
  }

  // Shared memory: UNI's step tables (this lane's E(4 j + r), j < TILE /
  // 4, of its row and column modes, in its own slots), then each warp's
  // two stage buffers of a tile's times, trapezoid weights (any grid)
  // and data rows, filled by cp.async one tile ahead.
  double2* steps = step_slots() + warp * 2 * (TILE / 4) * 32;
  if (UNI) {
#pragma unroll
    for (int j = 0; j < TILE / 4; ++j) {
      const double b = (4 * j + r) * dlt;
      steps[j * 32 + lane] = phase(wr, b);
      if (two) steps[(TILE / 4 + j) * 32 + lane] = phase(wc, b);
    }
  }
  const int stage = TILE * (NV + 2 * I);            // doubles a buffer
  double* stages = reinterpret_cast<double*>(
      step_slots() + (UNI ? WARPS * 2 * (TILE / 4) * 32 : 0)) +
      warp * 2 * stage;
  // Tile tt's samples into buffer b: lane l takes sample l (clamped to
  // the grid; a sample past the window is never read).
  auto fetch = [&](int tt, int b) {
    const int k = min(k0 + tt * TILE + lane, K - 1);
    double* buf = stages + b * stage;
    copy_async(buf + lane, p.times + k, 8);
    if (!UNI) copy_async(buf + TILE + lane, p.tau + n * K + k, 8);
    for (int i = 0; i < I; ++i)
      copy_async(buf + NV * TILE + 2 * (i * TILE + lane),
                 p.rows + static_cast<long long>(i) * K + k, 16);
    copy_commit();
  };

  double acc[NF + NH][4];
#pragma unroll
  for (int f = 0; f < NF + NH; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0;
  QNM_LAP(0);

  // This warp's k-steps (SPAN samples each, STEPS a tile): those of its
  // share of the tiles that hold a sample.  A lane takes samples 4 u + r
  // of each, u < KS.
  const int tiles = cdiv(cnt, TILE);
  const int t_lo = tiles * seg / split, t_hi = tiles * (seg + 1) / split;
  const int g_lo = t_lo * STEPS, g_hi = min(t_hi * STEPS, cdiv(cnt, SPAN));
  double2 own_r = make_double2(0.0, 0.0), own_c = own_r;
  double2 anc_r = own_r, anc_c = own_c;
  if (g_lo < g_hi) fetch(t_lo, 0);
  const double* buf = stages;
  for (int gs = g_lo; gs < g_hi; ++gs) {
    const int st = gs % STEPS, tt = gs / STEPS;
    if (st == 0) {
      // The next tile's copies start (into the buffer the last tile
      // read: every lane is past it) and this tile's are awaited.
      const int rel = tt - t_lo;
      __syncwarp();
      if (tt + 1 < t_hi) fetch(tt + 1, (rel + 1) & 1);
      else copy_commit();
      copy_wait_older();
      __syncwarp();
      buf = stages + (rel & 1) * stage;
      if (UNI) {
        // The anchors of this warp's tiles tt .. tt + 3, lane r making
        // tile tt + r's.
        if ((rel & 3) == 0) {
          const int ta = min(tt + r, t_hi - 1);
          const double sa = p.times[k0 + ta * TILE] - t0;
          own_r = phase(wr, sa);
          if (two) own_c = phase(wc, sa);
        }
        const int src = (lane & ~3) | (rel & 3);
        anc_r = shfl2(own_r, src);
        anc_c = two ? shfl2(own_c, src) : anc_r;
      }
      QNM_LAP(1);
    }
    // This lane's samples: their times, weights and data, and phases.
    double s[KS], tk[KS], hv[NH][KS], a[2 * KS];
    double2 pc[KS];
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const int b = SPAN * st + 4 * u + r;         // the sample in the tile
      const bool valid = SPAN * gs + 4 * u + r < cnt;
      s[u] = buf[b] - t0;
      tk[u] = UNI ? 0.0 : buf[TILE + b];
#pragma unroll
      for (int f = 0; f < NH; ++f)
        hv[f][u] = valid && h_live[f]
                       ? buf[NV * TILE + 2 * (h_row[f] * TILE + b) + h_im[f]]
                       : 0.0;
      double2 pr;
      if (UNI) {
        const int j = st * KS + u;
        pr = cmul(anc_r, steps[j * 32 + lane]);
        pc[u] = two ? cmul(anc_c, steps[(TILE / 4 + j) * 32 + lane]) : pr;
      } else {
        pr = phase(wr, s[u]);
        pc[u] = two ? phase(wc, s[u]) : pr;
      }
      if (!(valid && live_r)) pr = make_double2(0.0, 0.0);
      if (!(valid && live_c)) pc[u] = make_double2(0.0, 0.0);
      a[2 * u] = pr.x;
      a[2 * u + 1] = pr.y;
    }
    QNM_LAP(2);
    if (cols) {
#pragma unroll
      for (int vp = 0; vp < NV * NP; ++vp) {
        double bre[KS], bim[KS];
#pragma unroll
        for (int u = 0; u < KS; ++u) {
          const double wt = (vp < NP ? 1.0 : tk[u]) * power(s[u], vp % NP);
          bre[u] = wt * pc[u].x;
          bim[u] = wt * pc[u].y;
        }
        mma_16x8<KS>(acc[2 * vp], a, bre);
        mma_16x8<KS>(acc[2 * vp + 1], a, bim);
      }
    }
#pragma unroll
    for (int f = 0; f < NH; ++f) {
      if (f < un.nh) {
        const int vp = h_vp[f];
        double b[KS];
#pragma unroll
        for (int u = 0; u < KS; ++u)
          b[u] = (vp < NP ? 1.0 : tk[u]) * power(s[u], vp % NP) * hv[f][u];
        mma_16x8<KS>(acc[NF + f], a, b);
      }
    }
    QNM_LAP(3);
  }

  // A split unit's warps add their sums into warp 0's, in warp order,
  // through the step tables' shared memory ([warp - 1][accumulator][lane]).
  if (split > 1) {
    __syncthreads();
    double* red = reinterpret_cast<double*>(step_slots());
    if (warp > 0) {
#pragma unroll
      for (int f = 0; f < NF + NH; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp - 1) * NA + 4 * f + e) * 32 + lane] = acc[f][e];
    }
    __syncthreads();
    if (warp > 0) return;
    for (int w = 1; w < split; ++w)
#pragma unroll
      for (int f = 0; f < NF + NH; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[f][e] += red[((w - 1) * NA + 4 * f + e) * 32 + lane];
  }

  // The epilogue.  A's rows are (re, im) of phi_j = (re, -im) of a_j, so
  // with top / bottom the accumulator's rows j / 8 + j: re(sum a b) = top
  // re + bottom im and im(sum a b) = top im - bottom re.
  const int a = k0, z = k0 + (cnt > 0 ? cnt - 1 : 0);  // the end samples
  const bool edges = UNI && cnt >= 2;
  const double sa = p.times[a] - t0, sz = p.times[z] - t0;
  double2 ra = make_double2(0.0, 0.0), rz = ra;
  if (edges && live_r) {
    ra = phase(wr, sa);
    rz = phase(wr, sz);
  }
  const long long plane_S = static_cast<long long>(J) * J;
  const long long plane_P = static_cast<long long>(I) * J;
  if (cols) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = 8 * un.q2 + 2 * r + e;
      if (!(live_r && l < J && (two || jr <= l))) continue;
      double2 ca = make_double2(0.0, 0.0), cz = ca;
      if (edges) {
        ca = phase(om[l], sa);
        cz = phase(om[l], sz);
      }
      const double2 ea = cjmul(ra, ca), ez = cjmul(rz, cz);
#pragma unroll
      for (int vp = 0; vp < NV * NP; ++vp) {
        const double2 x = make_double2(acc[2 * vp][e] + acc[2 * vp + 1][2 + e],
                                       acc[2 * vp + 1][e] - acc[2 * vp][2 + e]);
        const int v = UNI ? 0 : vp / NP, pw = vp % NP;
        store_gram(p.S + ((m * 2 + v) * NP + pw) * plane_S, J, jr, l, x);
        if (UNI) {
          double2 y = make_double2(0.0, 0.0);
          if (edges) {
            const double pa = 0.5 * dlt * power(sa, pw),
                         pz = 0.5 * dlt * power(sz, pw);
            y = make_double2(dlt * x.x - (pa * ea.x + pz * ez.x),
                             dlt * x.y - (pa * ea.y + pz * ez.y));
          }
          store_gram(p.S + ((m * 2 + 1) * NP + pw) * plane_S, J, jr, l, y);
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < NH; ++f) {
    const int t = 4 * (un.hb0 + f) + r;     // this lane's (v, p, i)
    const int i = t % I, vp = t / I;
    if (!(f < un.nh && vp < NV * NP && live_r)) continue;
    const double2 x = make_double2(acc[NF + f][0] + acc[NF + f][3],
                                   acc[NF + f][1] - acc[NF + f][2]);
    const int pw = vp % NP;
    const int v = UNI ? 0 : vp / NP;
    p.P[((m * 2 + v) * NP + pw) * plane_P + static_cast<long long>(i) * J +
        jr] = x;
    if (UNI) {
      double2 y = make_double2(0.0, 0.0);
      if (edges) {
        const double2* hrow = p.rows + static_cast<long long>(i) * K;
        const double2 ea = cjmul(ra, hrow[a]), ez = cjmul(rz, hrow[z]);
        const double pa = 0.5 * dlt * power(sa, pw), pz = 0.5 * dlt *
            power(sz, pw);
        y = make_double2(dlt * x.x - (pa * ea.x + pz * ez.x),
                         dlt * x.y - (pa * ea.y + pz * ez.y));
      }
      p.P[((m * 2 + 1) * NP + pw) * plane_P + static_cast<long long>(i) * J +
          jr] = y;
    }
  }
  QNM_LAP(4);
  QNM_STORE();
}

// Units a trajectory, warps a unit (split) and dynamic shared bytes a
// block of a launch of M trajectories of the variant.
inline int units_of(int I, int J, int order, int uniform) {
  const int nv = uniform ? 1 : 2;
  return unit_count(J, h_frags(I, order, nv), nv + 1);
}

inline int split_of(long long M, int units) {
  return M * units < SPLIT_BELOW ? WARPS : 1;
}

// A block's dynamic shared bytes: UNI's step tables and the warps' two
// stage buffers (times, trapezoid weights on any grid, I data rows of a
// tile), or a split unit's sums, whichever is larger.
inline long long shared_bytes(int I, int order, int uniform, int split) {
  const long long nv = uniform ? 1 : 2;
  const long long tables = uniform ? WARPS * 2 * (TILE / 4) * 32 * 16 : 0;
  const long long stages = WARPS * 2LL * TILE * (nv + 2LL * I) * 8;
  const long long red = split > 1 ? (WARPS - 1) * 32LL * 4 *
                                        (2 * nv * (order + 1) + nv + 1) * 8
                                  : 0;
  return tables + stages > red ? tables + stages : red;
}

#ifdef __CUDACC__
template <int ORDER, int NV>
int launch(const Moments& p, cudaStream_t stream) {
  const int units = units_of(p.I, p.J, ORDER, NV == 1);
  const int split = split_of(p.M, units);
  const long long warps = p.M * units;
  const unsigned blocks = static_cast<unsigned>(
      split > 1 ? warps : (warps + WARPS - 1) / WARPS);
  const long long smem = shared_bytes(p.I, ORDER, NV == 1, split);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_moments_kernel<ORDER, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_moments_kernel<ORDER, NV>
      <<<blocks, THREADS, static_cast<size_t>(smem), stream>>>(p, units,
                                                               split);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

// The plan of a launch (moments_cuda.plan reads it): out = (units a
// trajectory, warps a block, samples a tile, dynamic shared bytes a
// block, data fragments, data fragments a unit, warps a unit, the most
// dynamic shared bytes a block can have: a launch past it is refused) for
// M trajectories, I data rows, J modes, the order and the variant
// (uniform 1: the uniform grid's; 0: any grid's).
extern "C" void qnm_window_moments_plan(long long M, int I, int J, int order,
                                        int uniform, long long* out) {
  const int nv = uniform ? 1 : 2;
  out[0] = units_of(I, J, order, uniform);
  out[1] = WARPS;
  out[2] = TILE;
  out[6] = split_of(M, static_cast<int>(out[0]));
  out[3] = shared_bytes(I, order, uniform, static_cast<int>(out[6]));
  out[4] = h_frags(I, order, nv);
  out[5] = nv + 1;
  out[7] = SMEM_MAX;
}

#ifdef __CUDACC__
// The moments of M trajectories, orders 0..order (0, 1 or 2), in one
// launch on ``stream`` of the uniform grid's variant (uniform = 1, on a
// grid of fitted step dlt; tau is not read and may be null) or any
// grid's (0, tau the windows' trapezoid weights; dlt is not read).  Returns the launch's CUDA error (0: launched).
extern "C" int qnm_window_moments(const void* times, const void* rows,
                                  const void* omega, const void* t0s,
                                  const void* tau, const void* first,
                                  const void* count, const void* win,
                                  void* S, void* P, int K, int I, int J,
                                  long long M, int order, int uniform,
                                  double dlt, void* stream) {
  const Moments p{static_cast<const double*>(times),
                  static_cast<const double2*>(rows),
                  static_cast<const double2*>(omega),
                  static_cast<const double*>(t0s),
                  static_cast<const double*>(tau),
                  static_cast<const int*>(first),
                  static_cast<const int*>(count),
                  static_cast<const long long*>(win),
                  static_cast<double2*>(S), static_cast<double2*>(P),
                  M, K, I, J, dlt};
  auto st = static_cast<cudaStream_t>(stream);
  switch (order * 2 + (uniform ? 0 : 1)) {
    case 0: return launch<0, 1>(p, st);
    case 1: return launch<0, 2>(p, st);
    case 2: return launch<1, 1>(p, st);
    case 3: return launch<1, 2>(p, st);
    case 4: return launch<2, 1>(p, st);
    case 5: return launch<2, 2>(p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef QNM_MOMENTS_PHASES
// The phase counters (QNM_MOMENTS_PHASES): reset to 0, or copied into
// out[6].
extern "C" int qnm_moments_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[6] = {0};
    return static_cast<int>(
        cudaMemcpyToSymbol(qnm_moments_cycles, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, qnm_moments_cycles, 6 * sizeof(unsigned long long)));
}
#endif
#endif  // __CUDACC__
