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
// referenced to tref = the chunk's first start time; a block takes WPB
// windows of one chunk and one mode set s.  Its threads are (window,
// column) pairs: a column is one (i, j) of the I x J projections, taken
// j-major NQ / I whole modes a pass, or, past NQ rows, NQ rows of one
// mode a pass with its mixing added up over the mode's passes.  The block walks the samples its windows
// cover in tiles of TK: each tile's conj(phi0_j(t_k)) d_i(t_k) is made
// once in shared memory (exp and sincos in FP64) and every window adds the
// rows inside it.  The edge samples of the trapezoid are recomputed, the
// mixing mu^H . contracts the pass's columns in shared memory, and last
// each (window, j, l) Gram entry is evaluated in registers by the expm1
// bit ladder.  No (windows, K) matrix and no basis-times-data matrix
// reaches device memory.
//
// What bounds it on an H100: the window sums, 2 FP64 operations a
// (set, window, sample, i, j) here (8 where the products are formed per
// window, as the plain version's matmul does), read from shared memory;
// at the main path's shapes (J = 8, I = 2, m ~ 1000 samples a window)
// they outweigh the outputs' (2 J^2 + 2 J) x 16 bytes a system.  The
// basis is recomputed by each block over its span (~NQ transcendentals a
// sample and pass), which shares nothing across blocks of one chunk:
// later work.
//
// mismatch_rephase_kernel: one warp a (set, window) system after the
// solve: num = Re sum conj(C0) rt, model = Re C0^H G2 C0 (the J x J entries
// read in order by the lanes), mm = 1 - num / sqrt(model dnorm), and
// C = C0 exp(-i w (t0 - tref)).  It reads G2 once: bound by bytes.
//
// Both are built with nvcc into a library with a plain C interface, bound
// with ctypes; each C entry returns cudaGetLastError() of its launch.
// Without __CUDACC__ the file gives the kernels alone, for a host build
// that supplies the CUDA names and launches them itself (the CPU test of
// their arithmetic, tests/test_torch_factored_kernel.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace {

constexpr int NQ = 16;            // columns (i, j) a pass
constexpr int WPB = 16;           // windows a block
constexpr int TK = 16;            // samples a tile
constexpr int THREADS = NQ * WPB;
constexpr int EPI_WARPS = 4;      // systems a block of the epilogue

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
  long long B;
  int K, I, J, chunk, nbits;
};

// Samples strictly before x on the ascending grid: the plain version's
// sum(times < x).
__device__ int count_below(const double* times, int K, double x) {
  int lo = 0, hi = K;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (times[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// conj(phi0_j(t_k)) d_i(t_k), phi0 = exp(-i w (t - tref)) with t - tref
// clamped at 0 (rows before tref lie outside every window of the chunk).
__device__ double2 projected(const Sweep& p, int s, int i, int j, int k,
                             double tref) {
  const double2 w = p.omegas[(long long)s * p.J + j];
  const double dt0 = fmax(p.times[k] - tref, 0.0);
  const double E = exp(w.y * dt0);
  double sn, cs;
  sincos(w.x * dt0, &sn, &cs);
  const double pr = E * cs, pi = E * sn;          // conj(phi0)
  const double2 d = p.data[(long long)i * p.K + k];
  return make_double2(pr * d.x - pi * d.y, pr * d.y + pi * d.x);
}

__device__ double sq_norm(const Sweep& p, int k) {
  double acc = 0.0;
  for (int i = 0; i < p.I; ++i) {
    const double2 d = p.data[(long long)i * p.K + k];
    acc += d.x * d.x + d.y * d.y;
  }
  return acc;
}

// The closed-form sums of m samples of exp(nu t) from offset s (uniform
// step dlt): Gt and the trapezoid Gtau, as engine_real._geom_series_eval.
__device__ void geom_series(double dlt, int nbits, double nu_re,
                            double nu_im, double s, int m, double2* Gt,
                            double2* Gtau) {
  const double ex = exp(nu_re * dlt);
  const double sh = sin(nu_im * dlt * 0.5);
  const double den_re = expm1(nu_re * dlt) - 2.0 * ex * (sh * sh);
  const double den_im = ex * sin(nu_im * dlt);
  // The leading factor by a direct exp: it needs relative precision at
  // tiny magnitudes.
  const double e0 = exp(nu_re * s);
  double sn, cs;
  sincos(nu_im * s, &sn, &cs);
  const double F_re = e0 * cs, F_im = e0 * sn;
  // u(z^m) = z^m - 1 by the bits of m; a level above m's top bit may
  // overflow for growing modes and is never added (no 0 * inf).
  double usq_re = den_re, usq_im = den_im, um_re = 0.0, um_im = 0.0;
  for (int i = 0; i < nbits; ++i) {
    if ((m >> i) & 1) {
      const double cm_re = um_re * usq_re - um_im * usq_im + usq_re;
      const double cm_im = um_re * usq_im + um_im * usq_re + usq_im;
      um_re += cm_re;
      um_im += cm_im;
    }
    if (i < nbits - 1) {
      const double r = usq_re * usq_re - usq_im * usq_im + 2.0 * usq_re;
      usq_im = 2.0 * usq_re * usq_im + 2.0 * usq_im;
      usq_re = r;
    }
  }
  // S_m = u(z^m) / u(z); nu = 0 has the exact limit S_m = m.
  double S_re, S_im;
  if (den_re * den_re + den_im * den_im > 0.0) {
    const double d2 = den_re * den_re + den_im * den_im;
    S_re = (um_re * den_re + um_im * den_im) / d2;
    S_im = (um_im * den_re - um_re * den_im) / d2;
  } else {
    S_re = (double)m;
    S_im = 0.0;
  }
  const double gt_re = F_re * S_re - F_im * S_im;
  const double gt_im = F_re * S_im + F_im * S_re;
  // The last term F z^(m-1) = F (u(z^m) + 1) / z.
  const double zm_re = um_re + 1.0, zm_im = um_im;
  const double z_re = den_re + 1.0, z_im = den_im;
  const double z2 = z_re * z_re + z_im * z_im;
  const double zb_re = (zm_re * z_re + zm_im * z_im) / z2;
  const double zb_im = (zm_im * z_re - zm_re * z_im) / z2;
  const double tb_re = F_re * zb_re - F_im * zb_im;
  const double tb_im = F_re * zb_im + F_im * zb_re;
  const double nonempty = m > 0 ? 1.0 : 0.0;
  *Gt = make_double2(gt_re, gt_im);
  *Gtau = make_double2(dlt * (gt_re - 0.5 * (F_re + tb_re)) * nonempty,
                       dlt * (gt_im - 0.5 * (F_im + tb_im)) * nonempty);
}

__global__ void __launch_bounds__(THREADS)
factored_systems_kernel(Sweep p) {
  __shared__ double2 tile[TK][NQ];
  __shared__ double tile_sq[TK];
  __shared__ double2 sm_pd[WPB][NQ];
  __shared__ double2 sm_pdt[WPB][NQ];
  __shared__ int win_a[WPB], win_m[WPB];
  __shared__ int span[2];

  const int s = blockIdx.y;
  // The fitted uniform step, as engine_real._fitted_step.
  const double dlt = (p.times[p.K - 1] - p.times[0]) / (p.K - 1);
  const int per_chunk = (p.chunk + WPB - 1) / WPB;
  const long long c_lo = (long long)(blockIdx.x / per_chunk) * p.chunk;
  const long long c_hi = min(c_lo + p.chunk, p.B);
  const long long w_lo = c_lo + (long long)(blockIdx.x % per_chunk) * WPB;
  if (w_lo >= c_hi) return;                 // the whole block
  const int nw = (int)min((long long)WPB, c_hi - w_lo);
  const double tref = p.t0s[c_lo];
  const int tid = threadIdx.x;
  const int w = tid / NQ, q = tid % NQ;

  if (tid < nw) {
    const double t0 = p.t0s[w_lo + tid];
    const int a = count_below(p.times, p.K, t0);
    const int e = count_below(p.times, p.K, t0 + p.Ts[w_lo + tid]);
    win_a[tid] = a;
    win_m[tid] = max(e - a, 0);
  }
  __syncthreads();
  if (tid == 0) {
    int lo = p.K, hi = 0;
    for (int v = 0; v < nw; ++v) {
      if (win_m[v] > 0) {
        lo = min(lo, win_a[v]);
        hi = max(hi, win_a[v] + win_m[v]);
      }
    }
    span[0] = lo;
    span[1] = hi;
  }
  __syncthreads();
  const int k_lo = span[0], k_hi = span[1];
  const bool mine = w < nw;
  const int a = mine ? win_a[w] : 0, m = mine ? win_m[w] : 0;
  const int ka = min(max(a, 0), p.K - 1);
  const int ke = min(max(a + m - 1, 0), p.K - 1);
  const double nonempty = m > 0 ? 1.0 : 0.0;
  const long long b = w_lo + w;

  // A pass takes RP rows of each of JP modes: whole modes (RP = I, JP =
  // NQ / I) while I <= NQ, else NQ rows of one mode, whose mixing then
  // adds up over the mode's ceil(I / NQ) passes in rhs and rt themselves
  // (each written by one thread; in registers the sums would live across
  // the tiles' sincos and spill).
  const int RP = min(p.I, NQ);              // rows a pass
  const int JP = NQ / RP;                   // modes a pass
  const int NC = JP * RP;                   // columns a pass
  for (int j0 = 0; j0 < p.J; j0 += JP) {
    const int j = j0 + q;                   // the mode mixed by q < JP
    for (int i0 = 0; i0 < p.I; i0 += RP) {
      const int jq = j0 + q / RP, iq = i0 + q % RP;   // this thread's column
      const bool live = q < NC && jq < p.J && iq < p.I;
      const bool first = j0 == 0 && i0 == 0;
      double2 acc = make_double2(0.0, 0.0);
      double acc_sq = 0.0;
      for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
        __syncthreads();                    // the last tile is read
        for (int e = tid; e < TK * NQ; e += THREADS) {
          const int kk = e / NQ, qq = e % NQ;
          const int jc = j0 + qq / RP, ic = i0 + qq % RP;
          const int k = k0 + kk;
          tile[kk][qq] = (k < k_hi && qq < NC && jc < p.J && ic < p.I)
              ? projected(p, s, ic, jc, k, tref)
              : make_double2(0.0, 0.0);
        }
        if (first && tid < TK && k0 + tid < k_hi)
          tile_sq[tid] = sq_norm(p, k0 + tid);
        __syncthreads();
        if (m > 0) {
          const int kl = max(a, k0), kh = min(a + m, k0 + TK);
          for (int k = kl; k < kh; ++k) {
            const double2 r = tile[k - k0][q];
            acc.x += r.x;
            acc.y += r.y;
            if (first && q == 0) acc_sq += tile_sq[k - k0];
          }
        }
      }
      // The trapezoid: dlt times the window sum less half of the two edge
      // samples, zero for an empty window.
      if (mine && live) {
        const double2 ra = projected(p, s, iq, jq, ka, tref);
        const double2 re = projected(p, s, iq, jq, ke, tref);
        sm_pd[w][q] = acc;
        sm_pdt[w][q] = make_double2(
            (dlt * acc.x - 0.5 * dlt * (ra.x + re.x)) * nonempty,
            (dlt * acc.y - 0.5 * dlt * (ra.y + re.y)) * nonempty);
      }
      if (mine && first && q == 0 && s == 0) {
        p.dnorm[b] = (dlt * acc_sq
                      - 0.5 * dlt * (sq_norm(p, ka) + sq_norm(p, ke)))
                     * nonempty;
      }
      __syncthreads();
      // rhs = mu^H pd, rt = mu^H pdt: this pass's rows of mode j added to
      // the passes' before; zero rhs on a dead column.
      if (mine && q < JP && j < p.J) {
        const long long o = ((long long)s * p.B + b) * p.J + j;
        double2 r1 = i0 > 0 ? p.rhs[o] : make_double2(0.0, 0.0);
        double2 r2 = i0 > 0 ? p.rt[o] : make_double2(0.0, 0.0);
        const int i1 = min(i0 + RP, p.I);
        for (int i = i0; i < i1; ++i) {
          const double2 mu = p.mus[((long long)s * p.I + i) * p.J + j];
          const double2 v1 = sm_pd[w][q * RP + i - i0];
          const double2 v2 = sm_pdt[w][q * RP + i - i0];
          r1.x += mu.x * v1.x + mu.y * v1.y;
          r1.y += mu.x * v1.y - mu.y * v1.x;
          r2.x += mu.x * v2.x + mu.y * v2.y;
          r2.y += mu.x * v2.y - mu.y * v2.x;
        }
        p.rhs[o] = p.keep[(long long)s * p.J + j] ? r1
                                                  : make_double2(0.0, 0.0);
        p.rt[o] = r2;
      }
      __syncthreads();                      // sm_pd is rewritten next pass
    }
  }

  // The Grams: each (window, j, l) in registers, mixed by M = mu^H mu;
  // identity rows and columns for dead columns in G.
  const int JJ = p.J * p.J;
  for (int e = tid; e < nw * JJ; e += THREADS) {
    const int v = e / JJ, jl = e % JJ, j = jl / p.J, l = jl % p.J;
    const int av = win_a[v], mv = win_m[v];
    const double sv = fmax(p.times[min(max(av, 0), p.K - 1)] - tref, 0.0);
    const double2 wj = p.omegas[(long long)s * p.J + j];
    const double2 wl = p.omegas[(long long)s * p.J + l];
    double2 gt, gtau;
    geom_series(dlt, p.nbits, wj.y + wl.y, wj.x - wl.x, sv, mv, &gt,
                &gtau);
    double2 M = make_double2(0.0, 0.0);
    for (int i = 0; i < p.I; ++i) {
      const double2 uj = p.mus[((long long)s * p.I + i) * p.J + j];
      const double2 ul = p.mus[((long long)s * p.I + i) * p.J + l];
      M.x += uj.x * ul.x + uj.y * ul.y;
      M.y += uj.x * ul.y - uj.y * ul.x;
    }
    const long long o = (((long long)s * p.B + w_lo + v) * p.J + j) * p.J + l;
    const bool kk = p.keep[(long long)s * p.J + j] && p.keep[(long long)s * p.J + l];
    p.G[o] = kk ? make_double2(M.x * gt.x - M.y * gt.y, M.x * gt.y + M.y * gt.x)
                : make_double2(j == l ? 1.0 : 0.0, 0.0);
    p.G2[o] = make_double2(M.x * gtau.x - M.y * gtau.y,
                           M.x * gtau.y + M.y * gtau.x);
  }
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

// Systems of B windows (chunks of `chunk`, each referenced to its first
// start time) for S mode sets: G, G2 (S, B, J, J), rhs, rt (S, B, J)
// complex128 and dnorm (B,) float64.  nbits = ceil(log2(K + 1)).
int qnm_factored_systems(const void* times, const void* data,
                         const void* omegas, const void* mus,
                         const void* keep, const void* t0s, const void* Ts,
                         void* G, void* G2, void* rhs, void* rt, void* dnorm,
                         long long B, int K, int I, int J, int S,
                         int chunk, int nbits, void* stream) {
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
  p.B = B;
  p.K = K;
  p.I = I;
  p.J = J;
  p.chunk = chunk;
  p.nbits = nbits;
  const long long nchunk = (B + chunk - 1) / chunk;
  const long long per_chunk = (chunk + WPB - 1) / WPB;
  dim3 grid((unsigned)(nchunk * per_chunk), (unsigned)S);
  factored_systems_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(p);
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
