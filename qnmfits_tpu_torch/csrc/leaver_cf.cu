// Batched Leaver continued fraction for Kerr QNMs, in FP64 for Hopper
// (sm_90a), a team of threads on each element.
//
// Replaces the native CPU kernel of the JAX package's on-demand spectrum
// solver, qnmfits_tpu/spectrum/csrc/cf_kernel.cpp::radial_cf_batch (bound
// by qnmfits_tpu/spectrum/cf_native.py), which evaluates
// qnmfits_tpu/spectrum/solver.py::_cf_vec_a in 80-bit long double.  CUDA
// has no long double: this kernel runs in FP64, the precision of the JAX
// package's NumPy path.  Its plain version is
// qnmfits_tpu_torch/ops/cf_cuda.py::cf_parts.
//
// Per element i of a batch of B, with its own omega (Leaver units), spin
// a, separation constant A and inversion count n_inv, and shared s, m and
// depth N:
//   * Leaver's coefficients c0..c4 (2M = 1 units) and the three-term
//     recurrence alpha_k, beta_k, gamma_k, quadratics in k;
//   * the upward part U_k = beta_k - alpha_{k-1} gamma_k / U_{k-1} over
//     k <= n_inv;
//   * the Nollert tail T_N = -alpha_N (1 + u / sqrt(N) + v / N),
//     u = -sqrt(-2 i b omega) on the branch Re u <= 0,
//     v = (u^2 + 1/2 + G1 - A1) / 2;
//   * the backward recursion T_k = alpha_k gamma_{k+1} / (beta_{k+1} -
//     T_{k+1}) down to k = n_inv;
// and writes f = U - T and scale = |U| + |T| (near a root U - T cancels,
// so callers compare residuals relative to the scale).
//
// Design: the backward recursion as a segmented Mobius product.
//   * With T_{k+1} = p / q the step is [p; q]_k = M_k [p; q]_{k+1},
//     M_k = [[0, C_k], [-1, beta_{k+1}]], C_k = alpha_k gamma_{k+1}, so
//     T_{n_inv} is the ratio of (M_{n_inv} ... M_{N-1}) [T_N; 1]: no
//     division but the last.
//   * In that basis the product cannot be formed in FP64: at large k each
//     M_k is close to a multiple of a Jordan block (its eigenvalues,
//     ~-k^2 (1 +- u / sqrt(k)), nearly coincide), a product of L of them
//     carries entries ~L times its eigenvalues', and forming it cancels
//     them: the ratio loses ~N eps (tests/test_torch_cf_host.py's deep
//     tiers, N = 16384..442368, fail on it).  So the product is formed
//     in the basis V_k = [[tau_k, 1], [1, 0]] of the nearly double fixed
//     point tau_k = (t1 - k) k + t0 (t1 = c1 / 2,
//     t0 = (t1 + c3 + 1) / 2, so that beta_{k+1} - tau_{k+1} = tau_k):
//       Mh_k = V_k^-1 M_k V_{k+1} = [[tau_k, -1], [R_k, tau_k]],
//     R_k = C_k - tau_k^2 a cubic in k (the k^4 terms cancel in its
//     coefficients, formed once an element).  The Mh_k telescope, nearly
//     commute, and their products keep the split in their off-diagonal
//     entries: scripts/torch_cf_teams.py --host reads <= 2.8e-14 of
//     |U| + |T| against the 80-bit CF at N = 300..442368.  With
//     [y1; y2] = (Mh_{n_inv} ... Mh_{N-1}) [1; T_N - tau_N], T_{n_inv} =
//     tau_{n_inv} + y2 / y1.
//   * A team of 1..256 threads (a power of two the wrapper picks from B
//     and N) takes one element; a block of max(team, 128) threads holds
//     one or more teams, so teams below a warp share its instructions.
//     The team's first warp forms the coefficients once and leaves them
//     in shared memory.  Thread j takes the steps k in [j L, (j + 1) L)
//     of [0, N), L = ceil(N / team), skipping k < n_inv (the identity),
//     and forms its segment's product S <- S Mh_k left to right: [a b; c
//     d] Mh_k = [a tau + b R, b tau - a; c tau + d R, d tau - c], with
//     tau_k and R_k computed from k itself (nothing is read from memory in
//     the loop).  Every kRescale steps the product is scaled by the power
//     of two that brings its largest part into [1, 2): exact, and the
//     ratio it is applied for does not change.
//   * The segments combine in order (the product does not commute) by a
//     pairwise tree: at offsets 1, 2, 4, ... thread j takes j + off's
//     product on its right, through warp shuffles within a warp and then,
//     for a team of several warps, through shared memory and the same
//     tree in its first warp.  The team's thread 0 applies the product,
//     divides once, and forms U serially (at most n_inv + 1 steps) as the
//     ratio of two terms of the forward recurrence, again division-free.
//   * The same scripts/torch_cf_teams.py times every team on the card and
//     reads each one's error against the plain version (PERF.md, section
//     6).

// Layout: split real and imaginary float64 arrays, as cf_kernel.cpp takes
// them; n_inv int32.  Newton's two evaluations (at omega and omega + h)
// arrive as one batch of 2B.
//
// Bound on this card: operations.  An element reads 44 bytes and writes
// 24; the serial recursion does 40 FP64 operations a step, and this
// kernel 35 (tau_k 3, R_k 6, the two rows 24, the index 1, the rescale's
// products 1: its exponent is found by integer work), plus the team's
// combine (a 2 x 2 complex product and a rescale a tree level).  The work
// spreads over B x team threads: the solver's batches (2 in the sequential
// continuation, <= ~800 on a spin grid) take teams of 64..256 an element,
// S1's 4096 teams of 8.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QNM_HD __host__ __device__ __forceinline__
#define QNM_UNROLL _Pragma("unroll")
#else
#include <vector>
#define QNM_HD inline
#define QNM_UNROLL
#endif

namespace {

// Steps between two rescales of a running product.  A step multiplies the
// product's largest part by at most ~|R_k| + |tau_k| (< 2^60 |r3| at k <
// 2^20 = kMaxN), so kRescale steps stay far below 2^1023.
constexpr int kRescale = 8;
constexpr int kMaxN = 1 << 20;

struct cplx {
  double re, im;
};

QNM_HD cplx mk(double re, double im) { return cplx{re, im}; }
QNM_HD cplx operator+(cplx x, cplx y) { return mk(x.re + y.re, x.im + y.im); }
QNM_HD cplx operator-(cplx x, cplx y) { return mk(x.re - y.re, x.im - y.im); }
QNM_HD cplx operator-(cplx x) { return mk(-x.re, -x.im); }
QNM_HD cplx operator+(cplx x, double y) { return mk(x.re + y, x.im); }
QNM_HD cplx operator+(double y, cplx x) { return mk(y + x.re, x.im); }
QNM_HD cplx operator-(cplx x, double y) { return mk(x.re - y, x.im); }
QNM_HD cplx operator-(double y, cplx x) { return mk(y - x.re, -x.im); }
QNM_HD cplx operator*(cplx x, double y) { return mk(x.re * y, x.im * y); }
QNM_HD cplx operator*(double y, cplx x) { return mk(y * x.re, y * x.im); }
QNM_HD cplx operator*(cplx x, cplx y) {
  return mk(x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re);
}
// Smith's division, as NumPy and PyTorch divide complex numbers.
QNM_HD cplx operator/(cplx x, cplx y) {
  if (fabs(y.re) >= fabs(y.im)) {
    const double rat = y.im / y.re;
    const double scl = 1.0 / (y.re + y.im * rat);
    return mk((x.re + x.im * rat) * scl, (x.im - x.re * rat) * scl);
  }
  const double rat = y.re / y.im;
  const double scl = 1.0 / (y.im + y.re * rat);
  return mk((x.re * rat + x.im) * scl, (x.im * rat - x.re) * scl);
}
QNM_HD cplx operator/(cplx x, double y) { return mk(x.re / y, x.im / y); }
QNM_HD double cabs_(cplx x) { return hypot(x.re, x.im); }
QNM_HD double maxabs(cplx x) { return fmax(fabs(x.re), fabs(x.im)); }
// Principal square root (branch cut on the negative real axis).
QNM_HD cplx csqrt_(cplx z) {
  if (z.re == 0.0 && z.im == 0.0) return mk(0.0, z.im);
  const double t = sqrt(0.5 * (fabs(z.re) + hypot(z.re, z.im)));
  if (z.re >= 0.0) return mk(t, z.im / (2.0 * t));
  return mk(fabs(z.im) / (2.0 * t), copysign(t, z.im));
}

// x y and x y + z with fused multiply-adds, written out: the source is
// built without contraction (nvcc -fmad=false, g++ -ffp-contract=off), so
// the hot loop below rounds the same on the card and on the host.
QNM_HD cplx fmul(cplx x, cplx y) {
  return mk(fma(x.re, y.re, -(x.im * y.im)), fma(x.re, y.im, x.im * y.re));
}
QNM_HD cplx ffma(cplx x, cplx y, cplx z) {
  return mk(fma(x.re, y.re, fma(-x.im, y.im, z.re)),
            fma(x.re, y.im, fma(x.im, y.re, z.im)));
}
QNM_HD cplx ffma(cplx x, double y, cplx z) {
  return mk(fma(x.re, y, z.re), fma(x.im, y, z.im));
}

// The biased exponent of x (0 for zero and subnormals, 2047 for infinities
// and NaN), read off its bits: integer work, off the FP64 units.
QNM_HD int biased_exp(double x) {
#ifdef __CUDA_ARCH__
  return (__double2hiint(x) >> 20) & 0x7ff;
#else
  uint64_t bits;
  memcpy(&bits, &x, sizeof bits);
  return static_cast<int>(bits >> 52) & 0x7ff;
#endif
}

// 2^(1023 - e), which brings a number of biased exponent e in [1, 2045]
// into [1, 2): its own biased exponent is 2046 - e, a normal number.
QNM_HD double pow2_of_exp(int e) {
#ifdef __CUDA_ARCH__
  return __hiloint2double((2046 - e) << 20, 0);
#else
  const uint64_t bits = static_cast<uint64_t>(2046 - e) << 52;
  double f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

// The power of two that brings mx (> 0, finite) into [1, 2); 1 otherwise.
// A subnormal or the largest binade takes ldexp.
QNM_HD double pow2_scale(double mx) {
  if (!(mx > 0.0 && mx <= DBL_MAX)) return 1.0;
  const int e = biased_exp(mx);
  if (e < 1 || e > 2045) return ldexp(1.0, -ilogb(mx));
  return pow2_of_exp(e);
}

QNM_HD int imax(int x, int y) { return x > y ? x : y; }
QNM_HD int max_exp(cplx x) { return imax(biased_exp(x.re), biased_exp(x.im)); }

// The recurrence's coefficients as quadratics in n (ops/cf_cuda.py's
// leaver_coeffs and _alpha_beta_gamma): alpha_n = n^2 + A1 n + c0, beta_n
// = -2 n^2 + B1 n + c3, gamma_n = n^2 + G1 n + G0; and those of the
// product's basis: tau_n = (t1 - n) n + t0 and R_n = alpha_n gamma_{n+1}
// - tau_n^2 = ((r3 n + r2) n + r1) n + r0.
struct Rec {
  cplx c0, A1, B1, c3, G1, G0;
  cplx t1, t0, r3, r2, r1, r0;
};

QNM_HD double spin_b(double a) { return sqrt(1.0 - 4.0 * a * a); }

// Leaver's c0..c4 term by term, then the polynomials' coefficients.
QNM_HD Rec leaver_rec(int s, int m, double a, cplx w, cplx A) {
  const double b = spin_b(a);
  const cplx I = mk(0.0, 1.0);
  const cplx phi = w / 2.0 - a * m;
  const cplx i2b = mk(0.0, 2.0 / b), i4b = mk(0.0, 4.0 / b);
  const cplx tail = (4.0 * w + mk(0.0, 2.0)) / b * phi;
  const cplx c0 = (1.0 - s) - I * w - i2b * phi;
  const cplx c1 = -4.0 + mk(0.0, 2.0) * w * (2.0 + b) + i4b * phi;
  const cplx c2 = (s + 3.0) - mk(0.0, 3.0) * w - i2b * phi;
  const cplx c3 = (w * w) * (4.0 + 2.0 * b - a * a) - 2.0 * a * m * w - s -
                  1.0 + mk(0.0, 2.0 + b) * w - A + tail;
  const cplx c4 = (s + 1.0) - 2.0 * (w * w) - mk(0.0, 2.0 * s + 3.0) * w -
                  tail;
  Rec r;
  r.c0 = c0;
  r.A1 = c0 + 1.0;
  r.B1 = c1 + 2.0;
  r.c3 = c3;
  r.G1 = c2 - 3.0;
  r.G0 = c4 - c2 + 2.0;
  // gamma_{n+1} = n^2 + g1 n + g0.
  const cplx g1 = r.G1 + 2.0, g0 = r.G1 + r.G0 + 1.0;
  r.t1 = 0.5 * c1;
  r.t0 = 0.5 * (r.t1 + c3 + 1.0);
  r.r3 = g1 + r.A1 + 2.0 * r.t1;
  r.r2 = g0 + r.A1 * g1 + c0 - r.t1 * r.t1 + 2.0 * r.t0;
  r.r1 = r.A1 * g0 + c0 * g1 - 2.0 * (r.t1 * r.t0);
  r.r0 = c0 * g0 - r.t0 * r.t0;
  return r;
}

QNM_HD cplx alpha_at(double n, const Rec& r) {
  return n * n + r.A1 * n + r.c0;
}
QNM_HD cplx beta_at(double n, const Rec& r) {
  return -2.0 * (n * n) + r.B1 * n + r.c3;
}
QNM_HD cplx gamma_at(double n, const Rec& r) {
  return n * n + r.G1 * n + r.G0;
}
QNM_HD cplx tau_at(double n, cplx t1, cplx t0) {
  return ffma(t1 - n, n, t0);
}

// A 2 x 2 complex matrix [[a, b], [c, d]].
struct Mat2 {
  cplx a, b, c, d;
};

QNM_HD Mat2 identity2() {
  return Mat2{mk(1.0, 0.0), mk(0.0, 0.0), mk(0.0, 0.0), mk(1.0, 0.0)};
}
QNM_HD Mat2 operator*(const Mat2& x, const Mat2& y) {
  return Mat2{x.a * y.a + x.b * y.c, x.a * y.b + x.b * y.d,
              x.c * y.a + x.d * y.c, x.c * y.b + x.d * y.d};
}
// Scales S by an exact power of two, its largest part into [1, 2).  The
// largest part's exponent is the largest of the parts' exponents, an
// integer maximum; where that is 0 (zeros, subnormals), 2046 or 2047,
// pow2_scale of the largest part decides, as for any other number.
QNM_HD void rescale(Mat2& S) {
  const int e = imax(imax(max_exp(S.a), max_exp(S.b)),
                     imax(max_exp(S.c), max_exp(S.d)));
  const double f =
      e >= 1 && e <= 2045
          ? pow2_of_exp(e)
          : pow2_scale(fmax(fmax(maxabs(S.a), maxabs(S.b)),
                            fmax(maxabs(S.c), maxabs(S.d))));
  S.a = S.a * f;
  S.b = S.b * f;
  S.c = S.c * f;
  S.d = S.d * f;
}

// The coefficients of the basis's polynomials, in registers for the loop.
struct Basis {
  cplx t1, t0, r3, r2, r1, r0;
};

// S <- S Mh_k at n = k.
QNM_HD void step(Mat2& S, double n, const Basis& p) {
  const cplx tau = tau_at(n, p.t1, p.t0);
  const cplx R = ffma(ffma(ffma(p.r3, n, p.r2), n, p.r1), n, p.r0);
  const cplx a = ffma(S.b, R, fmul(S.a, tau));
  const cplx c = ffma(S.d, R, fmul(S.c, tau));
  S.b = ffma(S.b, tau, -S.a);
  S.d = ffma(S.d, tau, -S.c);
  S.a = a;
  S.c = c;
}

// The product Mh_lo Mh_{lo+1} ... Mh_{hi-1} (the identity when lo >= hi),
// rescaled after every kRescale steps and after the last.
QNM_HD Mat2 segment(int lo, int hi, const Rec& r) {
  const Basis p{r.t1, r.t0, r.r3, r.r2, r.r1, r.r0};
  Mat2 S = identity2();
  double n = static_cast<double>(lo);
  for (int k = lo; k < hi; k += kRescale) {
    if (hi - k >= kRescale) {
      QNM_UNROLL
      for (int j = 0; j < kRescale; ++j) {
        step(S, n, p);
        n += 1.0;
      }
    } else {
      for (int j = k; j < hi; ++j) {
        step(S, n, p);
        n += 1.0;
      }
    }
    rescale(S);
  }
  return S;
}

// The steps [j L, (j + 1) L) of [0, N), L = ceil(N / team), that thread j
// of a team takes, less those below n_inv.
QNM_HD void lane_range(int j, int team, int n_inv, int N, int* lo, int* hi) {
  const int L = (N + team - 1) / team;
  const int start = j * L;
  *lo = start > n_inv ? start : n_inv;
  *hi = start + L < N ? start + L : N;
}

// U = U_{n_inv}, U_0 = beta_0, as p_{n_inv} / p_{n_inv-1} of the forward
// recurrence p_k = beta_k p_{k-1} - alpha_{k-1} gamma_k p_{k-2}, p_{-1} =
// 1, p_0 = beta_0: one division.
QNM_HD cplx upward(int n_inv, const Rec& r) {
  cplx p0 = mk(1.0, 0.0), p1 = beta_at(0.0, r);
  for (int k = 1; k <= n_inv; ++k) {
    const double n = static_cast<double>(k);
    const cplx p2 = beta_at(n, r) * p1 -
                    alpha_at(n - 1.0, r) * gamma_at(n, r) * p0;
    p0 = p1;
    p1 = p2;
    if (k % kRescale == 0) {
      const double f = pow2_scale(fmax(maxabs(p0), maxabs(p1)));
      p0 = p0 * f;
      p1 = p1 * f;
    }
  }
  return p1 / p0;
}

// From the team's product P = Mh_{n_inv} ... Mh_{N-1}: T_{n_inv} =
// tau_{n_inv} + y2 / y1, [y1; y2] = P [1; T_N - tau_N] (T_N itself when
// n_inv >= N, the product then empty), U, and the outputs.
QNM_HD void finish(const Mat2& P, int n_inv, int N, double a, cplx w,
                   const Rec& r, cplx* f, double* scale) {
  cplx u = -csqrt_(mk(0.0, -2.0) * spin_b(a) * w);
  if (u.re > 0.0) u = -u;
  const cplx v = (u * u + 0.5 + r.G1 - r.A1) / 2.0;
  const double dN = static_cast<double>(N);
  const cplx TN = -alpha_at(dN, r) * (1.0 + u / sqrt(dN) + v / dN);
  const cplx xN = TN - tau_at(dN, r.t1, r.t0);
  const double lo = static_cast<double>(n_inv < N ? n_inv : N);
  const cplx T =
      tau_at(lo, r.t1, r.t0) + (P.c + P.d * xN) / (P.a + P.b * xN);
  const cplx U = upward(n_inv, r);
  *f = U - T;
  *scale = cabs_(U) + cabs_(T);
}

}  // namespace

#ifdef __CUDACC__

namespace {

__device__ __forceinline__ cplx shfl_down(cplx x, int off) {
  return mk(__shfl_down_sync(0xffffffffu, x.re, off),
            __shfl_down_sync(0xffffffffu, x.im, off));
}

// The ordered product of each group of `width` lanes' matrices (a power
// of two <= 32; j the lane's index in its group) by the pairwise tree;
// the group's first lane holds it.
__device__ __forceinline__ Mat2 tree_product(Mat2 S, int j, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const Mat2 Q{shfl_down(S.a, off), shfl_down(S.b, off),
                 shfl_down(S.c, off), shfl_down(S.d, off)};
    if ((j & (2 * off - 1)) == 0) {
      S = S * Q;
      rescale(S);
    }
  }
  return S;
}

// A team of `team` threads (a power of two, 1..256) an element; a block
// of kThreads = max(team, 128) threads holds kThreads / team elements, so
// teams below a warp share their warp's setup, tree and finish.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    leaver_cf_kernel(long long B, const double* __restrict__ w_re,
                     const double* __restrict__ w_im,
                     const double* __restrict__ a,
                     const double* __restrict__ A_re,
                     const double* __restrict__ A_im,
                     const int* __restrict__ n_inv_in, int s, int m, int N,
                     int team, double* __restrict__ f_re,
                     double* __restrict__ f_im, double* __restrict__ scale) {
  __shared__ Rec rec_s[kThreads <= 128 ? kThreads : 1];
  __shared__ Mat2 warp_s[kThreads / 32];
  const int t = threadIdx.x, e = t / team, j = t % team;
  const long long i = static_cast<long long>(blockIdx.x) * (kThreads / team) +
                      e;
  const bool live = i < B;
  const int n_inv = live ? n_inv_in[i] : N;
  // The team's first warp (all of a team below a warp) forms the
  // coefficients.
  if (j < 32 && live) {
    const Rec r = leaver_rec(s, m, a[i], mk(w_re[i], w_im[i]),
                             mk(A_re[i], A_im[i]));
    if (j == 0) rec_s[e] = r;
  }
  __syncthreads();
  int lo, hi;
  lane_range(j, team, n_inv, N, &lo, &hi);
  Mat2 S = tree_product(segment(lo, hi, rec_s[e]), j & 31,
                        team < 32 ? team : 32);
  if (team > 32) {
    // The warps' products, in order, to the team's first warp.
    const int lane = t & 31, first = (t - j) >> 5;
    if (lane == 0) warp_s[t >> 5] = S;
    __syncthreads();
    if (j >= 32) return;
    S = tree_product(lane < team / 32 ? warp_s[first + lane] : identity2(),
                     lane, team / 32);
  }
  if (j != 0 || !live) return;
  cplx f;
  double sc;
  finish(S, n_inv, N, a[i], mk(w_re[i], w_im[i]), rec_s[e], &f, &sc);
  f_re[i] = f.re;
  f_im[i] = f.im;
  scale[i] = sc;
}

template <int kThreads>
int launch(long long B, int team, const double* w_re, const double* w_im,
           const double* a, const double* A_re, const double* A_im,
           const int* n_inv, int s, int m, int N, double* f_re, double* f_im,
           double* scale, cudaStream_t stream) {
  const long long per_block = kThreads / team;
  const long long blocks = (B + per_block - 1) / per_block;
  leaver_cf_kernel<kThreads>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          B, w_re, w_im, a, A_re, A_im, n_inv, s, m, N, team, f_re, f_im,
          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Evaluate B elements on `stream` of device `device`, a team of `team`
// threads (a power of two, 1..256) an element.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int qnm_leaver_cf(long long B, const double* w_re,
                             const double* w_im, const double* a,
                             const double* A_re, const double* A_im,
                             const int* n_inv, int s, int m, int N, int team,
                             double* f_re, double* f_im, double* scale,
                             int device, void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxN || B > 0x7fffffffLL || team < 1 || team > 256 ||
      (team & (team - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (team <= 128)
    return launch<128>(B, team, w_re, w_im, a, A_re, A_im, n_inv, s, m, N,
                       f_re, f_im, scale, st);
  return launch<256>(B, team, w_re, w_im, a, A_re, A_im, n_inv, s, m, N,
                     f_re, f_im, scale, st);
}

#else

// Host build of the same arithmetic (g++ -x c++): the same segments for a
// team of `team` threads (any team >= 1), combined by the same pairwise
// tree, serially.  Returns 0, or 1 on arguments the kernel refuses.
extern "C" int qnm_leaver_cf_host(long long B, const double* w_re,
                                  const double* w_im, const double* a,
                                  const double* A_re, const double* A_im,
                                  const int* n_inv, int s, int m, int N,
                                  int team, double* f_re, double* f_im,
                                  double* scale) {
  if (N < 1 || N > kMaxN || team < 1) return 1;
  std::vector<Mat2> P(team);
  for (long long i = 0; i < B; ++i) {
    const cplx w = mk(w_re[i], w_im[i]);
    const Rec r = leaver_rec(s, m, a[i], w, mk(A_re[i], A_im[i]));
    for (int j = 0; j < team; ++j) {
      int lo, hi;
      lane_range(j, team, n_inv[i], N, &lo, &hi);
      P[j] = segment(lo, hi, r);
    }
    for (int off = 1; off < team; off *= 2) {
      for (int j = 0; j + off < team; j += 2 * off) {
        P[j] = P[j] * P[j + off];
        rescale(P[j]);
      }
    }
    cplx f;
    finish(P[0], n_inv[i], N, a[i], w, r, &f, &scale[i]);
    f_re[i] = f.re;
    f_im[i] = f.im;
  }
  return 0;
}

#endif
