// Batched Leaver continued fraction for Kerr QNMs for Hopper (sm_90a), a
// team of threads on each element, in FP64 and in double-double.
//
// Replaces the native CPU kernel of the JAX package's on-demand spectrum
// solver, qnmfits_tpu/spectrum/csrc/cf_kernel.cpp::radial_cf_batch (bound
// by qnmfits_tpu/spectrum/cf_native.py), which evaluates
// qnmfits_tpu/spectrum/solver.py::_cf_vec_a in 80-bit long double.  CUDA
// has no long double.  leaver_cf_kernel runs in FP64, the precision of the
// JAX package's NumPy path (its plain version is
// qnmfits_tpu_torch/ops/cf_cuda.py::cf_parts); leaver_cf_dd_kernel runs the
// same design in double-double (~106 bits; plain version cf_cuda.py::cf_dd)
// for the elements whose spin passes cf_cuda.CHI_EXTENDED (chi = 0.985):
// there an FP64 CF's rounding noise over |f'| exceeds the step the
// solver's Newton accepts, and the 80-bit CF converges the points FP64
// leaves on the coarse track.  The wrapper launches each on its own subset
// of a batch, so FP64 elements run as in an FP64-only batch.
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
//   * The double-double variant spreads an element further, over G
//     blocks (``cf_cuda.plan_dd``): its near-extremal launches hold a few
//     elements at depths up to 884736, which one block an element would
//     run on a few of the card's SMs.  The chain splits into T = G team
//     segments in index order; each block forms its team's segments and
//     reduces them by the pairwise tree, writes the product to a workspace
//     and counts on the element's arrival counter.  The grid's first
//     blocks form each element's terms that do not depend on the product
//     while the segments run (U in one half of such a block, the Nollert
//     tail's start and tau at n_inv in the other, a thread an element),
//     and count on the same counter.  The last of the G + 2 arrivals
//     continues the tree over the G products (the segments j and j + off
//     combine at off = team, 2 team, ...) and finishes: T = tau + (c + d
//     x_N) / (a + b x_N), then the outputs.  So the card rounds as the
//     host twin with a team of T.  A double-double step sums each row's
//     products with one renormalisation; a tree level splits each
//     product's rows over the pair of lanes that hold its factors.

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
// S1's 4096 teams of 8.  The first design's double-double step took 874
// FP64 operations (a fused multiply-add counted as 2: tau_k 66, R_k 168,
// the two rows 640), the bound's count; this one's 610 (tau_k and R_k by
// Horner as before, the rows 376 with one renormalisation a sum), at
// ~2.3x the FP64 kernel's registers.

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


// ---------------------------------------------------------------------------
// The double-double variant, for spins beyond ops/cf_cuda.py's
// CHI_EXTENDED: each real an unevaluated sum hi + lo of two doubles
// (|lo| <= ulp(hi) / 2, about 106 bits), the same segmented product in the
// same basis.  Two-sum is written out; two-prod takes an explicit fused
// multiply-add (__fma_rn on the card, std::fma on the host), which no
// contraction flag touches and which rounds alike on both.  Leaver's
// coefficients, tau_k, R_k and the Nollert tail are formed in
// double-double from the FP64 inputs; f = U - T and |U| + |T| are rounded
// once to FP64 at the end.  Its plain version is
// ops/cf_cuda.py::cf_dd.
// ---------------------------------------------------------------------------

QNM_HD double exact_fma(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

struct dd {
  double hi, lo;
};

QNM_HD dd two_sum(double a, double b) {
  const double s = a + b, bb = s - a;
  return dd{s, (a - (s - bb)) + (b - bb)};
}
// a + b where |a| >= |b| (or a = 0).
QNM_HD dd fast_two_sum(double a, double b) {
  const double s = a + b;
  return dd{s, b - (s - a)};
}
QNM_HD dd two_prod(double a, double b) {
  const double p = a * b;
  return dd{p, exact_fma(a, b, -p)};
}
QNM_HD dd operator+(dd x, dd y) {
  dd s = two_sum(x.hi, y.hi);
  const dd t = two_sum(x.lo, y.lo);
  s = fast_two_sum(s.hi, s.lo + t.hi);
  return fast_two_sum(s.hi, s.lo + t.lo);
}
QNM_HD dd operator+(dd x, double y) {
  const dd s = two_sum(x.hi, y);
  return fast_two_sum(s.hi, s.lo + x.lo);
}
QNM_HD dd operator-(dd x) { return dd{-x.hi, -x.lo}; }
QNM_HD dd operator-(dd x, dd y) { return x + (-y); }
QNM_HD dd operator-(dd x, double y) { return x + (-y); }
QNM_HD dd operator*(dd x, dd y) {
  const dd p = two_prod(x.hi, y.hi);
  return fast_two_sum(p.hi, p.lo + (x.hi * y.lo + x.lo * y.hi));
}
QNM_HD dd operator*(dd x, double y) {
  const dd p = two_prod(x.hi, y);
  return fast_two_sum(p.hi, p.lo + x.lo * y);
}
QNM_HD dd operator/(dd x, dd y) {
  const double q1 = x.hi / y.hi;
  const dd r1 = x - y * q1;
  const double q2 = r1.hi / y.hi;
  const dd r2 = r1 - y * q2;
  return fast_two_sum(q1, q2) + r2.hi / y.hi;
}
// One Newton step from the FP64 root: s + (x - s^2) / (2 s).
QNM_HD dd dd_sqrt(dd x) {
  if (!(x.hi > 0.0)) return dd{0.0, 0.0};
  const double s = sqrt(x.hi);
  const dd s2 = two_prod(s, s);
  return fast_two_sum(s, ((x.hi - s2.hi) - s2.lo + x.lo) / (2.0 * s));
}
QNM_HD dd dd_of(double x) { return dd{x, 0.0}; }
// x * f for f a power of two: exact on both parts.
QNM_HD dd scaled(dd x, double f) { return dd{x.hi * f, x.lo * f}; }

// A complex double-double.
struct zdd {
  dd re, im;
};

QNM_HD zdd widen(cplx x) { return zdd{dd_of(x.re), dd_of(x.im)}; }
QNM_HD zdd operator+(zdd x, zdd y) { return zdd{x.re + y.re, x.im + y.im}; }
QNM_HD zdd operator-(zdd x, zdd y) { return zdd{x.re - y.re, x.im - y.im}; }
QNM_HD zdd operator-(zdd x) { return zdd{-x.re, -x.im}; }
QNM_HD zdd operator+(zdd x, double y) { return zdd{x.re + y, x.im}; }
QNM_HD zdd operator-(zdd x, double y) { return zdd{x.re - y, x.im}; }
QNM_HD zdd operator*(zdd x, zdd y) {
  return zdd{x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re};
}
QNM_HD zdd operator*(zdd x, dd y) { return zdd{x.re * y, x.im * y}; }
QNM_HD zdd operator*(zdd x, double y) { return zdd{x.re * y, x.im * y}; }
QNM_HD zdd operator/(zdd x, zdd y) {
  const dd den = y.re * y.re + y.im * y.im;
  return zdd{(x.re * y.re + x.im * y.im) / den,
             (x.im * y.re - x.re * y.im) / den};
}
QNM_HD zdd operator/(zdd x, dd y) { return zdd{x.re / y, x.im / y}; }
// i x, exact.
QNM_HD zdd times_i(zdd x) { return zdd{-x.im, x.re}; }
QNM_HD zdd scaled(zdd x, double f) { return zdd{scaled(x.re, f), scaled(x.im, f)}; }
QNM_HD dd zabs(zdd x) { return dd_sqrt(x.re * x.re + x.im * x.im); }
// Principal square root (branch cut on the negative real axis).
QNM_HD zdd zsqrt(zdd z) {
  if (z.re.hi == 0.0 && z.im.hi == 0.0) return zdd{dd_of(0.0), z.im};
  const dd t = dd_sqrt(scaled(dd_sqrt(z.re * z.re + z.im * z.im) +
                                  (z.re.hi < 0.0 ? -z.re : z.re),
                              0.5));
  const dd half_im = scaled(z.im, 0.5) / t;
  if (z.re.hi >= 0.0) return zdd{t, half_im};
  return zdd{z.im.hi < 0.0 ? -half_im : half_im, z.im.hi < 0.0 ? -t : t};
}
QNM_HD double rounded(dd x) { return x.hi + x.lo; }

// The recurrence's coefficients (as Rec) in double-double, and the
// basis's, which the team's segments read.
struct RecDD {
  zdd c0, A1, B1, c3, G1, G0;
  zdd t1, t0, r3, r2, r1, r0;
};
struct BasisDD {
  zdd t1, t0, r3, r2, r1, r0;
};

QNM_HD dd spin_b_dd(double a) {
  return dd_sqrt(dd_of(1.0) - scaled(two_prod(a, a), 4.0));
}

// Leaver's c0..c4 from the FP64 inputs, then the polynomials' coefficients,
// as leaver_rec: q = 2 / b, so that 2i / b phi = i q phi, 4i / b phi = 2 i
// q phi and (4 w + 2i) / b phi = (2 w + i) q phi.
QNM_HD RecDD leaver_rec_dd(int s, int m, double a, cplx w_in, cplx A_in) {
  const dd b = spin_b_dd(a);
  const dd q = dd_of(2.0) / b;
  const zdd w = widen(w_in), A = widen(A_in), iw = times_i(w);
  const zdd phi{dd_of(0.5 * w_in.re) - two_prod(a, static_cast<double>(m)),
                dd_of(0.5 * w_in.im)};
  const zdd iq_phi = times_i(phi * q);
  const zdd tail = ((scaled(w, 2.0) + zdd{dd_of(0.0), dd_of(1.0)}) * q) * phi;
  const zdd w2 = w * w;
  const zdd c0 = -iw - iq_phi + (1.0 - s);
  const zdd c1 = scaled(iw, 2.0) * (b + 2.0) + scaled(iq_phi, 2.0) - 4.0;
  const zdd c2 = -(iw * 3.0) - iq_phi + (s + 3.0);
  const zdd c3 = w2 * (scaled(b, 2.0) + 4.0 - two_prod(a, a)) -
                 w * two_prod(a, 2.0 * m) + iw * (b + 2.0) - A + tail -
                 (s + 1.0);
  const zdd c4 = -scaled(w2, 2.0) - iw * (2.0 * s + 3.0) - tail + (s + 1.0);
  RecDD r;
  r.c0 = c0;
  r.A1 = c0 + 1.0;
  r.B1 = c1 + 2.0;
  r.c3 = c3;
  r.G1 = c2 - 3.0;
  r.G0 = c4 - c2 + 2.0;
  const zdd g1 = r.G1 + 2.0, g0 = r.G1 + r.G0 + 1.0;
  r.t1 = scaled(c1, 0.5);
  r.t0 = scaled(r.t1 + c3 + 1.0, 0.5);
  r.r3 = g1 + r.A1 + scaled(r.t1, 2.0);
  r.r2 = g0 + r.A1 * g1 + c0 - r.t1 * r.t1 + scaled(r.t0, 2.0);
  r.r1 = r.A1 * g0 + c0 * g1 - scaled(r.t1 * r.t0, 2.0);
  r.r0 = c0 * g0 - r.t0 * r.t0;
  return r;
}

QNM_HD BasisDD basis_dd(const RecDD& r) {
  return BasisDD{r.t1, r.t0, r.r3, r.r2, r.r1, r.r0};
}

// n (an integer <= kMaxN) and n^2 are exact doubles.
QNM_HD zdd alpha_dd(double n, const RecDD& r) {
  return r.A1 * n + r.c0 + n * n;
}
QNM_HD zdd beta_dd(double n, const RecDD& r) {
  return r.B1 * n + r.c3 + (-2.0 * (n * n));
}
QNM_HD zdd gamma_dd(double n, const RecDD& r) {
  return r.G1 * n + r.G0 + n * n;
}
QNM_HD zdd tau_dd(double n, zdd t1, zdd t0) { return (t1 - n) * n + t0; }
QNM_HD zdd cubic_dd(double n, const BasisDD& p) {
  return ((p.r3 * n + p.r2) * n + p.r1) * n + p.r0;
}

// Sums of double-double products with one renormalisation: each
// product's leading part joins the sum by an exact two-sum; its rounding
// error (an exact fused multiply-add), its cross terms and the two-sums'
// errors are summed in FP64; one two-sum at the end.  Its error is a few
// units of 2^-106 of the sum of the products' magnitudes, against one
// renormalisation a product and a sum in the plain version (cf_dd).
struct Acc {
  double hi, lo;
};
QNM_HD double prod_lo(dd x, dd y, double p) {
  return exact_fma(x.hi, y.hi, -p) + exact_fma(x.hi, y.lo, x.lo * y.hi);
}
QNM_HD Acc acc_of(dd x, dd y) {
  const double p = x.hi * y.hi;
  return Acc{p, prod_lo(x, y, p)};
}
QNM_HD void acc_add(Acc& s, dd x, dd y) {
  const double p = x.hi * y.hi;
  const dd t = two_sum(s.hi, p);
  s.hi = t.hi;
  s.lo += t.lo + prod_lo(x, y, p);
}
QNM_HD void acc_add(Acc& s, dd x) {
  const dd t = two_sum(s.hi, x.hi);
  s.hi = t.hi;
  s.lo += t.lo + x.lo;
}
QNM_HD dd acc_done(Acc s) { return two_sum(s.hi, s.lo); }

// x y + z w and x y - z for complex double-doubles, each part one sum.
QNM_HD zdd zdot(const zdd& x, const zdd& y, const zdd& z, const zdd& w) {
  Acc re = acc_of(x.re, y.re), im = acc_of(x.re, y.im);
  acc_add(re, -x.im, y.im);
  acc_add(im, x.im, y.re);
  acc_add(re, z.re, w.re);
  acc_add(im, z.re, w.im);
  acc_add(re, -z.im, w.im);
  acc_add(im, z.im, w.re);
  return zdd{acc_done(re), acc_done(im)};
}
QNM_HD zdd zmul_sub(const zdd& x, const zdd& y, const zdd& z) {
  Acc re = acc_of(x.re, y.re), im = acc_of(x.re, y.im);
  acc_add(re, -x.im, y.im);
  acc_add(im, x.im, y.re);
  acc_add(re, -z.re);
  acc_add(im, -z.im);
  return zdd{acc_done(re), acc_done(im)};
}
struct Mat2dd {
  zdd a, b, c, d;
};

QNM_HD Mat2dd identity_dd() {
  const zdd z{dd_of(0.0), dd_of(0.0)}, o{dd_of(1.0), dd_of(0.0)};
  return Mat2dd{o, z, z, o};
}
QNM_HD Mat2dd operator*(const Mat2dd& x, const Mat2dd& y) {
  return Mat2dd{zdot(x.a, y.a, x.b, y.c), zdot(x.a, y.b, x.b, y.d),
                zdot(x.c, y.a, x.d, y.c), zdot(x.c, y.b, x.d, y.d)};
}
QNM_HD int max_exp(const zdd& x) {
  return imax(biased_exp(x.re.hi), biased_exp(x.im.hi));
}
QNM_HD double maxabs(const zdd& x) {
  return fmax(fabs(x.re.hi), fabs(x.im.hi));
}
// As rescale(Mat2&), on the leading parts; both parts take the power of two.
QNM_HD void rescale(Mat2dd& S) {
  const int e = imax(imax(max_exp(S.a), max_exp(S.b)),
                     imax(max_exp(S.c), max_exp(S.d)));
  const double f =
      e >= 1 && e <= 2045
          ? pow2_of_exp(e)
          : pow2_scale(fmax(fmax(maxabs(S.a), maxabs(S.b)),
                            fmax(maxabs(S.c), maxabs(S.d))));
  S.a = scaled(S.a, f);
  S.b = scaled(S.b, f);
  S.c = scaled(S.c, f);
  S.d = scaled(S.d, f);
}

// S <- S Mh_k at n = k, as step().
QNM_HD void step(Mat2dd& S, double n, const BasisDD& p) {
  const zdd tau = tau_dd(n, p.t1, p.t0), R = cubic_dd(n, p);
  const zdd a = zdot(S.a, tau, S.b, R);
  const zdd c = zdot(S.c, tau, S.d, R);
  S.b = zmul_sub(S.b, tau, S.a);
  S.d = zmul_sub(S.d, tau, S.c);
  S.a = a;
  S.c = c;
}

// As segment(): the product Mh_lo ... Mh_{hi-1}, rescaled after every
// kRescale steps and after the last.
QNM_HD Mat2dd segment(int lo, int hi, const BasisDD& p) {
  Mat2dd S = identity_dd();
  double n = static_cast<double>(lo);
  for (int k = lo; k < hi; k += kRescale) {
    const int end = hi - k < kRescale ? hi : k + kRescale;
#ifdef __CUDACC__
#pragma unroll 1
#endif
    for (int j = k; j < end; ++j, n += 1.0) step(S, n, p);
    rescale(S);
  }
  return S;
}

// As upward().
QNM_HD zdd upward_dd(int n_inv, const RecDD& r) {
  zdd p0{dd_of(1.0), dd_of(0.0)}, p1 = beta_dd(0.0, r);
  for (int k = 1; k <= n_inv; ++k) {
    const double n = static_cast<double>(k);
    const zdd p2 = beta_dd(n, r) * p1 -
                   alpha_dd(n - 1.0, r) * gamma_dd(n, r) * p0;
    p0 = p1;
    p1 = p2;
    if (k % kRescale == 0) {
      const double f = pow2_scale(fmax(maxabs(p0), maxabs(p1)));
      p0 = scaled(p0, f);
      p1 = scaled(p1, f);
    }
  }
  return p1 / p0;
}

// What the finish needs that does not depend on the product, formed
// while the segments run, in two parts: U = U_{n_inv} and |U|; x_N = T_N
// - tau_N (the Nollert tail's start in the basis) and tau at n_inv (at N
// where n_inv >= N, the product then empty).
struct UpDD {
  zdd U;
  dd absU;
};
struct TailDD {
  zdd xN, tau_lo;
};
struct TermsDD {
  UpDD up;
  TailDD tail;
};

QNM_HD UpDD up_dd(int n_inv, const RecDD& r) {
  const zdd U = upward_dd(n_inv, r);
  return UpDD{U, zabs(U)};
}

QNM_HD TailDD tail_dd(int n_inv, int N, double a, cplx w_in,
                      const RecDD& r) {
  zdd u = -zsqrt(scaled(times_i(widen(w_in) * spin_b_dd(a)), -2.0));
  if (u.re.hi > 0.0) u = -u;
  const zdd v = scaled(u * u + 0.5 + r.G1 - r.A1, 0.5);
  const double dN = static_cast<double>(N);
  const zdd TN = -alpha_dd(dN, r) *
                 (u / dd_sqrt(dd_of(dN)) + v / dd_of(dN) + 1.0);
  return TailDD{
      TN - tau_dd(dN, r.t1, r.t0),
      tau_dd(static_cast<double>(n_inv < N ? n_inv : N), r.t1, r.t0)};
}

// As finish(), from the element's product P = Mh_{n_inv} ... Mh_{N-1}
// and its terms: T_{n_inv} = tau_{n_inv} + y2 / y1, [y1; y2] = P [1; x_N];
// f = U - T and |U| + |T| rounded once to FP64.
QNM_HD void finish_dd(const Mat2dd& P, const TermsDD& t, cplx* f,
                      double* scale) {
  const zdd T = t.tail.tau_lo + (P.c + P.d * t.tail.xN) /
                                    (P.a + P.b * t.tail.xN);
  const zdd d = t.up.U - T;
  *f = mk(rounded(d.re), rounded(d.im));
  *scale = rounded(t.up.absU + zabs(T));
}

// The workspace of a double-double launch (doubles; the wrapper allocates
// it): each element's blocks' products (kMatDoubles each), then each
// element's terms (kTermsDoubles).
constexpr int kMatDoubles = sizeof(Mat2dd) / sizeof(double);
constexpr int kUpDoubles = sizeof(UpDD) / sizeof(double);
constexpr int kTermsDoubles = sizeof(TermsDD) / sizeof(double);
static_assert(kMatDoubles == 16 && kUpDoubles == 6 && kTermsDoubles == 14,
              "packed layouts");

}  // namespace

#ifdef __CUDACC__

// Built with -DQNM_CF_PHASES (``cf_cuda.phase_cycles``), the double-double
// kernel adds the clock64 cycles of its phases into qnm_cf_phase_cycles
// (the indices are ``cf_cuda.PHASES``'s), which qnm_cf_phases reads: the
// clock reads slow the steps they time.  Otherwise these are empty.
#if defined(QNM_CF_PHASES)
__device__ unsigned long long qnm_cf_phase_cycles[16];
#endif
#if defined(QNM_CF_PHASES) && defined(__CUDA_ARCH__)
#define QNM_CLOCK(v) const long long v = clock64();
#define QNM_SPAN(cond, v, idx)                                     \
  if (cond)                                                        \
    atomicAdd(&qnm_cf_phase_cycles[idx],                           \
              static_cast<unsigned long long>(clock64() - (v)));
#define QNM_COUNT(cond, idx) \
  if (cond) atomicAdd(&qnm_cf_phase_cycles[idx], 1ull);
#else
#define QNM_CLOCK(v)
#define QNM_SPAN(cond, v, idx)
#define QNM_COUNT(cond, idx)
#endif

namespace {

// Phase counters: a segment block's coefficients, its warps' segments,
// its tree (with the wait for its slowest warp), its arrival, the last
// block's cross-block combine and finish, the terms, a segment block
// whole; then the counts of segment blocks, warps, last blocks and terms.
enum {
  kPhaseCoef, kPhaseSegments, kPhaseTree, kPhaseArrive, kPhaseCombine,
  kPhaseFinish, kPhaseTerms, kPhaseBlock, kCountBlocks, kCountWarps,
  kCountLast, kCountTerms
};

__device__ __forceinline__ double shfl_down(double x, int off) {
  return __shfl_down_sync(0xffffffffu, x, off);
}
__device__ __forceinline__ cplx shfl_down(cplx x, int off) {
  return mk(shfl_down(x.re, off), shfl_down(x.im, off));
}
__device__ __forceinline__ dd shfl_down(dd x, int off) {
  return dd{shfl_down(x.hi, off), shfl_down(x.lo, off)};
}
__device__ __forceinline__ zdd shfl_down(zdd x, int off) {
  return zdd{shfl_down(x.re, off), shfl_down(x.im, off)};
}
__device__ __forceinline__ zdd shfl_up(zdd x, int off) {
  const auto up = [off](double v) {
    return __shfl_up_sync(0xffffffffu, v, off);
  };
  return zdd{dd{up(x.re.hi), up(x.re.lo)}, dd{up(x.im.hi), up(x.im.lo)}};
}

// The ordered product of each group of `width` lanes' matrices (a power
// of two <= 32; j the lane's index in its group) by the pairwise tree;
// the group's first lane holds it.
template <class Mat>
__device__ __forceinline__ Mat tree_product(Mat S, int j, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const Mat Q{shfl_down(S.a, off), shfl_down(S.b, off),
                shfl_down(S.c, off), shfl_down(S.d, off)};
    if ((j & (2 * off - 1)) == 0) {
      S = S * Q;
      rescale(S);
    }
  }
  return S;
}

// As tree_product, for double-double products: the two lanes of a pair
// split the product X Y by rows (X in lane j, Y in lane j + off): lane j
// forms the first row from Y's shuffled copy, lane j + off the second
// from X's second row, which lane j then takes back.  The same entries,
// in the same order, as X * Y, at half a lane's work.
__device__ __forceinline__ Mat2dd tree_product(Mat2dd S, int j, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const Mat2dd Y{shfl_down(S.a, off), shfl_down(S.b, off),
                   shfl_down(S.c, off), shfl_down(S.d, off)};
    const zdd xc = shfl_up(S.c, off), xd = shfl_up(S.d, off);
    const bool left = (j & (2 * off - 1)) == 0;
    const zdd r0 = left ? S.a : xc, r1 = left ? S.b : xd;
    const zdd ya = left ? Y.a : S.a, yb = left ? Y.b : S.b;
    const zdd yc = left ? Y.c : S.c, yd = left ? Y.d : S.d;
    const zdd e0 = zdot(r0, ya, r1, yc), e1 = zdot(r0, yb, r1, yd);
    const zdd f0 = shfl_down(e0, off), f1 = shfl_down(e1, off);
    if (left) {
      S = Mat2dd{e0, e1, f0, f1};
      rescale(S);
    }
  }
  return S;
}

// A team of `team` threads (a power of two, 1..256) an element; a block
// of kThreads = max(team, 128) threads holds kThreads / team elements, so
// teams below a warp share their warp's setup, tree and finish.
template <int kThreads>
__device__ __forceinline__ void team_cf(
    long long B, const double* __restrict__ w_re,
    const double* __restrict__ w_im, const double* __restrict__ a,
    const double* __restrict__ A_re, const double* __restrict__ A_im,
    const int* __restrict__ n_inv_in, int s, int m, int N, int team,
    double* __restrict__ f_re, double* __restrict__ f_im,
    double* __restrict__ scale) {
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
    const Rec r =
        leaver_rec(s, m, a[i], mk(w_re[i], w_im[i]), mk(A_re[i], A_im[i]));
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

#define QNM_CF_PARAMS                                                        \
  long long B, const double *__restrict__ w_re,                              \
      const double *__restrict__ w_im, const double *__restrict__ a,         \
      const double *__restrict__ A_re, const double *__restrict__ A_im,      \
      const int *__restrict__ n_inv, int s, int m, int N, int team,          \
      double *__restrict__ f_re, double *__restrict__ f_im,                  \
      double *__restrict__ scale
#define QNM_CF_ARGS \
  B, w_re, w_im, a, A_re, A_im, n_inv, s, m, N, team, f_re, f_im, scale

// The FP64 kernel.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    leaver_cf_kernel(QNM_CF_PARAMS) {
  team_cf<kThreads>(QNM_CF_ARGS);
}

// Loads and stores of the workspace through L2 (another SM's block wrote
// or reads it), as doubles.
template <class T>
__device__ __forceinline__ void store_cg(double* dst, const T& x) {
  const double* src = reinterpret_cast<const double*>(&x);
  QNM_UNROLL
  for (int k = 0; k < static_cast<int>(sizeof(T) / sizeof(double)); ++k)
    __stcg(dst + k, src[k]);
}
template <class T>
__device__ __forceinline__ T load_cg(const double* src) {
  T x;
  double* dst = reinterpret_cast<double*>(&x);
  QNM_UNROLL
  for (int k = 0; k < static_cast<int>(sizeof(T) / sizeof(double)); ++k)
    dst[k] = __ldcg(src + k);
  return x;
}

// The element's outputs from its product and its terms (in the
// workspace); its arrival count back to 0 for the next launch.
__device__ __forceinline__ void finish_element(
    long long i, const Mat2dd& P, const double* terms, unsigned* arrivals,
    double* f_re, double* f_im, double* scale) {
  cplx f;
  double sc;
  finish_dd(P, load_cg<TermsDD>(terms + i * kTermsDoubles), &f, &sc);
  f_re[i] = f.re;
  f_im[i] = f.im;
  scale[i] = sc;
  arrivals[i] = 0u;
}

// The double-double kernel (spins beyond CHI_EXTENDED).  The grid's first
// `term_blocks` blocks form the terms, two threads an element (U, the
// tail's start); the others are the segment blocks: `blocks` (G) of them
// an element, each with one team of `team` threads (team = kThreads, 128
// or 256, where G > 1), or, where G = 1, kThreads / team teams of the
// elements in order, as the FP64 kernel's.  Team thread j of block g
// takes segment g team + j of T = G team.  Each team's product and each
// part of an element's terms go to the workspace and count on the
// element's arrival counter; the last of the G + 2 arrivals combines the
// G products by the same pairwise tree (a block's threads, or, where a
// part of the terms comes last, its thread serially, in the same order)
// and finishes, so the arithmetic is the host twin's with a team of T
// whichever block comes last.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    leaver_cf_dd_kernel(QNM_CF_PARAMS, int blocks, int term_blocks,
                        double* __restrict__ ws,
                        unsigned* __restrict__ arrivals) {
  double* const parts = ws;
  double* const terms = ws + B * blocks * kMatDoubles;
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < term_blocks) {
    // The block's first half forms U of its elements, a thread an
    // element, the second half the tail's start: two arrivals.
    constexpr int kHalf = kThreads / 2;
    const bool up = t < kHalf;
    const long long i =
        static_cast<long long>(blockIdx.x) * kHalf + (up ? t : t - kHalf);
    if (i >= B) return;
    QNM_CLOCK(c0)
    const cplx w = mk(w_re[i], w_im[i]);
    const RecDD r = leaver_rec_dd(s, m, a[i], w, mk(A_re[i], A_im[i]));
    double* const tm = terms + i * kTermsDoubles;
    if (up)
      store_cg(tm, up_dd(n_inv[i], r));
    else
      store_cg(tm + kUpDoubles, tail_dd(n_inv[i], N, a[i], w, r));
    __threadfence();
    QNM_SPAN(true, c0, kPhaseTerms)
    QNM_COUNT(true, kCountTerms)
    if (atomicAdd(&arrivals[i], 1u) != static_cast<unsigned>(blocks) + 1u)
      return;
    // The terms came last (segments shorter than the terms' work): the
    // blocks' products combined here, serially, in place.
    __threadfence();
    double* const P = parts + i * blocks * kMatDoubles;
    for (int off = 1; off < blocks; off <<= 1) {
      for (int g = 0; g + off < blocks; g += 2 * off) {
        Mat2dd x = load_cg<Mat2dd>(P + g * kMatDoubles) *
                   load_cg<Mat2dd>(P + (g + off) * kMatDoubles);
        rescale(x);
        store_cg(P + g * kMatDoubles, x);
      }
    }
    finish_element(i, load_cg<Mat2dd>(P), terms, arrivals, f_re, f_im,
                   scale);
    return;
  }
  __shared__ BasisDD rec_s[kThreads <= 128 ? kThreads : 1];
  __shared__ Mat2dd warp_s[kThreads / 32];
  __shared__ bool last_s;
  QNM_CLOCK(c0)
  const int e = t / team, j = t % team, lane = t & 31;
  const long long slot =
      static_cast<long long>(blockIdx.x - term_blocks) * (kThreads / team) +
      e;
  const long long i = slot / blocks;
  const int g = static_cast<int>(slot % blocks);
  const bool live = i < B;
  const int n_inv_i = live ? n_inv[i] : N;
  // The team's first warp (all of a team below a warp) forms the basis.
  if (j < 32 && live) {
    const BasisDD r = basis_dd(leaver_rec_dd(s, m, a[i], mk(w_re[i], w_im[i]),
                                             mk(A_re[i], A_im[i])));
    if (j == 0) rec_s[e] = r;
  }
  __syncthreads();
  QNM_SPAN(t == 0, c0, kPhaseCoef)
  QNM_CLOCK(c1)
  int lo, hi;
  lane_range(g * team + j, team * blocks, n_inv_i, N, &lo, &hi);
  Mat2dd S = segment(lo, hi, rec_s[e]);
  QNM_SPAN(lane == 0, c1, kPhaseSegments)
  QNM_COUNT(lane == 0, kCountWarps)
  QNM_CLOCK(c2)
  S = tree_product(S, j & 31, team < 32 ? team : 32);
  if (team > 32) {
    // The warps' products, in order, to the team's first warp.
    const int first = (t - j) >> 5;
    if (lane == 0) warp_s[t >> 5] = S;
    __syncthreads();
    if (j < 32)
      S = tree_product(lane < team / 32 ? warp_s[first + lane] : identity_dd(),
                       lane, team / 32);
  }
  QNM_SPAN(t == 0, c2, kPhaseTree)
  QNM_COUNT(t == 0, kCountBlocks)
  if (blocks == 1) {
    // The element's one team: its product to the workspace; whichever of
    // it and the terms comes second finishes.
    if (j != 0 || !live) return;
    QNM_CLOCK(c3)
    store_cg(parts + i * kMatDoubles, S);
    __threadfence();
    const bool last = atomicAdd(&arrivals[i], 1u) == 2u;
    QNM_SPAN(t == 0, c3, kPhaseArrive)
    QNM_SPAN(t == 0 && !last, c0, kPhaseBlock)
    if (!last) return;
    __threadfence();
    QNM_CLOCK(c5)
    finish_element(i, S, terms, arrivals, f_re, f_im, scale);
    QNM_SPAN(t == 0, c5, kPhaseFinish)
    QNM_COUNT(t == 0, kCountLast)
    QNM_SPAN(t == 0, c0, kPhaseBlock)
    return;
  }
  // G > 1: the block is one team (team = kThreads).
  QNM_CLOCK(c3)
  if (t == 0) {
    store_cg(parts + (i * blocks + g) * kMatDoubles, S);
    __threadfence();
    last_s = atomicAdd(&arrivals[i], 1u) == static_cast<unsigned>(blocks) + 1u;
  }
  __syncthreads();
  QNM_SPAN(t == 0, c3, kPhaseArrive)
  QNM_SPAN(t == 0 && !last_s, c0, kPhaseBlock)
  if (!last_s) return;
  // The last block: the G products, in order, by the same tree.
  __threadfence();
  QNM_CLOCK(c4)
  S = t < blocks ? load_cg<Mat2dd>(parts + (i * blocks + t) * kMatDoubles)
                 : identity_dd();
  S = tree_product(S, lane, blocks < 32 ? blocks : 32);
  if (blocks > 32) {
    if (lane == 0) warp_s[t >> 5] = S;
    __syncthreads();
    if (t < 32)
      S = tree_product(lane < blocks / 32 ? warp_s[lane] : identity_dd(),
                       lane, blocks / 32);
  }
  if (t != 0) return;
  QNM_SPAN(true, c4, kPhaseCombine)
  QNM_CLOCK(c5)
  finish_element(i, S, terms, arrivals, f_re, f_im, scale);
  QNM_SPAN(true, c5, kPhaseFinish)
  QNM_COUNT(true, kCountLast)
  QNM_SPAN(true, c0, kPhaseBlock)
}

template <int kThreads>
int launch(cudaStream_t stream, QNM_CF_PARAMS) {
  const long long per_block = kThreads / team;
  const unsigned grid = static_cast<unsigned>((B + per_block - 1) / per_block);
  leaver_cf_kernel<kThreads><<<grid, kThreads, 0, stream>>>(QNM_CF_ARGS);
  return static_cast<int>(cudaGetLastError());
}

template <int kThreads>
int launch_dd(cudaStream_t stream, QNM_CF_PARAMS, int blocks, double* ws,
              unsigned* arrivals) {
  const long long per_block = kThreads / team;
  const long long term_blocks = (B + kThreads / 2 - 1) / (kThreads / 2);
  const long long seg_blocks =
      blocks > 1 ? B * blocks : (B + per_block - 1) / per_block;
  if (term_blocks + seg_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  leaver_cf_dd_kernel<kThreads>
      <<<static_cast<unsigned>(term_blocks + seg_blocks), kThreads, 0,
         stream>>>(QNM_CF_ARGS, blocks, static_cast<int>(term_blocks), ws,
                   arrivals);
  return static_cast<int>(cudaGetLastError());
}

bool pow2_upto(int x, int most) {
  return x >= 1 && x <= most && (x & (x - 1)) == 0;
}

int entry(int device, void* stream, QNM_CF_PARAMS) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxN || B > 0x7fffffffLL || !pow2_upto(team, 256))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (team <= 128) return launch<128>(st, QNM_CF_ARGS);
  return launch<256>(st, QNM_CF_ARGS);
}

int entry_dd(int device, void* stream, QNM_CF_PARAMS, int blocks,
             double* ws, unsigned* arrivals) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxN || B > 0x7fffffffLL || !pow2_upto(team, 256) ||
      !pow2_upto(blocks, 256) ||
      (blocks > 1 && (team < 128 || blocks > team)) || !ws || !arrivals)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (team <= 128)
    return launch_dd<128>(st, QNM_CF_ARGS, blocks, ws, arrivals);
  return launch_dd<256>(st, QNM_CF_ARGS, blocks, ws, arrivals);
}

}  // namespace

// Evaluate B elements on `stream` of device `device`, a team of `team`
// threads (a power of two, 1..256) an element, in FP64.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int qnm_leaver_cf(QNM_CF_PARAMS, int device, void* stream) {
  return entry(device, stream, QNM_CF_ARGS);
}
// The same in double-double, each element over `blocks` (a power of two,
// 1..256; above 1 only with a team of 128 or 256 and at most `team`)
// blocks of the team: `ws` B (16 blocks + 14) doubles of workspace and
// `arrivals` B counters, 0 before the launch and left 0 after it (so one
// zeroed set serves every launch of a stream).
extern "C" int qnm_leaver_cf_dd(QNM_CF_PARAMS, int blocks, double* ws,
                                unsigned* arrivals, int device,
                                void* stream) {
  return entry_dd(device, stream, QNM_CF_ARGS, blocks, ws, arrivals);
}

#ifdef QNM_CF_PHASES
// The phase counters (QNM_CF_PHASES): reset to 0, or copied into out[16].
extern "C" int qnm_cf_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[16] = {0};
    return static_cast<int>(
        cudaMemcpyToSymbol(qnm_cf_phase_cycles, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, qnm_cf_phase_cycles, 16 * sizeof(unsigned long long)));
}
#endif

#else

namespace {

// Host build of the same arithmetic (g++ -x c++): the same segments for a
// team of `team` threads (any team >= 1), combined by the same pairwise
// tree, serially.  Returns 0, or 1 on arguments the kernel refuses.
int host_cf(long long B, const double* w_re, const double* w_im,
            const double* a, const double* A_re, const double* A_im,
            const int* n_inv, int s, int m, int N, int team, double* f_re,
            double* f_im, double* scale) {
  if (N < 1 || N > kMaxN || team < 1) return 1;
  std::vector<Mat2> P(team);
  for (long long i = 0; i < B; ++i) {
    const cplx w = mk(w_re[i], w_im[i]), A = mk(A_re[i], A_im[i]);
    const Rec r = leaver_rec(s, m, a[i], w, A);
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

// The double-double kernel's arithmetic with T = team x blocks segments
// (any team and blocks >= 1): the card's blocks and teams combine by the
// same pairwise tree over the T segments in order.
int host_cf_dd(long long B, const double* w_re, const double* w_im,
               const double* a, const double* A_re, const double* A_im,
               const int* n_inv, int s, int m, int N, int team, int blocks,
               double* f_re, double* f_im, double* scale) {
  if (N < 1 || N > kMaxN || team < 1 || blocks < 1 ||
      static_cast<long long>(team) * blocks > kMaxN)
    return 1;
  const int T = team * blocks;
  std::vector<Mat2dd> P(T);
  for (long long i = 0; i < B; ++i) {
    const cplx w = mk(w_re[i], w_im[i]);
    const RecDD r = leaver_rec_dd(s, m, a[i], w, mk(A_re[i], A_im[i]));
    const BasisDD p = basis_dd(r);
    for (int j = 0; j < T; ++j) {
      int lo, hi;
      lane_range(j, T, n_inv[i], N, &lo, &hi);
      P[j] = segment(lo, hi, p);
    }
    for (int off = 1; off < T; off *= 2) {
      for (int j = 0; j + off < T; j += 2 * off) {
        P[j] = P[j] * P[j + off];
        rescale(P[j]);
      }
    }
    cplx f;
    finish_dd(P[0],
              TermsDD{up_dd(n_inv[i], r), tail_dd(n_inv[i], N, a[i], w, r)},
              &f, &scale[i]);
    f_re[i] = f.re;
    f_im[i] = f.im;
  }
  return 0;
}

}  // namespace

extern "C" int qnm_leaver_cf_host(long long B, const double* w_re,
                                  const double* w_im, const double* a,
                                  const double* A_re, const double* A_im,
                                  const int* n_inv, int s, int m, int N,
                                  int team, double* f_re, double* f_im,
                                  double* scale) {
  return host_cf(B, w_re, w_im, a, A_re, A_im, n_inv, s, m, N, team, f_re,
                 f_im, scale);
}
extern "C" int qnm_leaver_cf_dd_host(long long B, const double* w_re,
                                     const double* w_im, const double* a,
                                     const double* A_re, const double* A_im,
                                     const int* n_inv, int s, int m, int N,
                                     int team, int blocks, double* f_re,
                                     double* f_im, double* scale) {
  return host_cf_dd(B, w_re, w_im, a, A_re, A_im, n_inv, s, m, N, team,
                    blocks, f_re, f_im, scale);
}

#endif
