// The on-demand Kerr solver's angular eigenproblem for Hopper (sm_90a):
// every eigenvalue, and optionally one eigenvector, of a batch of complex
// pentadiagonal matrices, one warp a matrix, or a team of two warps a
// matrix for small batches.
//
// Replaces the host eig of the JAX package's solver,
// qnmfits_tpu/spectrum/solver.py::_batched_angular_eig (np.linalg.eig over
// the stacked angular matrices) with _select_eig (the eigenpair nearest a
// guess, the entry l - lmin real and positive, unit norm).  Its plain
// version, qnmfits_tpu_torch/ops/eig_cuda.py::eigvals_plain and
// eigpair_plain, runs torch.linalg.eig on CPU tensors.
//
// The matrix, at one complex oblateness c of a (B,) batch:
//   M(c) = diag(lam0) + 2 c s X - c^2 X^2,
// X the real tridiagonal matrix of cos(theta) in the sYlm basis (order n =
// nl), so M is pentadiagonal, complex symmetric, not Hermitian.  A warp
// builds it in its own shared memory from the c-independent bands (lam0,
// X's three diagonals, X^2's five), so the (B, n, n) tensor is never
// written to device memory.
//
// Design, per matrix (one warp; the lanes take the columns of a row
// update and the rows of a column update, j = lane, lane + 32, ...):
//   * Householder reduction to upper Hessenberg form (zgehd2's
//     reflectors: H^H A H), stopped at each column's last nonzero row, the
//     column norms by a butterfly of warp shuffles that leaves every lane
//     the same sum, the reflector's products by fused multiply-adds;
//   * single-shift complex QR iterations on the active block [l, i] only
//     (eigenvalues, no Schur vectors: LAPACK zlahqr with wantt false):
//     Givens rotations (c real), zlahqr's deflation test on each
//     subdiagonal (the lanes test one subdiagonal each and a ballot finds
//     the split nearest the bottom), Wilkinson's shift, exceptional
//     shifts after 10 and 20 iterations without a deflation, and zlahqr's
//     cap of 30 max(10, n) iterations an eigenvalue, past which the matrix
//     reports failure (info -1) and the wrapper raises.  Unitary
//     transforms only: no complex-orthogonal step of the symmetric form,
//     which is unstable.
//   * a team of two warps a matrix (the wrapper's plan for launches of a
//     few matrices, where the card's SMs would idle): where the active
//     block has 6 rows or more and the iteration takes Wilkinson's shift,
//     it takes instead both eigenvalues of the trailing 2 x 2 block
//     (LAPACK zlaqr5's shifts from the trailing block, two of them) and
//     chases two single-shift bulges two steps apart, a warp each, in
//     ticks: each warp's step of its bulge, the 64-thread named barrier
//     of the team (bar.sync) where one warp has its __syncwarp.  The
//     first warp does all else (the reduction, the split tests, the
//     shifts, the vector) and hands the second its bulge through a word
//     in shared memory.  Info counts such an iteration as two sweeps and
//     its FP64 operations as two sweeps' over the block.
//   * vectors mode: the eigenvalue nearest the guess (smallest |A -
//     guess|, the first on a tie), its right eigenvector by three steps of
//     inverse iteration on the pentadiagonal M - lambda I (band LU with
//     partial pivoting: U's upper bandwidth is 4), then the solver's
//     phase rule (entry l - lmin real and positive) and unit norm.
//
// Bound on this card: latency.  A matrix of n = 28 moves 16 bytes in and
// 28 x 16 out, and its work (the FP64 operations that the reduction's,
// the rotations' and the inverse iteration's loops do, which the kernel
// counts and reports) is a chain of small dependent steps, one warp's, so
// 2 matrices on one warp each take about as long as 800 (the batch's
// warps run side by side on the 132 SMs).  On an H100
// (scripts/torch_card_latency.py) a dependent
// FP64 multiply, add or fused multiply-add takes 8 cycles, IEEE sqrt 80,
// division 113, 1 / sqrt 141, a shuffle of a double 26, a shared-memory
// store, __syncwarp and load 35: a sweep step's rotation and its two
// passes over shared memory are the chain.  So the design keeps each step
// short rather than adding lanes: the rotation's 1 / sqrt by four Newton
// steps of fused multiply-adds from a seed off the exponent's bits (no
// branch, no division; ``rsqrt_newton``), every pair update three fused
// operations a real part, one division where zlahqr's shift and the
// reflector took Smith's two, the matrix in shared memory addressed as
// such (a kernel for shared memory and one for the global workspace, so
// the shared path's loads are not generic ones), each lane's loads of a
// step issued before its rotation, two barriers a step.  Where a launch
// leaves SMs idle, a second warp a matrix takes a second bulge: 0.6-0.75
// as many ticks as one bulge's steps, each dearer than a step (the team's
// barrier spans two schedulers).
// Exchanging a step's window between lanes by shuffles, having every lane
// compute it, and two bulges in one warp all measured slower (PERF.md,
// section 6).  Tensor cores and TMA have no part in it.
//
// The source is built without contraction (nvcc -fmad=false, and g++
// -ffp-contract=off for the host build the CPU tests run), so both builds
// round each product and sum alike, and fused multiply-adds only where the
// source calls fma (std::fma on the host, correctly rounded as the card's
// DFMA); the host build runs the same functions with one lane doing every
// lane's share in lane order, the same butterfly order for the norms, and
// a sweep step's rotations in the card's order (a team's two bulges in
// the order of its ticks, ``double_sweep``).  The CPU tests also run the
// card's own code path, one host thread a lane (64 for a team), and hold
// it to the host build bit for bit.
//
// Memory of a warp (complex entries): H, n rows of ld = n | 1 (odd, so a
// column's 16-byte entries fall in distinct banks), then the eigenvalues
// W (n), the iterate V (n) and the pivots (n ints in n entries), then for
// a team its word (two entries).  Up to ~119 rows a matrix's memory is
// shared memory (the block's opt-in 227 KB); beyond, or when the wrapper
// asks, a global workspace of the same layout, one region a matrix.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QNM_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define QNM_HD inline
#endif

#ifdef __CUDA_ARCH__
// A lane's share of a warp-wide loop, and the warp's barrier.
#define QNM_LANES(j, lo, hi) for (int j = (lo) + lane; j < (hi); j += 32)
#define QNM_SYNC() __syncwarp()
// The barrier of a team's two warps (64 threads), named ``id``.
#ifndef QNM_TEAM_BAR
#define QNM_TEAM_BAR(id) asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory")
#endif
#else
#define QNM_LANES(j, lo, hi) for (int j = (lo); j < (hi); ++j)
#define QNM_SYNC() ((void)0)
#define QNM_TEAM_BAR(id) ((void)(id))
#endif

// Built with -DQNM_EIG_PHASES (``eig_cuda.phase_cycles``), lane 0 of each
// warp adds the clock64 cycles of the phases into qnm_phase_cycles, which
// qnm_eig_phases reads (the indices are ``eig_cuda.PHASES``'s): the clock
// reads slow the steps they time.  Otherwise these are empty.
#if defined(QNM_EIG_PHASES) && defined(__CUDACC__)
__device__ unsigned long long qnm_phase_cycles[16];
#endif
#if defined(QNM_EIG_PHASES) && defined(__CUDA_ARCH__)
#define QNM_CLOCK(v) const long long v = clock64();
#define QNM_SPAN(v, idx)                                       \
  if (lane == 0)                                               \
    atomicAdd(&qnm_phase_cycles[idx],                          \
              static_cast<unsigned long long>(clock64() - (v)));
#define QNM_COUNT(idx) \
  if (lane == 0) atomicAdd(&qnm_phase_cycles[idx], 1ull);
#else
#define QNM_CLOCK(v)
#define QNM_SPAN(v, idx)
#define QNM_COUNT(idx)
#endif

namespace {

constexpr double kUlp = DBL_EPSILON;   // LAPACK's dlamch('P')
constexpr double kSafeMin = DBL_MIN;   // dlamch('S')
constexpr int kExceptional = 10;       // zlahqr's KEXSH
constexpr double kExceptionalScale = 0.75;  // zlahqr's DAT1
constexpr int kInverseSteps = 3;
// FP64 operations the kernel counts (its info's second column): a complex
// multiply-add 8, a complex product 6, a complex entry scaled by a real 2
// and a sum of two 2; a rotation's update of a pair of entries (two
// products by c, two by s, two sums) 20.  The set-up of each reflector
// and rotation, the shifts, the deflation tests, divisions and square
// roots are left out, so the count is a little below the work done.
constexpr long long kMaddOps = 8, kMulOps = 6, kPairOps = 20;
// A team of two warps takes a QR iteration on two bulges from an active
// block of this order on (smaller blocks: one bulge, the first warp).
constexpr int kTeamMinOrder = 6;

struct alignas(16) cplx {
  double re, im;
};

QNM_HD cplx mk(double re, double im) { return cplx{re, im}; }
QNM_HD cplx operator+(cplx x, cplx y) { return mk(x.re + y.re, x.im + y.im); }
QNM_HD cplx operator-(cplx x, cplx y) { return mk(x.re - y.re, x.im - y.im); }
QNM_HD cplx operator-(cplx x) { return mk(-x.re, -x.im); }
QNM_HD cplx operator*(cplx x, double y) { return mk(x.re * y, x.im * y); }
QNM_HD cplx operator*(double y, cplx x) { return mk(y * x.re, y * x.im); }
QNM_HD cplx operator*(cplx x, cplx y) {
  return mk(x.re * y.re - x.im * y.im, x.re * y.im + x.im * y.re);
}
QNM_HD cplx conj(cplx x) { return mk(x.re, -x.im); }
// Smith's division.
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
// LAPACK's CABS1, |re| + |im|.
QNM_HD double cabs1(cplx x) { return fabs(x.re) + fabs(x.im); }
QNM_HD double norm2(cplx x) { return fma(x.re, x.re, x.im * x.im); }
QNM_HD bool finite(cplx x) {
  return fabs(x.re) <= DBL_MAX && fabs(x.im) <= DBL_MAX;  // false for NaN
}
// |x| by one square root where neither square over- nor underflows, else
// hypot.
QNM_HD double cabs_fast(cplx x) {
  const double m = fmax(fabs(x.re), fabs(x.im));
  return m > 1e-150 && m < 1e150 ? sqrt(norm2(x)) : hypot(x.re, x.im);
}
// x / y by one reciprocal of |y|^2 where that neither over- nor
// underflows, else Smith's division.
QNM_HD cplx cdiv_fast(cplx x, cplx y) {
  const double d = norm2(y);
  if (!(d > 1e-290 && d < 1e290)) return x / y;
  const double u = 1.0 / d;
  return mk(fma(x.re, y.re, x.im * y.im) * u,
            fma(x.im, y.re, -(x.re * y.im)) * u);
}
// Principal square root (branch cut on the negative real axis).
QNM_HD cplx csqrt_(cplx z) {
  if (z.re == 0.0 && z.im == 0.0) return mk(0.0, z.im);
  const double t = sqrt(0.5 * (fabs(z.re) + cabs_fast(z)));
  if (z.re >= 0.0) return mk(t, z.im / (2.0 * t));
  return mk(fabs(z.im) / (2.0 * t), copysign(t, z.im));
}

// The warp's view of one matrix: H row-major with leading dimension ld.
struct Mat {
  cplx* h;
  int ld;
  QNM_HD cplx& operator()(int r, int c) const { return h[r * ld + c]; }
};

// A sum over the warp, each lane adding its share (the values of the
// loop indices it takes): on the card a butterfly of shuffles, after which
// every lane holds the same sum (each level adds the same two numbers on
// both lanes of a pair); the host build keeps the 32 lanes' partial sums
// (by index mod 32, as the lanes take them) and runs the same tree.
struct LaneSum {
#ifdef __CUDA_ARCH__
  double p = 0.0;
  __device__ __forceinline__ void add(int, double x) { p += x; }
  __device__ __forceinline__ double total() const {
    double q = p;
    for (int off = 16; off; off >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, off);
    return q;
  }
#else
  double p[32] = {0.0};
  void add(int j, double x) { p[j % 32] += x; }
  double total() const {
    double q[32], t[32];
    for (int j = 0; j < 32; ++j) q[j] = p[j];
    for (int off = 16; off; off >>= 1) {
      for (int j = 0; j < 32; ++j) t[j] = q[j] + q[j ^ off];
      for (int j = 0; j < 32; ++j) q[j] = t[j];
    }
    return q[0];
  }
#endif
};

// Sum of |H(r, col)|^2 over rows r0 <= r < r1.
QNM_HD double column_norm2(const Mat& H, int r0, int r1, int col, int lane) {
  LaneSum sum;
  QNM_LANES(r, r0, r1) sum.add(r - r0, norm2(H(r, col)));
  return sum.total();
}

// Whether any lane's flag is set (host: the one flag).
QNM_HD bool warp_any(bool flag) {
#ifdef __CUDA_ARCH__
  return __any_sync(0xffffffffu, flag);
#else
  return flag;
#endif
}

// M(c) - shift I in H: the band of each row from the bands, every other
// entry of columns [0, n) zero.  The lanes take the rows.  Returns
// ||M(c)||_F^2 (the shift left out), or -1 when an entry of M(c) is not
// finite.
QNM_HD double build(const Mat& H, const double* bands, int n, int s, cplx c,
                    cplx shift, int lane) {
  const cplx tcs = mk(2.0 * c.re, 2.0 * c.im) * static_cast<double>(s);
  const cplx c2 = c * c;
  const double* lam0 = bands;
  const double* x = bands + 2 * n;   // X at offset 0; -1 and +1 beside
  const double* x2 = bands + 6 * n;  // X^2 at offset 0; -2..+2 beside
  LaneSum fro2;
  bool bad = false;
  QNM_LANES(r, 0, n) {
    for (int col = 0; col < n; ++col) H(r, col) = mk(0.0, 0.0);
    const int lo = r >= 2 ? r - 2 : 0, hi = r + 2 < n ? r + 2 : n - 1;
    for (int col = lo; col <= hi; ++col) {
      const int d = col - r;
      const double xv = (d >= -1 && d <= 1) ? x[d * n + r] : 0.0;
      const double x2v = x2[d * n + r];
      cplx v = mk(d == 0 ? lam0[r] : 0.0, 0.0) + tcs * xv;
      v = v - c2 * x2v;
      fro2.add(r, norm2(v));
      bad = bad || !finite(v);
      H(r, col) = d == 0 ? v - shift : v;
    }
  }
  QNM_SYNC();
  return warp_any(bad) ? -1.0 : fro2.total();
}

// One past the last row r > k with H(r, k) nonzero (k + 1 if none).
QNM_HD int column_end(const Mat& H, int k, int n, int lane) {
#ifdef __CUDA_ARCH__
  for (int top = n - 1; top > k; top -= 32) {
    const int r = top - lane;
    const bool nz = r > k && (H(r, k).re != 0.0 || H(r, k).im != 0.0);
    const unsigned mask = __ballot_sync(0xffffffffu, nz);
    if (mask) return top - (__ffs(mask) - 1) + 1;
  }
  return k + 1;
#else
  (void)lane;
  for (int r = n - 1; r > k; --r)
    if (H(r, k).re != 0.0 || H(r, k).im != 0.0) return r + 1;
  return k + 1;
#endif
}

// Householder reduction of H to upper Hessenberg form, H <- Q^H H Q, with
// zlarfg's reflectors I - tau v v^H (v_0 = 1); V holds v.  Entries below
// the subdiagonal end exactly zero.  The band fills in one row a step
// (column k reaches row 2k + 2 at most), so v, and the work, stop at the
// column's last nonzero row: the terms left out are exact zeros.  Adds
// its FP64 operations to *ops.
QNM_HD void hessenberg(const Mat& H, cplx* V, int n, long long* ops,
                       int lane) {
  for (int k = 0; k + 2 < n; ++k) {
    const int end = column_end(H, k, n, lane);
    const cplx alpha = H(k + 1, k);
    const double xnorm2 = column_norm2(H, k + 2, end, k, lane);
    if (xnorm2 == 0.0 && alpha.im == 0.0) continue;  // tau = 0
    const double beta =
        -copysign(sqrt(alpha.re * alpha.re + alpha.im * alpha.im + xnorm2),
                  alpha.re);
    const cplx tau = mk((beta - alpha.re) / beta, -alpha.im / beta);
    const cplx scal = cdiv_fast(mk(1.0, 0.0), alpha - mk(beta, 0.0));
    QNM_LANES(r, k + 2, end) V[r] = scal * H(r, k);
    if (lane == 0) V[k + 1] = mk(1.0, 0.0);
    QNM_SYNC();
    // Each of the n - k - 1 columns and n rows below: len multiply-adds
    // for the product with v, one complex product, len for the update.
    const long long len = end - k - 1;
    *ops += (2LL * n - k - 1) * (2 * kMaddOps * len + kMulOps);
    // From the left, H(k+1:, k+1:) -= conj(tau) v (v^H H(k+1:, k+1:)):
    // a lane a column.
    const cplx ctau = conj(tau);
    QNM_LANES(col, k + 1, n) {
      cplx w = mk(0.0, 0.0);
      for (int r = k + 1; r < end; ++r) {
        const cplx v = V[r], h = H(r, col);
        w = mk(fma(v.re, h.re, fma(v.im, h.im, w.re)),
               fma(v.re, h.im, fma(-v.im, h.re, w.im)));
      }
      const cplx tw = ctau * w;
      for (int r = k + 1; r < end; ++r) {
        const cplx v = V[r], h = H(r, col);
        H(r, col) = mk(fma(-v.re, tw.re, fma(v.im, tw.im, h.re)),
                       fma(-v.re, tw.im, fma(-v.im, tw.re, h.im)));
      }
    }
    // Column k: beta on the subdiagonal, zeros below.
    QNM_LANES(r, k + 1, end) H(r, k) = mk(r == k + 1 ? beta : 0.0, 0.0);
    QNM_SYNC();
    // From the right, H(:, k+1:) -= tau (H(:, k+1:) v) v^H: a lane a row.
    QNM_LANES(row, 0, n) {
      cplx y = mk(0.0, 0.0);
      for (int r = k + 1; r < end; ++r) {
        const cplx v = V[r], h = H(row, r);
        y = mk(fma(h.re, v.re, fma(-h.im, v.im, y.re)),
               fma(h.re, v.im, fma(h.im, v.re, y.im)));
      }
      const cplx ty = tau * y;
      for (int r = k + 1; r < end; ++r) {
        const cplx v = V[r], h = H(row, r);
        H(row, r) = mk(fma(-ty.re, v.re, fma(-ty.im, v.im, h.re)),
                       fma(-ty.im, v.re, fma(ty.re, v.im, h.im)));
      }
    }
    QNM_SYNC();
  }
}

// zlahqr's test of the subdiagonal entry H(k, k-1), k in (l, i].
QNM_HD bool negligible(const Mat& H, int k, int n, double smlnum) {
  const cplx sub = H(k, k - 1);
  const double s1 = cabs1(sub);
  if (s1 <= smlnum) return true;
  double tst = cabs1(H(k - 1, k - 1)) + cabs1(H(k, k));
  if (tst == 0.0) {
    if (k - 2 >= 0) tst += cabs1(H(k - 1, k - 2));
    if (k + 1 <= n - 1) tst += cabs1(H(k + 1, k));
  }
  if (s1 > kUlp * tst) return false;
  const double up = cabs1(H(k - 1, k));
  const double ab = fmax(s1, up), ba = fmin(s1, up);
  const cplx dd = H(k - 1, k - 1) - H(k, k);
  const double aa = fmax(cabs1(H(k, k)), cabs1(dd));
  const double bb = fmin(cabs1(H(k, k)), cabs1(dd));
  const double sc = aa + ab;
  return ba * (ab / sc) <= fmax(smlnum, kUlp * (bb * (aa / sc)));
}

// The largest k in (l, i] whose subdiagonal is negligible, else l.
QNM_HD int find_split(const Mat& H, int l, int i, int n, double smlnum,
                      int lane) {
#ifdef __CUDA_ARCH__
  for (int top = i; top > l; top -= 32) {
    const int k = top - lane;
    const bool small = k > l && negligible(H, k, n, smlnum);
    const unsigned mask = __ballot_sync(0xffffffffu, small);
    if (mask) return top - (__ffs(mask) - 1);
  }
  return l;
#else
  (void)lane;
  for (int k = i; k > l; --k)
    if (negligible(H, k, n, smlnum)) return k;
  return l;
#endif
}

// The trailing 2 x 2 block's eigenvalue nearer H(i, i) (zlahqr's
// Wilkinson shift): t - u^2 / (x + y), t = H(i, i), u^2 = H(i-1, i)
// H(i, i-1), x = (H(i-1, i-1) - t) / 2, y = sqrt(x^2 + u^2) on the branch
// with Re(conj(x) y) >= 0, u^2 / (x + y) by one reciprocal.  zlahqr scales
// x and u by max(|x|, |u|) first (two square roots and four divisions
// more), which only matters where x^2 or u^2 would overflow: there, and
// only there, this takes its scaled form.
QNM_HD cplx wilkinson(const Mat& H, int i) {
  const cplx t = H(i, i);
  const cplx u2 = H(i - 1, i) * H(i, i - 1);
  if (u2.re == 0.0 && u2.im == 0.0) return t;
  const cplx x = 0.5 * (H(i - 1, i - 1) - t);
  const cplx x2u2 = x * x + u2;
  if (finite(x2u2)) {
    cplx y = csqrt_(x2u2);
    if (x.re * y.re + x.im * y.im < 0.0) y = -y;
    return t - cdiv_fast(u2, x + y);
  }
  const cplx u = csqrt_(H(i - 1, i)) * csqrt_(H(i, i - 1));
  const double sx = cabs1(x), s = fmax(cabs1(u), sx);
  const cplx xs = x / s, us = u / s;
  cplx y = s * csqrt_(xs * xs + us * us);
  if (sx > 0.0 && (x.re / sx) * y.re + (x.im / sx) * y.im < 0.0) y = -y;
  return t - u * (u / (x + y));
}

// Both eigenvalues of the trailing 2 x 2 block, the shifts of a team's
// two bulges (zlaqr5's shifts from the trailing block, two of them): the
// nearer one as ``wilkinson`` computes it, the other t + x + y.  False
// where x^2 + u^2 is not finite (the iteration then takes one shift).
QNM_HD bool shift_pair(const Mat& H, int i, cplx* near, cplx* far) {
  const cplx t = H(i, i);
  const cplx u2 = H(i - 1, i) * H(i, i - 1);
  if (u2.re == 0.0 && u2.im == 0.0) {
    *near = t;
    *far = H(i - 1, i - 1);
    return true;
  }
  const cplx x = 0.5 * (H(i - 1, i - 1) - t);
  const cplx x2u2 = x * x + u2;
  if (!finite(x2u2)) return false;
  cplx y = csqrt_(x2u2);
  if (x.re * y.re + x.im * y.im < 0.0) y = -y;
  *near = t - cdiv_fast(u2, x + y);
  *far = t + (x + y);
  return true;
}

// 1 / sqrt(p) for a normal p by Newton's iteration from a seed read off
// p's bits (relative error below 0.035): four steps of y <- y + y (1/2 -
// p y^2 / 2), fused multiply-adds only, leave it within a few ulp: 12
// dependent operations against IEEE sqrt's and division's 141 cycles, no
// branch and no division; the host build takes the same steps and rounds
// alike.
QNM_HD double rsqrt_newton(double p) {
  uint64_t bits;
  memcpy(&bits, &p, sizeof bits);
  bits = 0x5FE6EB50C7B537A9ULL - (bits >> 1);
  double y;
  memcpy(&y, &bits, sizeof y);
  const double h = 0.5 * p;
  for (int step = 0; step < 4; ++step) y = fma(y, fma(-(h * y), y, 0.5), y);
  return y;
}

// The Givens rotation G = [[c, s], [-conj(s), c]] (c real) with
// G [f; g] = [r; 0] (zlartg).  With p = |f|^2 (|f|^2 + |g|^2) in the
// range where it neither overflows nor underflows (every rotation of the
// solver's matrices): u = 1 / sqrt(p) (``rsqrt_newton``), c = |f|^2 u,
// s = f conj(g) u, r = f (|f|^2 + |g|^2) u; ``rotation_fast`` computes
// that, and says whether p was in range.  Otherwise ``rotation_scaled``,
// from the scaled moduli.
QNM_HD bool rotation_fast(cplx f, cplx g, double* c, cplx* s, cplx* r) {
  const double f2 = norm2(f), g2 = norm2(g), d2 = f2 + g2, p = f2 * d2;
  const double u = rsqrt_newton(p);
  *c = f2 * u;
  *s = (f * conj(g)) * u;
  *r = f * (d2 * u);
  return p > 1e-290 && p < 1e290;
}
QNM_HD void rotation_scaled(cplx f, cplx g, double* c, cplx* s, cplx* r) {
  const double ga = cabs_(g);
  if (ga == 0.0) {
    *c = 1.0;
    *s = mk(0.0, 0.0);
    *r = f;
    return;
  }
  const double fa = cabs_(f);
  if (fa == 0.0) {
    *c = 0.0;
    *s = conj(g) / ga;
    *r = mk(ga, 0.0);
    return;
  }
  const double d = hypot(fa, ga);
  const cplx fs = f / fa;
  *c = fa / d;
  *s = (fs * conj(g)) / d;
  *r = fs * d;
}
QNM_HD void rotation(cplx f, cplx g, double* c, cplx* s, cplx* r) {
  if (!rotation_fast(f, g, c, s, r)) rotation_scaled(f, g, c, s, r);
}

// A rotation from the left of the pair (a, b) = (H(k, col), H(k+1, col)),
// and from the right of the pair (a, b) = (H(row, k), H(row, k+1)): ms =
// -conj(s), cs = conj(s).  Every update of an entry by a rotation is one of
// these two, on the card and in the host build alike; each real part is one
// product and two fused multiply-adds (fma: DFMA on the card, the correctly
// rounded std::fma on the host, so both round alike).
QNM_HD cplx mix(double c, cplx x, cplx u, cplx y) {  // c x + u y
  return mk(fma(u.re, y.re, fma(-u.im, y.im, c * x.re)),
            fma(u.re, y.im, fma(u.im, y.re, c * x.im)));
}
QNM_HD void rot_rows(double c, cplx s, cplx ms, cplx* a, cplx* b) {
  const cplx x = *a, y = *b;
  *a = mix(c, x, s, y);
  *b = mix(c, y, ms, x);
}
QNM_HD void rot_cols(double c, cplx s, cplx cs, cplx* a, cplx* b) {
  const cplx x = *a, y = *b;
  *a = mix(c, x, cs, y);
  *b = mix(c, y, -s, x);
}

// One single-shift QR sweep over the active block [l, i]: at each step k =
// l..i-1 the rotation from (H(l, l) - shift, H(l+1, l)) at the first, else
// from the bulge (H(k, k-1), H(k+1, k-1)); from the left to rows k, k+1 of
// columns k-1..i (column k-1 becomes (r, 0)), then from the right to
// columns k, k+1 of rows l..min(k+2, i).  Adds its FP64 operations to
// *ops.
#ifndef __CUDA_ARCH__
QNM_HD void qr_sweep(const Mat& H, int l, int i, cplx shift, long long* ops,
                     int lane) {
  (void)lane;
  for (int k = l; k < i; ++k) {
    const cplx f = k == l ? H(l, l) - shift : H(k, k - 1);
    const cplx g = k == l ? H(l + 1, l) : H(k + 1, k - 1);
    double c;
    cplx s, r;
    rotation(f, g, &c, &s, &r);
    if (k > l) {
      H(k, k - 1) = r;
      H(k + 1, k - 1) = mk(0.0, 0.0);
    }
    const cplx ms = -conj(s), cs = conj(s);
    for (int col = k; col <= i; ++col)
      rot_rows(c, s, ms, &H(k, col), &H(k + 1, col));
    const int last = k + 2 < i ? k + 2 : i;
    *ops += kPairOps * ((i - k + 1) + (last - l + 1));
    for (int row = l; row <= last; ++row)
      rot_cols(c, s, cs, &H(row, k), &H(row, k + 1));
  }
}

// A team's QR iteration on two bulges, in the order of the card's ticks
// (``team_sweep``): at tick t bulge 0 takes step l + t of a single-shift
// sweep with shift[0] and bulge 1 step l + t - 2 with shift[1]; both
// rotations from the tick's entries, then both left passes (and column
// k-1 to (r, 0)), then both right passes.  Two steps apart, the bulges'
// passes of a tick touch disjoint entries, and each bulge's step reads
// what the other's earlier steps wrote as a sweep after a sweep would.
QNM_HD void double_sweep(const Mat& H, int l, int i, const cplx* shift,
                         int lane) {
  (void)lane;
  for (int t = 0; t < i - l + 2; ++t) {
    int k[2];
    double c[2];
    cplx s[2], r[2];
    for (int b = 0; b < 2; ++b) {
      k[b] = l + t - 2 * b;
      if (k[b] < l || k[b] >= i) continue;
      const int kb = k[b];
      const cplx f = kb == l ? H(l, l) - shift[b] : H(kb, kb - 1);
      const cplx g = kb == l ? H(l + 1, l) : H(kb + 1, kb - 1);
      rotation(f, g, &c[b], &s[b], &r[b]);
    }
    for (int b = 0; b < 2; ++b) {
      const int kb = k[b];
      if (kb < l || kb >= i) continue;
      const cplx ms = -conj(s[b]);
      for (int col = kb; col <= i; ++col)
        rot_rows(c[b], s[b], ms, &H(kb, col), &H(kb + 1, col));
      if (kb > l) {
        H(kb, kb - 1) = r[b];
        H(kb + 1, kb - 1) = mk(0.0, 0.0);
      }
    }
    for (int b = 0; b < 2; ++b) {
      const int kb = k[b];
      if (kb < l || kb >= i) continue;
      const cplx cs = conj(s[b]);
      const int last = kb + 2 < i ? kb + 2 : i;
      for (int row = l; row <= last; ++row)
        rot_cols(c[b], s[b], cs, &H(row, kb), &H(row, kb + 1));
    }
  }
}
#else
// On the card a step is the host build's in two phases: every lane
// computes the rotation (from the bulge's entries in shared memory); the
// lanes take the columns of the left rotation, a barrier, lane 0 writes
// column k-1 (r, 0), the lanes take the rows of the right rotation, a
// barrier.  A lane takes the columns and rows q = lane + 32 u, u < S
// (S = 1 while i < 32, 2 while i < 64; larger orders loop,
// ``qr_sweep_looped``), and
// loads at the top of the step every pair it will rotate that no lane
// writes in the step before it rotates it: its left pair, and its right
// pair but in the window's rows k, k+1, which it loads after the first
// barrier; so the loads wait under the rotation (``rotation_fast``: no
// branch; the rare scaled one after).  Every lane has read the rotation's
// entries before the first barrier (the first step's, H(l, l) and
// H(l+1, l), which its left rotation writes, before a barrier of its own,
// which also orders the shift's reads before the sweep's writes), and
// lane 0 writes column k-1 after it.
__device__ __forceinline__ void step_rotation(const Mat& H, int l, int k,
                                              cplx shift, double* c,
                                              cplx* s, cplx* r) {
  const cplx f = k == l ? H(l, l) - shift : H(k, k - 1);
  const cplx g = k == l ? H(l + 1, l) : H(k + 1, k - 1);
  if (!rotation_fast(f, g, c, s, r)) rotation_scaled(f, g, c, s, r);
}

// Orders of 64 and more: the lanes loop over their columns and rows, each
// pair loaded where it is rotated.
__device__ __forceinline__ void qr_sweep_looped(const Mat& H, int l, int i,
                                                cplx shift, long long* ops,
                                                int lane) {
  for (int k = l; k < i; ++k) {
    double c;
    cplx s, r;
    step_rotation(H, l, k, shift, &c, &s, &r);
    if (k == l) __syncwarp();
    const cplx ms = -conj(s), cs = conj(s);
    for (int col = k + lane; col <= i; col += 32)
      rot_rows(c, s, ms, &H(k, col), &H(k + 1, col));
    __syncwarp();
    const int last = k + 2 < i ? k + 2 : i;
    if (k > l && lane == 0) {
      H(k, k - 1) = r;
      H(k + 1, k - 1) = mk(0.0, 0.0);
    }
    *ops += kPairOps * ((i - k + 1) + (last - l + 1));
    for (int row = l + lane; row <= last; row += 32)
      rot_cols(c, s, cs, &H(row, k), &H(row, k + 1));
    __syncwarp();
  }
}

// Orders below 32 S: each lane's pairs loaded at the top of the step.
template <int S>
__device__ __forceinline__ void qr_sweep_slots(const Mat& H, int l, int i,
                                               cplx shift, long long* ops,
                                               int lane) {
  for (int k = l; k < i; ++k) {
    QNM_COUNT(5)
    QNM_CLOCK(qt0)
    const int last = k + 2 < i ? k + 2 : i;
    cplx la[S], lb[S], ra[S], rb[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int q = lane + 32 * u;
      if (q >= k && q <= i) {
        la[u] = H(k, q);
        lb[u] = H(k + 1, q);
      }
      if (q >= l && q <= last && q != k && q != k + 1) {
        ra[u] = H(q, k);
        rb[u] = H(q, k + 1);
      }
    }
    double c;
    cplx s, r;
    step_rotation(H, l, k, shift, &c, &s, &r);
    if (k == l) __syncwarp();
    QNM_SPAN(qt0, 8)
    QNM_CLOCK(qt1)
    const cplx ms = -conj(s), cs = conj(s);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int q = lane + 32 * u;
      if (q >= k && q <= i) {
        rot_rows(c, s, ms, &la[u], &lb[u]);
        H(k, q) = la[u];
        H(k + 1, q) = lb[u];
      }
    }
    __syncwarp();
    QNM_SPAN(qt1, 9)
    QNM_CLOCK(qt2)
    if (k > l && lane == 0) {
      H(k, k - 1) = r;
      H(k + 1, k - 1) = mk(0.0, 0.0);
    }
    *ops += kPairOps * ((i - k + 1) + (last - l + 1));
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const int q = lane + 32 * u;
      if (q < l || q > last) continue;
      if (q == k || q == k + 1) {
        ra[u] = H(q, k);
        rb[u] = H(q, k + 1);
      }
      rot_cols(c, s, cs, &ra[u], &rb[u]);
      H(q, k) = ra[u];
      H(q, k + 1) = rb[u];
    }
    __syncwarp();
    QNM_SPAN(qt2, 10)
  }
}

__device__ __forceinline__ void qr_sweep(const Mat& H, int l, int i,
                                         cplx shift, long long* ops,
                                         int lane) {
  if (i >= 64)
    qr_sweep_looped(H, l, i, shift, ops, lane);
  else if (i >= 32)
    qr_sweep_slots<2>(H, l, i, shift, ops, lane);
  else
    qr_sweep_slots<1>(H, l, i, shift, ops, lane);
}

// A team's QR iteration on two bulges (``double_sweep`` is its host
// order): warp ``role`` chases bulge ``role``, step k = l + t - 2 role at
// tick t, with its own shift.  A tick is a step of ``qr_sweep_slots`` with
// the team's barrier in place of the warp's: the lanes' pairs loaded,
// the rotation, a __syncwarp (every lane has read the rotation's
// entries), the left pass and lane 0's column k-1; the team's barrier;
// the right pass, the pairs in rows that a left pass of the tick wrote
// (either bulge's k, k+1) loaded only now; the team's barrier.
template <int S>
__device__ __forceinline__ void team_sweep(const Mat& H, int l, int i,
                                           cplx shift, int role, int bar,
                                           int lane) {
  for (int t = 0; t < i - l + 2; ++t) {
    const int k = l + t - 2 * role, ko = role == 0 ? k - 2 : k + 2;
    const bool on = k >= l && k < i, other = ko >= l && ko < i;
    const int last = k + 2 < i ? k + 2 : i;
    double c = 1.0;
    cplx s = mk(0.0, 0.0), r;
    cplx la[S], lb[S], ra[S], rb[S];
    if (role == 0) {
      QNM_COUNT(6)
    }
    if (on) {
      QNM_COUNT(5)
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int q = lane + 32 * u;
        if (q >= k && q <= i) {
          la[u] = H(k, q);
          lb[u] = H(k + 1, q);
        }
        const bool late = q == k || q == k + 1 ||
                          (other && (q == ko || q == ko + 1));
        if (q >= l && q <= last && !late) {
          ra[u] = H(q, k);
          rb[u] = H(q, k + 1);
        }
      }
      step_rotation(H, l, k, shift, &c, &s, &r);
      __syncwarp();
      const cplx ms = -conj(s);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int q = lane + 32 * u;
        if (q >= k && q <= i) {
          rot_rows(c, s, ms, &la[u], &lb[u]);
          H(k, q) = la[u];
          H(k + 1, q) = lb[u];
        }
      }
      if (k > l && lane == 0) {
        H(k, k - 1) = r;
        H(k + 1, k - 1) = mk(0.0, 0.0);
      }
    }
    QNM_TEAM_BAR(bar);
    if (on) {
      const cplx cs = conj(s);
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int q = lane + 32 * u;
        if (q < l || q > last) continue;
        if (q == k || q == k + 1 || (other && (q == ko || q == ko + 1))) {
          ra[u] = H(q, k);
          rb[u] = H(q, k + 1);
        }
        rot_cols(c, s, cs, &ra[u], &rb[u]);
        H(q, k) = ra[u];
        H(q, k + 1) = rb[u];
      }
    }
    QNM_TEAM_BAR(bar);
  }
}

__device__ __forceinline__ void team_sweep_at(const Mat& H, int l, int i,
                                              cplx shift, int role, int bar,
                                              int lane) {
  if (i >= 32)
    team_sweep<2>(H, l, i, shift, role, bar, lane);
  else
    team_sweep<1>(H, l, i, shift, role, bar, lane);
}
#endif

// The FP64 operations of a single-shift sweep over [l, i], as
// ``qr_sweep`` counts them.
QNM_HD long long sweep_ops(int l, int i) {
  long long ops = 0;
  for (int k = l; k < i; ++k) {
    const int last = k + 2 < i ? k + 2 : i;
    ops += kPairOps * ((i - k + 1) + (last - l + 1));
  }
  return ops;
}

// The leader's word to the team's second warp, after the matrix's memory:
// op 1 chase the second bulge of [l, i] with ``shift``, op 0 done.
struct alignas(16) TeamCmd {
  int op, l, i, pad;
  cplx shift;
};

// The warps on one matrix: size 1, or 2 (a QR iteration chases two
// bulges, a warp each, where the active block has kTeamMinOrder rows or
// more and fewer than 64); on the card the team's named barrier and its
// word.  The first warp (the leader) does all else.
struct Team {
  int size, bar;
  TeamCmd* cmd;
};

// The team's QR iteration on [l, i] with the shifts pair[0] (the
// leader's bulge) and pair[1].
QNM_HD void team_iteration(const Mat& H, int l, int i, const cplx* pair,
                           const Team& team, int lane) {
#ifdef __CUDA_ARCH__
  if (lane == 0) {
    team.cmd->op = 1;
    team.cmd->l = l;
    team.cmd->i = i;
    team.cmd->shift = pair[1];
  }
  QNM_TEAM_BAR(team.bar);
  team_sweep_at(H, l, i, pair[0], 0, team.bar, lane);
#else
  (void)team;
  double_sweep(H, l, i, pair, lane);
#endif
}

// Every eigenvalue of the Hessenberg H into W (W[i] the one deflated at
// row i).  Returns the sweeps run (a team's iteration on two bulges counts
// two), or -1 when an eigenvalue took more than max_its QR iterations;
// adds the sweeps' FP64 operations to *ops.
QNM_HD int hqr(const Mat& H, cplx* W, int n, int max_its, long long* ops,
               const Team& team, int lane) {
  const double smlnum = kSafeMin * (static_cast<double>(n) / kUlp);
  int sweeps = 0, i = n - 1;
  while (i >= 0) {
    int l = 0, kdefl = 0;
    bool deflated = false;
    for (int its = 0; its <= max_its; ++its) {
      QNM_CLOCK(t_split)
      l = find_split(H, l, i, n, smlnum, lane);
      QNM_SPAN(t_split, 2)
      // Every lane read H(l, l-1) before the vote; nothing reads it again
      // before the sweep's barriers.
      if (l > 0 && lane == 0) H(l, l - 1) = mk(0.0, 0.0);
      if (l >= i) {
        deflated = true;
        break;
      }
      QNM_CLOCK(t_shift)
      ++kdefl;
      cplx shift = mk(0.0, 0.0), pair[2];
      bool two = false;
      if (kdefl % (2 * kExceptional) == 0)
        shift = H(i, i) + mk(kExceptionalScale * cabs1(H(i, i - 1)), 0.0);
      else if (kdefl % kExceptional == 0)
        shift = H(l, l) + mk(kExceptionalScale * cabs1(H(l + 1, l)), 0.0);
      else if (team.size > 1 && i - l + 1 >= kTeamMinOrder && i < 64 &&
               shift_pair(H, i, &pair[0], &pair[1]))
        two = true;
      else
        shift = wilkinson(H, i);
      QNM_SPAN(t_shift, 3)
      QNM_CLOCK(t_sweep)
      // The sweep's first step waits on a barrier before it writes: every
      // lane has read the shift's entries by then.
      if (two) {
        team_iteration(H, l, i, pair, team, lane);
        *ops += 2 * sweep_ops(l, i);
        sweeps += 2;
      } else {
        qr_sweep(H, l, i, shift, ops, lane);
        ++sweeps;
      }
      QNM_SPAN(t_sweep, 1)
    }
    if (!deflated) return -1;
    if (lane == 0) W[i] = H(i, i);
    i = l - 1;
  }
  QNM_SYNC();
  return sweeps;
}

// The right eigenvector of M for the eigenvalue lambda, by inverse
// iteration: H holds M - lambda I (``build``), which is factored in place
// (band LU with partial pivoting; L's multipliers below the diagonal,
// U's upper bandwidth 4) by lane 0; V returns the vector, scaled so that
// entry ``sel`` is real and positive, with unit norm.  Adds the LU's and
// the solves' multiply-adds to *ops (lane 0's).
QNM_HD void eigvec(const Mat& H, cplx* V, int* piv, int n, int sel,
                   double anorm, long long* ops, int lane) {
  if (lane == 0) {
    const double tiny = kUlp * (anorm > 0.0 ? anorm : 1.0);
    for (int k = 0; k < n; ++k) {
      const int rmax = k + 2 < n ? k + 2 : n - 1;
      const int cmax = k + 4 < n ? k + 4 : n - 1;
      int p = k;
      for (int r = k + 1; r <= rmax; ++r)
        if (cabs1(H(r, k)) > cabs1(H(p, k))) p = r;
      piv[k] = p;
      if (p != k)
        for (int col = k; col <= cmax; ++col) {
          const cplx t = H(k, col);
          H(k, col) = H(p, col);
          H(p, col) = t;
        }
      if (cabs1(H(k, k)) == 0.0) H(k, k) = mk(tiny, 0.0);
      const cplx piv_kk = H(k, k);
      *ops += kMaddOps * (rmax - k) * (cmax - k);
      for (int r = k + 1; r <= rmax; ++r) {
        const cplx lr = cdiv_fast(H(r, k), piv_kk);
        H(r, k) = lr;
        for (int col = k + 1; col <= cmax; ++col)
          H(r, col) = H(r, col) - lr * H(k, col);
      }
    }
    for (int r = 0; r < n; ++r) V[r] = mk(1.0, 0.0);
    for (int step = 0; step < kInverseSteps; ++step) {
      // L y = P x, then U z = y.
      for (int k = 0; k < n; ++k) {
        const int rmax = k + 2 < n ? k + 2 : n - 1;
        const int cmax = k + 4 < n ? k + 4 : n - 1;
        *ops += kMaddOps * ((rmax - k) + (cmax - k));
        const int p = piv[k];
        if (p != k) {
          const cplx t = V[k];
          V[k] = V[p];
          V[p] = t;
        }
        for (int r = k + 1; r <= rmax; ++r) V[r] = V[r] - H(r, k) * V[k];
      }
      double big = 0.0;
      for (int k = n - 1; k >= 0; --k) {
        const int cmax = k + 4 < n ? k + 4 : n - 1;
        cplx y = V[k];
        for (int col = k + 1; col <= cmax; ++col) y = y - H(k, col) * V[col];
        V[k] = cdiv_fast(y, H(k, k));
        big = fmax(big, cabs1(V[k]));
      }
      for (int r = 0; r < n; ++r) V[r] = V[r] / big;
    }
    // The phase rule, then the unit norm.
    const cplx d = V[sel];
    if (d.re != 0.0 || d.im != 0.0) {
      const cplx phase = mk(cabs_(d), 0.0) / d;
      for (int r = 0; r < n; ++r) V[r] = V[r] * phase;
    }
    double sq = 0.0;
    for (int r = 0; r < n; ++r) sq += norm2(V[r]);
    const double nrm = sqrt(sq);
    for (int r = 0; r < n; ++r) V[r] = V[r] / nrm;
  }
  QNM_SYNC();
}

// A launch's arguments: B matrices of order n; c, guess, eig, A, C
// interleaved complex; guess, A and C null in values mode; ws null for
// shared memory, else a global workspace of B x warp_entries(n) entries.
struct Args {
  long long B;
  int n, s, sel, max_its, warps, team;  // matrices a block, warps a matrix
  const cplx* c;        // (B,)
  const cplx* guess;    // (B,) or null (values mode)
  const double* bands;  // (9, n)
  cplx* eig;            // (B, n)
  cplx* A;              // (B,) (vectors mode)
  cplx* C;              // (B, n) (vectors mode)
  long long* info;      // (B, 2)
  cplx* ws;             // (B, matrix_entries(n, team)) or null
};

// A warp's entries of memory (n ld + 3n complex).
QNM_HD long long warp_entries(int n) {
  return static_cast<long long>(n) * (n | 1) + 3LL * n;
}

// A matrix's entries: a warp's, and a team's word (two entries) after
// them where a team of two warps takes it.
QNM_HD long long matrix_entries(int n, int team) {
  return warp_entries(n) + (team > 1 ? 2 : 0);
}

// Vectors mode of matrix b, its eigenvalues in W: the eigenvalue nearest
// its guess (every lane the same scan) into A, that eigenvalue's vector
// into C; adds the inverse iteration's operations to *ops.
QNM_HD void select_vector(const Args& a, long long b, const Mat& H,
                          const cplx* W, cplx* V, long long* ops, int lane) {
  const int n = a.n;
  const cplx guess = a.guess[b];
  int best = 0;
  double dbest = cabs_(W[0] - guess);
  for (int k = 1; k < n; ++k) {
    const double dk = cabs_(W[k] - guess);
    if (dk < dbest) {
      dbest = dk;
      best = k;
    }
  }
  const cplx lambda = W[best];
  const double fro2 = build(H, a.bands, n, a.s, a.c[b], lambda, lane);
  eigvec(H, V, reinterpret_cast<int*>(V + n), n, a.sel, sqrt(fro2), ops,
         lane);
  if (lane == 0) a.A[b] = lambda;
  QNM_LANES(k, 0, n) a.C[b * n + k] = V[k];
}

// The eigenproblem of matrix b, on the team's memory ``mem`` (the
// leader's part where two warps take it).  Writes its
// eigenvalues, and in vectors mode the eigenvalue nearest its guess and
// that eigenvalue's vector; info (QR sweeps, FP64 operations), the sweeps
// -1 when an eigenvalue did not converge within max_its and -2 when the
// matrix is not finite.  The outputs' addresses are read from ``a`` where
// they are written, so no register holds them through the iteration.
QNM_HD void solve_one(const Args& a, long long b, cplx* mem,
                      const Team& team, int lane) {
  QNM_CLOCK(t_solve)
  const int n = a.n;
  const Mat H{mem, n | 1};
  cplx* W = mem + static_cast<long long>(n) * (n | 1);
  cplx* V = W + n;
  if (build(H, a.bands, n, a.s, a.c[b], mk(0.0, 0.0), lane) < 0.0) {
    if (lane == 0) {
      a.info[2 * b] = -2;
      a.info[2 * b + 1] = 0;
    }
    return;
  }
  long long ops = 0;
  QNM_CLOCK(t_hh)
  hessenberg(H, V, n, &ops, lane);
  QNM_SPAN(t_hh, 0)
  const int sweeps = hqr(H, W, n, a.max_its, &ops, team, lane);
  QNM_SPAN(t_solve, 4)
  if (sweeps >= 0) {
    QNM_LANES(k, 0, n) a.eig[b * n + k] = W[k];
    if (a.guess != nullptr) select_vector(a, b, H, W, V, &ops, lane);
  }
  if (lane == 0) {
    a.info[2 * b] = sweeps;
    a.info[2 * b + 1] = ops;
  }
}

#if defined(__CUDA_ARCH__) || defined(__CUDACC__)
// The second warp of a team: each of the leader's QR iterations on two
// bulges, until its word says done.  It reads the word after the team's
// barrier; the leader writes it again only after the iteration's ticks,
// whose barriers this warp passes after reading it.
__device__ __forceinline__ void team_follow(const Mat& H, const Team& team,
                                            int lane) {
#ifdef __CUDA_ARCH__
  for (;;) {
    QNM_TEAM_BAR(team.bar);
    const TeamCmd cmd = *team.cmd;
    if (cmd.op == 0) return;
    team_sweep_at(H, cmd.l, cmd.i, cmd.shift, 1, team.bar, lane);
  }
#endif
}

// Matrix b on memory ``mem`` by its team's warp ``role`` (slot: its team
// in the block, whose named barrier is 1 + slot).
__device__ __forceinline__ void run_one(const Args& a, long long b,
                                        cplx* mem, int slot, int role,
                                        int lane) {
  const Team team{a.team, 1 + slot,
                  reinterpret_cast<TeamCmd*>(mem + warp_entries(a.n))};
  if (role > 0) {
    team_follow(Mat{mem, a.n | 1}, team, lane);
    return;
  }
  solve_one(a, b, mem, team, lane);
  if (team.size > 1) {
    if (lane == 0) team.cmd->op = 0;
    QNM_TEAM_BAR(team.bar);
  }
}
#endif

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kSmemLimit = 232448;  // a block's opt-in shared memory

// At least one block an SM: left to its default, ptxas caps the kernel
// at 72 registers and keeps the matrix's index and addresses in local
// memory (spills); with the cap lifted it spills nothing
// (scripts/torch_eig_variants.py).  The warps an SM are bounded by the
// shared memory, not by registers.  Two kernels, so that the compiler
// knows where a matrix lives: in shared memory (angular_eig_kernel: its
// loads and stores are the shared-memory instructions, not generic ones,
// which take longer), or in the global workspace
// (angular_eig_ws_kernel).  A block holds a.warps matrices of a.team
// warps each.
__global__ void __launch_bounds__(128, 1)
    angular_eig_kernel(const __grid_constant__ Args a) {
  extern __shared__ cplx smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / a.team;
  const long long b = static_cast<long long>(blockIdx.x) * a.warps + slot;
  if (b >= a.B) return;
  run_one(a, b, smem + slot * matrix_entries(a.n, a.team), slot,
          warp % a.team, lane);
}

__global__ void __launch_bounds__(128, 1)
    angular_eig_ws_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / a.team;
  const long long b = static_cast<long long>(blockIdx.x) * a.warps + slot;
  if (b >= a.B) return;
  run_one(a, b, a.ws + b * matrix_entries(a.n, a.team), slot,
          warp % a.team, lane);
}

}  // namespace

// B matrices of order n on `stream` of device `device`, `warps` matrices
// a block of `team` (1 or 2) warps each, at most 4 warps a block.  c,
// guess, eig, A, C interleaved complex; guess, A and C null in values
// mode; ws null for shared memory, else a global workspace of B x
// matrix_entries(n, team) complex entries.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int qnm_angular_eig(long long B, int n, int s, int sel,
                               int max_its, int warps, int team,
                               const double* c,
                               const double* guess, const double* bands,
                               double* eig, double* A, double* C,
                               long long* info, double* ws, int device,
                               void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || warps < 1 || team < 1 || team > 2 || warps * team > 4 ||
      max_its < 0 || sel < 0 || sel >= n ||
      (guess != nullptr && (A == nullptr || C == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = warps * matrix_entries(n, team) * 16;
  const int smem = ws != nullptr ? 0 : static_cast<int>(per_block);
  if (ws == nullptr && per_block > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The kernel's shared-memory ceiling, raised once a device to the
  // largest a launch has asked for (cudaFuncSetAttribute at every launch
  // adds host time to each one-matrix call).
  static int smem_set[64] = {0};
  if (ws == nullptr &&
      (device < 0 || device >= 64 || smem > smem_set[device])) {
    err = cudaFuncSetAttribute(angular_eig_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) smem_set[device] = smem;
  }
  const Args a{B, n, s, sel, max_its, warps, team,
               reinterpret_cast<const cplx*>(c),
               reinterpret_cast<const cplx*>(guess), bands,
               reinterpret_cast<cplx*>(eig), reinterpret_cast<cplx*>(A),
               reinterpret_cast<cplx*>(C), info,
               reinterpret_cast<cplx*>(ws)};
  if (ws == nullptr)
    angular_eig_kernel<<<static_cast<unsigned>(blocks), 32 * warps * team,
                         smem, static_cast<cudaStream_t>(stream)>>>(a);
  else
    angular_eig_ws_kernel<<<static_cast<unsigned>(blocks),
                            32 * warps * team, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#ifdef QNM_EIG_PHASES
// The phase counters (QNM_EIG_PHASES): reset to 0, or copied into out[16].
extern "C" int qnm_eig_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[16] = {0};
    return static_cast<int>(
        cudaMemcpyToSymbol(qnm_phase_cycles, zero, sizeof zero));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, qnm_phase_cycles, 16 * sizeof(unsigned long long)));
}
#endif

#else

// Host build of the same arithmetic (g++ -x c++): the matrices one after
// another, one lane doing the work of a matrix's warps (with team 2, its
// QR iterations on two bulges in the order of the card's ticks).
// Arguments as qnm_angular_eig's but the matrices a block, the device, the
// stream and the workspace.
extern "C" int qnm_angular_eig_host_team(long long B, int n, int s, int sel,
                                         int max_its, const double* c,
                                         const double* guess,
                                         const double* bands, double* eig,
                                         double* A, double* C,
                                         long long* info, int team) {
  if (n < 1 || max_its < 0 || sel < 0 || sel >= n || team < 1 ||
      team > 2 || (guess != nullptr && (A == nullptr || C == nullptr)))
    return 1;
  std::vector<cplx> mem(static_cast<size_t>(matrix_entries(n, team)));
  const Args a{B, n, s, sel, max_its, 1, team,
               reinterpret_cast<const cplx*>(c),
               reinterpret_cast<const cplx*>(guess), bands,
               reinterpret_cast<cplx*>(eig), reinterpret_cast<cplx*>(A),
               reinterpret_cast<cplx*>(C), info, nullptr};
  const Team one{team, 0, nullptr};
  for (long long b = 0; b < B; ++b) solve_one(a, b, mem.data(), one, 0);
  return 0;
}

// The host build with one warp a matrix.
extern "C" int qnm_angular_eig_host(long long B, int n, int s, int sel,
                                    int max_its, const double* c,
                                    const double* guess, const double* bands,
                                    double* eig, double* A, double* C,
                                    long long* info) {
  return qnm_angular_eig_host_team(B, n, s, sel, max_its, c, guess, bands,
                                   eig, A, C, info, 1);
}

#endif
