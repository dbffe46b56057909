// The on-demand Kerr solver's angular eigenproblem for Hopper (sm_90a):
// every eigenvalue, and optionally one eigenvector, of a batch of complex
// pentadiagonal matrices, one warp a matrix.
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
// nl), so M is pentadiagonal, complex symmetric, not Hermitian.  The warp
// builds it in its own shared memory from the c-independent bands (lam0,
// X's three diagonals, X^2's five), so the (B, n, n) tensor is never
// written to device memory.
//
// Design, per matrix (one warp; the lanes take the columns of a row
// update and the rows of a column update, j = lane, lane + 32, ...):
//   * Householder reduction to upper Hessenberg form (zgehd2's
//     reflectors: H^H A H), the column norms by a butterfly of warp
//     shuffles that leaves every lane the same sum;
//   * single-shift complex QR iteration on the active block [l, i] only
//     (eigenvalues, no Schur vectors: LAPACK zlahqr with wantt false):
//     Givens rotations (c real), Wilkinson's shift, zlahqr's deflation
//     test on each subdiagonal (the lanes test one subdiagonal each and a
//     ballot finds the split nearest the bottom), exceptional shifts
//     after 10 and 20 iterations without a deflation, and zlahqr's cap of
//     30 max(10, n) iterations an eigenvalue, past which the matrix
//     reports failure (info -1) and the wrapper raises.  Unitary
//     transforms only: no complex-orthogonal step of the symmetric form,
//     which is unstable.
//   * vectors mode: the eigenvalue nearest the guess (smallest |A -
//     guess|, the first on a tie), its right eigenvector by three steps of
//     inverse iteration on the pentadiagonal M - lambda I (band LU with
//     partial pivoting: U's upper bandwidth is 4), then the solver's
//     phase rule (entry l - lmin real and positive) and unit norm.
//
// Bound on this card: latency.  A matrix of n = 28 moves 16 bytes in and
// 28 x 16 out, and its work (the FP64 operations that the reduction's,
// the rotations' and the inverse iteration's loops do, which the kernel
// counts and reports) is a chain of small
// dependent steps: a rotation takes ~860 cycles of one warp (two passes
// over shared memory, two barriers; scripts/torch_eig_variants.py
// --phases), a matrix ~0.4 ms, and the batch's warps run side by side on
// the 132 SMs, so 2 matrices take about as long as 800.  Tensor cores and
// TMA have no part in it.
//
// The source is built without contraction (nvcc -fmad=false, and g++
// -ffp-contract=off for the host build the CPU tests run), so both builds
// round each product and sum alike; the host build runs the same
// functions with one lane doing every lane's share in lane order, and the
// same butterfly order for the norms.
//
// Memory of a warp (complex entries): H, n rows of ld = n | 1 (odd, so a
// column's 16-byte entries fall in distinct banks), then the eigenvalues
// W (n), the iterate V (n) and the pivots (n ints in n entries).  Up to
// ~119 rows a warp's memory is shared memory (the block's opt-in 227 KB);
// beyond, or when the wrapper asks, a global workspace of the same layout,
// one region a matrix.

#include <cfloat>
#include <cmath>
#include <cstdint>

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
#else
#define QNM_LANES(j, lo, hi) for (int j = (lo); j < (hi); ++j)
#define QNM_SYNC() ((void)0)
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
QNM_HD double norm2(cplx x) { return x.re * x.re + x.im * x.im; }
QNM_HD bool finite(cplx x) {
  return fabs(x.re) <= DBL_MAX && fabs(x.im) <= DBL_MAX;  // false for NaN
}
// Principal square root (branch cut on the negative real axis).
QNM_HD cplx csqrt_(cplx z) {
  if (z.re == 0.0 && z.im == 0.0) return mk(0.0, z.im);
  const double t = sqrt(0.5 * (fabs(z.re) + hypot(z.re, z.im)));
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
    const cplx scal = mk(1.0, 0.0) / (alpha - mk(beta, 0.0));
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
      for (int r = k + 1; r < end; ++r) w = w + conj(V[r]) * H(r, col);
      const cplx tw = ctau * w;
      for (int r = k + 1; r < end; ++r) H(r, col) = H(r, col) - V[r] * tw;
    }
    // Column k: beta on the subdiagonal, zeros below.
    QNM_LANES(r, k + 1, end) H(r, k) = mk(r == k + 1 ? beta : 0.0, 0.0);
    QNM_SYNC();
    // From the right, H(:, k+1:) -= tau (H(:, k+1:) v) v^H: a lane a row.
    QNM_LANES(row, 0, n) {
      cplx y = mk(0.0, 0.0);
      for (int r = k + 1; r < end; ++r) y = y + H(row, r) * V[r];
      const cplx ty = tau * y;
      for (int r = k + 1; r < end; ++r)
        H(row, r) = H(row, r) - ty * conj(V[r]);
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
// with Re(conj(x) y) >= 0.  zlahqr scales x and u by max(|x|, |u|) first
// (two square roots and four divisions more), which only matters where x^2
// or u^2 would overflow: there, and only there, this takes its scaled
// form.
QNM_HD cplx wilkinson(const Mat& H, int i) {
  const cplx t = H(i, i);
  const cplx u2 = H(i - 1, i) * H(i, i - 1);
  if (u2.re == 0.0 && u2.im == 0.0) return t;
  const cplx x = 0.5 * (H(i - 1, i - 1) - t);
  const cplx x2u2 = x * x + u2;
  if (finite(x2u2)) {
    cplx y = csqrt_(x2u2);
    if (x.re * y.re + x.im * y.im < 0.0) y = -y;
    return t - u2 / (x + y);
  }
  const cplx u = csqrt_(H(i - 1, i)) * csqrt_(H(i, i - 1));
  const double sx = cabs1(x), s = fmax(cabs1(u), sx);
  const cplx xs = x / s, us = u / s;
  cplx y = s * csqrt_(xs * xs + us * us);
  if (sx > 0.0 && (x.re / sx) * y.re + (x.im / sx) * y.im < 0.0) y = -y;
  return t - u * (u / (x + y));
}

// The Givens rotation G = [[c, s], [-conj(s), c]] (c real) with
// G [f; g] = [r; 0] (zlartg).  With p = |f|^2 (|f|^2 + |g|^2) in the
// range where it neither overflows nor underflows (every rotation of the
// solver's matrices), one square root and one division: u = 1 / sqrt(p),
// c = |f|^2 u, s = f conj(g) u, r = f (|f|^2 + |g|^2) u.  Otherwise the
// scaled moduli.
QNM_HD void rotation(cplx f, cplx g, double* c, cplx* s, cplx* r) {
  const double f2 = norm2(f), g2 = norm2(g), d2 = f2 + g2, p = f2 * d2;
  if (p > 1e-290 && p < 1e290) {
    const double u = 1.0 / sqrt(p);
    *c = f2 * u;
    *s = (f * conj(g)) * u;
    *r = f * (d2 * u);
    return;
  }
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

// One single-shift QR sweep over the active block [l, i]: the first
// rotation from (H(l, l) - shift, H(l+1, l)), then the bulge chased down.
// Adds its FP64 operations to *ops.
QNM_HD void qr_sweep(const Mat& H, int l, int i, cplx shift, long long* ops,
                     int lane) {
  for (int k = l; k < i; ++k) {
    cplx f, g;
    if (k == l) {
      f = H(l, l) - shift;
      g = H(l + 1, l);
    } else {
      f = H(k, k - 1);
      g = H(k + 1, k - 1);
    }
    double c;
    cplx s, r;
    rotation(f, g, &c, &s, &r);
    const cplx ms = -conj(s), cs = conj(s);
    // The first rotation reads H(l, l), H(l+1, l) and the shift read the
    // trailing block: every lane has read them before any writes them.
    if (k == l) QNM_SYNC();
    // Rows k and k+1 from the left, columns k..i.
    QNM_LANES(col, k, i + 1) {
      const cplx a = H(k, col), b = H(k + 1, col);
      H(k, col) = c * a + s * b;
      H(k + 1, col) = ms * a + c * b;
    }
    QNM_SYNC();
    // Column k-1, which every lane read for f and g before the barrier
    // and the column pass does not touch.
    if (k > l && lane == 0) {
      H(k, k - 1) = r;
      H(k + 1, k - 1) = mk(0.0, 0.0);
    }
    // Columns k and k+1 from the right, rows l..min(k+2, i).
    const int last = k + 2 < i ? k + 2 : i;
    *ops += kPairOps * ((i - k + 1) + (last - l + 1));
    QNM_LANES(row, l, last + 1) {
      const cplx a = H(row, k), b = H(row, k + 1);
      H(row, k) = a * c + b * cs;
      H(row, k + 1) = b * c - a * s;
    }
    QNM_SYNC();
  }
}

// Every eigenvalue of the Hessenberg H into W (W[i] the one deflated at
// row i).  Returns the QR iterations (sweeps) run, or -1 when an
// eigenvalue took more than max_its; adds the sweeps' FP64 operations to
// *ops.
QNM_HD int hqr(const Mat& H, cplx* W, int n, int max_its, long long* ops,
               int lane) {
  const double smlnum = kSafeMin * (static_cast<double>(n) / kUlp);
  int sweeps = 0, i = n - 1;
  while (i >= 0) {
    int l = 0, kdefl = 0;
    bool deflated = false;
    for (int its = 0; its <= max_its; ++its) {
      l = find_split(H, l, i, n, smlnum, lane);
      if (l > 0 && lane == 0) H(l, l - 1) = mk(0.0, 0.0);
      QNM_SYNC();
      if (l >= i) {
        deflated = true;
        break;
      }
      ++kdefl;
      cplx shift;
      if (kdefl % (2 * kExceptional) == 0)
        shift = H(i, i) + mk(kExceptionalScale * cabs1(H(i, i - 1)), 0.0);
      else if (kdefl % kExceptional == 0)
        shift = H(l, l) + mk(kExceptionalScale * cabs1(H(l + 1, l)), 0.0);
      else
        shift = wilkinson(H, i);
      qr_sweep(H, l, i, shift, ops, lane);
      ++sweeps;
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
        const cplx lr = H(r, k) / piv_kk;
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
        V[k] = y / H(k, k);
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
  int n, s, sel, max_its, warps;
  const cplx* c;        // (B,)
  const cplx* guess;    // (B,) or null (values mode)
  const double* bands;  // (9, n)
  cplx* eig;            // (B, n)
  cplx* A;              // (B,) (vectors mode)
  cplx* C;              // (B, n) (vectors mode)
  long long* info;      // (B, 2)
  cplx* ws;             // (B, warp_entries(n)) or null
};

// A warp's entries of memory (n ld + 3n complex).
QNM_HD long long warp_entries(int n) {
  return static_cast<long long>(n) * (n | 1) + 3LL * n;
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

// The eigenproblem of matrix b, on the warp's memory ``mem``.  Writes its
// eigenvalues, and in vectors mode the eigenvalue nearest its guess and
// that eigenvalue's vector; info (QR sweeps, FP64 operations), the sweeps
// -1 when an eigenvalue did not converge within max_its and -2 when the
// matrix is not finite.  The outputs' addresses are read from ``a`` where
// they are written, so no register holds them through the iteration.
QNM_HD void solve_one(const Args& a, long long b, cplx* mem, int lane) {
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
  hessenberg(H, V, n, &ops, lane);
  const int sweeps = hqr(H, W, n, a.max_its, &ops, lane);
  if (sweeps >= 0) {
    QNM_LANES(k, 0, n) a.eig[b * n + k] = W[k];
    if (a.guess != nullptr) select_vector(a, b, H, W, V, &ops, lane);
  }
  if (lane == 0) {
    a.info[2 * b] = sweeps;
    a.info[2 * b + 1] = ops;
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kSmemLimit = 232448;  // a block's opt-in shared memory

// At least one block an SM: left to its default, ptxas caps the kernel
// at 72 registers and keeps the matrix's index and addresses in local
// memory (spills); with the cap lifted it takes 96 and spills nothing
// (scripts/torch_eig_variants.py).  The warps an SM are bounded by the
// shared memory, not by registers.
__global__ void __launch_bounds__(128, 1)
    angular_eig_kernel(const __grid_constant__ Args a) {
  extern __shared__ cplx smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * a.warps + warp;
  if (b >= a.B) return;
  const long long per = warp_entries(a.n);
  solve_one(a, b, a.ws != nullptr ? a.ws + b * per : smem + warp * per,
            lane);
}

}  // namespace

// B matrices of order n on `stream` of device `device`, `warps` (1..4)
// matrices a block.  c, guess, eig, A, C interleaved complex; guess, A and
// C null in values mode; ws null for shared memory, else a global
// workspace of B x (n (n | 1) + 3n) complex entries.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int qnm_angular_eig(long long B, int n, int s, int sel,
                               int max_its, int warps, const double* c,
                               const double* guess, const double* bands,
                               double* eig, double* A, double* C,
                               long long* info, double* ws, int device,
                               void* stream) {
  if (B <= 0) return 0;
  if (n < 1 || warps < 1 || warps > 4 || max_its < 0 || sel < 0 ||
      sel >= n || (guess != nullptr && (A == nullptr || C == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = warps * warp_entries(n) * 16;
  const int smem = ws != nullptr ? 0 : static_cast<int>(per_block);
  if (ws == nullptr && per_block > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(angular_eig_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{B, n, s, sel, max_its, warps,
               reinterpret_cast<const cplx*>(c),
               reinterpret_cast<const cplx*>(guess), bands,
               reinterpret_cast<cplx*>(eig), reinterpret_cast<cplx*>(A),
               reinterpret_cast<cplx*>(C), info,
               reinterpret_cast<cplx*>(ws)};
  angular_eig_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#else

// Host build of the same arithmetic (g++ -x c++): the matrices one after
// another, one lane doing the warp's work.  Arguments as qnm_angular_eig's
// but the device, the stream and the workspace.
extern "C" int qnm_angular_eig_host(long long B, int n, int s, int sel,
                                    int max_its, const double* c,
                                    const double* guess, const double* bands,
                                    double* eig, double* A, double* C,
                                    long long* info) {
  if (n < 1 || max_its < 0 || sel < 0 || sel >= n ||
      (guess != nullptr && (A == nullptr || C == nullptr)))
    return 1;
  std::vector<cplx> mem(static_cast<size_t>(warp_entries(n)));
  const Args a{B, n, s, sel, max_its, 1,
               reinterpret_cast<const cplx*>(c),
               reinterpret_cast<const cplx*>(guess), bands,
               reinterpret_cast<cplx*>(eig), reinterpret_cast<cplx*>(A),
               reinterpret_cast<cplx*>(C), info, nullptr};
  for (long long b = 0; b < B; ++b) solve_one(a, b, mem.data(), 0);
  return 0;
}

#endif
