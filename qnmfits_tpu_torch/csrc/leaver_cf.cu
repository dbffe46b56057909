// Batched Leaver continued fraction for Kerr QNMs, in FP64 for Hopper
// (sm_90a).
//
// Replaces the native CPU kernel of the JAX package's on-demand spectrum
// solver, qnmfits_tpu/spectrum/csrc/cf_kernel.cpp::radial_cf_batch (bound
// by qnmfits_tpu/spectrum/cf_native.py), which evaluates
// qnmfits_tpu/spectrum/solver.py::_cf_vec_a in 80-bit long double.  CUDA
// has no long double: this kernel runs in FP64, the precision of the JAX
// package's NumPy path, with its formulas and order of operations.  Its
// plain version is qnmfits_tpu_torch/spectrum/radial.py::cf_parts.
//
// Per element i of a batch of B, with its own omega (Leaver units), spin
// a, separation constant A and inversion count n_inv, and shared s, m and
// depth N:
//   * Leaver's coefficients c0..c4 (2M = 1 units) and the three-term
//     recurrence alpha_k, beta_k, gamma_k;
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
// Layout: split real and imaginary float64 arrays, as cf_kernel.cpp takes
// them; n_inv int32; one thread per element.  Newton's two evaluations (at
// omega and omega + h) arrive as one batch of 2B.
//
// Bound on this card: operations.  An element reads 44 bytes and writes
// 24, and does 40 FP64 operations (two of them divisions) for each of its
// N + 1 steps: alpha_k 6, beta_{k+1} 7, gamma_{k+1} 9, their product 6,
// the difference 2 and Smith's division 10.  Each step depends on the one
// before, so a thread is one dependent chain of N steps: at the solver's
// batches (B <= 800 on a spin grid, 2 in a sequential continuation) the
// card holds far fewer threads than it can run, and the time is the
// chain's latency (~350 cycles a step on an H100), not the bound.  This
// first version does nothing about that: a later one could split a
// chain's coefficient work across the lanes of a warp or evaluate several
// Newton candidates a thread.

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define QNM_HD __host__ __device__ __forceinline__
#else
#define QNM_HD inline
#endif

namespace {

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
// Principal square root (branch cut on the negative real axis).
QNM_HD cplx csqrt_(cplx z) {
  if (z.re == 0.0 && z.im == 0.0) return mk(0.0, z.im);
  const double t = sqrt(0.5 * (fabs(z.re) + hypot(z.re, z.im)));
  if (z.re >= 0.0) return mk(t, z.im / (2.0 * t));
  return mk(fabs(z.im) / (2.0 * t), copysign(t, z.im));
}

struct Coeffs {
  cplx c0, c1, c2, c3, c4;
};

// radial.py::leaver_coeffs, term by term.
QNM_HD Coeffs leaver_coeffs(int s, int m, double a, cplx w, cplx A) {
  const double b = sqrt(1.0 - 4.0 * a * a);
  const cplx I = mk(0.0, 1.0);
  const cplx phi = w / 2.0 - a * m;
  const cplx i2b = mk(0.0, 2.0 / b), i4b = mk(0.0, 4.0 / b);
  const cplx tail = (4.0 * w + mk(0.0, 2.0)) / b * phi;
  Coeffs c;
  c.c0 = (1.0 - s) - I * w - i2b * phi;
  c.c1 = -4.0 + mk(0.0, 2.0) * w * (2.0 + b) + i4b * phi;
  c.c2 = (s + 3.0) - mk(0.0, 3.0) * w - i2b * phi;
  c.c3 = (w * w) * (4.0 + 2.0 * b - a * a) - 2.0 * a * m * w - s - 1.0 +
         mk(0.0, 2.0 + b) * w - A + tail;
  c.c4 = (s + 1.0) - 2.0 * (w * w) - mk(0.0, 2.0 * s + 3.0) * w - tail;
  return c;
}

QNM_HD cplx alpha_at(double n, const Coeffs& c) {
  return n * n + (c.c0 + 1.0) * n + c.c0;
}
QNM_HD cplx beta_at(double n, const Coeffs& c) {
  return -2.0 * n * n + (c.c1 + 2.0) * n + c.c3;
}
QNM_HD cplx gamma_at(double n, const Coeffs& c) {
  return n * n + (c.c2 - 3.0) * n + c.c4 - c.c2 + 2.0;
}

// One element: writes U - T and |U| + |T|.
QNM_HD void cf_one(int s, int m, double a, cplx w, cplx A, int n_inv, int N,
                   cplx* f, double* scale) {
  const Coeffs c = leaver_coeffs(s, m, a, w, A);
  const double b = sqrt(1.0 - 4.0 * a * a);

  cplx U = beta_at(0.0, c);
  cplx alpha_prev = alpha_at(0.0, c);
  for (int k = 1; k <= n_inv; ++k) {
    const double n = static_cast<double>(k);
    U = beta_at(n, c) - alpha_prev * gamma_at(n, c) / U;
    alpha_prev = alpha_at(n, c);
  }

  cplx u = -csqrt_(mk(0.0, -2.0) * b * w);
  if (u.re > 0.0) u = -u;
  const cplx A1 = c.c0 + 1.0;
  const cplx G1 = c.c2 - 3.0;
  const cplx v = (u * u + 0.5 + G1 - A1) / 2.0;
  const double dN = static_cast<double>(N);
  cplx T = -alpha_at(dN, c) * (1.0 + u / sqrt(dN) + v / dN);

  cplx be1 = beta_at(dN, c), ga1 = gamma_at(dN, c);
  for (int k = N - 1; k >= n_inv; --k) {
    const double n = static_cast<double>(k);
    T = alpha_at(n, c) * ga1 / (be1 - T);
    be1 = beta_at(n, c);
    ga1 = gamma_at(n, c);
  }
  *f = U - T;
  *scale = cabs_(U) + cabs_(T);
}

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kThreads = 64;

__global__ void leaver_cf_kernel(long long B, const double* __restrict__ w_re,
                                 const double* __restrict__ w_im,
                                 const double* __restrict__ a,
                                 const double* __restrict__ A_re,
                                 const double* __restrict__ A_im,
                                 const int* __restrict__ n_inv, int s, int m,
                                 int N, double* __restrict__ f_re,
                                 double* __restrict__ f_im,
                                 double* __restrict__ scale) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= B) return;
  cplx f;
  double sc;
  cf_one(s, m, a[i], mk(w_re[i], w_im[i]), mk(A_re[i], A_im[i]), n_inv[i], N,
         &f, &sc);
  f_re[i] = f.re;
  f_im[i] = f.im;
  scale[i] = sc;
}

}  // namespace

// Evaluate B elements on `stream` of device `device`.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int qnm_leaver_cf(long long B, const double* w_re,
                             const double* w_im, const double* a,
                             const double* A_re, const double* A_im,
                             const int* n_inv, int s, int m, int N,
                             double* f_re, double* f_im, double* scale,
                             int device, void* stream) {
  if (B <= 0) return 0;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (B + kThreads - 1) / kThreads;
  leaver_cf_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      B, w_re, w_im, a, A_re, A_im, n_inv, s, m, N, f_re, f_im, scale);
  return static_cast<int>(cudaGetLastError());
}

#else

// Host build of the same arithmetic (g++ -x c++), for checking the
// kernel's formulas against the plain version without a card.
extern "C" void qnm_leaver_cf_host(long long B, const double* w_re,
                                   const double* w_im, const double* a,
                                   const double* A_re, const double* A_im,
                                   const int* n_inv, int s, int m, int N,
                                   double* f_re, double* f_im, double* scale) {
  for (long long i = 0; i < B; ++i) {
    cplx f;
    cf_one(s, m, a[i], mk(w_re[i], w_im[i]), mk(A_re[i], A_im[i]), n_inv[i],
           N, &f, &scale[i]);
    f_re[i] = f.re;
    f_im[i] = f.im;
  }
}

#endif
