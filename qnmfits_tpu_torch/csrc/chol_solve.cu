// Batched equilibrated Hermitian solve in native FP64 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// qnmfits_tpu/ops/chol_pallas.py::complex_cholesky_solve_ds (body
// _solve_values), fused with the XLA steps that surround the solve in
// qnmfits_tpu/engine_real.py::_regularised_solve / _equilibrated:
//   * dead columns (Gram diagonal <= max(diag) * (1e3 eps)^2) become
//     identity rows with a zero right-hand side (amplitude exactly 0);
//   * sqrt-diagonal equilibration, then a 500 * n * eps diagonal floor;
//   * complex LL^H Cholesky (left-looking, lower triangle read),
//     forward and back substitution, and the unscaling of x.
// The TPU kernel carried each value as a double-single f32 pair with the
// batch on the lanes; FP64 is native here, so none of that carries over.
//
// Layout: G (batch, n, n) and b, x (batch, n), complex128 row-major with
// interleaved (re, im), i.e. double2.  One thread solves one system; the
// packed lower triangle lives in registers (spilling to local memory for
// the largest n), fully unrolled for each n = 2..16.
//
// Bound on this card: bytes.  A system reads (n^2 + n) * 16 bytes and
// writes n * 16 (1.3 KB at n = 8) for about 2.5k FP64 operations, some 2
// operations a byte against the H100's ~10 FP64 operations per byte of
// HBM bandwidth.  The design reads each input once and keeps every
// intermediate out of device memory.  The loads are not coalesced (the
// systems of neighbouring threads lie n^2 * 16 bytes apart); a staged
// shared-memory load is the first step to a faster kernel.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int N>
__global__ void __launch_bounds__(kThreads)
regularised_solve_kernel(const double2* __restrict__ G,
                         const double2* __restrict__ b,
                         double2* __restrict__ x, long long batch) {
  const long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= batch) return;
  const double2* g = G + s * (N * N);
  const double2* r = b + s * N;
  constexpr double eps = DBL_EPSILON;
  constexpr double dead_ratio = (1e3 * eps) * (1e3 * eps);
  constexpr double floor_ = 500.0 * N * eps;

  // Dead-column mask from the Gram diagonal (a NaN maximum marks none
  // dead, as jnp.max's NaN does in the reference).
  double di[N];
  bool dead[N];
  double dmax = g[0].x;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    di[j] = g[j * N + j].x;
    dmax = (di[j] > dmax || di[j] != di[j]) ? di[j] : dmax;
  }
  const double thresh = dmax * dead_ratio;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dead[j] = di[j] <= thresh;
    double d = dead[j] ? 1.0 : di[j];
    d = d < DBL_MIN ? DBL_MIN : d;
    di[j] = 1.0 / sqrt(d);               // equilibration scale D^-1/2
  }

  // Equilibrated, floored lower triangle.
  double2 L[N * (N + 1) / 2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      double2 a = g[i * N + j];
      if (dead[i] || dead[j]) {
        a.x = (i == j) ? 1.0 : 0.0;
        a.y = 0.0;
      }
      a.x = a.x * di[i] * di[j];
      a.y = a.y * di[i] * di[j];
      if (i == j) a.x += floor_;
      L[tri(i, j)] = a;
    }
  }

  // Left-looking Cholesky in place: column j from the finished columns
  // k < j, L[i][j] = (A[i][j] - sum_k L[i][k] conj(L[j][k])) / L[j][j].
  double inv[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = j; i < N; ++i) {
      double sr = L[tri(i, j)].x, si = L[tri(i, j)].y;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const double2 a = L[tri(i, k)], c = L[tri(j, k)];
        sr -= a.x * c.x + a.y * c.y;
        si -= a.y * c.x - a.x * c.y;
      }
      L[tri(i, j)] = make_double2(sr, si);
    }
    const double rs = 1.0 / sqrt(L[tri(j, j)].x);
#pragma unroll
    for (int i = j; i < N; ++i) {
      L[tri(i, j)].x *= rs;
      L[tri(i, j)].y *= rs;
    }
    inv[j] = 1.0 / L[tri(j, j)].x;
  }

  // Forward substitution L y = D^-1/2 b (dead rows zeroed).
  double2 y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    double ar = dead[j] ? 0.0 : r[j].x * di[j];
    double ai = dead[j] ? 0.0 : r[j].y * di[j];
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const double2 l = L[tri(j, k)];
      ar -= l.x * y[k].x - l.y * y[k].y;
      ai -= l.x * y[k].y + l.y * y[k].x;
    }
    y[j] = make_double2(ar * inv[j], ai * inv[j]);
  }

  // Back substitution L^H z = y in place, then x = D^-1/2 z.
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    double ar = y[j].x, ai = y[j].y;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const double2 l = L[tri(i, j)];
      ar -= l.x * y[i].x + l.y * y[i].y;
      ai -= l.x * y[i].y - l.y * y[i].x;
    }
    y[j] = make_double2(ar * inv[j], ai * inv[j]);
  }
  double2* out = x + s * N;
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = make_double2(y[j].x * di[j], y[j].y * di[j]);
}

template <int N>
cudaError_t launch(const void* G, const void* b, void* x, long long batch,
                   cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  regularised_solve_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const double2*>(G), static_cast<const double2*>(b),
      static_cast<double2*>(x), batch);
  return cudaGetLastError();
}

}  // namespace

// Solve `batch` systems of size n (2 <= n <= 16) on `stream` of device
// `device`.  Returns the CUDA error of the launch (0 on success).
extern "C" int qnm_regularised_solve(const void* G, const void* b, void* x,
                                     long long batch, int n, int device,
                                     void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch<2>(G, b, x, batch, st);
    case 3: return launch<3>(G, b, x, batch, st);
    case 4: return launch<4>(G, b, x, batch, st);
    case 5: return launch<5>(G, b, x, batch, st);
    case 6: return launch<6>(G, b, x, batch, st);
    case 7: return launch<7>(G, b, x, batch, st);
    case 8: return launch<8>(G, b, x, batch, st);
    case 9: return launch<9>(G, b, x, batch, st);
    case 10: return launch<10>(G, b, x, batch, st);
    case 11: return launch<11>(G, b, x, batch, st);
    case 12: return launch<12>(G, b, x, batch, st);
    case 13: return launch<13>(G, b, x, batch, st);
    case 14: return launch<14>(G, b, x, batch, st);
    case 15: return launch<15>(G, b, x, batch, st);
    case 16: return launch<16>(G, b, x, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
