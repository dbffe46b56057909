// Window moments of damped phases, FP64, for Hopper (sm_90a).
//
// For trajectory m on window n = win[m] (start time t0 = t0s[n], samples
// first[n] .. first[n] + count[n] - 1 where its {0,1} weight is 1,
// trapezoid weights tau[n, k], offsets s_k = t_k - t0 and phases
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
// Bound.  FP64 operations: a (trajectory, window sample, entry) costs a
// conj product and 2 (ORDER + 1) weighted sums, ~30 operations at ORDER
// 2; the bytes (the moments written once, the inputs read once) are a few
// MB.  At the optimisers' Newton step (2565 trajectories, ~1000 samples a
// window, J = 8, I = 2) that is ~4 GFLOP against ~13 MB: operations bound.
//
// Design (simple first).  One block a trajectory.  Its window's samples
// are taken in tiles: the tile's phases (exp and sincos a sample, no
// recurrence), data rows and the 2 (ORDER + 1) weights of each sample go
// to shared memory.  Each thread owns one entry, a Gram entry j <= l or a
// projection (i, j), and accumulates its 2 (ORDER + 1) sums in registers;
// where a block has more threads than entries, groups of threads take
// interleaved samples of each tile and their sums are added in shared
// memory at the end; where it has fewer, the block makes one pass over the
// window for each THREADS entries.  The Gram's mirror entries are written
// as conjugates, its diagonal as real.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int ORDER>
__global__ void __launch_bounds__(THREADS)
window_moments_kernel(const double* __restrict__ times,
                      const double2* __restrict__ rows,
                      const double2* __restrict__ omega,
                      const double* __restrict__ t0s,
                      const double* __restrict__ tau,
                      const int* __restrict__ first,
                      const int* __restrict__ count,
                      const long long* __restrict__ win,
                      double2* __restrict__ S, double2* __restrict__ P,
                      int K, int I, int J, int tile) {
  constexpr int NW = 2 * (ORDER + 1);  // weights a sample: (v, p)
  extern __shared__ double2 smem[];
  double2* phi = smem;                        // [tile][J]
  double2* hs = phi + tile * J;               // [tile][I]
  double* wts = reinterpret_cast<double*>(hs + tile * I);  // [tile][NW]
  double2* red = smem;                        // [THREADS][NW], reused

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const long long n = win[m];
  const int k0 = first[n];
  const int cnt = count[n];
  const double t0 = t0s[n];
  const double* tau_n = tau + n * static_cast<long long>(K);
  const double2* om = omega + static_cast<long long>(m) * J;
  const int n_gram = J * (J + 1) / 2;
  const int n_entries = n_gram + I * J;

  for (int e0 = 0; e0 < n_entries; e0 += THREADS) {
    const int n_pass = min(n_entries - e0, THREADS);
    const int groups = THREADS / n_pass;
    const bool active = tid < groups * n_pass;
    const int e = e0 + tid % n_pass;
    const int g = tid / n_pass;
    // This thread's entry: Gram (a, b) = (j, l), j <= l, or projection
    // (a, b) = (i, j).
    const bool gram = e < n_gram;
    int a = 0, b = 0;
    if (gram) {
      int rem = e;
      while (rem >= J - a) {
        rem -= J - a;
        ++a;
      }
      b = a + rem;
    } else {
      a = (e - n_gram) / J;
      b = (e - n_gram) % J;
    }
    double2 acc[NW];
#pragma unroll
    for (int c = 0; c < NW; ++c) acc[c] = make_double2(0.0, 0.0);

    for (int kb = 0; kb < cnt; kb += tile) {
      const int nt = min(tile, cnt - kb);
      __syncthreads();
      for (int idx = tid; idx < nt * J; idx += THREADS) {
        const int kk = idx / J, j = idx % J;
        const double s = times[k0 + kb + kk] - t0;
        const double2 w = om[j];
        double sn, cs;
        sincos(w.x * s, &sn, &cs);
        const double mag = exp(w.y * s);
        phi[idx] = make_double2(mag * cs, -(mag * sn));
      }
      for (int idx = tid; idx < nt * I; idx += THREADS) {
        const int kk = idx / I, i = idx % I;
        hs[idx] = rows[static_cast<long long>(i) * K + k0 + kb + kk];
      }
      for (int kk = tid; kk < nt; kk += THREADS) {
        const double s = times[k0 + kb + kk] - t0;
        const double ss = s * s;
        const double tk = tau_n[k0 + kb + kk];
        double* wk = wts + kk * NW;
        wk[0] = 1.0;
        if (ORDER >= 1) wk[1] = s;
        if (ORDER >= 2) wk[2] = ss;
        wk[ORDER + 1] = tk;
        if (ORDER >= 1) wk[ORDER + 2] = tk * s;
        if (ORDER >= 2) wk[ORDER + 3] = tk * ss;
      }
      __syncthreads();
      if (active) {
        for (int kk = g; kk < nt; kk += groups) {
          const double2 x = phi[kk * J + (gram ? a : b)];
          const double2 y = gram ? phi[kk * J + b] : hs[kk * I + a];
          // conj(x) y
          const double re = x.x * y.x + x.y * y.y;
          const double im = x.x * y.y - x.y * y.x;
          const double* wk = wts + kk * NW;
#pragma unroll
          for (int c = 0; c < NW; ++c) {
            acc[c].x += wk[c] * re;
            acc[c].y += wk[c] * im;
          }
        }
      }
    }

    // The groups' sums, in group order.
    if (groups > 1) {
      __syncthreads();
      if (active) {
#pragma unroll
        for (int c = 0; c < NW; ++c) red[tid * NW + c] = acc[c];
      }
      __syncthreads();
      if (active && g == 0) {
        for (int q = 1; q < groups; ++q) {
          const int src = (q * n_pass + tid) * NW;
#pragma unroll
          for (int c = 0; c < NW; ++c) {
            acc[c].x += red[src + c].x;
            acc[c].y += red[src + c].y;
          }
        }
      }
    }
    if (active && g == 0) {
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        const long long plane = static_cast<long long>(m) * NW + c;
        if (gram) {
          double2* Sm = S + plane * J * J;
          if (a == b) {
            Sm[a * J + a] = make_double2(acc[c].x, 0.0);
          } else {
            Sm[a * J + b] = acc[c];
            Sm[b * J + a] = make_double2(acc[c].x, -acc[c].y);
          }
        } else {
          P[plane * I * J + a * J + b] = acc[c];
        }
      }
    }
  }
}

template <int ORDER>
int launch(const double* times, const double2* rows, const double2* omega,
           const double* t0s, const double* tau, const int* first,
           const int* count, const long long* win, double2* S, double2* P,
           int K, int I, int J, int M, int tile, cudaStream_t stream) {
  constexpr int NW = 2 * (ORDER + 1);
  const size_t tile_bytes = static_cast<size_t>(tile) *
                            (16 * (I + J) + 8 * NW);
  const size_t red_bytes = static_cast<size_t>(THREADS) * NW * 16;
  const size_t smem = tile_bytes > red_bytes ? tile_bytes : red_bytes;
  window_moments_kernel<ORDER><<<M, THREADS, smem, stream>>>(
      times, rows, omega, t0s, tau, first, count, win, S, P, K, I, J, tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The moments of M trajectories, orders 0..order (0, 1 or 2), in one
// launch on ``stream``; tile samples a tile (ops/moments_cuda.tile).
// Returns the launch's CUDA error (0: launched).
extern "C" int qnm_window_moments(const void* times, const void* rows,
                                  const void* omega, const void* t0s,
                                  const void* tau, const void* first,
                                  const void* count, const void* win,
                                  void* S, void* P, int K, int I, int J,
                                  int M, int order, int tile, void* stream) {
  auto t = static_cast<const double*>(times);
  auto r = static_cast<const double2*>(rows);
  auto o = static_cast<const double2*>(omega);
  auto z = static_cast<const double*>(t0s);
  auto u = static_cast<const double*>(tau);
  auto f = static_cast<const int*>(first);
  auto c = static_cast<const int*>(count);
  auto w = static_cast<const long long*>(win);
  auto s = static_cast<double2*>(S);
  auto p = static_cast<double2*>(P);
  auto st = static_cast<cudaStream_t>(stream);
  switch (order) {
    case 0:
      return launch<0>(t, r, o, z, u, f, c, w, s, p, K, I, J, M, tile, st);
    case 1:
      return launch<1>(t, r, o, z, u, f, c, w, s, p, K, I, J, M, tile, st);
    case 2:
      return launch<2>(t, r, o, z, u, f, c, w, s, p, K, I, J, M, tile, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
