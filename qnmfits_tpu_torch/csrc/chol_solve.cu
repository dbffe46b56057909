// Batched equilibrated Hermitian solve in native FP64 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// qnmfits_tpu/ops/chol_pallas.py::complex_cholesky_solve_ds (body
// _solve_values), fused with the XLA steps that surround the solve in
// qnmfits_tpu/engine_real.py::_regularised_solve / _equilibrated:
//   * dead columns (Gram diagonal <= max(diag) * (1e3 eps)^2, a NaN maximum
//     marking none dead) become identity rows with a zero right-hand side
//     (amplitude exactly 0);
//   * sqrt-diagonal equilibration (DBL_MIN clamp), then a 500 * n * eps
//     diagonal floor;
//   * complex LL^H Cholesky (lower triangle read), forward and back
//     substitution, and the unscaling of x.
// The TPU kernel carried each value as a double-single f32 pair with the
// batch on the lanes; FP64 is native here, so none of that carries over.
//
// Layout: G (batch, n, n) and b, x (batch, n), complex128 row-major with
// interleaved (re, im), i.e. double2, 16-byte aligned; n = 1..64.
//
// Two kernels, chosen by n alone: the team kernel below for n = 1..16, and
// the warp kernel (regularised_solve_wide_kernel, at the end of the file)
// for n = 17..64, where a register-resident column would spill.
//
// Design of the team kernel.
//   * A team of P threads solves one system, P the next power of two >= n
//     (2, 4, 8 or 16; a one-mode system is a team of 2 with one idle
//     lane), inside one warp.  Lane j holds column j of the
//     equilibrated lower triangle in registers (at most 16 complex values,
//     indexed only by compile-time constants).  The Cholesky runs
//     right-looking: at step k lane k scales its column, and the column
//     and y[k] are broadcast from lane k with __shfl_sync; lane j updates
//     its entries i >= j.  The forward substitution rides along in the
//     same steps; the back substitution reads each lane's own column.  The
//     diagonal maximum of the dead-column mask is a team shuffle reduction.
//   * A block of 128 threads works on slabs of 128 / P systems, which are
//     contiguous in the (batch, n, n) layout.  Each lane copies what it
//     will read, its column of the lower triangle and its entry of b, into
//     shared memory with 16-byte cp.async; at each row the lanes of a team
//     read neighbouring words, so the loads are coalesced and the upper
//     triangle's sectors are never fetched.  Two slab buffers let the copy
//     of the next slab run while this one is factorised.  No thread reads
//     another's copies, so the pipeline needs no block barrier.  A warp's
//     teams hold consecutive systems, so the stores of x are contiguous.
//   * The grid is persistent: as many blocks as fit on the SMs, at most one
//     per slab, each striding over the slabs.
//
// Bound on this card: bytes.  A system needs its lower triangle of G and b
// read and x written, (n(n+1)/2 + 2n) * 16 bytes (832 at n = 8), for about
// 1.4k FP64 operations: some 2 operations a byte against the H100's ~10
// FP64 operations per byte of HBM bandwidth.  The tensor cores' FP64 path
// (DMMA) cannot help: the work is byte-bound, and an 8 x 8 factorisation
// is a chain of rank-1 updates, not a matrix product.  In practice the
// kernel is held back by its instructions, not its bytes: a team repeats
// the pivot's reciprocal square root on every lane and runs the
// triangular updates and the broadcasts as predicated full-width steps
// (PERF.md, section 6).

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 2;        // slab buffers in shared memory
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int team_size(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
}

template <int N>
struct Slab {
  static constexpr int P = team_size(N);       // threads per system
  static constexpr int kSystems = kThreads / P;
  static constexpr int kTri = N * (N + 1) / 2; // packed lower triangle
  // One stage: the slab's lower triangles, then its right-hand sides.
  static constexpr int kStage = kSystems * (kTri + N);
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(double2));
  static_assert(kSmem <= 48 * 1024, "more than the default shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from device to shared memory, cached in L2 only.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `Pending` committed groups of this thread's copies are
// in flight; the landed data is then visible to this thread.
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(Pending) : "memory");
}

// Lane j of a team copies what it will read: column j of the lower
// triangle of g (n, n) into tri (packed) and r[j] into rb.  At each row i
// the lanes j <= i read neighbouring words, so the upper triangle's
// sectors are never fetched.
template <int N>
__device__ __forceinline__ void copy_system(double2* tri, double2* rb,
                                            const double2* g,
                                            const double2* r, int lane) {
  if (lane >= N) return;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i >= lane) copy16(&tri[i * (i + 1) / 2 + lane], &g[i * N + lane]);
  copy16(&rb[lane], &r[lane]);
}

template <int P>
__device__ __forceinline__ double2 shfl2(double2 v, int src) {
  return make_double2(__shfl_sync(kAll, v.x, src, P),
                      __shfl_sync(kAll, v.y, src, P));
}

// One system, solved by the P lanes of a team: g, its packed lower
// triangle, and r (n,) in shared memory, each lane reading only what it
// copied; returns x[lane] (meaningless on lanes >= N).  Every lane of the
// warp calls it, so the shuffles run on the full mask.
template <int N>
__device__ __forceinline__ double2 solve_system(const double2* g,
                                                const double2* r, int lane) {
  constexpr int P = team_size(N);
  constexpr double eps = DBL_EPSILON;
  constexpr double dead_ratio = (1e3 * eps) * (1e3 * eps);
  constexpr double floor_ = 500.0 * N * eps;
  const bool live = lane < N;

  // Dead-column mask from the diagonal: a team maximum that propagates
  // NaN (as torch.amax does; a NaN maximum marks no column dead).
  const double d = live ? g[lane * (lane + 1) / 2 + lane].x : -INFINITY;
  double dmax = d;
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) {
    const double v = __shfl_xor_sync(kAll, dmax, o, P);
    dmax = (v > dmax || v != v) ? v : dmax;
  }
  const bool dead = live && d <= dmax * dead_ratio;
  const unsigned team_base = (threadIdx.x & 31) & ~(P - 1);
  const unsigned dead_bits = (__ballot_sync(kAll, dead) >> team_base) & ((1u << P) - 1);
  const double dd = dead ? 1.0 : d;
  const double s = live ? 1.0 / sqrt(dd < DBL_MIN ? DBL_MIN : dd) : 1.0;

  // Column `lane` of the equilibrated, floored lower triangle.
  double2 a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const double si = __shfl_sync(kAll, s, i, P);
    double2 v = make_double2(0.0, 0.0);
    if (live && i >= lane) {
      v = g[i * (i + 1) / 2 + lane];
      if (dead || ((dead_bits >> i) & 1)) v = make_double2(i == lane ? 1.0 : 0.0, 0.0);
      v.x = v.x * si * s;
      v.y = v.y * si * s;
      if (i == lane) v.x += floor_;
    }
    a[i] = v;
  }
  double2 acc = make_double2(0.0, 0.0);       // D^-1/2 b, dead rows zeroed
  if (live && !dead) acc = make_double2(r[lane].x * s, r[lane].y * s);

  // Right-looking Cholesky with the forward substitution L y = acc.
  double2 cj = make_double2(0.0, 0.0);        // L[lane][k] of step k
  double2 y = make_double2(0.0, 0.0);         // y[lane], then z[lane]
  double inv = 0.0;                           // 1 / L[lane][lane]
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (lane == k) {
      // rs = 1 / sqrt(pivot) and inv = 1 / L[k][k] to within an ulp: the
      // reciprocal square root, and one Newton step from rs (L[k][k] =
      // pivot * rs), in place of two IEEE divisions and a square root.
      const double rs = rsqrt(a[k].x);
#pragma unroll
      for (int i = k; i < N; ++i) {
        a[i].x *= rs;
        a[i].y *= rs;
      }
      inv = fma(rs, fma(-a[k].x, rs, 1.0), rs);
      y = make_double2(acc.x * inv, acc.y * inv);
    }
    const double2 yk = shfl2<P>(y, k);
    // L[i][j] -= L[i][k] conj(L[j][k]) for k < j <= i, j = lane.
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const double2 c = shfl2<P>(a[i], k);
      if (lane == i) cj = c;
      if (lane > k && i >= lane) {
        a[i].x -= c.x * cj.x + c.y * cj.y;
        a[i].y -= c.y * cj.x - c.x * cj.y;
      }
    }
    if (lane > k) {
      acc.x -= cj.x * yk.x - cj.y * yk.y;
      acc.y -= cj.x * yk.y + cj.y * yk.x;
    }
  }

  // Back substitution L^H z = y: z[j] -= conj(L[i][j]) z[i] for j < i.
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    if (lane == i) y = make_double2(y.x * inv, y.y * inv);
    const double2 zi = shfl2<P>(y, i);
    if (lane < i) {
      y.x -= a[i].x * zi.x + a[i].y * zi.y;
      y.y -= a[i].x * zi.y - a[i].y * zi.x;
    }
  }
  return make_double2(y.x * s, y.y * s);
}

// At most 128 registers a thread (4 blocks an SM): left to itself, ptxas
// spills a few bytes at some n.
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
regularised_solve_kernel(const double2* __restrict__ G,
                         const double2* __restrict__ b,
                         double2* __restrict__ x, long long batch,
                         long long slabs) {
  using S = Slab<N>;
  extern __shared__ __align__(16) unsigned char smem[];
  double2* stages = reinterpret_cast<double2*>(smem);
  const int lane = threadIdx.x & (S::P - 1);
  const int team = threadIdx.x / S::P;

  // Copy this team's system of `slab` into stage `st`, and commit the
  // group (empty past the last slab, so every thread counts alike).
  auto fetch = [&](long long slab, int st) {
    const long long sys = slab * S::kSystems + team;
    if (sys < batch) {
      double2* base = stages + st * S::kStage;
      copy_system<N>(base + team * S::kTri,
                     base + S::kSystems * S::kTri + team * N,
                     G + sys * N * N, b + sys * N, lane);
    }
    commit_copies();
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    fetch(blockIdx.x + st * static_cast<long long>(gridDim.x), st);
  int it = 0;
  for (long long slab = blockIdx.x; slab < slabs; slab += gridDim.x, ++it) {
    // The stage refilled here was last read by this thread in the previous
    // iteration (each thread reads only what it copied), so no barrier.
    fetch(slab + (kStages - 1) * static_cast<long long>(gridDim.x),
          (it + kStages - 1) % kStages);
    wait_copies<kStages - 1>();
    const double2* base = stages + (it % kStages) * S::kStage;
    // Teams past a partial slab's end solve stale data and store nothing.
    const double2 xv = solve_system<N>(base + team * S::kTri,
                                       base + S::kSystems * S::kTri + team * N,
                                       lane);
    // A warp's teams hold consecutive systems: its stores are contiguous.
    const long long sys = slab * S::kSystems + team;
    if (lane < N && sys < batch) x[sys * N + lane] = xv;
  }
}

template <int N>
cudaError_t launch(const void* G, const void* b, void* x, long long batch,
                   int device, cudaStream_t stream) {
  using S = Slab<N>;
  // Blocks of this kernel resident on the whole device, set up once.
  static int resident[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, regularised_solve_kernel<N>, kThreads, S::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = per_sm * sms;
  }
  const long long slabs = (batch + S::kSystems - 1) / S::kSystems;
  const long long grid = slabs < resident[device] ? slabs : resident[device];
  regularised_solve_kernel<N><<<static_cast<unsigned>(grid), kThreads,
                                S::kSmem, stream>>>(
      static_cast<const double2*>(G), static_cast<const double2*>(b),
      static_cast<double2*>(x), batch, slabs);
  return cudaGetLastError();
}

}  // namespace

// Solve `batch` systems of size n (1 <= n <= 16) on `stream` of device
// `device` with the team kernel.  G, b and x must be 16-byte aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int qnm_regularised_solve(const void* G, const void* b, void* x,
                                     long long batch, int n, int device,
                                     void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(G, b, x, batch, device, st);
    case 2: return launch<2>(G, b, x, batch, device, st);
    case 3: return launch<3>(G, b, x, batch, device, st);
    case 4: return launch<4>(G, b, x, batch, device, st);
    case 5: return launch<5>(G, b, x, batch, device, st);
    case 6: return launch<6>(G, b, x, batch, device, st);
    case 7: return launch<7>(G, b, x, batch, device, st);
    case 8: return launch<8>(G, b, x, batch, device, st);
    case 9: return launch<9>(G, b, x, batch, device, st);
    case 10: return launch<10>(G, b, x, batch, device, st);
    case 11: return launch<11>(G, b, x, batch, device, st);
    case 12: return launch<12>(G, b, x, batch, device, st);
    case 13: return launch<13>(G, b, x, batch, device, st);
    case 14: return launch<14>(G, b, x, batch, device, st);
    case 15: return launch<15>(G, b, x, batch, device, st);
    case 16: return launch<16>(G, b, x, batch, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// ---------------------------------------------------------------------------
// The warp kernel, n = 17..64: one warp per system.
//
// A lane holding a whole column in registers, as the team kernel does,
// would spill past n = 16, so here the equilibrated lower triangle lives in
// shared memory: packed, at most 64 * 65 / 2 * 16 B = 33 KB, with b (then
// y, then z) and the scales beside it, 35 KB at n = 64, under the default
// 48 KB a block.  A block is one warp and the grid strides over systems.
// Lane l owns rows l and l + 32.  Each right-looking step k scales column k
// (the pivot's reciprocal square root and one Newton step for 1 / L[k][k],
// as in the team kernel), then every lane updates its own rows of the
// trailing triangle and of the forward substitution; the back substitution
// runs column by column in the same warp.  The semantics are those of the
// team kernel and of engine_real._equilibrated line for line.
//
// Bound: bytes, as for the team kernel, (n(n+1)/2 + 2n) * 16 B a system
// (14.4 KB at n = 40, against ~7 FP64 operations a byte).  This is the
// simple kernel, and latency holds it back: each of the n steps waits on
// shared-memory round trips and two warp syncs, most lanes idle on short
// rows, and no copy is in flight while a system is factorised (PERF.md,
// section 6).
// ---------------------------------------------------------------------------

constexpr int kWideMaxN = 64;
constexpr int kWideBlocksPerSm = 32;

__host__ __device__ inline int tri_index(int i, int j) { return i * (i + 1) / 2 + j; }

inline size_t wide_smem_bytes(int n) {
  return (static_cast<size_t>(n) * (n + 1) / 2 + n) * sizeof(double2)
         + 2 * static_cast<size_t>(n) * sizeof(double);
}

__global__ void __launch_bounds__(32)
regularised_solve_wide_kernel(const double2* __restrict__ G,
                              const double2* __restrict__ b,
                              double2* __restrict__ x, long long batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  double2* tri = reinterpret_cast<double2*>(smem);      // packed lower triangle
  double2* rb = tri + tri_index(n, 0);                  // b, then y, then z
  double* sc = reinterpret_cast<double*>(rb + n);       // D^-1/2
  double* dinv = sc + n;                                // 1 / L[k][k]
  const int lane = threadIdx.x;
  const double eps = DBL_EPSILON;
  const double dead_ratio = (1e3 * eps) * (1e3 * eps);
  const double floor_ = 500.0 * n * eps;

  for (long long sys = blockIdx.x; sys < batch; sys += gridDim.x) {
    const double2* g = G + sys * n * n;
    // The lower triangle row by row (neighbouring lanes, neighbouring
    // words), and b.
    for (int i = 0; i < n; ++i)
      for (int j = lane; j <= i; j += 32) tri[tri_index(i, j)] = g[i * n + j];
    for (int i = lane; i < n; i += 32) rb[i] = b[sys * n + i];
    __syncwarp();

    // Dead-column mask from the diagonal: a warp maximum that propagates
    // NaN (as torch.amax does; a NaN maximum marks no column dead).
    double dmax = -INFINITY;
    for (int i = lane; i < n; i += 32) {
      const double d = tri[tri_index(i, i)].x;
      dmax = (d > dmax || d != d) ? d : dmax;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double v = __shfl_xor_sync(kAll, dmax, o);
      dmax = (v > dmax || v != v) ? v : dmax;
    }
    unsigned long long dead_bits = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      bool dead = false;
      if (i < n) {
        const double d = tri[tri_index(i, i)].x;
        dead = d <= dmax * dead_ratio;
        const double dd = dead ? 1.0 : d;
        sc[i] = 1.0 / sqrt(dd < DBL_MIN ? DBL_MIN : dd);
      }
      dead_bits |= static_cast<unsigned long long>(__ballot_sync(kAll, dead))
                   << base;
    }
    __syncwarp();

    // Equilibrate and floor; dead rows and columns become identity rows
    // with a zero right-hand side.
    for (int i = 0; i < n; ++i) {
      const bool dead_i = (dead_bits >> i) & 1;
      const double si = sc[i];
      for (int j = lane; j <= i; j += 32) {
        double2 v = tri[tri_index(i, j)];
        if (dead_i || ((dead_bits >> j) & 1)) v = make_double2(i == j ? 1.0 : 0.0, 0.0);
        v.x = v.x * si * sc[j];
        v.y = v.y * si * sc[j];
        if (i == j) v.x += floor_;
        tri[tri_index(i, j)] = v;
      }
    }
    for (int i = lane; i < n; i += 32) {
      const double2 r = rb[i];
      rb[i] = ((dead_bits >> i) & 1) ? make_double2(0.0, 0.0)
                                     : make_double2(r.x * sc[i], r.y * sc[i]);
    }

    // Right-looking Cholesky with the forward substitution L y = b'.
    for (int k = 0; k < n; ++k) {
      __syncwarp();
      const double piv = tri[tri_index(k, k)].x;
      const double rs = rsqrt(piv);
      const double lkk = piv * rs;
      const double inv = fma(rs, fma(-lkk, rs, 1.0), rs);
      for (int i = k + lane; i < n; i += 32) {
        double2 v = tri[tri_index(i, k)];
        tri[tri_index(i, k)] = i == k ? make_double2(lkk, 0.0)
                                      : make_double2(v.x * rs, v.y * rs);
      }
      if (lane == (k & 31)) {
        rb[k] = make_double2(rb[k].x * inv, rb[k].y * inv);
        dinv[k] = inv;
      }
      __syncwarp();
      const double2 yk = rb[k];
      // Rows i > k of this lane: b'[i] -= L[i][k] y[k], and
      // L[i][j] -= L[i][k] conj(L[j][k]) for k < j <= i.
      for (int i = lane; i < n; i += 32) {
        if (i <= k) continue;
        const double2 c = tri[tri_index(i, k)];
        rb[i].x -= c.x * yk.x - c.y * yk.y;
        rb[i].y -= c.x * yk.y + c.y * yk.x;
        for (int j = k + 1; j <= i; ++j) {
          const double2 cj = tri[tri_index(j, k)];
          double2& a = tri[tri_index(i, j)];
          a.x -= c.x * cj.x + c.y * cj.y;
          a.y -= c.y * cj.x - c.x * cj.y;
        }
      }
    }

    // Back substitution L^H z = y: z[j] -= conj(L[i][j]) z[i] for j < i.
    for (int i = n - 1; i >= 0; --i) {
      __syncwarp();
      if (lane == (i & 31)) rb[i] = make_double2(rb[i].x * dinv[i], rb[i].y * dinv[i]);
      __syncwarp();
      const double2 zi = rb[i];
      for (int j = lane; j < i; j += 32) {
        const double2 l = tri[tri_index(i, j)];
        rb[j].x -= l.x * zi.x + l.y * zi.y;
        rb[j].y -= l.x * zi.y - l.y * zi.x;
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32)
      x[sys * n + i] = make_double2(rb[i].x * sc[i], rb[i].y * sc[i]);
    __syncwarp();   // the next system's copies overwrite shared memory
  }
}

}  // namespace

// Solve `batch` systems of size n (17 <= n <= 64) on `stream` of device
// `device` with the warp kernel.  G, b and x must be 16-byte aligned.
// Returns the CUDA error of the launch (0 on success).
extern "C" int qnm_regularised_solve_wide(const void* G, const void* b,
                                          void* x, long long batch, int n,
                                          int device, void* stream) {
  if (batch <= 0) return 0;
  if (n < 17 || n > kWideMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms[kMaxDevices] = {};
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long cap = static_cast<long long>(sms[device]) * kWideBlocksPerSm;
  const long long grid = batch < cap ? batch : cap;
  regularised_solve_wide_kernel<<<static_cast<unsigned>(grid), 32,
                                  wide_smem_bytes(n),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(G), static_cast<const double2*>(b),
      static_cast<double2*>(x), batch, n);
  return static_cast<int>(cudaGetLastError());
}
