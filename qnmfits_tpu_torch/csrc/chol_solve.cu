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
// interleaved (re, im), i.e. double2, 16-byte aligned; any n >= 1.
//
// Two kernels, chosen by n alone: the team kernel below for n = 1..16, and
// the wide kernel (regularised_solve_wide_kernel, at the end of the file)
// for every n >= 17, where a register-resident column would spill.
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
#include <map>
#include <mutex>
#include <tuple>

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
// The wide kernel, n >= 17: a block of T threads per system, blocked
// right-looking Cholesky in panels of kPanel = 8 columns.
//
// A lane holding a whole column in registers, as the team kernel does,
// would spill past n = 16, so here the equilibrated lower triangle lives in
// the block's arena: shared memory up to n = 167, a global-memory workspace
// above (the wrapper allocates it; the kernel allocates nothing).  T is 32
// up to n = 32, 128 up to n = 96, 256 above.
//
// Layout.  The lower triangle is packed by columns: entry (i, j), i >= j, at
// cb(j) + i - j with cb(j) = j n - j (j - 1) / 2, so column j is
// contiguous.  After one stage's triangle comes b (then y, then z), and
// after the stages the scales D^-1/2 (-1 on dead columns), the pivots'
// 1 / sqrt, 1 / L[k][k] and the warp maxima of the dead mask.
//
// A panel, columns [k0, k0 + 8):
//   * Diagonal block, warp 0, an entry a lane (factor_diagonal_block): 8
//     steps of some 50 instructions for the warp, each taking the pivot and
//     the two entries of column k a lane needs by shuffles, the reciprocal
//     square root, and 1 / L[k][k] from one Newton step as in the team
//     kernel; the forward substitution rides along.
//   * Rows below, a thread a row: L[i][panel] = a[i][panel] L_D^-H in
//     registers (28 complex multiply-adds), then b[i] -= L[i][panel] y.
//   * Trailing rank-8 update a[i][j] -= sum_m L[i][m] conj(L[j][m]) for
//     j >= k0 + 8.  Thread t is (ti, tj) = (t mod 16, t / 16) and owns the
//     entries i = ti (mod 16), j = tj (mod T/16): a cyclic 2-D
//     distribution, about (n - k0)^2 / 2T entries a thread, each with one
//     owner.  A thread holds its row's 8 values of L in registers, so an
//     entry costs a load and a store and 8 broadcast loads for 8 complex
//     multiply-adds; two entries go at a time.
// A barrier after each of the three, none inside them.  The back
// substitution L^H z = y runs in warp 0, 8 rows at a time from the last:
// the block's own triangle with lane m holding column m and z[m] broadcast
// by shuffles, then the rows above, a lane a row, 8 multiply-adds each;
// warp syncs only.  Barriers a system: 3 ceil(n / 8) + 4 (19 at n = 40,
// where one column a step takes n + 5 and one lane a row n syncs of a warp).
//
// Critical path, one system alone on an SM (scripts/torch_wide_phases.py,
// clock64 around each phase; H100 at 700 W): at n = 40 about 36k cycles,
// of which the 5 diagonal blocks take ~14k (8 dependent steps of ~350
// cycles: shuffles, reciprocal square root, two fused multiply-adds), the
// back substitution ~6.5k, the copy in and the mask and equilibration ~6.5k,
// the rows below and the trailing updates the rest.  The dependent chain of
// n pivots is what blocking cannot shorten.
//
// Banks.  Shared memory serves a 16-byte access a quarter-warp (8 threads)
// at a time, 8 slots of 16 bytes.  In the trailing update a quarter-warp is
// 8 consecutive ti with one tj: the same j and rows i distinct mod 8, so
// its accesses of a[i][j] and L[i][m] fall on 8 distinct slots of one
// column, and L[j][m] is one address (a broadcast): no conflict.  The rows
// below read and write consecutive rows of a column (consecutive threads),
// and L_D by broadcast: no conflict.  The copy in, a warp per row of G
// (coalesced 16-byte global reads), scatters into the packed columns with
// stride n - j - 1 slots and may conflict, as may the back substitution's
// reads of a row of L.
//
// Copies in flight.  The grid is persistent, sized from the occupancy the
// runtime reports for this block and arena.  With two stages, the rows of
// system s + gridDim.x go into the second stage with 16-byte cp.async
// spread over the block while system s is solved.  cp.async, not TMA: the
// packed columns are a scatter of G's rows, and a 1-D bulk copy needs a
// contiguous destination.  Two stages fit the 232,448 bytes a block may
// use up to n = 118, one up to n = 167; the host takes two only where they
// leave as many blocks resident as the batch can use.  Above n = 167 the
// arena is one stage in the global workspace, copied with plain loads, and
// the grid is cut so the workspace stays within kWorkCap bytes: the simple
// version.
//
// Bound: bytes, (n(n+1)/2 + 2n) * 16 B a system, against ~n^3 / 6 complex
// multiply-adds (~7 FP64 operations a byte at n = 40).  At the batches of
// the sweeps (a few systems an SM) the kernel is held back by the latency
// of one system, not by either bound.
// ---------------------------------------------------------------------------

constexpr int kRows = 16;                       // ti of the owner map
constexpr int kPanel = 8;                       // columns a panel
constexpr long long kWorkCap = 256ll << 20;     // global workspace, bytes

__host__ __device__ __forceinline__ int col_base(int j, int n) {
  return j * n - j * (j - 1) / 2;
}

__host__ __device__ __forceinline__ size_t stage_elems(int n) {
  return static_cast<size_t>(n) * (n + 1) / 2 + n;     // triangle, then b
}

// Bytes of one block's arena: the stages, then sc, rs and inv (n each) and
// eight warp maxima, rounded up to 16 so that arenas laid end to end in
// the global workspace stay aligned.
inline size_t wide_arena_bytes(int n, int stages) {
  const size_t bytes = stages * stage_elems(n) * sizeof(double2)
                       + (3 * static_cast<size_t>(n) + 8) * sizeof(double);
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ double dmax_nan(double m, double v) {
  return (v > m || v != v) ? v : m;   // NaN propagates, as in torch.amax
}

// Complex multiply-subtracts as two fused multiply-adds a component.
// a -= c conj(d)
__device__ __forceinline__ void sub_c_conj(double2& a, double2 c, double2 d) {
  a.x = fma(-c.x, d.x, fma(-c.y, d.y, a.x));
  a.y = fma(-c.y, d.x, fma(c.x, d.y, a.y));
}

// a -= c d
__device__ __forceinline__ void sub_c(double2& a, double2 c, double2 d) {
  a.x = fma(-c.x, d.x, fma(c.y, d.y, a.x));
  a.y = fma(-c.x, d.y, fma(-c.y, d.x, a.y));
}

// a -= conj(l) z
__device__ __forceinline__ void sub_conj_c(double2& a, double2 l, double2 z) {
  a.x = fma(-l.x, z.x, fma(-l.y, z.y, a.x));
  a.y = fma(-l.x, z.y, fma(l.y, z.x, a.y));
}

// The diagonal block's entries on the lanes of one warp, one a lane in
// each of two slots: slot 0 holds columns 0..3 of the block (26 lanes),
// slot 1 columns 4..7 (lanes 0..9) and b' (lanes 10..17).  Entry (i, k)
// sits in slot k / 4 at lane col_lane(k) + i - k.
__host__ __device__ constexpr int col_lane(int k) {
  return k < 4 ? 8 * k - k * (k - 1) / 2 : 4 * (k - 4) - (k - 4) * (k - 5) / 2;
}
constexpr int kRhsLane = 10;                     // b'[r] at lane 10 + r, slot 1
static_assert(kPanel == 8, "the lane layout of the diagonal block has 8 columns");

// The diagonal block [k0, k0 + nb) of the factorisation, nb <= kPanel, in
// one warp, an entry a lane.  At step k every lane takes the pivot and b'[k]
// by shuffles and computes rs = 1 / sqrt(pivot), 1 / L[k][k] (one Newton
// step) and y[k] itself; the lanes of column k scale it; then each lane
// takes the two entries of column k that its own entry needs by shuffles
// and subtracts L[i][k] conj(L[j][k]) (or L[r][k] y[k] from b'[r]).  A
// step is some 50 instructions for the warp, not a loop over columns.
// Writes back L, rs, 1 / L[k][k] and y.  Every lane of the warp calls it.
__device__ __forceinline__ void factor_diagonal_block(double2* tri, double2* rb,
                                                      double* rsv, double* invv,
                                                      int k0, int nb, int n,
                                                      int lane) {
  int j0 = 0, j1 = 4;                            // this lane's columns
#pragma unroll
  for (int k = 1; k < 4; ++k) j0 = lane >= col_lane(k) ? k : j0;
#pragma unroll
  for (int k = 5; k < kPanel; ++k) j1 = lane >= col_lane(k) ? k : j1;
  const int i0 = j0 + lane - col_lane(j0);
  const int i1 = j1 + lane - col_lane(j1);
  const int r1 = lane - kRhsLane;
  const bool has0 = lane < col_lane(3) + 5 && i0 < nb;
  const bool has1 = lane < col_lane(7) + 1 && i1 < nb;
  const bool rhs = r1 >= 0 && r1 < nb;
  const int p0 = col_base(k0 + j0, n) + i0 - j0;
  const int p1 = col_base(k0 + j1, n) + i1 - j1;
  double2 v0 = has0 ? tri[p0] : make_double2(0.0, 0.0);
  double2 v1 = has1 ? tri[p1] : rhs ? rb[k0 + r1] : make_double2(0.0, 0.0);
  const int row1 = rhs ? r1 : i1;                // row of the slot-1 entry
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    if (k >= nb) break;
    double2& vk = k < 4 ? v0 : v1;               // column k's slot
    const int c = col_lane(k);
    // Every shuffle of the step before the reciprocal square root, whose
    // latency they then overlap: column k goes unscaled.
    const double piv = __shfl_sync(kAll, vk.x, c);
    const double2 bk = shfl2<32>(v1, kRhsLane + k);
    double2 li0 = shfl2<32>(vk, c + i0 - k);
    double2 lj0 = shfl2<32>(vk, c + j0 - k);
    double2 li1 = shfl2<32>(vk, c + row1 - k);
    double2 lj1 = shfl2<32>(vk, c + j1 - k);
    const double rs = rsqrt(piv);
    const double lkk = piv * rs;
    const double inv = fma(rs, fma(-lkk, rs, 1.0), rs);
    const double2 yk = make_double2(bk.x * inv, bk.y * inv);
    li0 = make_double2(li0.x * rs, li0.y * rs);     // L[i][k] = rs a[i][k]
    lj0 = make_double2(lj0.x * rs, lj0.y * rs);
    li1 = make_double2(li1.x * rs, li1.y * rs);
    lj1 = make_double2(lj1.x * rs, lj1.y * rs);
    if (lane >= c && lane < c + kPanel - k) vk = make_double2(vk.x * rs, vk.y * rs);
    if (lane == 0) {
      rsv[k0 + k] = rs;
      invv[k0 + k] = inv;
    }
    if (lane == kRhsLane + k) v1 = yk;
    if (has0 && j0 > k) sub_c_conj(v0, li0, lj0);
    if (has1 && j1 > k) sub_c_conj(v1, li1, lj1);
    if (rhs && r1 > k) sub_c(v1, li1, yk);
  }
  if (has0) tri[p0] = v0;
  if (has1) tri[p1] = v1;
  if (rhs) rb[k0 + r1] = v1;
}

// The diagonal block [k0, k0 + nb) of the back substitution L^H z = y in
// one warp: lane m < nb holds column m of the block below the diagonal and
// z[m]; z[r] goes to the others by a shuffle, from the last row.
__device__ __forceinline__ void back_diagonal_block(const double2* tri,
                                                    double2* rb,
                                                    const double* invv, int k0,
                                                    int nb, int n, int lane) {
  const bool live = lane < nb;
  const double2* col = tri + col_base(k0 + lane, n) - lane;
  double2 l[kPanel];
#pragma unroll
  for (int r = 0; r < kPanel; ++r)
    l[r] = live && r > lane && r < nb ? col[r] : make_double2(0.0, 0.0);
  double2 z = live ? rb[k0 + lane] : make_double2(0.0, 0.0);
  const double inv = live ? invv[k0 + lane] : 0.0;
#pragma unroll
  for (int r = kPanel - 1; r >= 0; --r) {
    if (r >= nb) continue;
    if (lane == r) z = make_double2(z.x * inv, z.y * inv);
    const double2 zr = shfl2<32>(z, r);
    if (lane < r) sub_conj_c(z, l[r], zr);
  }
  if (live) rb[k0 + lane] = z;
}

// At most 128 registers a thread (512 threads an SM) below 256 threads,
// which keeps enough blocks resident for a batch of a few systems an SM in
// one wave; a block of 256 threads (n > 96) has an SM's shared memory to
// itself, or nearly, anyway.
template <int T, bool kGlobal>
__global__ void __launch_bounds__(T, T < 256 ? 512 / T : 1)
regularised_solve_wide_kernel(const double2* __restrict__ G,
                              const double2* __restrict__ b,
                              double2* __restrict__ x, long long batch, int n,
                              int stages, unsigned char* __restrict__ work,
                              size_t arena_bytes) {
  constexpr int kCols = T / kRows;              // tj of the owner map
  constexpr int kWarps = T / 32;
  static_assert(kWarps <= 8, "eight warp maxima in the arena");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* arena = kGlobal ? work + blockIdx.x * arena_bytes : smem;
  const size_t per_stage = stage_elems(n);
  const int tri_size = n * (n + 1) / 2;
  double2* stage0 = reinterpret_cast<double2*>(arena);
  double* sc = reinterpret_cast<double*>(stage0 + stages * per_stage);
  double* rsv = sc + n;                          // 1 / sqrt(pivot k)
  double* invv = rsv + n;                        // 1 / L[k][k]
  double* red = invv + n;                        // warp maxima
  const int t = threadIdx.x;
  const int ti = t % kRows, tj = t / kRows;
  const int warp = t / 32, lane = t & 31;
  constexpr double eps = DBL_EPSILON;
  constexpr double dead_ratio = (1e3 * eps) * (1e3 * eps);

  // The lower triangle of system `sys` into the packed columns of `dst`,
  // a warp per row of G, and b after it.
  auto fetch = [&](long long sys, double2* dst) {
    if (sys < batch) {
      const double2* g = G + sys * n * n;
      for (int i = warp; i < n; i += kWarps)
        for (int j = lane; j <= i; j += 32) {
          double2* d = dst + col_base(j, n) + i - j;
          const double2* s = g + static_cast<long long>(i) * n + j;
          if constexpr (kGlobal) *d = *s; else copy16(d, s);
        }
      for (int i = t; i < n; i += T) {
        if constexpr (kGlobal) dst[tri_size + i] = b[sys * n + i];
        else copy16(dst + tri_size + i, b + sys * n + i);
      }
    }
    if constexpr (!kGlobal) commit_copies();
  };

  if (!kGlobal) fetch(blockIdx.x, stage0);
  int it = 0;
  for (long long sys = blockIdx.x; sys < batch; sys += gridDim.x, ++it) {
    double2* tri = stage0 + (stages == 2 ? (it & 1) : 0) * per_stage;
    double2* rb = tri + tri_size;
    if (kGlobal) {
      fetch(sys, tri);
    } else if (stages == 2) {
      // The other stage was last read in the previous iteration, which
      // ended with a barrier.
      fetch(sys + gridDim.x, stage0 + ((it + 1) & 1) * per_stage);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();

    // Dead-column mask from the diagonal: a block maximum that propagates
    // NaN (a NaN maximum marks no column dead).
    double dmax = -INFINITY;
    for (int i = t; i < n; i += T) dmax = dmax_nan(dmax, tri[col_base(i, n)].x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dmax = dmax_nan(dmax, __shfl_xor_sync(kAll, dmax, o));
    if (lane == 0) red[warp] = dmax;
    __syncthreads();
    dmax = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) dmax = dmax_nan(dmax, red[w]);
    for (int i = t; i < n; i += T) {
      const double d = tri[col_base(i, n)].x;
      const bool dead = d <= dmax * dead_ratio;
      const double dd = dead ? 1.0 : d;
      sc[i] = dead ? -1.0 : 1.0 / sqrt(dd < DBL_MIN ? DBL_MIN : dd);
    }
    __syncthreads();

    // Equilibrate and floor; dead rows and columns become identity rows
    // with a zero right-hand side.
    const double floor_ = 500.0 * n * eps;
    for (int i = ti; i < n; i += kRows) {
      const bool dead_i = sc[i] < 0.0;
      const double si = fabs(sc[i]);
      for (int j = tj; j <= i; j += kCols) {
        double2* p = tri + col_base(j, n) + i - j;
        double2 v = *p;
        if (dead_i || sc[j] < 0.0) v = make_double2(i == j ? 1.0 : 0.0, 0.0);
        const double sj = fabs(sc[j]);
        v.x = v.x * si * sj;
        v.y = v.y * si * sj;
        if (i == j) v.x += floor_;
        *p = v;
      }
      if (tj == 0) {
        const double2 r = rb[i];
        rb[i] = dead_i ? make_double2(0.0, 0.0) : make_double2(r.x * si, r.y * si);
      }
    }
    __syncthreads();

    // Blocked right-looking Cholesky with the forward substitution
    // L y = b', a panel of kPanel columns at a time.
    for (int k0 = 0;; k0 += kPanel) {
      if (warp == 0)
        factor_diagonal_block(tri, rb, rsv, invv, k0, min(kPanel, n - k0), n,
                              lane);
      __syncthreads();
      const int k1 = k0 + kPanel;
      if (k1 >= n) break;
      int off[kPanel];                        // L[i][k0 + m] = tri[off[m] + i]
#pragma unroll
      for (int m = 0; m < kPanel; ++m) off[m] = col_base(k0 + m, n) - k0 - m;

      // The panel's rows below its diagonal block, a thread a row:
      // L[i][k0..k1) = a[i][k0..k1) L_D^-H, then b[i] -= L[i][.] y[.].
      for (int i = k1 + t; i < n; i += T) {
        double2 l[kPanel];
#pragma unroll
        for (int m = 0; m < kPanel; ++m) l[m] = tri[off[m] + i];
#pragma unroll
        for (int m = 0; m < kPanel; ++m) {
#pragma unroll
          for (int q = 0; q < m; ++q) sub_c_conj(l[m], l[q], tri[off[q] + k0 + m]);
          const double rs = rsv[k0 + m];
          l[m] = make_double2(l[m].x * rs, l[m].y * rs);
        }
        double2 r = rb[i];
#pragma unroll
        for (int m = 0; m < kPanel; ++m) {
          tri[off[m] + i] = l[m];
          sub_c(r, l[m], rb[k0 + m]);
        }
        rb[i] = r;
      }
      __syncthreads();

      // Trailing rank-kPanel update of the columns j >= k1.
      const int j0 = k1 + ((tj - k1) & (kCols - 1));
      for (int i = k1 + ((ti - k1) & (kRows - 1)); i < n; i += kRows) {
        double2 l[kPanel];
#pragma unroll
        for (int m = 0; m < kPanel; ++m) l[m] = tri[off[m] + i];
        // Two entries at a time, both loaded before either is stored.
        int j = j0;
        for (; j + kCols <= i; j += 2 * kCols) {
          double2* p0 = tri + col_base(j, n) + i - j;
          double2* p1 = tri + col_base(j + kCols, n) + i - j - kCols;
          double2 a0 = *p0, a1 = *p1;
#pragma unroll
          for (int m = 0; m < kPanel; ++m) {
            sub_c_conj(a0, l[m], tri[off[m] + j]);
            sub_c_conj(a1, l[m], tri[off[m] + j + kCols]);
          }
          *p0 = a0;
          *p1 = a1;
        }
        if (j <= i) {
          double2* p0 = tri + col_base(j, n) + i - j;
          double2 a0 = *p0;
#pragma unroll
          for (int m = 0; m < kPanel; ++m) sub_c_conj(a0, l[m], tri[off[m] + j]);
          *p0 = a0;
        }
      }
      __syncthreads();
    }

    // Back substitution L^H z = y in warp 0, a block of kPanel rows at a
    // time from the last: the block's own triangle, then the rows above.
    if (warp == 0) {
      for (int k0 = (n - 1) / kPanel * kPanel; k0 >= 0; k0 -= kPanel) {
        const int nb = min(kPanel, n - k0);
        back_diagonal_block(tri, rb, invv, k0, nb, n, lane);
        __syncwarp();
        // z[j] -= conj(L[k0 + m][j]) z[k0 + m] for j < k0, m from the last.
        for (int j = lane; j < k0; j += 32) {
          const double2* col = tri + col_base(j, n) + k0 - j;   // col[m] = L[k0 + m][j]
          double2 r = rb[j];
#pragma unroll
          for (int m = kPanel - 1; m >= 0; --m)
            if (m < nb) sub_conj_c(r, col[m], rb[k0 + m]);
          rb[j] = r;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int j = t; j < n; j += T) {
      const double s = fabs(sc[j]);
      x[sys * n + j] = make_double2(rb[j].x * s, rb[j].y * s);
    }
    __syncthreads();   // the next copies overwrite this stage
    if (!kGlobal && stages == 1) fetch(sys + gridDim.x, stage0);
  }
}

// The wide kernel's launch for n on `device`: threads a block, stages, the
// global workspace or not, grid, dynamic shared bytes, workspace bytes.
struct WidePlan {
  int threads, stages, global;
  long long grid;
  size_t arena, smem, work;
};

// Threads a block for systems of size n in shared memory.
int wide_threads(int n) { return n <= 32 ? 32 : n <= 96 ? 128 : 256; }

template <int T, bool kGlobal>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&regularised_solve_wide_kernel<T, kGlobal>);
}

const void* wide_kernel(int threads, bool global) {
  if (global) return kernel_ptr<256, true>();
  return threads == 32 ? kernel_ptr<32, false>()
         : threads == 128 ? kernel_ptr<128, false>() : kernel_ptr<256, false>();
}

// What the plan asks of the runtime, queried once a device (and a kernel
// and arena size) and kept: a launch then costs no attribute or occupancy
// query.
std::mutex cache_mutex;

struct DeviceLimits {
  int optin, sms;
};

cudaError_t device_limits(int device, DeviceLimits* out) {
  static std::map<int, DeviceLimits> cache;
  std::lock_guard<std::mutex> lock(cache_mutex);
  auto it = cache.find(device);
  if (it == cache.end()) {
    DeviceLimits d;
    cudaError_t err = cudaDeviceGetAttribute(
        &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    // The shared-memory kernels may take all a block may opt in to.
    for (int threads : {32, 128, 256}) {
      err = cudaFuncSetAttribute(wide_kernel(threads, false),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 d.optin);
      if (err != cudaSuccess) return err;
    }
    it = cache.emplace(device, d).first;
  }
  *out = it->second;
  return cudaSuccess;
}

// Blocks of a wide kernel resident on an SM of `device` with `bytes` of
// dynamic shared memory.
cudaError_t resident(int device, int threads, bool global, size_t bytes,
                     int* per_sm) {
  static std::map<std::tuple<int, int, bool, size_t>, int> cache;
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto key = std::make_tuple(device, threads, global, bytes);
  auto it = cache.find(key);
  if (it == cache.end()) {
    int v = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, wide_kernel(threads, global), threads, bytes);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, v).first;
  }
  *per_sm = it->second;
  return cudaSuccess;
}

cudaError_t wide_plan(int n, long long batch, int device, WidePlan* p) {
  DeviceLimits d;
  cudaError_t err = device_limits(device, &d);
  if (err != cudaSuccess) return err;
  const size_t optin = static_cast<size_t>(d.optin);
  const size_t one = wide_arena_bytes(n, 1), two = wide_arena_bytes(n, 2);
  p->global = one > optin;
  p->threads = p->global ? 256 : wide_threads(n);
  int per_sm = 0;
  err = resident(device, p->threads, p->global, p->global ? 0 : one, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p->stages = 1;
  if (!p->global && two <= optin) {
    // Two stages where they leave as many blocks resident as the batch
    // can use.
    int per_sm2 = 0;
    err = resident(device, p->threads, false, two, &per_sm2);
    if (err != cudaSuccess) return err;
    const long long want = batch < static_cast<long long>(per_sm) * d.sms
                               ? batch : static_cast<long long>(per_sm) * d.sms;
    if (static_cast<long long>(per_sm2) * d.sms >= want) {
      p->stages = 2;
      per_sm = per_sm2;
    }
  }
  p->arena = wide_arena_bytes(n, p->stages);
  p->smem = p->global ? 0 : p->arena;
  long long grid = static_cast<long long>(per_sm) * d.sms;
  if (p->global) {
    // At least one block an SM, else at most kWorkCap bytes of workspace.
    long long cap = kWorkCap / static_cast<long long>(p->arena);
    if (cap < d.sms) cap = d.sms;
    if (grid > cap) grid = cap;
  }
  p->grid = batch < grid ? batch : grid;
  p->work = p->global ? p->grid * p->arena : 0;
  return cudaSuccess;
}

}  // namespace

// The wide kernel's plan for `batch` systems of size n (n >= 17) on device
// `device`: out[0..5] = threads a block, stages, 1 if the arena is the
// global workspace, grid, dynamic shared bytes, workspace bytes (the
// caller allocates them and passes them to qnm_regularised_solve_wide).
// Returns the CUDA error (0 on success).
extern "C" int qnm_wide_plan(int n, long long batch, int device,
                             long long* out) {
  if (n < 17 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  WidePlan p;
  err = wide_plan(n, batch, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[6] = {p.threads, p.stages, p.global, p.grid,
                          static_cast<long long>(p.smem),
                          static_cast<long long>(p.work)};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Solve `batch` systems of size n (n >= 17) on `stream` of device `device`
// with the wide kernel; `work` holds `work_bytes` of device memory, at
// least what qnm_wide_plan asks for (none below the global switch).  G, b,
// x and work must be 16-byte aligned.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int qnm_regularised_solve_wide(const void* G, const void* b,
                                          void* x, long long batch, int n,
                                          int device, void* stream, void* work,
                                          long long work_bytes) {
  if (batch <= 0) return 0;
  if (n < 17) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  WidePlan p;
  err = wide_plan(n, batch, device, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.work && (work == nullptr || work_bytes < static_cast<long long>(p.work)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* g = static_cast<const double2*>(G);
  const auto* bb = static_cast<const double2*>(b);
  auto* xx = static_cast<double2*>(x);
  auto* w = static_cast<unsigned char*>(work);
  const dim3 grid(static_cast<unsigned>(p.grid));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.global)
    regularised_solve_wide_kernel<256, true><<<grid, 256, 0, st>>>(
        g, bb, xx, batch, n, p.stages, w, p.arena);
  else if (p.threads == 32)
    regularised_solve_wide_kernel<32, false><<<grid, 32, p.smem, st>>>(
        g, bb, xx, batch, n, p.stages, w, p.arena);
  else if (p.threads == 128)
    regularised_solve_wide_kernel<128, false><<<grid, 128, p.smem, st>>>(
        g, bb, xx, batch, n, p.stages, w, p.arena);
  else
    regularised_solve_wide_kernel<256, false><<<grid, 256, p.smem, st>>>(
        g, bb, xx, batch, n, p.stages, w, p.arena);
  return static_cast<int>(cudaGetLastError());
}
