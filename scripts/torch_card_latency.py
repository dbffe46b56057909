#!/usr/bin/env python3
"""Latency of one warp's dependent FP64 chains on the card, in cycles an
operation: DMUL, DADD, DFMA, IEEE sqrt and division, 1 / sqrt, the
non-IEEE rsqrt, hypot, a shuffle, a dependent shared-memory load, a store,
__syncwarp and load round trip, and a vote.  These set the pace of the
angular eig kernel (``csrc/angular_eig.cu``), whose work is such chains.

    python3 scripts/torch_card_latency.py

Builds a small CUDA program with the kernels' nvcc flags (``-fmad=false``)
into ``build/latency/`` and prints the card's name and power limit, then
one line an operation and one JSON line.  Needs CUDA and nvcc.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from qnmfits_tpu_torch.ops import chol_cuda  # noqa: E402

SOURCE = r"""
#include <cstdio>
#include <cmath>
#include <cuda_runtime.h>
#define REP8(s) s s s s s s s s
__global__ void lat(double* out, long long* cyc, double x0, double y0, int n) {
  __shared__ double sm[64];
  const int lane = threadIdx.x & 31;
  sm[lane] = lane;
  sm[lane + 32] = lane;
  __syncwarp();
  double x, y = y0;
  long long t0, t1;
  int k = 0;
#define MEASURE(idx, body) \
  x = x0; __syncwarp(); t0 = clock64(); \
  for (int i = 0; i < n; ++i) { REP8(body) } \
  t1 = clock64(); out[idx * 32 + lane] = x; if (lane == 0) cyc[idx] = t1 - t0;
  MEASURE(0, x = x * y;)
  MEASURE(1, x = x + y;)
  MEASURE(2, x = fma(x, y, y);)
  MEASURE(3, x = sqrt(x);)
  MEASURE(4, x = y / x;)
  MEASURE(5, x = 1.0 / sqrt(x);)
  MEASURE(6, x = rsqrt(x);)
  MEASURE(7, x = hypot(x, y);)
  MEASURE(8, x = __shfl_sync(0xffffffffu, x, (lane + 1) & 31);)
  MEASURE(9, x = sm[(int)(x * 0.0) + lane] + x * 0.0;)
  MEASURE(10, sm[lane] = x; __syncwarp(); x = sm[(lane + 1) & 31];)
  MEASURE(11, k += __popc(__ballot_sync(0xffffffffu, x > k)); x = x * y;)
  (void)k;
}
int main() {
  double* out;
  long long* cyc;
  cudaMalloc(&out, 64 * 32 * 8);
  cudaMallocManaged(&cyc, 64 * 8);
  const int n = 256;
  lat<<<1, 32>>>(out, cyc, 1.0000003, 1.0000001, n);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  for (int i = 0; i < 12; ++i) printf("%.2f\n", cyc[i] / (8.0 * n));
  return 0;
}
"""
NAMES = ("dmul", "dadd", "dfma", "sqrt", "div", "1/sqrt", "rsqrt (not IEEE)",
         "hypot", "shfl", "lds (dependent, with its address)",
         "sts + syncwarp + lds", "ballot + popc + dmul (less dmul)")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = ROOT / "build" / "latency"
    out.mkdir(parents=True, exist_ok=True)
    (out / "lat.cu").write_text(SOURCE)
    subprocess.run([chol_cuda._nvcc(), "-gencode=arch=compute_90a,code=sm_90a",
                    "-O3", "-fmad=false", "-o", str(out / "lat"),
                    str(out / "lat.cu")], check=True, timeout=300)
    res = subprocess.run([str(out / "lat")], capture_output=True, text=True,
                         check=True, timeout=120)
    cycles = dict(zip(NAMES, map(float, res.stdout.split())))
    cycles["ballot + popc + dmul (less dmul)"] -= cycles["dmul"]
    for name, v in cycles.items():
        print(f"{name:>34}: {v:.2f} cycles", flush=True)
    print(json.dumps(dict(card=smi, cycles=cycles)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
