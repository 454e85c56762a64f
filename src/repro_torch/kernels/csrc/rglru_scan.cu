// RG-LRU linear recurrence for Hopper (sm_90a), the hybrid family's
// prefill: h_t = a_t * h_{t-1} + b_t along S, fp32.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_tpu
// (_rglru_kernel).
//
// What bounds it on the H100: it reads a and b once and writes h once,
// 12 bytes per (b, s, d) element for 2 FLOP, so bytes bound it
// (3.35 TB/s): at the 512-token prefill of RecurrentGemma-2B
// (B 1, D 2560) that is 15.7 MB, ~4.7 us.
//
// What the design does about it, simply and right first: the reference
// blocks D into VMEM lanes and carries h in scratch across a sequential S
// grid axis.  Here one thread owns one (batch, channel) pair and walks S
// in order with h in a register, so nothing is carried between blocks.
// Neighbouring threads take neighbouring channels, so every load of a_t,
// b_t and store of h_t is coalesced along D.  The loads do not depend on
// h: UNROLL steps of a and b are loaded before the dependent chain runs,
// so that many loads are in flight per thread.  The step is
// __fmul_rn then __fadd_rn, no FMA contraction, so the result equals the
// plain version's (a * h + b, rounded twice) bit for bit.
//
// At batch 1 and D 2560 this is 2560 threads, 20 blocks on 132 SMs, and
// each thread walks all of S: latency, not bandwidth, sets its time.  A
// chunked two-pass scan (per-chunk (prod a, local h), then a fix-up) would
// fill the card; that is later work.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 128;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y, int S,
             int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const i64 base = (i64)bi * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* yp = y + base;
  float h = h0[(i64)bi * D + d];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float at[UNROLL], bt[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = ap[(i64)(t + u) * D];
      bt[u] = bp[(i64)(t + u) * D];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(at[u], h), bt[u]);
      yp[(i64)(t + u) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(ap[(i64)t * D], h), bp[(i64)t * D]);
    yp[(i64)t * D] = h;
  }
}

}  // namespace

// a, b, y: contiguous (B, S, D) float32; h0: contiguous (B, D) float32.
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* y, int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)h0, (float*)y, S, D);
  return (int)cudaGetLastError();
}
