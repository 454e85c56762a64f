// RG-LRU linear recurrence for Hopper (sm_90a), the hybrid family's
// prefill: h_t = a_t * h_{t-1} + b_t along S, fp32.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_tpu
// (_rglru_kernel).
//
// What bounds it on the H100: it reads a and b once and writes h once,
// 12 bytes per (b, s, d) element for 2 FLOP, so bytes bound it
// (3.35 TB/s): at the 512-token prefill of RecurrentGemma-2B
// (B 1, D 2560) that is 15.7 MB, ~4.7 us.  Each channel's chain of S
// dependent steps (__fmul_rn then __fadd_rn, ~8 cycles) takes ~2.3 us at
// S 512, under the bytes' time, but only if no load waits on the chain
// and ~2.7 MB are in flight across the card (3.35 TB/s x ~0.8 us of DRAM
// latency, Little's law).  Measured on the H100 (PERF.md): 1.3x the
// byte bound at S 2560; at S 512, 1.6x, where the launch and the chain's
// latency, not the bytes, set the time.
//
// What the design does about it: a block owns C consecutive channels of
// one batch row (C 8, 16 or 32), so B * ceil(D / C) blocks fill the card
// through D alone (160 at B 1, D 2560, C 16; one thread per channel, as
// before, gave 20 blocks).  Warp 0 runs the chains: lane c walks channel
// c0 + c from t = 0 to S - 1 in order with h in a register.  The step is
// __fmul_rn then __fadd_rn, no FMA contraction and no re-association
// (a chunked scan would multiply up to S decays before adding), so the
// result equals the plain version's (a * h + b, rounded twice) bit for
// bit.  Warps 1-3 fill a ring of STAGES shared-memory stages, each T
// steps x C channels of a and of b, by cp.async: 16-byte copies where
// every row starts 16-byte aligned (D % 4 == 0 and 16-byte bases), 4-byte
// copies elsewhere.  STAGES - 1 tiles stay in flight while the chain
// consumes one (32 KB a block at C 16, T 128, 3 stages: ~5 MB on the
// card), and the chain lanes read each tile from shared memory U steps
// ahead of the dependent step and store h_t straight to y, coalesced
// along D.  One __syncthreads a tile hands a landed tile to the chains
// and its consumed stage back to the copies; T 128 halves the barriers
// of T 64 and ran 7-11% faster at S 512 on the H100 (chip_smoke.py's
// sweep, PERF.md).  C, T, STAGES and the route come from the wrapper's
// scan_plan (kernels/rglru_scan.py).  No atomics: repeated calls are
// bit-identical.  The TPU kernel's sequential S grid axis becomes the
// tile loop inside the block.
#include <stdint.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int THREADS = 128;            // warp 0: chains; warps 1-3: copies
constexpr int COPIERS = THREADS - 32;
constexpr int U = 8;                    // steps a chain lane loads ahead

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const float* a;
  const float* b;
  const float* h0;
  float* y;
  int S, D;
};

// Rows [0, n) x channels [0, nc) of the tile whose first element is a[0]
// (row stride D) into one stage, each copier thread p a share.
template <int C, int T, bool VEC>
__device__ __forceinline__ void load_tile(const float* a, const float* b,
                                          float* as, float* bs, int n,
                                          int nc, int D, int p) {
  constexpr int V = VEC ? 4 : 1;        // floats a copy
  for (int q = p; q < T * C / V; q += COPIERS) {
    const int r = q / (C / V), c = (q % (C / V)) * V;
    if (r < n && c < nc) {              // VEC: nc % 4 == 0, so c + 3 < nc
      const i64 g = (i64)r * D + c;
      cp_async<4 * V>(as + r * C + c, a + g);
      cp_async<4 * V>(bs + r * C + c, b + g);
    }
  }
}

// One chain lane over a full tile: as, bs its channel's column of the
// stage (stride C), y its channel at the tile's first row (stride D).
// The next U steps of a and b are loaded before the current U run.
template <int C, int T>
__device__ __forceinline__ float chain_tile(const float* as, const float* bs,
                                            float* y, int D, float h) {
  float ca[U], cb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ca[u] = as[u * C];
    cb[u] = bs[u * C];
  }
#pragma unroll
  for (int k = 0; k < T; k += U) {
    float na[U], nb[U];
    if (k + U < T) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        na[u] = as[(k + U + u) * C];
        nb[u] = bs[(k + U + u) * C];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
      y[(i64)(k + u) * D] = h;
    }
    if (k + U < T) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ca[u] = na[u];
        cb[u] = nb[u];
      }
    }
  }
  return h;
}

template <int C, int T, int STAGES, bool VEC>
__global__ void __launch_bounds__(THREADS) rglru_kernel(Args g) {
  static_assert(C <= 32 && T % U == 0 && STAGES >= 2, "one chain warp");
  constexpr int TILE = T * C;           // floats of a (or b) in a stage
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, p = tid - 32;
  const int c0 = blockIdx.x * C, nc = min(C, g.D - c0);
  const int tiles = (g.S + T - 1) / T;
  const i64 first = (i64)blockIdx.y * g.S * g.D + c0;  // (b, t 0, c0)
  const i64 step = (i64)T * g.D;                       // one tile of rows
  const float* a = g.a + first;
  const float* b = g.b + first;

  if (p >= 0) {                         // the first STAGES - 1 tiles
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < tiles)
        load_tile<C, T, VEC>(a + j * step, b + j * step,
                             smem + 2 * j * TILE, smem + (2 * j + 1) * TILE,
                             min(T, g.S - j * T), nc, g.D, p);
      cp_commit();
    }
  }
  float h = tid < nc ? g.h0[(i64)blockIdx.y * g.D + c0 + tid] : 0.f;
  for (int i = 0; i < tiles; ++i) {
    if (p >= 0) cp_wait<STAGES - 2>();  // this thread's copies of tile i
    __syncthreads();                    // everyone's; stage i-1 consumed
    if (p >= 0) {
      const int j = i + STAGES - 1, s = j % STAGES;
      if (j < tiles)
        load_tile<C, T, VEC>(a + j * step, b + j * step,
                             smem + 2 * s * TILE, smem + (2 * s + 1) * TILE,
                             min(T, g.S - j * T), nc, g.D, p);
      cp_commit();                      // empty past the end
    } else if (tid < nc) {
      const float* as = smem + 2 * (i % STAGES) * TILE + tid;
      const float* bs = as + TILE;
      float* y = g.y + first + i * step + tid;
      const int n = min(T, g.S - i * T);
      if (n == T) {
        h = chain_tile<C, T>(as, bs, y, g.D, h);
      } else {                          // the last, partial tile
        for (int t = 0; t < n; ++t) {
          h = __fadd_rn(__fmul_rn(as[t * C], h), bs[t * C]);
          y[(i64)t * g.D] = h;
        }
      }
    }
  }
}

template <int C, int T, int STAGES, bool VEC>
int launch(const Args& g, int B, cudaStream_t s) {
  auto kern = rglru_kernel<C, T, STAGES, VEC>;
  constexpr int SMEM = STAGES * 2 * T * C * 4;   // the ring of a and b
  static bool ready = false;             // raise the smem limit once
  if (!ready) {
    const cudaError_t e = allow_smem(kern, SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((g.D + C - 1) / C, B);
  kern<<<grid, THREADS, SMEM, s>>>(g);
  return (int)cudaGetLastError();
}

template <int C, int T, int STAGES>
int launch_route(int vec, const Args& g, int B, cudaStream_t s) {
  return vec ? launch<C, T, STAGES, true>(g, B, s)
             : launch<C, T, STAGES, false>(g, B, s);
}

template <int C, int T>
int launch_stages(int stages, int vec, const Args& g, int B, cudaStream_t s) {
  if (stages == 3) return launch_route<C, T, 3>(vec, g, B, s);
  if (stages == 4) return launch_route<C, T, 4>(vec, g, B, s);
  return (int)cudaErrorInvalidValue;
}

template <int C>
int launch_steps(int steps, int stages, int vec, const Args& g, int B,
                 cudaStream_t s) {
  if (steps == 64) return launch_stages<C, 64>(stages, vec, g, B, s);
  if (steps == 128) return launch_stages<C, 128>(stages, vec, g, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b, y: contiguous (B, S, D) float32; h0: contiguous (B, D) float32.
// channels (8, 16, 32), steps (64, 128), stages (3, 4): the plan's block
// width, tile length and ring depth; vec 1: 16-byte copies (D % 4 == 0
// and a, b 16-byte aligned, which the plan checked and this checks).
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* y, int B, int S, int D, int channels,
                                int steps, int stages, int vec,
                                void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % 4 || (uintptr_t)a % 16 || (uintptr_t)b % 16))
    return (int)cudaErrorInvalidValue;
  const Args g{(const float*)a, (const float*)b, (const float*)h0,
               (float*)y, S, D};
  cudaStream_t s = (cudaStream_t)stream;
  if (channels == 8) return launch_steps<8>(steps, stages, vec, g, B, s);
  if (channels == 16) return launch_steps<16>(steps, stages, vec, g, B, s);
  if (channels == 32) return launch_steps<32>(steps, stages, vec, g, B, s);
  return (int)cudaErrorInvalidValue;
}
