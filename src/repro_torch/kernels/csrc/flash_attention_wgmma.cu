// Flash attention on Hopper's tensor cores (sm_90a), bf16: the prefill path
// of every attention family, with an optional local window, a query offset
// (chunked prefill) and a score cap.  wgmma fed by TMA in a warp-specialised
// pipeline.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu
// (_flash_kernel) for bf16, and with a window the banded attention of
// src/repro/models/attention.py::local_attention.  fp32 stays on the FFMA
// kernel in flash_attention.cu: it is the parity path, and fp32 on the
// tensor cores would mean TF32, which its tolerance does not allow.
//
// What bounds it on the H100: a causal pass over S tokens does
// ~S^2*(dqk+dv) FLOP per query head on S*(2*dqk+2*dv) values.  At batch-1
// 512-token prompts the bound (~1.4-3 us) is set by the bytes, and what
// holds a kernel back is latency: each block walks at most a few KV tiles
// in series.  LLaVA-NeXT-34B's 1024-token prefill (56 heads, 15 GFLOP) is
// bound by the tensor cores' 989 TFLOP/s, which only wgmma reaches.
//
// What the design does about it.  A block owns one (batch, query head) and
// BQ = 64 x WG query rows; WG consumer warpgroups own 64 rows each and a
// producer warpgroup feeds them (setmaxnreg moves registers from the
// producer to the consumers where WG is 2).  One producer thread loads the
// block's Q tile once and then K and V tiles of BKV keys into a ring of
// STAGES stages with TMA (cp.async.bulk.tensor.4d): full barriers for K and
// for V of each stage (completed by the bytes that land), an empty barrier
// that each consumer warp arrives on once both products on the stage have
// retired.  Per tile a consumer warpgroup runs S = Q K^T as
// wgmma.m64nBKVk16 with Q and K K-major in shared memory, the online
// softmax on S's accumulator registers, and O += P V as wgmma.m64nDVk16,
// pipelined: S of tile t and P V of tile t - 1 go to the tensor cores
// together, and the softmax of tile t runs while P V of tile t - 1 does
// (the tensor cores and the softmax's ALU work overlap within one
// warpgroup); two warpgroups take turns issuing their products (named
// barriers, FlashAttention-3's ping-pong), so that one's softmax runs
// under the other's products.  P V takes P,
// converted to bf16 in registers, as the A operand (the m64nNk16
// accumulator layout of S is the A fragment layout of P: registers 8kk..
// 8kk+7 are the four A registers of k-step kk, two values each) and V
// MN-major in shared memory with the transpose-B flag, as gemm_wgmma.cu
// takes B.  Every operand lives in shared memory in the 128-byte swizzled
// layout TMA writes, in atoms of 64 columns (128 bytes) x the tile's rows;
// a head dim below 64 fills one atom, the columns past it zero.
//
// TMA: each operand is described on its own extent as a 4-D map (d, S, H,
// B) built from the caller's strides, so the model's (B,S,H,d) storage
// viewed as (B,H,S,d) needs no copy, TMA's zero fill stops at S (Q) or
// Skv (K, V) and never reads the next rows of a larger buffer, and a dqk of
// 24 arrives as 24 columns and 40 zeros (QK^T steps k by 16 over 32
// columns).  The maps are made per call on the host and travel as
// __grid_constant__ kernel parameters, so a CUDA graph replays them.
//
// Tiles never visited (flash_plan in kernels/flash_attention.py is the same
// arithmetic, CPU-tested): causal blocks stop at the diagonal of their last
// row (position q_offset + min(q0 + BQ, S) - 1), a window starts at the
// tile that holds the band of the block's first row, and the heaviest
// causal row-blocks are launched first (blockIdx.y reversed).  A lone
// consumer warpgroup skips the products of a tile that is dead for all its
// rows; two walk every tile of the block, so that their turns pair up (a
// tile dead for one's rows is masked whole).  Only tiles that cross the
// diagonal, the band's edge or Skv are masked.
//
// Semantics kept from _flash_kernel: s = dot * scale with the scale applied
// to the fp32 product (here times log2(e) inside each exponent's FFMA,
// after the max of the raw products, so exp is one ex2), then
// s = softcap * tanh(s / softcap) where softcap > 0 (before the mask, the
// reference's jnp flash_attention); query row r sits at position
// q_offset + r; keys live where kp < Skv, kp <= q (causal) and
// kp > q - window (window > 0); p = exp(s - m_new) * (s > NEG_INF*0.5),
// corr = exp(m - m_new); p enters PV rounded to bf16 (p.astype(v.dtype))
// while l sums the unrounded p; the output is acc / max(l, 1e-30), stored
// as bf16 pairs from the registers for rows < S and columns < dv.  GQA maps
// query head h to KV head h / G.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

// The capped instantiations (softcap > 0) are an object of their own:
// kernels/_build.py compiles this file a second time with
// REPRO_FLASH_CAP=1, so that the uncapped kernels carry no tanh and the
// two halves compile side by side.
#ifndef REPRO_FLASH_CAP
#define REPRO_FLASH_CAP 0
#endif

namespace repro {
// the capped instantiations' dispatch, defined where this file is built
// with REPRO_FLASH_CAP=1
int flash_wgmma_capped(int dqk, int dv, const void* q, const void* k,
                       const void* v, void* o, int B, int Hq, int Hkv, int S,
                       int Skv, int causal, int window, int q_offset,
                       const i64* st, float scale, float softcap,
                       cudaStream_t s);
}  // namespace repro

using namespace repro;

namespace {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use

// The tiling of each (dqk, dv) pair, as kernels/flash_attention.py::
// flash_plan computes it: consumer warpgroups (64 query rows each), keys a
// tile, ring stages.  One warpgroup where a head dim passes 128, so that the
// hybrid's 10 heads and MLA's 16 make 80 and 128 blocks of a 512-token
// prompt, not 40 and 64; 64 keys a tile at dv 256, where O takes 128
// registers a thread; as many stages (at most 4) as shared memory holds.
template <int DQK, int DV> struct Tiling;
#define REPRO_FLASH_WGMMA_TILING(DQK, DV, WG, BKV, STAGES)                 \
  template <> struct Tiling<DQK, DV> {                                     \
    static constexpr int wg = WG, bkv = BKV, stages = STAGES;              \
  };
REPRO_FLASH_WGMMA_TILING(16, 16, 2, 128, 4)
REPRO_FLASH_WGMMA_TILING(32, 32, 2, 128, 4)
REPRO_FLASH_WGMMA_TILING(64, 64, 2, 128, 4)
REPRO_FLASH_WGMMA_TILING(128, 128, 2, 128, 3)
REPRO_FLASH_WGMMA_TILING(256, 256, 1, 64, 3)
REPRO_FLASH_WGMMA_TILING(192, 128, 1, 128, 2)
REPRO_FLASH_WGMMA_TILING(24, 16, 2, 128, 4)
#undef REPRO_FLASH_WGMMA_TILING

template <int DQK, int DV> struct Cfg {
  static constexpr int WG = Tiling<DQK, DV>::wg;
  static constexpr int BKV = Tiling<DQK, DV>::bkv;
  static constexpr int STAGES = Tiling<DQK, DV>::stages;
  static constexpr int BQ = 64 * WG;                  // query rows a block
  static constexpr int THREADS = 128 * (WG + 1);      // + the producer
  static constexpr int QA = (DQK + 63) / 64;  // 64-column atoms of a Q/K row
  static constexpr int VA = (DV + 63) / 64;   // of a V row
  static constexpr int DQKP = (DQK + 15) / 16 * 16;   // k depth of Q K^T
  static constexpr int DVP = 64 * VA;                 // N of P V
  static constexpr int Q_BYTES = BQ * 128 * QA;
  static constexpr int K_BYTES = BKV * 128 * QA;
  static constexpr int V_BYTES = BKV * 128 * VA;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // Q, the ring, the Q barrier and full K, full V and empty barriers of
  // each stage; +1024 to align the swizzled tiles
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + (3 * STAGES + 1) * 8;
  static_assert(DQK % 8 == 0 && DV % 16 == 0, "16-byte rows, k-steps of 16");
  static_assert(SMEM <= SMEM_MAX, "shared memory of one block");
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// "%0, ..., %(R-1)": the accumulator registers of a wgmma
#define REPRO_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define REPRO_R64                                                          \
  REPRO_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "    \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63"
#define REPRO_R128                                                         \
  REPRO_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "    \
  "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, " \
  "%89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "    \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "     \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "     \
  "%124, %125, %126, %127"
#define REPRO_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_D32(i)                                                       \
  REPRO_D8(i), REPRO_D8(i + 8), REPRO_D8(i + 16), REPRO_D8(i + 24)

// S (64 x N, fp32) = Q (64 x 16, K-major, smem) K^T (16 x N: K's rows,
// K-major, smem); scale_d 0 ignores S's old value
template <int N> struct QK;
template <> struct QK<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
        " {" REPRO_R32 "},\n %32, %33, p, 1, 1, 0, 0;\n}\n"
        : REPRO_D32(0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct QK<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
        " {" REPRO_R64 "},\n %64, %65, p, 1, 1, 0, 0;\n}\n"
        : REPRO_D32(0), REPRO_D32(32)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// O (64 x N, fp32) += P (64 x 16, bf16 A fragment in 4 registers) V (16 x
// N, MN-major, smem: transpose-B flag 1); the scale-d predicate is 1
template <int N> struct PV;
template <> struct PV<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
        " {" REPRO_R32 "},\n {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : REPRO_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct PV<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
        " {" REPRO_R64 "},\n {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : REPRO_D32(0), REPRO_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <> struct PV<256> {
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
        " {" REPRO_R128 "},\n {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : REPRO_D32(0), REPRO_D32(32), REPRO_D32(64), REPRO_D32(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// tanh(y) as 1 - 2 / (exp(2y) + 1), saturating to +-1 where exp overflows
// or vanishes: its absolute error (~1e-7) is what a capped score carries
// into the softmax, and it keeps the capped kernels free of tanhf's
// accurate slow path
__device__ __forceinline__ float tanh_fast(float y) {
  return 1.f - __fdividef(2.f, __expf(2.f * y) + 1.f);
}

// fetch a __grid_constant__ tensor map ahead of its first TMA load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

struct Args {
  bf16* o;
  int Hq, Hkv, S, Skv, causal, window, q_offset;
  i64 sob, soh, sos;   // the output's (batch, head, sequence) strides
  float scale_log2;    // scale * log2(e)
  float cap_scale;     // scale / softcap: the tanh argument's factor
  float cap_log2;      // softcap * log2(e)
};

// keep the compiler from reusing or moving the A registers of a wgmma
// still in flight (they are read asynchronously until its wait)
template <int R>
__device__ __forceinline__ void fence_a(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// x, hidden from the compiler: a descriptor made from it is rebuilt at
// each use, one add a wgmma, not hoisted out of the tile loop into 2
// registers a k-step (at dqk 256, 32 registers: the spills of the widest
// pairs)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// issue S = Q K^T for one K tile (no commit); 16 k are 32 bytes along a
// swizzled 128-byte row, 8-row groups 1 KB apart; atom kk/4 of Q (BQ
// rows) and of K (BKV rows).  A shared-memory address below 256 KB keeps
// the descriptor's 14-bit address field from carrying, so adding an
// offset / 16 to a descriptor moves its start address.
template <int DQK, int DV>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<DQK, DV>::BKV / 2],
                                         uint32_t q_st, uint32_t k_st) {
  using C = Cfg<DQK, DV>;
  const uint64_t dq = gmma_desc(opaque(q_st), 16, 1024);
  const uint64_t dk = gmma_desc(k_st, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < C::DQKP / 16; ++kk)
    QK<C::BKV>::run(sc, dq + (((kk / 4) * C::BQ * 128 + (kk % 4) * 32) >> 4),
                    dk + (((kk / 4) * C::BKV * 128 + (kk % 4) * 32) >> 4),
                    kk > 0 ? 1 : 0);
}

// issue O += P V for one V tile (no commit); 16 keys are 16 rows of 128
// bytes, 8-row groups 1 KB apart (stride), 64-column atoms BKV rows apart
// (leading)
template <int DQK, int DV>
__device__ __forceinline__ void issue_pv(
    float (&o)[Cfg<DQK, DV>::DVP / 2],
    uint32_t (&pa)[Cfg<DQK, DV>::BKV / 16][4], uint32_t v_st) {
  using C = Cfg<DQK, DV>;
  const uint64_t dv = gmma_desc(v_st, C::BKV * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < C::BKV / 16; ++kk)
    PV<C::DVP>::run(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
}

// the online softmax of one tile on S's registers.  The plain kernel
// takes the max of the raw scores and folds scale * log2(e) (> 0, so it
// commutes with the max) into the exponent's one FFMA; the capped one
// first maps each score to softcap * log2(e) * tanh(s * scale / softcap).
// Where `edge` (the tile crosses Skv, the diagonal or the band's edge for
// these rows) key k0 + col + j of row r is live iff lo[r] < j <= hi[r],
// j a constant of the register.  Then corr = exp2(m_old - m), l = l * corr
// + sum p, and p = exp2(s - m) is left in S's registers.
template <int BKV, bool CAP>
__device__ __forceinline__ void softmax(float (&sc)[BKV / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        const Args& g, int k0, bool edge,
                                        const int (&pos)[2], int col) {
  const float f = CAP ? 1.f : g.scale_log2;
  if (CAP) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i)
      sc[i] = g.cap_log2 * tanh_fast(sc[i] * g.cap_scale);
  }
  if (edge) {
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int base = k0 + col;
      hi[r] = min(g.Skv - 1, g.causal ? pos[r] : 0x7fffffff) - base;
      lo[r] = g.window > 0 ? pos[r] - g.window - base : -0x7fffffff;
    }
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int j = (i / 4) * 8 + (i % 2), r = (i / 2) % 2;
      if (!(j > lo[r] && j <= hi[r])) sc[i] = NEG_INF;
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float fm[2];   // the new max, times f: what each exponent subtracts
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // a row's 4 threads hold its columns
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    fm[r] = fmaxf(m[r], mx[r] * f);
    corr[r] = exp2_fast(m[r] - fm[r]);
    m[r] = fm[r];
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // two partial sums a row
  if (edge) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2;
      const float p = exp2_fast(fmaf(sc[i], f, -fm[r]));
      sc[i] = sc[i] > NEG_INF * 0.5f ? p : 0.f;
      ls[r][(i / 4) % 2] += sc[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2;
      sc[i] = exp2_fast(fmaf(sc[i], f, -fm[r]));
      ls[r][(i / 4) % 2] += sc[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + (ls[r][0] + ls[r][1]);
}

// P (in S's registers) as the A operand of P V: k-step kk takes registers
// 8kk..8kk+7, two bf16 values in each A register
template <int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKV / 16][4],
                                       const float (&sc)[BKV / 2]) {
#pragma unroll
  for (int i = 0; i < BKV / 2; i += 2)
    pa[i / 8][(i % 8) / 2] = pack_bf16(sc[i], sc[i + 1]);
}

template <int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(Cfg<DQK, DV>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Args g) {
  using C = Cfg<DQK, DV>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ char smem_raw[];
  // Q: QA atoms of BQ rows x 128 bytes; then each stage: K (QA atoms of
  // BKV rows), V (VA atoms of BKV rows); then the barriers
  char* qs = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* ring = qs + C::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  const uint32_t q_bar = smem_u32(bars);
  const uint32_t full_k = smem_u32(bars + 1);
  const uint32_t full_v = smem_u32(bars + 1 + STAGES);
  const uint32_t empty = smem_u32(bars + 1 + 2 * STAGES);
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / g.Hq, hq = blockIdx.x % g.Hq;
  const int hk = hq / (g.Hq / g.Hkv);
  // heaviest causal row-blocks first
  const int qblk = g.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                            : (int)blockIdx.y;
  const int q0 = qblk * BQ;
  // live keys of the block's rows (positions q_offset + row): below the
  // last row's position + 1 when causal; with a window, from the tile that
  // holds the band of the first row
  const int p_first = g.q_offset + q0;
  const int p_last = g.q_offset + min(q0 + BQ, g.S) - 1;
  const int kv_end = g.causal ? min(g.Skv, p_last + 1) : g.Skv;
  const int kv_begin =
      g.window > 0 ? max(0, p_first - g.window + 1) / BKV * BKV : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C::WG);   // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::WG) {
    // ------------------------------------------------------------ producer
    if constexpr (C::WG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != C::WG * 128) return;
    prefetch_map(&map_q);
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
    for (int a = 0; a < C::QA; ++a)
      tma_load_4d(smem_u32(qs + a * BQ * 128), &map_q, q_bar, a * 64, q0, hq,
                  b);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES, round = t / STAGES;
      if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
      const int k0 = kv_begin + t * BKV;
      char* st = ring + s * C::STAGE_BYTES;
      mbar_expect_tx(full_k + 8 * s, C::K_BYTES);
#pragma unroll
      for (int a = 0; a < C::QA; ++a)
        tma_load_4d(smem_u32(st + a * BKV * 128), &map_k, full_k + 8 * s,
                    a * 64, k0, hk, b);
      mbar_expect_tx(full_v + 8 * s, C::V_BYTES);
#pragma unroll
      for (int a = 0; a < C::VA; ++a)
        tma_load_4d(smem_u32(st + C::K_BYTES + a * BKV * 128), &map_v,
                    full_v + 8 * s, a * 64, k0, hk, b);
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (C::WG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r0 = q0 + wg * 64;          // the warpgroup's first row
    const bool idle = r0 >= g.S;          // rows past S only: no products
    const int w_first = g.q_offset + r0;  // its first and last positions
    const int w_last = g.q_offset + min(r0 + 64, g.S) - 1;
    // this thread's rows of every fragment: row and row + 8; register i
    // of an accumulator holds row + 8*((i/2)%2), column (i/4)*8 + col + i%2
    const int row = r0 + warp * 16 + lane / 4;
    const int pos[2] = {g.q_offset + row, g.q_offset + row + 8};
    const int col = (lane % 4) * 2;
    float o[C::DVP / 2];
#pragma unroll
    for (int i = 0; i < C::DVP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_st = smem_u32(qs) + wg * 64 * 128;
    const uint32_t ring_st = smem_u32(ring);
    auto k_of = [&](int t) { return kv_begin + t * BKV; };
    auto stage = [&](int t) { return t % STAGES; };
    auto parity = [&](int t) { return (t / STAGES) & 1; };
    // the tiles dead for all this warpgroup's rows lie before and after
    // its live ones [lo, hi): it only lets them pass
    auto dead = [&](int t) {
      const int k0 = k_of(t);
      return idle || (g.causal && k0 > w_last) ||
             (g.window > 0 && k0 + BKV - 1 <= w_first - g.window);
    };
    auto edge = [&](int t) {
      const int k0 = k_of(t);
      return k0 + BKV > g.Skv || (g.causal && k0 + BKV - 1 > w_first) ||
             (g.window > 0 && k0 <= w_last - g.window);
    };
    auto pass = [&](int t) {
      mbar_wait(full_k + 8 * stage(t), parity(t));
      mbar_wait(full_v + 8 * stage(t), parity(t));
      if (lane == 0) mbar_arrive(empty + 8 * stage(t));
    };
    // Two warpgroups take turns at the tensor cores (named barriers 1 and
    // 2, FlashAttention-3's ping-pong): each issues its products only once
    // the other has issued its own, so that one's softmax runs under the
    // other's products.  Both then walk all the block's tiles (a tile dead
    // for one's rows is masked whole), so their turns pair up.
    constexpr bool PINGPONG = C::WG == 2;
    auto my_turn = [&]() {
      if constexpr (PINGPONG)
        asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
    };
    auto your_turn = [&](bool last) {   // the second's last turn passes none
      if constexpr (PINGPONG)
        if (!(last && wg == 1))
          asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
    };
    int lo = 0, hi = n_tiles;
    if constexpr (!PINGPONG) {
      while (lo < hi && dead(lo)) ++lo;
      while (hi > lo && dead(hi - 1)) --hi;
    }
    if (PINGPONG && wg == 1 && n_tiles > 0) your_turn(false);  // first go
    mbar_wait(q_bar, 0);
    for (int t = 0; t < lo; ++t) pass(t);
    if (lo < hi) {
      // the pipeline: S of tile t on the tensor cores, then P V of tile
      // t - 1, while the softmax of tile t runs on S as soon as it is done
      float sc[BKV / 2], corr[2];
      uint32_t pa[BKV / 16][4];
      mbar_wait(full_k + 8 * stage(lo), parity(lo));
      my_turn();
      wgmma_fence();
      issue_qk<DQK, DV>(sc, q_st, ring_st + stage(lo) * C::STAGE_BYTES);
      wgmma_commit();
      your_turn(false);
      wgmma_wait<0>();
      fence_operands(sc);
      softmax<BKV, CAP>(sc, m, l, corr, g, k_of(lo), edge(lo), pos, col);
      pack_p<BKV>(pa, sc);
      for (int t = lo + 1; t < hi; ++t) {
        const uint32_t k_st = ring_st + stage(t) * C::STAGE_BYTES;
        const uint32_t v_prev =
            ring_st + stage(t - 1) * C::STAGE_BYTES + C::K_BYTES;
        mbar_wait(full_k + 8 * stage(t), parity(t));
        mbar_wait(full_v + 8 * stage(t - 1), parity(t - 1));
        fence_operands(o);
        my_turn();
        wgmma_fence();
        issue_qk<DQK, DV>(sc, q_st, k_st);
        wgmma_commit();
        issue_pv<DQK, DV>(o, pa, v_prev);
        wgmma_commit();
        your_turn(false);
        wgmma_wait<1>();                 // S of tile t is done
        fence_operands(sc);
        softmax<BKV, CAP>(sc, m, l, corr, g, k_of(t), edge(t), pos, col);
        wgmma_wait<0>();                 // P V of tile t - 1 is done
        fence_operands(o);
        fence_a(pa);
        if (lane == 0) mbar_arrive(empty + 8 * stage(t - 1));
#pragma unroll
        for (int i = 0; i < C::DVP / 2; ++i) o[i] *= corr[(i / 2) % 2];
        pack_p<BKV>(pa, sc);
      }
      mbar_wait(full_v + 8 * stage(hi - 1), parity(hi - 1));
      fence_operands(o);
      my_turn();
      wgmma_fence();
      issue_pv<DQK, DV>(o, pa, ring_st + stage(hi - 1) * C::STAGE_BYTES +
                                   C::K_BYTES);
      wgmma_commit();
      your_turn(true);
      wgmma_wait<0>();
      fence_operands(o);
      fence_a(pa);
      if (lane == 0) mbar_arrive(empty + 8 * stage(hi - 1));
    }
    for (int t = hi; t < n_tiles; ++t) pass(t);

    // normalise; store bf16 pairs of rows < S and columns < DV
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    bf16* ob = g.o + b * g.sob + hq * g.soh;
#pragma unroll
    for (int i = 0; i < C::DVP / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int c = (i / 4) * 8 + col, rr = row + 8 * r;
      if (c < DV && rr < g.S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (i64)rr * g.sos + c) =
            __floats2bfloat162_rn(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
}

// 4-D bf16 tensor map of a (batch, heads, rows, d) operand with element
// strides (sb, sh, sr) and a contiguous last dim: dims (d, rows, heads,
// batch), boxes of 64 columns x box_rows with the 128-byte swizzle; reads
// outside the extent are zero.  Returns 0 or the driver's error.
int make_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
             int batch, i64 sr, i64 sh, i64 sb, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const i64 st[3] = {sr, sh, sb};
  cuuint64_t strides[3];
  // a dimension of extent 1 is never stepped: any stride TMA takes will do
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)st[i] * 2;
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                 const_cast<void*>(base), dims, strides, box, estr,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DQK, int DV, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Skv, int causal, int window,
           int q_offset, const i64* st, float scale, float softcap,
           cudaStream_t s) {
  using C = Cfg<DQK, DV>;
  CUtensorMap mq, mk, mv;
  memset(&mq, 0, sizeof(mq));
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  // K and V on Skv rows (at least one: with none, no tile is visited)
  const int kv_rows = Skv > 0 ? Skv : 1;
  int e = make_map(&mq, q, DQK, S, Hq, B, st[2], st[1], st[0], C::BQ);
  if (e == 0)
    e = make_map(&mk, k, DQK, kv_rows, Hkv, B, st[5], st[4], st[3], C::BKV);
  if (e == 0)
    e = make_map(&mv, v, DV, kv_rows, Hkv, B, st[8], st[7], st[6], C::BKV);
  if (e != 0) return 1000 + e;
  auto kern = flash_wgmma_kernel<DQK, DV, CAP>;
  const cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const Args g{(bf16*)o, Hq, Hkv, S, Skv, causal, window, q_offset,
               st[9], st[10], st[11], scale * LOG2E,
               CAP ? scale / softcap : 0.f, softcap * LOG2E};
  dim3 grid(B * Hq, (S + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::SMEM, s>>>(mq, mk, mv, g);
  return (int)cudaGetLastError();
}

template <bool CAP>
int dispatch(int dqk, int dv, const void* q, const void* k, const void* v,
             void* o, int B, int Hq, int Hkv, int S, int Skv, int causal,
             int window, int q_offset, const i64* st, float scale,
             float softcap, cudaStream_t s) {
  // the (dqk, dv) pairs: kernels/flash_attention.py::HEAD_DIMS
#define REPRO_FLASH_WGMMA_CASE(DQK, DV)                                     \
  if (dqk == DQK && dv == DV)                                               \
    return launch<DQK, DV, CAP>(q, k, v, o, B, Hq, Hkv, S, Skv, causal,      \
                                window, q_offset, st, scale, softcap, s);
  REPRO_FLASH_WGMMA_CASE(16, 16)
  REPRO_FLASH_WGMMA_CASE(32, 32)
  REPRO_FLASH_WGMMA_CASE(64, 64)
  REPRO_FLASH_WGMMA_CASE(128, 128)
  REPRO_FLASH_WGMMA_CASE(256, 256)
  REPRO_FLASH_WGMMA_CASE(192, 128)
  REPRO_FLASH_WGMMA_CASE(24, 16)
#undef REPRO_FLASH_WGMMA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#if REPRO_FLASH_CAP
int repro::flash_wgmma_capped(int dqk, int dv, const void* q, const void* k,
                              const void* v, void* o, int B, int Hq, int Hkv,
                              int S, int Skv, int causal, int window,
                              int q_offset, const i64* st, float scale,
                              float softcap, cudaStream_t s) {
  return dispatch<true>(
      dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv, causal, window, q_offset, st,
      scale, softcap, s);
}
#else
// bf16 only; (dqk, dv) one of the pairs of dispatch; window 0 means none,
// > 0 needs causal; q_offset >= 0 is the position of q's first row;
// softcap 0 means none.  Strides are in elements, (batch, head, sequence)
// for q, k, v and o; the last dimension is contiguous, and every base and
// row stride of q, k and v is a multiple of 16 bytes (TMA's rule).
// Returns 0, a CUDA error of the launch, or 1000 + the driver's error of a
// tensor map.
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int S, int Skv, int dqk, int dv, int causal, int window,
    int q_offset, i64 sqb, i64 sqh, i64 sqs, i64 skb, i64 skh, i64 sks,
    i64 svb, i64 svh, i64 svs, i64 sob, i64 soh, i64 sos, float scale,
    float softcap, void* stream) {
  const i64 st[12] = {sqb, sqh, sqs, skb, skh, sks,
                      svb, svh, svs, sob, soh, sos};
  cudaStream_t s = (cudaStream_t)stream;
  if ((window > 0 && !causal) || q_offset < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  if (B * Hq == 0 || S == 0) return 0;      // nothing to compute
  if (softcap > 0.f)
    return repro::flash_wgmma_capped(dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv,
                                     causal, window, q_offset, st, scale,
                                     softcap, s);
  return dispatch<false>(
      dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv, causal, window, q_offset, st,
      scale, softcap, s);
}
#endif
