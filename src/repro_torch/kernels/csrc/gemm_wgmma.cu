// Checkpointable GEMM, bf16 inputs, for Hopper (sm_90a): wgmma + TMA.
//
// Replaces: src/repro/kernels/systolic_gemm.py::gemm_partial
// (_gemm_partial_kernel) and ::systolic_gemm (_gemm_kernel) for bf16
// operands.  One kernel computes  C = cast(seed + A @ B)  where A (M, K)
// and B (K, N) are the K slice [k_begin*bk, k_end*bk) of the caller's
// operands, the seed is the saved fp32 accumulator (gemm_partial, the
// paper's step_wise_mvout / resume) or zero (systolic_gemm), and C is the
// fp32 accumulator itself or its cast to bf16.  fp32 operands go to the
// FFMA kernel in gemm.cu.
//
// What bounds it on the H100: at TinyLlama's FFN width (512x2048x5632) a
// product is 11.8 GFLOP on 30 MB, above the 295 FLOP/byte ridge, so the
// tensor cores bound it (989 TFLOP/s).  A gemm_partial resume call reads
// and writes the fp32 accumulator (23 MB of its 39 MB at that width) and
// is bytes-bound (3.35 TB/s).
//
// What the design does about it: blocks of 3 warpgroups own a 128 x BN
// output tile (BN 128 or 192, picked by the wrapper's gemm_plan to fill
// the card in as few waves as it can: at 512 x 5632, BN 192 gives 120
// blocks in one wave where 128 gives 176 in two; gemm_sweep.py times
// both).  Warpgroups 0 and 1 each keep
// 64 rows of the fp32 accumulator in registers and run
// wgmma.mma_async.m64nBNk16 on a ring of STAGES shared-memory tiles of
// BK = 64; warpgroup 2 is the producer.  A is K-major, as wgmma takes it;
// B is (K, N) row-major, so it is MN-major and goes in with the
// transpose-B flag.  Both live in shared memory in the 128-byte swizzled
// layout, so wgmma reads them without bank conflicts.
//   route "tma": one producer thread fills each stage with TMA
//   (cp.async.bulk.tensor.2d) and mbarrier completion.  The tensor maps,
//   made per call on the host, describe the K SLICE (dims (K, M) and
//   (N, K) with the parent's row strides), so TMA's out-of-bounds zero
//   fill lands at the slice's edge and never reads the next K blocks.
//   route "async": for operands TMA cannot take (a base or a row stride
//   not a multiple of 16 bytes) the whole producer warpgroup loads the
//   same tiles with masked scalar loads into the same swizzled layout,
//   then fences the generic proxy against the async proxy that wgmma
//   reads through.  Same consumers, same results.
// The accumulator is seeded from acc_in straight into the wgmma
// registers (each thread's rows and columns of the D fragment); without
// a seed the first wgmma runs with scale-d 0.  The epilogue writes fp32
// or bf16 from registers, with the ragged M and N edges masked.  The bk
// of the reference is not a tile here: it is the preemption unit, and the
// wrapper cuts the K slice by it.
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int BM = 128;            // rows a block: two consumer warpgroups
constexpr int BK = 64;             // K a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = 384;       // 2 consumer warpgroups + 1 producer
constexpr int A_BYTES = BM * BK * 2;          // 16 KB a stage
constexpr int BOX_N = 64;                     // B columns a TMA box

template <int BN> struct Tile {
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // ring, then full[STAGES] and empty[STAGES] mbarriers; +1024 to align
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// D (64 x N, fp32, N/2 registers a thread) += A (64 x 16, K-major, smem)
// @ B (16 x N, MN-major, smem: transpose-B flag 1); scale_d 0 ignores D
template <int N> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16\n"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};
template <> struct Wgmma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16\n"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},\n"
      " %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
  }
};

// A stage: 128 rows of 64 k (128 bytes), 16-byte chunk c of row r at
// r*128 + ((c ^ (r % 8)) * 16): what TMA's 128-byte swizzle writes
__device__ __forceinline__ int a_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
// B stage: BN/64 boxes of 64 k rows x 64 n (8 KB each), same swizzle
__device__ __forceinline__ int b_off(int k, int n) {
  return (n / BOX_N) * (BK * 128) + k * 128 + ((((n % BOX_N) >> 3) ^ (k & 7))
                                               << 4);
}

struct Args {
  const __nv_bfloat16* A;   // slice base, for the async route
  const __nv_bfloat16* B;
  const float* acc_in;      // null: zero seed
  void* C;
  int M, N, K;
  i64 lda, ldb, ldacc, ldc;
  bool pairs;   // C and acc_in rows take aligned 2-element accesses
};

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the async route's producer: stage `s` of K tile `kt` through masked
// scalar loads by the 128 producer threads (t = 0..127)
template <int BN>
__device__ __forceinline__ void fill_stage_async(const Args& g, char* st,
                                                 int m0, int n0, int k0,
                                                 int t) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int q = t; q < BM * (BK / 8); q += 128) {       // A: 8 k a chunk
    const int r = q / (BK / 8), c = q % (BK / 8);
    const int m = m0 + r;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int k = k0 + c * 8 + e;
      const __nv_bfloat16* p = g.A + (i64)m * g.lda + k;
      w[e / 2] = pack(m < g.M && k < g.K ? p[0] : zero,
                      m < g.M && k + 1 < g.K ? p[1] : zero);
    }
    *reinterpret_cast<uint4*>(st + a_off(r, c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  char* bs = st + A_BYTES;
  for (int q = t; q < BK * (BN / 8); q += 128) {       // B: 8 n a chunk
    const int kr = q / (BN / 8), c = q % (BN / 8);
    const int k = k0 + kr;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int n = n0 + c * 8 + e;
      const __nv_bfloat16* p = g.B + (i64)k * g.ldb + n;
      w[e / 2] = pack(k < g.K && n < g.N ? p[0] : zero,
                      k < g.K && n + 1 < g.N ? p[1] : zero);
    }
    *reinterpret_cast<uint4*>(bs + b_off(kr, c * 8)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  // generic-proxy stores, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int BN, bool TMA, typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, const Args g) {
  using T = Tile<BN>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * T::STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (g.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);          // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int t = tid - 256;
    if (TMA && t != 0) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES, round = kt / STAGES;
      if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
      char* st = smem + s * T::STAGE_BYTES;
      if constexpr (TMA) {
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, T::STAGE_BYTES);
        tma_load_2d(smem_u32(st), &map_a, bar, kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / BOX_N; ++j)
          tma_load_2d(smem_u32(st + A_BYTES + j * BK * 128), &map_b, bar,
                      n0 + j * BOX_N, kt * BK);
      } else {
        fill_stage_async<BN>(g, st, m0, n0, kt * BK, t);
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (t == 0) mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int lane = tid % 32, warp = (tid % 128) / 32;
    // D fragment: register i of this thread holds row
    // warp*16 + lane/4 + 8*((i/2)%2), column (i/4)*8 + (lane%4)*2 + i%2
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + (lane % 4) * 2;
    float d[BN / 2];
    const bool seeded = g.acc_in != nullptr;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int m = row0 + 8 * ((i / 2) % 2), n = col0 + (i / 4) * 8;
      float2 x = make_float2(0.f, 0.f);
      if (seeded && m < g.M) {
        const float* p = g.acc_in + (i64)m * g.ldacc + n;
        if (g.pairs && n + 1 < g.N) {
          x = *reinterpret_cast<const float2*>(p);
        } else {
          if (n < g.N) x.x = p[0];
          if (n + 1 < g.N) x.y = p[1];
        }
      }
      d[i] = x.x;
      d[i + 1] = x.y;
    }
    const uint32_t a_base = smem_u32(smem) + wg * (64 * 128);
    const uint32_t b_base = smem_u32(smem) + A_BYTES;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
      const uint32_t a_st = a_base + s * T::STAGE_BYTES;
      const uint32_t b_st = b_base + s * T::STAGE_BYTES;
      fence_operands(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 k are 32 bytes along the swizzled row; 8-row groups 1 KB
        // apart.  B: 16 k are 16 rows of 128 bytes; 8-row groups 1 KB
        // apart (stride), 64-column boxes 8 KB apart (leading).
        const uint64_t da = gmma_desc(a_st + kk * 32, 16, 1024);
        const uint64_t db = gmma_desc(b_st + kk * 16 * 128, BK * 128, 1024);
        Wgmma<BN>::run(d, da, db, (seeded || kt > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      fence_operands(d);
      wgmma_wait<1>();                 // the previous stage's group is done
      if (kt > 0 && lane == 0)
        mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_operands(d);

    Tout* C = static_cast<Tout*>(g.C);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int m = row0 + 8 * ((i / 2) % 2), n = col0 + (i / 4) * 8;
      if (m >= g.M) continue;
      Tout* p = C + (i64)m * g.ldc + n;
      if (g.pairs && n + 1 < g.N) {
        store_pair(p, d[i], d[i + 1]);
      } else {
        if (n < g.N) p[0] = from_float<Tout>(d[i]);
        if (n + 1 < g.N) p[1] = from_float<Tout>(d[i + 1]);
      }
    }
  }
}

// 2-D bf16 tensor map of a row-major (rows, cols) view with row stride
// `ld` elements, boxes of (box_rows, 64) with the 128-byte swizzle; reads
// outside (rows, cols) are zero.  Returns 0 or the driver's error.
int make_map(CUtensorMap* map, const void* base, int rows, int cols, i64 ld,
             int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                 const_cast<void*>(base), dims, strides, box, estr,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool TMA, typename Tout>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const Args& g,
           cudaStream_t s) {
  auto kern = gemm_wgmma_kernel<BN, TMA, Tout>;
  static bool ready = false;             // raise the smem limit once
  if (!ready) {
    const cudaError_t e = allow_smem(kern, Tile<BN>::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  kern<<<grid, THREADS, Tile<BN>::SMEM, s>>>(ma, mb, g);
  return (int)cudaGetLastError();
}

template <int BN, bool TMA>
int launch_out(int out_dtype, const CUtensorMap& ma, const CUtensorMap& mb,
               const Args& g, cudaStream_t s) {
  return out_dtype == 0 ? launch<BN, TMA, float>(ma, mb, g, s)
                        : launch<BN, TMA, __nv_bfloat16>(ma, mb, g, s);
}

template <int BN>
int launch_route(int tma, int out_dtype, const CUtensorMap& ma,
                 const CUtensorMap& mb, const Args& g, cudaStream_t s) {
  return tma ? launch_out<BN, true>(out_dtype, ma, mb, g, s)
             : launch_out<BN, false>(out_dtype, ma, mb, g, s);
}

}  // namespace

// bf16 A (M, K) and B (K, N), both the K slice to multiply; acc_in fp32
// (M, N) or null (zero seed); C fp32 (out_dtype 0) or bf16 (1).  tma 1:
// the TMA route (the wrapper's plan checked 16-byte bases and row
// strides); 0: the async route.  bn: 128 or 192.  Returns 0, a CUDA
// error of the launch, or 1000 + the driver's error of a tensor map.
extern "C" int repro_gemm_bf16(int out_dtype, int tma, int bn, const void* A,
                               const void* B, const void* acc_in, void* C,
                               int M, int N, int K, i64 lda, i64 ldb,
                               i64 ldacc, i64 ldc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cb = out_dtype == 0 ? 8 : 4;   // bytes of an output pair
  const bool pairs = ldc % 2 == 0 && (uintptr_t)C % cb == 0 &&
                     (acc_in == nullptr ||
                      (ldacc % 2 == 0 && (uintptr_t)acc_in % 8 == 0));
  Args g{(const __nv_bfloat16*)A, (const __nv_bfloat16*)B,
         (const float*)acc_in, C, M, N, K, lda, ldb, ldacc, ldc, pairs};
  CUtensorMap ma, mb;
  memset(&ma, 0, sizeof(ma));
  memset(&mb, 0, sizeof(mb));
  if (tma) {
    int e = make_map(&ma, A, M, K, lda, BM);
    if (e == 0) e = make_map(&mb, B, K, N, ldb, BK);
    if (e != 0) return 1000 + e;
  }
  switch (bn) {
    case 128: return launch_route<128>(tma, out_dtype, ma, mb, g, s);
    case 192: return launch_route<192>(tma, out_dtype, ma, mb, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
