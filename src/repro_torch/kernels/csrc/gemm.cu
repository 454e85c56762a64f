// Checkpointable GEMM, fp32 inputs, for Hopper (sm_90a): pipelined FFMA.
//
// Replaces: src/repro/kernels/systolic_gemm.py::gemm_partial
// (_gemm_partial_kernel) and ::systolic_gemm (_gemm_kernel) for fp32
// operands (bf16 operands go to the wgmma kernel in gemm_wgmma.cu).  One
// kernel computes  C = cast(seed + A @ B)  where A (M, K) and B (K, N) are
// the K slice [k_begin*bk, k_end*bk) of the caller's operands, the seed
// is the saved fp32 accumulator (gemm_partial, the paper's step_wise_mvout
// / resume) or zero (systolic_gemm), and C is the fp32 accumulator itself
// or its cast to the output dtype.
//
// What bounds it on the H100: the preemptible GEMM's calls (1024^2 x K 640,
// the 128^3 HI product) do 2*M*N*K FLOP on a few MB, above the ridge, so
// the CUDA cores bound it: 67 TFLOP/s.  fp32 stays off the tensor cores:
// TF32 keeps ~3 decimal digits and would miss the reference's rtol 1e-4
// preempt/resume chain.  At 128^3 the product is 4 MFLOP, a few
// microseconds on one SM, so there latency and the count of SMs in use
// bound it.
//
// What the design does about it: each block owns a BM x BN output tile
// whose fp32 accumulator stays in registers for the whole K slice; each of
// its threads holds a TM x 4 micro-tile (8x4 or 4x4) in registers, its
// rows in groups of 4 spread over the tile.  K runs in steps
// of BK = 32 through a ring of 3 shared-memory stages filled by
// cp.async (16-byte copies where every row starts 16-byte aligned, VEC;
// 4-byte copies otherwise, e.g. a slice that starts at k_begin*bk floats
// with bk not a multiple of 4), with zero fill outside the operands, so
// the next stages' loads overlap this stage's FFMAs and a step costs one
// __syncthreads.  A keeps its (m, k) layout in shared memory (rows padded
// to 36 floats) and is read 4 k at a time as float4, which, like the
// float4 reads of B's rows, a warp serves as broadcasts without bank
// conflicts.  The tile comes from the wrapper's gemm_plan
// (kernels/systolic_gemm.py): 128x64 where that still puts blocks on
// most of the 132 SMs (1024^2: 128 blocks, one wave; 128x128 would leave
// half the card idle), else 32x32 (the 128^3 product: 16 blocks).
// No atomics: repeated calls are bit-identical.  The TPU kernel's
// sequential K grid axis becomes the K loop inside the block.  BK 32 and
// 3 stages were measured against BK 8 / 16 and 4 stages on the H100
// (gemm_sweep.py, PERF.md): BK 16 cost ~17% at 1024^2 and ~24% at 128^3,
// a fourth stage ~1%.
#include <stdint.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int LDA = BK + 4;   // floats a row of a stage's A (m, k)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (16 or 4) from src, or zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const float* A;
  const float* B;
  const float* acc_in;   // null: zero seed
  void* C;
  int M, N, K;
  i64 lda, ldb, ldacc, ldc;
  bool quads;            // C and acc_in rows take aligned 4-float accesses
};

template <int BM, int BN> struct Smem {
  static constexpr int A = BM * LDA;        // floats a stage
  static constexpr int B = BK * (BN + 4);
  static constexpr int BYTES = STAGES * (A + B) * 4;
};

// K tile kt into stage s, every thread a share of the copies
template <int BM, int BN, int THREADS, bool VEC>
__device__ __forceinline__ void load_stage(const Args& g, float* as,
                                           float* bs, int m0, int n0, int k0,
                                           int tid) {
  constexpr int V = VEC ? 4 : 1;            // floats a copy
  for (int q = tid; q < BM * BK / V; q += THREADS) {
    const int r = q / (BK / V), c = (q % (BK / V)) * V;
    const int m = m0 + r, k = k0 + c;
    const bool ok = m < g.M && k < g.K;
    cp_async<4 * V>(as + r * LDA + c, ok ? g.A + (i64)m * g.lda + k : g.A, ok);
  }
  for (int q = tid; q < BK * BN / V; q += THREADS) {
    const int r = q / (BN / V), c = (q % (BN / V)) * V;
    const int k = k0 + r, n = n0 + c;
    const bool ok = k < g.K && n < g.N;
    cp_async<4 * V>(bs + r * (BN + 4) + c, ok ? g.B + (i64)k * g.ldb + n : g.B,
                    ok);
  }
}

template <typename T> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// each thread: TM rows (groups of 4, BM / (TM/4) apart) x 4 columns
template <int BM, int BN, int TM, bool VEC, typename Tout>
__global__ void __launch_bounds__((BM / TM) * (BN / 4))
gemm_f32_kernel(const Args g) {
  constexpr int THREADS = (BM / TM) * (BN / 4);
  constexpr int TX = BN / 4;                // threads along n
  constexpr int MG = TM / 4;                // groups of 4 rows
  using S = Smem<BM, BN>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // STAGES x (BM, LDA)
  float* Bs = smem + STAGES * S::A;          // STAGES x (BK, BN + 4)
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (g.K + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<BM, BN, THREADS, VEC>(g, As + s * S::A, Bs + s * S::B, m0,
                                       n0, s * BK, tid);
    cp_commit();
  }

  // the seed: the saved accumulator, or zero
  float acc[TM][4];
  const int n = n0 + tx * 4;                // this thread's first column
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / MG) + ty * 4 + i % 4;
    const float* p = g.acc_in + (i64)m * g.ldacc + n;
    if (g.acc_in != nullptr && m < g.M && g.quads && n + 3 < g.N) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      acc[i][0] = v.x;
      acc[i][1] = v.y;
      acc[i][2] = v.z;
      acc[i][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = (g.acc_in != nullptr && m < g.M && n + j < g.N) ? p[j]
                                                                  : 0.f;
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();        // this thread's copies of tile kt landed
    __syncthreads();              // everyone's did; stage (kt-1) is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<BM, BN, THREADS, VEC>(g, As + (nxt % STAGES) * S::A,
                                       Bs + (nxt % STAGES) * S::B, m0, n0,
                                       nxt * BK, tid);
    cp_commit();
    const float* as = As + (kt % STAGES) * S::A;
    const float* bs = Bs + (kt % STAGES) * S::B;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + ((i / 4) * (BM / MG) + ty * 4 + i % 4) * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * (BN + 4) + tx * 4);
        const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                           : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

  Tout* C = static_cast<Tout*>(g.C);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (BM / MG) + ty * 4 + i % 4;
    if (m >= g.M) continue;
    Tout* p = C + (i64)m * g.ldc + n;
    if (g.quads && n + 3 < g.N) {
      Quad<Tout>::store(p, acc[i]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < g.N) p[j] = from_float<Tout>(acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, bool VEC, typename Tout>
int launch(const Args& g, cudaStream_t s) {
  auto kern = gemm_f32_kernel<BM, BN, TM, VEC, Tout>;
  static bool ready = false;             // raise the smem limit once
  if (!ready) {
    const cudaError_t e = allow_smem(kern, Smem<BM, BN>::BYTES);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  kern<<<grid, (BM / TM) * (BN / 4), Smem<BM, BN>::BYTES, s>>>(g);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TM>
int launch_tile(int vec, int out_dtype, const Args& g, cudaStream_t s) {
  if (vec)
    return out_dtype == 0 ? launch<BM, BN, TM, true, float>(g, s)
                          : launch<BM, BN, TM, true, __nv_bfloat16>(g, s);
  return out_dtype == 0 ? launch<BM, BN, TM, false, float>(g, s)
                        : launch<BM, BN, TM, false, __nv_bfloat16>(g, s);
}

}  // namespace

// fp32 A (M, K) and B (K, N), both the K slice to multiply; acc_in fp32
// (M, N) or null (zero seed); C fp32 (out_dtype 0) or bf16 (1).  bm x bn:
// the plan's tile, 128x64 or 32x32.  vec 1: every
// row of A and B starts 16-byte aligned and K, N are multiples of 4 (the
// plan checked).  Returns cudaGetLastError() after the launch.
extern "C" int repro_gemm_f32(int out_dtype, int bm, int bn, int vec,
                              const void* A, const void* B, const void* acc_in,
                              void* C, int M, int N, int K, i64 lda, i64 ldb,
                              i64 ldacc, i64 ldc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cb = out_dtype == 0 ? 16 : 8;   // bytes of 4 outputs
  const bool quads = ldc % 4 == 0 && (uintptr_t)C % cb == 0 &&
                     (acc_in == nullptr ||
                      (ldacc % 4 == 0 && (uintptr_t)acc_in % 16 == 0));
  Args g{(const float*)A, (const float*)B, (const float*)acc_in, C, M, N, K,
         lda, ldb, ldacc, ldc, quads};
  if (bm == 128 && bn == 64)
    return launch_tile<128, 64, 8>(vec, out_dtype, g, s);
  if (bm == 32 && bn == 32)
    return launch_tile<32, 32, 4>(vec, out_dtype, g, s);
  return (int)cudaErrorInvalidValue;
}
