// Checkpointable GEMM for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/systolic_gemm.py::gemm_partial
// (_gemm_partial_kernel) and ::systolic_gemm (_gemm_kernel).  One kernel
// computes  C = cast(acc_seed + A[:, k-range] @ B[k-range, :])  where the
// seed is the saved fp32 accumulator (gemm_partial, the paper's
// step_wise_mvout / resume) or zero (systolic_gemm), and the output is the
// fp32 accumulator itself or its cast to the output dtype.
//
// What bounds it on the H100: at the main path's shapes (1024^3 fp32, and
// 512x2048x5632 bf16 at TinyLlama width) a product does ~2 GFLOP-12 GFLOP
// on a few MB, far above the 295 FLOP/byte ridge, so operations bound it:
// 67 TFLOP/s for fp32 without tensor cores (fp32 must stay out of TF32 for
// the reference's rtol 1e-4 preempt/resume chain), 989 TFLOP/s for bf16.
//
// What the design does about it, simply and right first: a grid of
// (N/64, M/64) output tiles, each block holding its 64x64 fp32 accumulator
// on chip for the whole K range.  The TPU kernel's sequential K grid axis
// (with dimension_semantics and a CostEstimate for the pipeliner) becomes
// the K loop inside the block; blocks run in parallel and in no order.
// fp32 inputs: 16x16 threads, each a 4x4 register tile, FFMA from
// shared-memory tiles.  bf16 inputs: 4 warps of WMMA 16x16x16 bf16 products
// with fp32 accumulation; the accumulator is seeded from acc_in through
// shared memory.  Ragged M/N/K edges are zero-filled on load and masked on
// store (gemm_partial has no M/N divisibility assert).  wgmma, TMA and a
// multi-stage smem ring are later work.
#include <mma.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int F_TM = 64, F_TN = 64, F_TK = 16;  // fp32 FFMA tile

template <typename Tout>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ acc_in, Tout* __restrict__ C,
                int M, int N, int K, i64 lda, i64 ldb, i64 ldacc, i64 ldc) {
  __shared__ float As[F_TK][F_TM + 4];  // As[k][m]
  __shared__ float Bs[F_TK][F_TN + 4];  // Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * F_TM, n0 = blockIdx.x * F_TN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      acc[i][j] = (acc_in != nullptr && m < M && n < N)
                      ? acc_in[(i64)m * ldacc + n] : 0.f;
    }

  for (int k0 = 0; k0 < K; k0 += F_TK) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (F_TM * F_TK) / 256; ++r) {
      const int idx = tid + 256 * r;
      const int ml = idx / F_TK, kl = idx % F_TK;
      const int m = m0 + ml, k = k0 + kl;
      As[kl][ml] = (m < M && k < K) ? A[(i64)m * lda + k] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (F_TK * F_TN) / 256; ++r) {
      const int idx = tid + 256 * r;
      const int kl = idx / F_TN, nl = idx % F_TN;
      const int k = k0 + kl, n = n0 + nl;
      Bs[kl][nl] = (k < K && n < N) ? B[(i64)k * ldb + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) C[(i64)m * ldc + n] = from_float<Tout>(acc[i][j]);
    }
}

constexpr int W_BM = 64, W_BN = 64, W_BK = 32;  // bf16 WMMA tile
constexpr int W_LDA = W_BK + 8, W_LDB = W_BN + 8, W_LDC = W_BN + 4;

template <typename Tout>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B,
                 const float* __restrict__ acc_in, Tout* __restrict__ C,
                 int M, int N, int K, i64 lda, i64 ldb, i64 ldacc, i64 ldc) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[W_BM * W_LDA];  // (m, k)
  __shared__ __align__(128) __nv_bfloat16 Bs[W_BK * W_LDB];  // (k, n)
  __shared__ __align__(128) float Cs[W_BM * W_LDC];          // (m, n)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // each warp: 32x32 of the tile
  const int m0 = blockIdx.y * W_BM, n0 = blockIdx.x * W_BN;

  // seed the accumulator: saved fp32 accumulator or zero
  for (int idx = tid; idx < W_BM * W_BN; idx += 128) {
    const int ml = idx / W_BN, nl = idx % W_BN;
    const int m = m0 + ml, n = n0 + nl;
    Cs[ml * W_LDC + nl] = (acc_in != nullptr && m < M && n < N)
                              ? acc_in[(i64)m * ldacc + n] : 0.f;
  }
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(
          cf[i][j], &Cs[(wm * 32 + i * 16) * W_LDC + wn * 32 + j * 16],
          W_LDC, wmma::mem_row_major);

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int k0 = 0; k0 < K; k0 += W_BK) {
    __syncthreads();
    for (int idx = tid; idx < W_BM * W_BK; idx += 128) {
      const int ml = idx / W_BK, kl = idx % W_BK;
      const int m = m0 + ml, k = k0 + kl;
      As[ml * W_LDA + kl] = (m < M && k < K) ? A[(i64)m * lda + k] : zero;
    }
    for (int idx = tid; idx < W_BK * W_BN; idx += 128) {
      const int kl = idx / W_BN, nl = idx % W_BN;
      const int k = k0 + kl, n = n0 + nl;
      Bs[kl * W_LDB + nl] = (k < K && n < N) ? B[(i64)k * ldb + n] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * 32 + i * 16) * W_LDA + kk],
                               W_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[kk * W_LDB + wn * 32 + j * 16],
                               W_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(cf[i][j], af[i], bf[j], cf[i][j]);
    }
  }

  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          &Cs[(wm * 32 + i * 16) * W_LDC + wn * 32 + j * 16], cf[i][j],
          W_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < W_BM * W_BN; idx += 128) {
    const int ml = idx / W_BN, nl = idx % W_BN;
    const int m = m0 + ml, n = n0 + nl;
    if (m < M && n < N)
      C[(i64)m * ldc + n] = from_float<Tout>(Cs[ml * W_LDC + nl]);
  }
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16.  acc_in may be null
// (zero seed).  Returns cudaGetLastError() after the launch.
extern "C" int repro_gemm(int in_dtype, int out_dtype, const void* A,
                          const void* B, const void* acc_in, void* C, int M,
                          int N, int K, i64 lda, i64 ldb, i64 ldacc, i64 ldc,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* acc = (const float*)acc_in;
  if (in_dtype == 0) {
    dim3 grid((N + F_TN - 1) / F_TN, (M + F_TM - 1) / F_TM);
    if (out_dtype == 0)
      gemm_f32_kernel<float><<<grid, 256, 0, s>>>(
          (const float*)A, (const float*)B, acc, (float*)C, M, N, K, lda,
          ldb, ldacc, ldc);
    else
      gemm_f32_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
          (const float*)A, (const float*)B, acc, (__nv_bfloat16*)C, M, N, K,
          lda, ldb, ldacc, ldc);
  } else {
    dim3 grid((N + W_BN - 1) / W_BN, (M + W_BM - 1) / W_BM);
    if (out_dtype == 0)
      gemm_bf16_kernel<float><<<grid, 128, 0, s>>>(
          (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, acc, (float*)C,
          M, N, K, lda, ldb, ldacc, ldc);
    else
      gemm_bf16_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(
          (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, acc,
          (__nv_bfloat16*)C, M, N, K, lda, ldb, ldacc, ldc);
  }
  return (int)cudaGetLastError();
}
