// Causal (or full) flash attention for Hopper (sm_90a) in fp32, the parity
// path of the prefill, with an optional local window (the hybrid family's
// banded attention), a query offset (chunked prefill) and a score cap.
// bf16, the serving path, runs on the tensor-core kernel in
// flash_attention_wgmma.cu.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu
// (_flash_kernel), and with a window the banded attention of
// src/repro/models/attention.py::local_attention, for fp32.
//
// What bounds it on the H100: a causal pass over S tokens does
// ~S^2*(dqk+dv) FLOP per query head on S*(2*dqk+2*dv) values; in fp32 outside the tensor cores
// (67 TFLOP/s) the 512-token prompt is operations-bound; the 8-token
// serving prompt is launch-bound.
//
// What the design does about it, simply and right first: a grid of
// (B*Hq, ceil(S/BQ)) blocks.  A block owns BQ query rows, one thread per
// row, with the row's running max m, sum l and fp32 accumulator acc[DV] in
// registers (the reference keeps them in VMEM scratch across its sequential
// KV grid axis; here the KV loop runs inside the block).  It walks KV tiles
// of BKV keys staged in shared memory, only up to its diagonal: KV tiles the
// reference skips as fully masked (ki*bkv >= (qi+1)*bq) are never loaded.
// Query row r sits at position q_offset + r (the reference's q_offset: a
// later chunk of a prompt against the keys of all earlier ones).  With a
// window W > 0 a key k is live for the query at position p when
// p - W < k <= p, and KV tiles wholly below the band of the block's first
// row are skipped the same way, so a banded pass costs O(S * W).  A
// softcap c > 0 maps the scaled score s to c * tanh(s / c) before the mask
// (the reference's order).  Per tile it applies the
// reference's online softmax in fp32: mask, m_new,
// p = exp(s - m_new) * (s > NEG_INF*0.5), corr = exp(m - m_new).  GQA maps
// query head h to KV head h / G.  Every tensor goes in through its strides,
// so the model's (B,S,H,dh) q/k/v are passed as views; the ragged S edge
// (an 8-token prompt fits no tile) is masked.  Q and K rows are DQK wide,
// V rows and the accumulator DV wide: MLA's prefill has dqk 192 and dv 128
// (its smoke config 24 and 16), the other families dqk == dv; the scale is
// the caller's (dqk ** -0.5).  The tiles live in dynamic shared memory: at
// dh 256 they take 65 KB, over the 48 KB a static array may hold.  At
// dh 256 acc[256] does not fit in registers and spills to local memory
// (ptxas reports it); the parity path accepts that.
#include "common.cuh"

// The capped instantiations (softcap > 0) are an object of their own:
// kernels/_build.py compiles this file a second time with
// REPRO_FLASH_CAP=1, so that the uncapped kernels carry no tanhf and the
// two halves compile side by side.
#ifndef REPRO_FLASH_CAP
#define REPRO_FLASH_CAP 0
#endif

namespace repro {
// the capped instantiations' dispatch, defined where this file is built
// with REPRO_FLASH_CAP=1
int flash_f32_capped(int dqk, int dv, const void* q, const void* k,
                     const void* v, void* o, int B, int Hq, int Hkv, int S,
                     int Skv, int causal, int window, int q_offset,
                     const i64* st, float scale, float softcap,
                     cudaStream_t s);
}  // namespace repro

using namespace repro;

namespace {

template <int DQK, int DV> struct Tile {
  // 64 query rows and 32 keys per tile; a head dim of 128 or more halves
  // both, so a block's tiles stay at 33 KB (dh 128), 45 KB (192/128) and
  // 65 KB (dh 256)
  static constexpr int DMAX = DQK > DV ? DQK : DV;
  static constexpr int BQ = DMAX >= 128 ? 32 : 64;
  static constexpr int BKV = DMAX >= 128 ? 16 : 32;
  // q padded by one column: each thread reads its own row; k and v rows
  // are read by every thread at once
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * (DQK + 1) + (size_t)BKV * (DQK + DV));
};

template <typename T, int DQK, int DV, bool CAP>
__global__ void __launch_bounds__(Tile<DQK, DV>::BQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int S, int Skv, int causal, int window, int q_offset, i64 sqb,
             i64 sqh, i64 sqs, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh,
             i64 svs, i64 sob, i64 soh, i64 sos, float scale, float softcap) {
  constexpr int BQ = Tile<DQK, DV>::BQ, BKV = Tile<DQK, DV>::BKV;
  extern __shared__ float smem[];
  float(*qs)[DQK + 1] = reinterpret_cast<float(*)[DQK + 1]>(smem);
  float(*ks)[DQK] = reinterpret_cast<float(*)[DQK]>(smem + BQ * (DQK + 1));
  float(*vs)[DV] = reinterpret_cast<float(*)[DV]>(smem + BQ * (DQK + 1) +
                                                  BKV * DQK);
  const int t = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int qrow = q0 + t;
  const int qpos = q_offset + qrow;  // the row's absolute position

  const T* qb = q + b * sqb + hq * sqh;
  for (int i = t; i < BQ * DQK; i += BQ) {
    const int r = i / DQK, d = i % DQK;
    qs[r][d] = (q0 + r < S) ? to_float(qb[(q0 + r) * sqs + d]) : 0.f;
  }
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  float m = NEG_INF, l = 0.f;
  float acc[DV];
#pragma unroll
  for (int d = 0; d < DV; ++d) acc[d] = 0.f;

  // live keys: below (block's last position + 1) when causal, the
  // reference's block-skipping rule with the block's own edge; with a
  // window, from the first tile that reaches the band of the block's first
  // row
  const int p0 = q_offset + q0;
  const int kv_end = causal ? min(Skv, p0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) / BKV * BKV : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    for (int i = t; i < BKV * DQK; i += BQ) {
      const int r = i / DQK, d = i % DQK, kp = k0 + r;
      ks[r][d] = kp < Skv ? to_float(kb[kp * sks + d]) : 0.f;
    }
    for (int i = t; i < BKV * DV; i += BQ) {
      const int r = i / DV, d = i % DV, kp = k0 + r;
      vs[r][d] = kp < Skv ? to_float(vb[kp * svs + d]) : 0.f;
    }
    __syncthreads();

    float s[BKV];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DQK; ++d) dot = fmaf(qs[t][d], ks[j][d], dot);
      const int kp = k0 + j;
      const bool live = kp < Skv && (!causal || kp <= qpos) &&
                        (window <= 0 || kp > qpos - window);
      float sc = dot * scale;
      if (CAP) sc = softcap * tanhf(sc / softcap);
      s[j] = live ? sc : NEG_INF;
      m_new = fmaxf(m_new, s[j]);
    }
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      const float p = expf(s[j] - m_new) * (s[j] > NEG_INF * 0.5f ? 1.f : 0.f);
      psum += p;
      s[j] = round_to<T>(p);  // p.astype(v.dtype)
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < DV; ++d) {
      float a = acc[d] * corr;
#pragma unroll
      for (int j = 0; j < BKV; ++j) a = fmaf(s[j], vs[j][d], a);
      acc[d] = a;
    }
    m = m_new;
  }

  if (qrow < S) {
    T* ob = o + b * sob + hq * soh + qrow * sos;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DV; ++d) ob[d] = from_float<T>(acc[d] * inv);
  }
}

template <typename T, int DQK, int DV, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Skv, int causal, int window,
           int q_offset, const i64* st, float scale, float softcap,
           cudaStream_t s) {
  constexpr int BQ = Tile<DQK, DV>::BQ;
  constexpr size_t smem = Tile<DQK, DV>::SMEM;
  cudaError_t e = allow_smem(flash_kernel<T, DQK, DV, CAP>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_kernel<T, DQK, DV, CAP><<<grid, BQ, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, S, Skv, causal,
      window, q_offset, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, bool CAP>
int dispatch(int dqk, int dv, const void* q, const void* k, const void* v,
             void* o, int B, int Hq, int Hkv, int S, int Skv, int causal,
             int window, int q_offset, const i64* st, float scale,
             float softcap, cudaStream_t s) {
  // the (dqk, dv) pairs: kernels/flash_attention.py::HEAD_DIMS
#define REPRO_FLASH_CASE(DQK, DV)                                           \
  if (dqk == DQK && dv == DV)                                               \
    return launch<T, DQK, DV, CAP>(q, k, v, o, B, Hq, Hkv, S, Skv, causal,   \
                                   window, q_offset, st, scale, softcap, s);
  REPRO_FLASH_CASE(16, 16)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(64, 64)
  REPRO_FLASH_CASE(128, 128)
  REPRO_FLASH_CASE(256, 256)
  REPRO_FLASH_CASE(192, 128)
  REPRO_FLASH_CASE(24, 16)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#if REPRO_FLASH_CAP
int repro::flash_f32_capped(int dqk, int dv, const void* q, const void* k,
                            const void* v, void* o, int B, int Hq, int Hkv,
                            int S, int Skv, int causal, int window,
                            int q_offset, const i64* st, float scale,
                            float softcap, cudaStream_t s) {
  return dispatch<float, true>(
      dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv, causal, window, q_offset, st,
      scale, softcap, s);
}
#else
// fp32 only; (dqk, dv) one of the pairs of dispatch; window 0 means none,
// > 0 needs causal; q_offset >= 0 is the position of q's first row;
// softcap 0 means none.  Strides are in elements, (batch, head, sequence)
// for q, k, v and o; the last dimension is contiguous.
extern "C" int repro_flash_attention_f32(
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
  if (softcap > 0.f)
    return repro::flash_f32_capped(dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv,
                                   causal, window, q_offset, st, scale,
                                   softcap, s);
  return dispatch<float, false>(
      dqk, dv, q, k, v, o, B, Hq, Hkv, S, Skv, causal, window, q_offset, st,
      scale, softcap, s);
}
#endif
