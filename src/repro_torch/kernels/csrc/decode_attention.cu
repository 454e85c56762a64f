// Flash-decoding for Hopper (sm_90a): one new query token per sequence
// against its KV cache, keys past `pos` masked.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_tpu
// (_decode_kernel).
//
// What bounds it on the H100: it reads each live cache row once and does
// ~4*G*dh FLOP per row, so bytes bound it (3.35 TB/s): at TinyLlama width
// (Hkv 4, dh 64, bf16) a layer's live cache is 1 KB per position.
//
// What the design does about it: the reference runs one grid row per
// (batch, kv head) and walks S in sequence with (m, l, acc) in VMEM.  At
// batch 1 and 4 KV heads that layout would fill 4 of the 132 SMs.  Here S
// is split: a grid of (B*Hkv, n_split) blocks, each taking the G query heads
// of one KV head over one chunk of CHUNK positions, and only chunks that
// start at or before `pos` are launched (the wrapper sizes n_split from the
// host-side `pos`), so work past `pos` costs nothing.  Each block stages its
// K chunk and then its V chunk in shared memory (reading each row once,
// coalesced along dh, through the caller's strides so the model's
// (B,S,Hkv,dh) cache goes in as a view), computes the chunk's scores,
// max, probabilities and partial PV product, and writes partial
// (m, l, acc) to scratch the wrapper allocates.  A second kernel combines
// the partials.  The reference's guards are kept: masked probabilities are
// zeroed by the (s > NEG_INF*0.5) factor, p is rounded to v's dtype before
// the PV product, and the output is divided by max(l, 1e-30).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int CHUNK = 64;     // cache positions per block
constexpr int THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int Hkv, int G, int dh, int pos, int n_split, i64 sqb,
                    i64 sqh, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh,
                    i64 svs, float scale) {
  extern __shared__ float smem[];
  const int ldk = dh + 1;  // padded: threads walk rows, conflict-free
  float* qs = smem;                  // [G][dh]
  float* kv = qs + G * dh;           // [CHUNK][dh + 1], K then V
  float* ps = kv + CHUNK * ldk;      // [G][CHUNK]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int s0 = split * CHUNK;

  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh, d = i % dh;
    qs[i] = to_float(q[b * sqb + (i64)(h * G + g) * sqh + d]);
  }
  const T* kb = k + b * skb + h * skh;
  for (int i = tid; i < CHUNK * dh; i += THREADS) {
    const int j = i / dh, d = i % dh, s = s0 + j;
    kv[j * ldk + d] = s <= pos ? to_float(kb[s * sks + d]) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < G * CHUNK; i += THREADS) {
    const int g = i / CHUNK, j = i % CHUNK;
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot = fmaf(qs[g * dh + d], kv[j * ldk + d], dot);
    ps[i] = (s0 + j <= pos) ? dot * scale : NEG_INF;
  }
  __syncthreads();

  // one warp per query head: chunk max, probabilities, their sum
  for (int g = warp; g < G; g += THREADS / 32) {
    float m = NEG_INF;
    for (int j = lane; j < CHUNK; j += 32) m = fmaxf(m, ps[g * CHUNK + j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < CHUNK; j += 32) {
      const float s = ps[g * CHUNK + j];
      const float p = expf(s - m) * (s > NEG_INF * 0.5f ? 1.f : 0.f);
      l += p;
      ps[g * CHUNK + j] = round_to<T>(p);  // p.astype(v.dtype)
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      part_m[(i64)(bh * n_split + split) * G + g] = m;
      part_l[(i64)(bh * n_split + split) * G + g] = l;
    }
  }
  __syncthreads();

  const T* vb = v + b * svb + h * svh;
  for (int i = tid; i < CHUNK * dh; i += THREADS) {
    const int j = i / dh, d = i % dh, s = s0 + j;
    kv[j * ldk + d] = s <= pos ? to_float(vb[s * svs + d]) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < G * dh; i += THREADS) {
    const int g = i / dh, d = i % dh;
    float acc = 0.f;
    for (int j = 0; j < CHUNK; ++j)
      acc = fmaf(ps[g * CHUNK + j], kv[j * ldk + d], acc);
    part_acc[((i64)(bh * n_split + split) * G + g) * dh + d] = acc;
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int G, int dh,
                                      int n_split) {
  const int row = blockIdx.x;  // (b*Hkv + h)*G + g == b*Hq + hq
  const int bh = row / G, g = row % G;
  float m = NEG_INF;
  for (int sp = 0; sp < n_split; ++sp)
    m = fmaxf(m, part_m[(i64)(bh * n_split + sp) * G + g]);
  float l = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const i64 r = (i64)(bh * n_split + sp) * G + g;
    l += part_l[r] * expf(part_m[r] - m);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const i64 r = (i64)(bh * n_split + sp) * G + g;
      acc += part_acc[r * dh + d] * expf(part_m[r] - m);
    }
    out[(i64)row * dh + d] = from_float<T>(acc * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* pm, float* pl, float* pacc, int B, int Hkv, int G, int dh,
           int pos, int n_split, i64 sqb, i64 sqh, i64 skb, i64 skh, i64 sks,
           i64 svb, i64 svh, i64 svs, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) *
                      ((size_t)G * dh + (size_t)CHUNK * (dh + 1) +
                       (size_t)G * CHUNK);
  cudaError_t e = allow_smem(decode_split_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  decode_split_kernel<T><<<dim3(B * Hkv, n_split), THREADS, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, pm, pl, pacc, Hkv, G, dh, pos,
      n_split, sqb, sqh, skb, skh, sks, svb, svh, svs, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = dh < 32 ? 32 : (dh > 1024 ? 1024 : dh);
  decode_combine_kernel<T><<<B * Hkv * G, threads, 0, s>>>(
      pm, pl, pacc, (T*)out, G, dh, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  out is a contiguous (B, Hq, dh)
// buffer; part_m / part_l hold (B*Hkv, n_split, G) floats and part_acc
// (B*Hkv, n_split, G, dh).  n_split must be pos / CHUNK + 1.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* part_m, void* part_l, void* part_acc, int B, int Hkv, int G,
    int dh, int pos, int n_split, i64 sqb, i64 sqh, i64 skb, i64 skh,
    i64 sks, i64 svb, i64 svh, i64 svs, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split != pos / CHUNK + 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, out, (float*)part_m, (float*)part_l,
                         (float*)part_acc, B, Hkv, G, dh, pos, n_split, sqb,
                         sqh, skb, skh, sks, svb, svh, svs, scale, s);
  return launch<__nv_bfloat16>(q, k, v, out, (float*)part_m, (float*)part_l,
                               (float*)part_acc, B, Hkv, G, dh, pos, n_split,
                               sqb, sqh, skb, skh, sks, svb, svh, svs, scale,
                               s);
}
