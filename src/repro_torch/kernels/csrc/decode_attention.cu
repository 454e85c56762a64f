// Flash-decoding for Hopper (sm_90a): one new query token per sequence
// against its KV cache, keys past `pos` masked, in one launch.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_tpu
// (_decode_kernel).
//
// What bounds it on the H100: it reads each live cache row once and does
// ~4*G*dh FLOP per row, so bytes bound it (3.35 TB/s): a TinyLlama layer at
// position 535 moves ~0.55 MB.  At batch 1 what holds it back is
// parallelism and latency, not arithmetic, so it runs on the CUDA cores.
//
// What the design does about it: the reference runs one grid row per
// (batch, kv head) and walks S in sequence with (m, l, acc) in VMEM; at
// batch 1 that would fill a few of the 132 SMs.  Here the grid is
// (n_split, n_grp, B*Hkv): the wrapper's split plan
// (kernels/decode_attention.py::split_plan) cuts the live positions
// [0, pos] into n_split chunks of `chunk` positions (a multiple of 16),
// enough blocks to fill the card where the cache allows; and the G query
// heads of a KV head go to n_grp groups of at most GM = 4 heads, which
// keeps a lane's q slice and accumulators in registers and gives the
// card more, lighter blocks.  Lanes run along dh with one 16-byte load
// each (8 bf16 or 4 fp32): a key's row takes LPK lanes, so a warp takes
// KPW keys at once (4 at bf16 dh 64, 1 at dh 256).  K and V of a key are
// loaded together straight into registers, through the caller's strides
// (the model's (B,S,Hkv,dh) cache goes in as a view), and the next key
// pair's loads are issued before this pair's arithmetic.  A score is the
// lane-slice dot reduced by __shfl_xor_sync across the key's lanes; every
// key slot keeps an online softmax (m, l, acc) per head, with the
// reference's guards: the (s > NEG_INF*0.5) factor, p rounded to v's
// dtype before the PV product, and max(l, 1e-30).  The key slots merge by
// shuffles, the warps in shared memory, and the block writes its partial
// (m, l, acc).
//
// The combine runs in the same launch, in two levels, so that no block
// folds more than FAN = 16 partials (one block folding 128 of them was
// the kernel's long pole on a full 2048-slot ring): the last block of
// each run of 16 splits folds the run's partials, and with more than one
// run the last of those folds the runs' results and writes `out`.  A
// block learns that it is last from a __threadfence() and an atomicAdd on
// a counter, and resets that counter to 0 itself, so the counters
// (zeroed once by the wrapper) are ready for the next launch and the call
// can be captured in a CUDA graph.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int GM = 4;   // query heads a block, at most
constexpr int FAN = 16;  // partials one block folds, at most

template <typename T, int DH> struct Lanes {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a load
  static constexpr int LPK = DH / VEC < 32 ? DH / VEC : 32;  // lanes a key
  static constexpr int KPW = 32 / LPK;              // keys a warp at once
  static constexpr int NV = DH / (VEC * LPK);       // loads a lane a row
  static constexpr int E = NV * VEC;                // elements a lane
};

// K and V rows of the key pair (jw + kw, jw + STEP + kw), where they are
// below s1; zeros elsewhere
template <typename T, int NV, int LPK, int VEC, int STEP>
__device__ __forceinline__ void load_pair(uint4 (&kr)[2][NV],
                                          uint4 (&vr)[2][NV],
                                          const T* kb, const T* vb, i64 sks,
                                          i64 svs, int jw, int kw, int s1) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int j = jw + x * STEP + kw;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      kr[x][u] = j < s1 ? __ldg(reinterpret_cast<const uint4*>(
                              kb + (i64)j * sks + u * LPK * VEC))
                        : make_uint4(0, 0, 0, 0);
      vr[x][u] = j < s1 ? __ldg(reinterpret_cast<const uint4*>(
                              vb + (i64)j * svs + u * LPK * VEC))
                        : make_uint4(0, 0, 0, 0);
    }
  }
}

// 16 bytes as VEC floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> fp32 is exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// True in every thread of the block that arrives last of `n` blocks at
// `counter`; that block resets the counter for the next launch.  What the
// n blocks wrote before arriving is visible to it (through L2).
__device__ __forceinline__ bool last_of(int* counter, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Fold the partials (m, l, acc) at rows row + i*G, i < count, of the gn
// heads of a group: a thread per (head, 4 columns) with an online max, so
// the loads of 8 partials go out together (__ldcg: other blocks wrote
// them).  The result goes to `out` normalised and cast to T or, when
// out is null, to the partial at row `orow`.
template <typename T, int DH>
__device__ __forceinline__ void fold(const float* pm, const float* pl,
                                     const float* pacc, i64 row, int G,
                                     int count, int gn, T* out, float* om,
                                     float* ol, float* oacc, i64 orow) {
  constexpr int DV = DH / 4;
  for (int i = threadIdx.x; i < gn * DV; i += THREADS) {
    const int g = i / DV, d4 = i % DV;
    float M = NEG_INF, Ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = 0; sp < count; ++sp) {
      const i64 r = row + (i64)sp * G + g;
      const float ms = __ldcg(pm + r), ls = __ldcg(pl + r);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(pacc + r * DH) + d4);
      const float mn = fmaxf(M, ms);
      const float c = __expf(M - mn), w = __expf(ms - mn);
      Ls = Ls * c + ls * w;
      a.x = fmaf(x.x, w, a.x * c);
      a.y = fmaf(x.y, w, a.y * c);
      a.z = fmaf(x.z, w, a.z * c);
      a.w = fmaf(x.w, w, a.w * c);
      M = mn;
    }
    if (out) {
      const float inv = 1.f / fmaxf(Ls, 1e-30f);
      T* od = out + g * DH + d4 * 4;
      od[0] = from_float<T>(a.x * inv);
      od[1] = from_float<T>(a.y * inv);
      od[2] = from_float<T>(a.z * inv);
      od[3] = from_float<T>(a.w * inv);
    } else {
      *reinterpret_cast<float4*>(oacc + (orow + g) * DH + d4 * 4) = a;
      if (d4 == 0) {
        om[orow + g] = M;
        ol[orow + g] = Ls;
      }
    }
  }
}

// a minimum of one block a multiprocessor: ptxas need not hold the
// registers down (and spill) to fit more blocks on one
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ part, int* __restrict__ counters, int Hkv,
              int G, int pos, int chunk, int n_split, i64 sqb,
              i64 sqh, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh, i64 svs,
              float scale) {
  using L = Lanes<T, DH>;
  constexpr int VEC = L::VEC, LPK = L::LPK, KPW = L::KPW, NV = L::NV,
                E = L::E;
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ __align__(16) float sm_acc[WARPS][GM][DH];
  __shared__ float sm_m[WARPS][GM], sm_l[WARPS][GM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, grp = blockIdx.y, bh = blockIdx.z;
  const int n_grp = gridDim.y;
  const int b = bh / Hkv, h = bh % Hkv;
  const int GB = (G + n_grp - 1) / n_grp;
  const int g0 = grp * GB, gn = min(GB, G - g0);
  const int li = lane % LPK, kw = lane / LPK;
  const int s0 = split * chunk, s1 = min(s0 + chunk, pos + 1);

  // the first key pair's loads go out before q's
  const T* kb = k + b * skb + h * skh + li * VEC;
  const T* vb = v + b * svb + h * svh + li * VEC;
  constexpr int STEP = WARPS * KPW;  // keys the block takes at once
  const int jw0 = s0 + warp * KPW;
  uint4 kr[2][NV], vr[2][NV];
  load_pair<T, NV, LPK, VEC, STEP>(kr, vr, kb, vb, sks, svs, jw0, kw, s1);

  // this lane's dh slice: element v*VEC + i is column (v*LPK + li)*VEC + i
  float qf[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < gn) {
      const T* qr = q + b * sqb + (i64)(h * G + g0 + g) * sqh + li * VEC;
#pragma unroll
      for (int u = 0; u < NV; ++u)
        unpack(__ldg(reinterpret_cast<const uint4*>(qr + u * LPK * VEC)),
               &qf[g][u * VEC], T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    }
  }
  float acc[GM][E], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // warp-uniform trip count; a key slot past s1 scores NEG_INF.  The next
  // pair's loads are issued before this pair's arithmetic.
  for (int jw = jw0; jw < s1; jw += 2 * STEP) {
    float kf[2][E], vf[2][E];
    bool ok[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      ok[x] = jw + x * STEP + kw < s1;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        unpack(kr[x][u], &kf[x][u * VEC], T());
        unpack(vr[x][u], &vf[x][u * VEC], T());
      }
    }
    if (jw + 2 * STEP < s1)
      load_pair<T, NV, LPK, VEC, STEP>(kr, vr, kb, vb, sks, svs,
                                       jw + 2 * STEP, kw, s1);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < gn) {
        float sc[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qf[g][e], kf[x][e], dot);
#pragma unroll
          for (int o = LPK / 2; o > 0; o /= 2)
            dot += __shfl_xor_sync(FULL, dot, o);
          sc[x] = ok[x] ? dot * scale : NEG_INF;
        }
        const float mn = fmaxf(m[g], fmaxf(sc[0], sc[1]));
        const float corr = __expf(m[g] - mn);
        const float p0 =
            __expf(sc[0] - mn) * (sc[0] > NEG_INF * 0.5f ? 1.f : 0.f);
        const float p1 =
            __expf(sc[1] - mn) * (sc[1] > NEG_INF * 0.5f ? 1.f : 0.f);
        l[g] = l[g] * corr + p0 + p1;
        const float r0 = round_to<T>(p0), r1 = round_to<T>(p1);  // astype
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(r1, vf[1][e], fmaf(r0, vf[0][e], acc[g][e] * corr));
        m[g] = mn;
      }
    }
  }

  // merge the warp's key slots: lanes li of every slot hold the same slice
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < gn) {
        const float mo = __shfl_xor_sync(FULL, m[g], off);
        const float lo = __shfl_xor_sync(FULL, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float ca = __expf(m[g] - mn), cb = __expf(mo - mn);
        l[g] = l[g] * ca + lo * cb;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = acc[g][e] * ca +
                      __shfl_xor_sync(FULL, acc[g][e], off) * cb;
        m[g] = mn;
      }
    }
  }
  // merge the warps in shared memory; the block's partial to part_*
  if (kw == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < gn) {
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sm_acc[warp][g][(u * LPK + li) * VEC + i] = acc[g][u * VEC + i];
        if (li == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  // scratch: acc of the splits (R1 rows of DH) and of the runs (R2 rows),
  // then m and l of the splits, then m and l of the runs
  const int n_run = (n_split + FAN - 1) / FAN, run = split / FAN;
  const i64 R1 = (i64)gridDim.z * n_split * G, R2 = (i64)gridDim.z * n_run * G;
  float* acc1 = part;
  float* acc2 = acc1 + R1 * DH;
  float* m1 = acc2 + R2 * DH;
  float* l1 = m1 + R1;
  float* m2 = l1 + R1;
  float* l2 = m2 + R2;
  const i64 row1 = (i64)bh * n_split * G + g0;  // split 0, head g0
  const i64 row2 = (i64)bh * n_run * G + g0;    // run 0, head g0
  for (int i = tid; i < gn * DH; i += THREADS) {
    const int g = i / DH, d = i % DH;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float a = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = __expf(sm_m[w][g] - M);
      a += sm_acc[w][g][d] * c;
      Ls += sm_l[w][g] * c;
    }
    const i64 r = row1 + (i64)split * G + g;
    acc1[r * DH + d] = a;
    if (d == 0) {
      m1[r] = M;
      l1[r] = Ls;
    }
  }

  // the combine, in two levels so that no block folds more than FAN
  // partials: the last block of each run of FAN splits folds the run;
  // with more than one run, the last of those folds the runs
  const int gi = bh * n_grp + grp, NG = gridDim.z * n_grp;
  T* og = out + ((i64)bh * G + g0) * DH;
  if (!last_of(counters + (i64)gi * n_run + run,
               min(FAN, n_split - run * FAN)))
    return;
  if (n_run == 1) {
    fold<T, DH>(m1, l1, acc1, row1, G, n_split, gn, og, nullptr, nullptr,
                nullptr, 0);
    return;
  }
  fold<T, DH>(m1, l1, acc1, row1 + (i64)run * FAN * G, G,
              min(FAN, n_split - run * FAN), gn, (T*)nullptr, m2, l2, acc2,
              row2 + (i64)run * G);
  if (!last_of(counters + (i64)NG * n_run + gi, n_run)) return;
  fold<T, DH>(m2, l2, acc2, row2, G, n_run, gn, og, nullptr, nullptr,
              nullptr, 0);
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int* counters, int B, int Hkv, int G, int pos,
           int chunk, int n_split, int n_grp, const i64* st, float scale,
           cudaStream_t s) {
  decode_kernel<T, DH><<<dim3(n_split, n_grp, B * Hkv), THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, part, counters, Hkv, G,
      pos, chunk, n_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* out,
             float* part, int* counters, int B, int Hkv, int G, int pos,
             int chunk, int n_split, int n_grp, const i64* st, float scale,
             cudaStream_t s) {
#define REPRO_DECODE_CASE(DH)                                                \
  case DH:                                                                  \
    return launch<T, DH>(q, k, v, out, part, counters, B, Hkv, G, pos,      \
                         chunk, n_split, n_grp, st, scale, s);
  switch (dh) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh in {16, 32, 64, 128, 256}.  out is a
// contiguous (B, Hq, dh) buffer.  chunk is a positive multiple of 16,
// n_split == ceil((pos + 1) / chunk), n_grp == ceil(G / 4); with
// n_run = ceil(n_split / 16), part holds (B*Hkv*(n_split + n_run)*G)
// * (dh + 2) floats, 16-byte aligned, and counters
// B*Hkv*n_grp*(n_run + 1) ints, all 0.  q, k and v rows start 16-byte
// aligned.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* part, void* counters, int B, int Hkv, int G, int dh, int pos,
    int chunk, int n_split, int n_grp, i64 sqb, i64 sqh, i64 skb, i64 skh,
    i64 sks, i64 svb, i64 svh, i64 svs, float scale, void* stream) {
  const i64 st[8] = {sqb, sqh, skb, skh, sks, svb, svh, svs};
  cudaStream_t s = (cudaStream_t)stream;
  if (pos < 0 || chunk <= 0 || chunk % 16 != 0 ||
      n_split != (pos + chunk) / chunk || n_grp != (G + GM - 1) / GM)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, out, (float*)part, (int*)counters, B,
                           Hkv, G, pos, chunk, n_split, n_grp, st, scale, s);
  return dispatch<__nv_bfloat16>(dh, q, k, v, out, (float*)part,
                                 (int*)counters, B, Hkv, G, pos, chunk,
                                 n_split, n_grp, st, scale, s);
}
