// Flash attention on Hopper's tensor cores (sm_90a), bf16: the prefill path
// of both model families, with an optional local window.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_tpu
// (_flash_kernel) for bf16, and with a window the banded attention of
// src/repro/models/attention.py::local_attention.  fp32 stays on the FFMA
// kernel in flash_attention.cu: it is the parity path, and fp32 on the
// tensor cores would mean TF32, which its tolerance does not allow.
//
// What bounds it on the H100: a causal pass over S tokens does
// ~S^2*(dqk+dv) FLOP per query head on S*(2*dqk+2*dv) values.  At the serving shapes (batch 1,
// a 512-token prompt) the bound is ~1.4-1.7 us, set by the bytes; what
// holds a kernel back there is parallelism and latency (a few hundred
// small blocks, each a serial walk over its KV tiles), not the mma rate.
//
// What the design does about it, the FlashAttention-2 structure: a grid of
// (B*Hq, ceil(S/BQ)) blocks, the heaviest causal row-blocks launched first
// (blockIdx.y reversed).  One warp owns 16 query rows; a block is 4 warps
// (64 rows) at dh <= 128 and 2 warps (32 rows) at dh 256, so that the
// hybrid's 10 heads x 512 rows still make 160 blocks for the 132 SMs.
// QK^T and PV run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
// fragments loaded by ldmatrix (V's by ldmatrix.trans).  The scores S and
// the output accumulator stay in registers as mma fragments: dh is split
// across the fragment's lanes (at dh 256 the accumulator is 128 fp32
// registers a thread), and Q stays in shared memory, its fragments
// reloaded for every KV tile, which keeps dh 256 below 255 registers.  Q,
// K and V reach bf16 shared memory through 16-byte cp.async.cg, K/V in a
// two-stage ring, so the next tile's copy overlaps this tile's two mma
// passes; rows are padded by 16 bytes, which makes every ldmatrix free of
// bank conflicts.  At dh 256 the tiles take 84 KB of dynamic shared memory.
//
// Q and K rows are DQK wide, V rows and the output DV wide: MLA's prefill
// (DeepSeek-V2) has dqk 192 = 128 + 64 rope and dv 128, its smoke config
// 24 and 16; the other families dqk == dv.  m16n8k16 steps k by 16, so a
// dqk that is no multiple of 16 (24) is zero-padded to the next one (32)
// in shared memory: the copy of the missing 16-byte chunks is predicated
// off, which zero-fills them, and zero columns add nothing to Q.K^T.
//
// Semantics kept exactly from _flash_kernel: s = dot * scale with the scale
// applied to the fp32 product; keys live where kp < Skv, kp <= q (causal)
// and kp > q - window (window > 0); KV tiles wholly above the diagonal or
// below the band are never loaded (and a warp skips a loaded tile that is
// dead for all of its 16 rows, which leaves m, l and acc exactly as the
// masked update would); p = exp(s - m_new) * (s > NEG_INF*0.5),
// corr = exp(m - m_new); p enters PV rounded to bf16 (the mma's A operand,
// which is p.astype(v.dtype)) while l sums the unrounded p; the output is
// acc / max(l, 1e-30).  GQA maps query head h to KV head h / G.  Every
// tensor goes in through its (batch, head, seq) strides; the ragged S edge
// is zero-filled on load and rows >= S are never stored.
//
// Later work: wgmma with TMA-fed tiles and warp specialisation, if the
// kernel stays above its library yardstick.  wgmma's 64-row tile would cut
// the hybrid's 10 heads x 512 rows to 80 blocks on 132 SMs, so at these
// batch-1 shapes it buys rate that the latency-bound kernel cannot use.
#include "common.cuh"

using namespace repro;

namespace {

typedef __nv_bfloat16 bf16;

template <int DQK, int DV> struct Cfg {
  static_assert(DQK % 8 == 0 && DV % 16 == 0, "16-byte rows, k-steps of 16");
  static constexpr int DQKP = (DQK + 15) / 16 * 16;  // Q.K^T depth, padded
  static_assert(DV <= DQKP, "the output is staged in the Q tile's rows");
  static constexpr int WARPS = DQK >= 256 || DV >= 256 ? 2 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;               // query rows a block
  static constexpr int BKV = WARPS == 2 ? 32 : 64;    // keys a tile
  static constexpr int LDQ = DQKP + 8;  // padded Q and K rows, elements
  static constexpr int LDV = DV + 8;    // padded V rows
  static constexpr int CPRQ = DQK / 8;  // 16-byte chunks of a Q or K row
  static constexpr int CPRQP = DQKP / 8;  // the same with the zero padding
  static constexpr int CPRV = DV / 8;   // 16-byte chunks of a V row
  // Q tile and two stages of K and V
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)LDQ * (BQ + 2 * BKV) + (size_t)LDV * 2 * BKV);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills them when !pred
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&h);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(Cfg<DQK, DV>::THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                 int Hkv, int S, int Skv, int causal, int window, i64 sqb,
                 i64 sqh, i64 sqs, i64 skb, i64 skh, i64 sks, i64 svb,
                 i64 svh, i64 svs, i64 sob, i64 soh, i64 sos, float scale) {
  using C = Cfg<DQK, DV>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LDQ = C::LDQ, LDV = C::LDV;
  constexpr int CPRQ = C::CPRQ, CPRQP = C::CPRQP, CPRV = C::CPRV;
  constexpr int NT = C::THREADS;
  constexpr int NS = BKV / 8;  // score fragments (8 keys each) a warp
  constexpr int NO = DV / 8;   // output fragments (8 columns each) a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDQ]
  bf16* ks = qs + BQ * LDQ;                      // [2][BKV][LDQ]
  bf16* vs = ks + 2 * BKV * LDQ;                 // [2][BKV][LDV]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq, hk = hq / (Hq / Hkv);
  // heaviest causal row-blocks first
  const int qblk = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qblk * BQ;
  const bf16* qb = q + b * sqb + hq * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  // chunks c >= CPRQ are the zero padding of a dqk of no multiple of 16
  constexpr bool PADDED = CPRQ != CPRQP;
  for (int i = tid; i < BQ * CPRQP; i += NT) {
    const int r = i / CPRQP, c = i % CPRQP;
    const bool in = q0 + r < S && (!PADDED || c < CPRQ);
    cp_async16(smem_addr(qs + r * LDQ + c * 8),
               in ? qb + (i64)(q0 + r) * sqs + c * 8 : qb, in);
  }
  // live keys: below (block's last row + 1) when causal; with a window,
  // from the first tile that reaches the band of the block's first row
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;
  // one pass over the wider of a K row and a V row; the tests on c fold
  // away at compile time, and at dqk == dv they vanish
  constexpr int CMAX = CPRQP > CPRV ? CPRQP : CPRV;
  auto load_kv = [&](int k0, int stage) {
    bf16* kd = ks + stage * BKV * LDQ;
    bf16* vd = vs + stage * BKV * LDV;
    for (int i = tid; i < BKV * CMAX; i += NT) {
      const int r = i / CMAX, c = i % CMAX, kp = k0 + r;
      const bool in = kp < Skv;
      if (c < CPRQP) {
        const bool kin = in && (!PADDED || c < CPRQ);
        cp_async16(smem_addr(kd + r * LDQ + c * 8),
                   kin ? kb + (i64)kp * sks + c * 8 : kb, kin);
      }
      if (c < CPRV)
        cp_async16(smem_addr(vd + r * LDV + c * 8),
                   in ? vb + (i64)kp * svs + c * 8 : vb, in);
    }
  };
  if (n_tiles > 0) load_kv(kv_begin, 0);
  cp_async_commit();  // group: Q and the first K/V tile

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's two rows of each fragment: g and g + 8 of the warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qw = q0 + warp * 16;
  const int row[2] = {qw + (lane >> 2), qw + (lane >> 2) + 8};
  // ldmatrix row addresses: Q as the A operand (rows 0-15, k halves);
  // K as the B operand of QK^T (keys j..j+15, dh halves); V as the B
  // operand of PV, transposed (keys k halves, dh columns)
  const unsigned q_addr =
      smem_addr(qs + (warp * 16 + (lane & 15)) * LDQ + (lane >> 4) * 8);
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
  const int v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * BKV;
    if (t + 1 < n_tiles) {
      load_kv(k0 + BKV, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // all but the tile just issued have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool dead = (causal && k0 > qw + 15) ||
                      (window > 0 && k0 + BKV - 1 <= qw - window);
    if (!dead) {
      const unsigned kst = smem_addr(ks + (t & 1) * BKV * LDQ + k_off);
      const unsigned vst = smem_addr(vs + (t & 1) * BKV * LDV + v_off);
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::DQKP / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, q_addr + kk * 16 * (unsigned)sizeof(bf16));
#pragma unroll
        for (int jp = 0; jp < BKV / 16; ++jp) {
          unsigned bk[4];
          ldsm_x4(bk,
                  kst + (jp * 16 * LDQ + kk * 16) * (unsigned)sizeof(bf16));
          mma_bf16(s[2 * jp], a, bk[0], bk[1]);
          mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
      // scale, mask, online softmax; a row's 4 threads hold its columns
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int qr = row[e >> 1];
          const bool live = kp < Skv && (!causal || kp <= qr) &&
                            (window <= 0 || kp > qr - window);
          s[n][e] = live ? s[n][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = __expf(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // p as the A operand of PV: keys 16*kk.. of fragments 2kk, 2kk+1
      unsigned pa[BKV / 16][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(s[n][e] - m[e >> 1]) *
                 (s[n][e] > NEG_INF * 0.5f ? 1.f : 0.f);
          l[e >> 1] += p[e];
        }
        pa[n / 2][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          unsigned bv[4];
          ldsm_x4_trans(
              bv, vst + (kk * 16 * LDV + dp * 16) * (unsigned)sizeof(bf16));
          mma_bf16(acc[2 * dp], pa[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
        }
    }
    __syncthreads();  // the stage read here is the next load's target
  }
  cp_async_wait<0>();  // with no live tile the Q copy may still be landing
  __syncthreads();

  // normalise, stage the warp's 16 rows in its own Q rows, store 16 bytes
  // a lane; rows >= S are not stored
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  bf16* ow = qs + warp * 16 * LDQ;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(ow + g * LDQ + n * 8 + c2) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(ow + (g + 8) * LDQ + n * 8 + c2) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = o + b * sob + hq * soh;
  for (int i = lane; i < 16 * CPRV; i += 32) {
    const int r = i / CPRV, c = i % CPRV;
    if (qw + r < S)
      *reinterpret_cast<uint4*>(ob + (i64)(qw + r) * sos + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * LDQ + c * 8);
  }
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Skv, int causal, int window,
           const i64* st, float scale, cudaStream_t s) {
  using C = Cfg<DQK, DV>;
  cudaError_t e = allow_smem(flash_mma_kernel<DQK, DV>, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (S + C::BQ - 1) / C::BQ);
  flash_mma_kernel<DQK, DV><<<grid, C::THREADS, C::SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Hq, Hkv, S,
      Skv, causal, window, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; (dqk, dv) one of the pairs below; window 0 means none, > 0
// needs causal.  Strides are in elements, (batch, head, sequence) for q, k,
// v and o; the last dimension is contiguous, and every row starts 16-byte
// aligned.
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int S, int Skv, int dqk, int dv, int causal, int window, i64 sqb,
    i64 sqh, i64 sqs, i64 skb, i64 skh, i64 sks, i64 svb, i64 svh, i64 svs,
    i64 sob, i64 soh, i64 sos, float scale, void* stream) {
  const i64 st[12] = {sqb, sqh, sqs, skb, skh, sks,
                      svb, svh, svs, sob, soh, sos};
  cudaStream_t s = (cudaStream_t)stream;
  if (window > 0 && !causal) return (int)cudaErrorInvalidValue;
  // the (dqk, dv) pairs: kernels/flash_attention.py::HEAD_DIMS
#define REPRO_FLASH_MMA_CASE(DQK, DV)                                       \
  if (dqk == DQK && dv == DV)                                               \
    return launch<DQK, DV>(q, k, v, o, B, Hq, Hkv, S, Skv, causal, window,  \
                           st, scale, s);
  REPRO_FLASH_MMA_CASE(16, 16)
  REPRO_FLASH_MMA_CASE(32, 32)
  REPRO_FLASH_MMA_CASE(64, 64)
  REPRO_FLASH_MMA_CASE(128, 128)
  REPRO_FLASH_MMA_CASE(256, 256)
  REPRO_FLASH_MMA_CASE(192, 128)
  REPRO_FLASH_MMA_CASE(24, 16)
#undef REPRO_FLASH_MMA_CASE
  return (int)cudaErrorInvalidValue;
}
