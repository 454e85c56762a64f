// Flash-decoding for Hopper (sm_90a): one new query token per sequence
// against its KV cache, keys past `pos` masked, in one launch: TMA-fed
// tiles and a combine inside one thread-block cluster.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention_tpu
// (_decode_kernel).
//
// What bounds it on the H100: it reads each live cache row once and does
// ~4*G*dh FLOP per row, so bytes bound it (3.35 TB/s): a TinyLlama layer at
// position 535 moves ~0.55 MB, 0.17 us.  At batch 1 what holds it back is
// latency: a few loads and a combine in series, not arithmetic, so it runs
// on the CUDA cores (G <= 10 query rows would leave an m64 wgmma mostly
// padding).
//
// What the design does about it.  The reference walks S in sequence with
// (m, l, acc) in VMEM, one grid row per (batch, kv head).  Here a
// thread-block cluster of n_split CTAs takes a (batch, kv head, head
// share): the wrapper's plan (kernels/decode_attention.py::cluster_plan)
// cuts the live positions [0, pos] into n_split chunks of `chunk`
// positions (a multiple of 16, at most 16 chunks, every one non-empty),
// one a CTA, and the G query heads of a kv head into head_splits shares
// of hps = ceil(G / head_splits), one a cluster.  Each CTA serves its
// cluster's heads from one copy of its chunk.  One share (head_splits 1)
// brings the cache from L2 to the SMs once; where B*Hkv clusters of at
// most 16 CTAs leave SMs idle (batch 1: recurrentgemma-2b's one kv head
// holds 16 of 132), more shares put them to work on the arithmetic, each
// reading the chunk again.  The plan weighs the two with a cost fitted on
// the card (decode_split_sweep.py).
//
// Loads: one producer warp, one elected thread, copies the chunk's K and V
// tiles of T rows into a ring of `stages` stages with TMA
// (cp.async.bulk.tensor.4d on a (dh, S, Hkv, B) map built from the
// caller's strides, so the model's (B,S,Hkv,dh) cache goes in as a view
// and rows past S arrive as zeros), a full barrier a stage that the bytes
// complete and an empty barrier that each consumer warp arrives on; a
// chunk longer than the ring walks through it.
//
// Arithmetic: WARPS consumer warps share a tile by (head group x key
// slot): the cluster's heads go to groups of at most GM (8: 4 + 4, 10:
// 5 + 5, 7: 4 + 3), and the warps of a group split the tile's keys.  A warp
// keeps NH heads in registers (1, 4 or GM, whichever holds its group) and
// works them all without branches.  Lanes run along dh with one 16-byte
// shared-memory load each (8 bf16 or 4 fp32): a key's row takes LPK lanes,
// so a warp takes KPW keys at once, KS such sets a step.  A score is the
// lane-slice dot reduced by __shfl_xor_sync across the key's lanes; every
// key slot keeps an online softmax (m, l, acc) per head in registers,
// with the reference's guards: the (s > NEG_INF*0.5) factor, p rounded to
// v's dtype before the PV product, and max(l, 1e-30).  A row past the
// chunk's live end is not read (its K and V count as zeros, its score as
// NEG_INF), so whatever the cache holds past `pos` (NaN included) never
// reaches the output.  More than 8 groups (G > 40) run in passes over the
// chunk.
//
// Combine, on chip: the key slots merge by shuffles and then in shared
// memory into the CTA's partial (m, l, acc) of G heads, (head, 4-column)
// output by output.  Output u belongs to rank u % n_split: each CTA pushes
// its partial of u into a slot of that rank's shared memory
// (mapa + st.shared::cluster), one cluster barrier (release / acquire)
// publishes every push, and each rank folds the slots of its outputs
// locally, sources in rank order, so repeats and graph replays are
// bit-identical.  Pushing costs one barrier after the partials where
// pulling them (ld.shared::cluster) costs two, the second to keep every
// CTA's shared memory alive until the reads are done.  A relaxed arrive
// at the start and its wait before the first push make sure every CTA of
// the cluster runs before anyone writes to it.  Nothing but q, the cache
// and `out` lives in global memory: no scratch, no counters, so a call can
// be captured in a CUDA graph as it is and calls on two streams share
// nothing.
//
// Position on the device: given a pointer, the kernel reads `pos` from a
// device word when it starts, so a CUDA graph of a decode step
// replays at any position.  The plan is then the plan for `top`, the last
// position of the caller's bucket, and `pos` is clamped to [0, top].  A
// chunk that starts past `pos` reads nothing and pushes an empty partial
// (max NEG_INF, sum 0), which the combine skips; at pos == top the launch
// is the per-position one.
#include <stdint.h>
#include <string.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace repro;

namespace {

constexpr int WARPS = 8;                    // consumer warps
constexpr int THREADS = 32 * (WARPS + 1);   // and one producer warp
constexpr int GM = 5;                       // query heads a warp holds
constexpr int KS = 2;                       // rows a key lane takes a step
constexpr int MAX_CLUSTER = 16;             // non-portable cluster size
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;          // a block's shared memory

template <typename T, int DH> struct Lanes {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a load
  static constexpr int LPK = DH / VEC < 32 ? DH / VEC : 32;  // lanes a key
  static constexpr int KPW = 32 / LPK;              // keys a warp at once
  static constexpr int NV = DH / (VEC * LPK);       // loads a lane a row
  static constexpr int E = NV * VEC;                // elements a lane
};

// How the G heads of a kv head split over the consumer warps: n_hg groups
// of hpg heads (the last may hold fewer), gpp groups a pass, each taken by
// n_ks warps (key slots); kernels/decode_attention.py::head_split
struct Heads {
  int hpg, n_hg, gpp, n_ks, passes;
  __host__ __device__ explicit Heads(int G) {
    const int n = (G + GM - 1) / GM;
    hpg = (G + n - 1) / n;
    n_hg = (G + hpg - 1) / hpg;
    gpp = n_hg <= WARPS ? n_hg : WARPS;
    n_ks = WARPS / gpp;
    passes = (n_hg + gpp - 1) / gpp;
  }
};

// Byte offsets of the shared-memory layout after its 128-byte aligned base:
// the ring (stages x K and V tiles of T rows), the warps' partials (acc,
// then m and l), the slots the cluster's CTAs push their partials of this
// CTA's outputs into (acc, then (m, l)), and the barriers;
// kernels/decode_attention.py::smem_bytes
struct Layout {
  int tile, ring, wacc, wml, racc, rml, bars, total;
  __host__ __device__ Layout(int dh, int isz, int G, int T, int stages) {
    const int slots = G * dh / 4 + MAX_CLUSTER;   // n_split x ceil(U / n)
    tile = T * dh * isz;
    ring = 0;
    wacc = ring + stages * 2 * tile;
    wml = wacc + WARPS * GM * dh * 4;
    racc = wml + WARPS * GM * 2 * 4;
    rml = racc + slots * 16;
    bars = (rml + slots * 8 + 7) / 8 * 8;
    total = bars + stages * 2 * 8 + 128;   // + the base's alignment
  }
};

struct Args {
  const void* q;
  void* out;
  const i64* posp;   // the position on the device, or null: `pos` is it
  i64 sqb, sqh;   // q's (batch, head) strides
  int Hkv, G, hps, pos, chunk, T, stages;   // hps: heads a cluster; pos: the
                                            // plan's last position
  float scale;
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// the cluster barrier, every thread of every CTA of the cluster, in turns
// of arrive and wait: a relaxed arrive orders nothing; after a release
// arrive and an acquire wait, shared-memory writes before the arrive (to
// any CTA of the cluster) are visible to every thread
__device__ __forceinline__ void cluster_arrive_relaxed() {
  __syncwarp();   // .aligned: the warp's threads together
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this CTA's shared-memory word `addr` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

__device__ __forceinline__ void st_cluster2(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
               :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// barrier of the consumer warps alone (the producer may still be waiting
// to refill the ring)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * WARPS) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
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

// four outputs in one store (out rows are 16-byte aligned: dh >= 16)
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(o) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// the 16-byte loads of row r of a tile (zeros where r is not live)
template <typename T, int DH>
__device__ __forceinline__ void load_row(uint4 (&x)[Lanes<T, DH>::NV],
                                         const T* tile, int r, bool ok,
                                         int li) {
  using L = Lanes<T, DH>;
#pragma unroll
  for (int u = 0; u < L::NV; ++u)
    x[u] = ok ? *reinterpret_cast<const uint4*>(
                    tile + r * DH + (u * L::LPK + li) * L::VEC)
              : make_uint4(0, 0, 0, 0);
}

// One consumer warp over its share of the chunk for one pass: the online
// softmax of its heads [g0, g0 + gn) over its key slot's rows of every
// tile, merged over the warp's key lanes; the warp's partial goes to
// wacc / wml.  A step takes KS rows a key lane (KS x KPW x n_ks rows for
// the group), all NH heads at once and without branches (heads past gn
// have q = 0 and are never written), so the scores' dots, reductions and
// exponentials of KS x NH (head, key) pairs are in flight together.
// Every consumer warp waits on every tile and releases it, whether it
// has heads this pass or not.
template <typename T, int DH, int NH>
__device__ __forceinline__ void consume(const Args& g, const char* ring,
                                        float* wacc, float* wml,
                                        uint32_t full, uint32_t empty, int b,
                                        int qh, int s0, int s1, int n_tiles,
                                        int visit0, int g0, int gn, int ks,
                                        int n_ks, int warp, int lane) {
  using L = Lanes<T, DH>;
  constexpr int VEC = L::VEC, LPK = L::LPK, KPW = L::KPW, NV = L::NV,
                E = L::E;
  constexpr unsigned FULL = 0xffffffffu;
  const int li = lane % LPK, kw = lane / LPK;
  const int step = n_ks * KPW;          // rows the group's warps take at once
  const int tile = g.T * DH;            // elements of an operand tile

  // this lane's dh slice: element u*VEC + i is column (u*LPK + li)*VEC + i
  float qf[NH][E], acc[NH][E], m[NH], l[NH];
  const T* qb = reinterpret_cast<const T*>(g.q) + b * g.sqb + li * VEC;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
    if (j < gn) {
      const T* qr = qb + (i64)(qh + g0 + j) * g.sqh;
#pragma unroll
      for (int u = 0; u < NV; ++u)
        unpack(__ldg(reinterpret_cast<const uint4*>(qr + u * LPK * VEC)),
               &qf[j][u * VEC], T());
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[j][e] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int v = visit0 + t, s = v % g.stages;
    mbar_wait(full + 8 * s, (v / g.stages) & 1);
    const T* kt = reinterpret_cast<const T*>(ring) + (i64)s * 2 * tile;
    const T* vt = kt + tile;
    const int rows = min(g.T, s1 - (s0 + t * g.T));   // live rows
    if (gn > 0) {
      // warp-uniform trip count; a row at or past `rows` is not read and
      // scores NEG_INF
      for (int base = ks * KPW + kw; base - kw < rows; base += KS * step) {
        bool ok[KS];
        float sc[NH][KS];
#pragma unroll
        for (int x = 0; x < KS; ++x) {
          ok[x] = base + x * step < rows;
          uint4 kr[NV];
          load_row<T, DH>(kr, kt, base + x * step, ok[x], li);
          float kf[E];
#pragma unroll
          for (int u = 0; u < NV; ++u) unpack(kr[u], &kf[u * VEC], T());
#pragma unroll
          for (int j = 0; j < NH; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) dot = fmaf(qf[j][e], kf[e], dot);
            sc[j][x] = dot;
          }
        }
        // each dot over the key's LPK lanes
#pragma unroll
        for (int o = LPK / 2; o > 0; o /= 2)
#pragma unroll
          for (int j = 0; j < NH; ++j)
#pragma unroll
            for (int x = 0; x < KS; ++x)
              sc[j][x] += __shfl_xor_sync(FULL, sc[j][x], o);
        float corr[NH];
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          float mn = m[j];
#pragma unroll
          for (int x = 0; x < KS; ++x) {
            sc[j][x] = ok[x] ? sc[j][x] * g.scale : NEG_INF;
            mn = fmaxf(mn, sc[j][x]);
          }
          corr[j] = __expf(m[j] - mn);
          float ls = l[j] * corr[j];
#pragma unroll
          for (int x = 0; x < KS; ++x) {
            const float p = __expf(sc[j][x] - mn) *
                            (sc[j][x] > NEG_INF * 0.5f ? 1.f : 0.f);
            ls += p;
            sc[j][x] = round_to<T>(p);   // p.astype(v.dtype)
          }
          l[j] = ls;
          m[j] = mn;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] *= corr[j];
        }
#pragma unroll
        for (int x = 0; x < KS; ++x) {
          uint4 vr[NV];
          load_row<T, DH>(vr, vt, base + x * step, ok[x], li);
          float vf[E];
#pragma unroll
          for (int u = 0; u < NV; ++u) unpack(vr[u], &vf[u * VEC], T());
#pragma unroll
          for (int j = 0; j < NH; ++j)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[j][e] = fmaf(sc[j][x], vf[e], acc[j][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // merge the warp's key lanes: lanes li of every kw hold the same slice
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const float mo = __shfl_xor_sync(FULL, m[j], off);
      const float lo = __shfl_xor_sync(FULL, l[j], off);
      const float mn = fmaxf(m[j], mo);
      const float ca = __expf(m[j] - mn), cb = __expf(mo - mn);
      l[j] = l[j] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[j][e] = acc[j][e] * ca +
                    __shfl_xor_sync(FULL, acc[j][e], off) * cb;
      m[j] = mn;
    }
  }
  if (kw == 0) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      if (j < gn) {
        float* wa = wacc + (warp * GM + j) * DH;
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int i = 0; i < VEC; i += 4)
            *reinterpret_cast<float4*>(wa + (u * LPK + li) * VEC + i) =
                make_float4(acc[j][u * VEC + i], acc[j][u * VEC + i + 1],
                            acc[j][u * VEC + i + 2], acc[j][u * VEC + i + 3]);
        if (li == 0) {
          wml[warp * GM + j] = m[j];
          wml[WARPS * GM + warp * GM + j] = l[j];
        }
      }
    }
  }
}

// a minimum of one block a multiprocessor: ptxas need not hold the
// registers down (and spill) to fit more blocks on one
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 1)
decode_kernel(const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, const Args g) {
  constexpr int D4 = DH / 4;
  extern __shared__ char smem_raw[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  // this cluster's heads of its kv head: [hs * hps, hs * hps + Gc)
  const int hs = blockIdx.y, bh = blockIdx.z, b = bh / g.Hkv, h = bh % g.Hkv;
  const int Gc = min(g.hps, g.G - hs * g.hps), qh = h * g.G + hs * g.hps;
  const Layout lay(DH, (int)sizeof(T), g.hps, g.T, g.stages);
  const Heads hd(Gc);
  char* ring = base + lay.ring;
  float* wacc = reinterpret_cast<float*>(base + lay.wacc);
  float* wml = reinterpret_cast<float*>(base + lay.wml);
  const float4* racc = reinterpret_cast<const float4*>(base + lay.racc);
  const float2* rml = reinterpret_cast<const float2*>(base + lay.rml);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + lay.bars);
  const uint32_t full = smem_u32(bars), empty = smem_u32(bars + g.stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank(), n_split = (int)cluster_size();
  const int pos = g.posp == nullptr
                      ? g.pos
                      : (int)min(max(__ldg(g.posp), (i64)0), (i64)g.pos);
  // a chunk past pos has no rows and no tiles
  const int s0 = rank * g.chunk, s1 = max(s0, min(s0 + g.chunk, pos + 1));
  const int n_tiles = (s1 - s0 + g.T - 1) / g.T;
  // the (head, 4-column) outputs: unit u belongs to rank u % n_split, at
  // its slot u / n_split of each source rank's upr slots
  const int U = Gc * D4, upr = (U + n_split - 1) / n_split;
  // a cluster of one CTA writes its outputs from its own fold: no pushes,
  // no cluster barrier (the same bits: folding one source changes none)
  const bool alone = n_split == 1;
  T* out = reinterpret_cast<T*>(g.out) + ((i64)bh * g.G + hs * g.hps) * DH;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WARPS);   // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started before any writes to another's
  // shared memory: arrive now, wait before the first push
  if (!alone) cluster_arrive_relaxed();
  __syncthreads();

  if (warp == WARPS) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      const int tile_bytes = lay.tile;
      for (int v = 0; v < hd.passes * n_tiles; ++v) {
        const int s = v % g.stages, round = v / g.stages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const int t0 = s0 + (v % n_tiles) * g.T;
        char* st = ring + s * 2 * tile_bytes;
        mbar_expect_tx(full + 8 * s, 2 * tile_bytes);
        tma_load_4d(smem_u32(st), &map_k, full + 8 * s, 0, t0, h, b);
        tma_load_4d(smem_u32(st + tile_bytes), &map_v, full + 8 * s, 0, t0,
                    h, b);
      }
    }
    if (!alone) cluster_wait();
  } else {
    // ----------------------------------------------------------- consumers
    const int hl = warp % hd.gpp, ks = warp / hd.gpp;
    const uint32_t racc_a = smem_u32(racc), rml_a = smem_u32(rml);
    for (int p = 0; p < hd.passes; ++p) {
      const int g0 = (p * hd.gpp + hl) * hd.hpg;
      const int gn = ks < hd.n_ks ? max(0, min(hd.hpg, Gc - g0)) : 0;
      // the warp's heads in registers: 1, 4 or GM (G 1: MHA; up to 4:
      // G 2-4, 6-8; GM: G 5, 9, 10 and the wider groups)
#define REPRO_DECODE_CONSUME(NH)                                              \
  consume<T, DH, NH>(g, ring, wacc, wml, full, empty, b, qh, s0, s1, n_tiles,\
                     p * n_tiles, g0, gn, ks, hd.n_ks, warp, lane)
      if (hd.hpg == 1)
        REPRO_DECODE_CONSUME(1);
      else if (hd.hpg <= 4)
        REPRO_DECODE_CONSUME(4);
      else
        REPRO_DECODE_CONSUME(GM);
#undef REPRO_DECODE_CONSUME
      consumers_sync();
      if (p == 0 && !alone) cluster_wait();
      // fold the key slots of this pass's heads, slots in order, and push
      // each unit's partial to the slot of its rank
      const int h0 = p * hd.gpp * hd.hpg;
      const int hn = min(Gc, h0 + hd.gpp * hd.hpg) - h0;
      for (int i = tid; i < hn * D4; i += 32 * WARPS) {
        const int gh = h0 + i / D4, d4 = i % D4;
        const int gl = gh / hd.hpg - p * hd.gpp, j = gh % hd.hpg;
        float M = NEG_INF;
        for (int k = 0; k < hd.n_ks; ++k)
          M = fmaxf(M, wml[(gl + k * hd.gpp) * GM + j]);
        float Ls = 0.f;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int k = 0; k < hd.n_ks; ++k) {
          const int w = (gl + k * hd.gpp) * GM + j;
          const float c = __expf(wml[w] - M);
          const float4 x = reinterpret_cast<const float4*>(wacc + w * DH)[d4];
          Ls = fmaf(wml[WARPS * GM + w], c, Ls);
          a.x = fmaf(x.x, c, a.x);
          a.y = fmaf(x.y, c, a.y);
          a.z = fmaf(x.z, c, a.z);
          a.w = fmaf(x.w, c, a.w);
        }
        const int u = gh * D4 + d4;
        if (alone) {
          const float inv = 1.f / fmaxf(Ls, 1e-30f);
          store4(out + u * 4, a.x * inv, a.y * inv, a.z * inv, a.w * inv);
          continue;
        }
        const int slot = rank * upr + u / n_split;
        const uint32_t to = (uint32_t)(u % n_split);
        st_cluster4(map_rank(racc_a + slot * 16, to), a);
        st_cluster2(map_rank(rml_a + slot * 8, to), M, Ls);
      }
      if (p + 1 < hd.passes) consumers_sync();   // before wacc is rewritten
    }
  }

  // ------------------------------------------------------- cluster combine
  // every rank's pushes have landed: fold this rank's units, sources in
  // rank order, skipping the ranks whose chunk starts past pos
  if (alone) return;
  cluster_arrive();
  cluster_wait();
  const int live = min(n_split, pos / g.chunk + 1);
  for (int i = tid; i < upr; i += THREADS) {
    const int u = rank + n_split * i;
    if (u >= U) break;
    float M = NEG_INF;
    for (int r = 0; r < live; ++r) M = fmaxf(M, rml[r * upr + i].x);
    float Ls = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < live; ++r) {
      const float2 ml = rml[r * upr + i];
      const float4 x = racc[r * upr + i];
      const float c = __expf(ml.x - M);
      Ls = fmaf(ml.y, c, Ls);
      a.x = fmaf(x.x, c, a.x);
      a.y = fmaf(x.y, c, a.y);
      a.z = fmaf(x.z, c, a.z);
      a.w = fmaf(x.w, c, a.w);
    }
    const float inv = 1.f / fmaxf(Ls, 1e-30f);
    store4(out + u * 4, a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

// 4-D tensor map of a (batch, heads, rows, dh) cache with element strides
// (sb, sh, sr) and a contiguous last dim: dims (dh, rows, heads, batch),
// boxes of dh columns x box_rows, no swizzle; reads past the extent are
// zero.  Returns 0 or the driver's error.
int make_map(CUtensorMap* map, const void* base, int dtype, int dh, int rows,
             int heads, int batch, i64 sr, i64 sh, i64 sb, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const int isz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const i64 st[3] = {sr, sh, sb};
  cuuint64_t strides[3];
  // a dimension of extent 1 is never stepped: any stride TMA takes will do
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : (cuuint64_t)st[i] * isz;
  const cuuint32_t box[4] = {(cuuint32_t)dh, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return (int)fn(map,
                 dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 4, const_cast<void*>(base), dims, strides, box, estr,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// the kernel's dynamic shared-memory limit and leave to form clusters of
// more than 8
template <typename T, int DH>
cudaError_t prepare(int smem) {
  auto kern = decode_kernel<T, DH>;
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// a grid of (n_split, head_splits, B * Hkv) CTAs in clusters of n_split
cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int n_split,
                          int head_splits, int groups, int smem,
                          cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, head_splits, groups);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int DH>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           int B, int Hkv, int G, int S, int pos, const i64* posp, int chunk,
           int n_split, int head_splits, int T_rows, int stages,
           const i64* st, float scale, cudaStream_t s) {
  const int hps = (G + head_splits - 1) / head_splits;
  const Layout lay(DH, (int)sizeof(T), hps, T_rows, stages);
  if (lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  memset(&mk, 0, sizeof(mk));
  memset(&mv, 0, sizeof(mv));
  int e = make_map(&mk, k, dtype, DH, S, Hkv, B, st[4], st[3], st[2], T_rows);
  if (e == 0)
    e = make_map(&mv, v, dtype, DH, S, Hkv, B, st[7], st[6], st[5], T_rows);
  if (e != 0) return 1000 + e;
  cudaError_t err = prepare<T, DH>(lay.total);
  if (err != cudaSuccess) return (int)err;
  Args a{q, out, posp, st[0], st[1], Hkv, G, hps, pos, chunk, T_rows, stages,
         scale};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(attr, n_split, head_splits, B * Hkv, lay.total, s);
  void* args[] = {&mk, &mv, &a};
  err = cudaLaunchKernelExC(&cfg, (const void*)decode_kernel<T, DH>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int active(int heads, int T_rows, int stages, int cluster, int* count) {
  const Layout lay(DH, (int)sizeof(T), heads, T_rows, stages);
  if (lay.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<T, DH>(lay.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(attr, cluster, 1, 1, lay.total, 0);
  return (int)cudaOccupancyMaxActiveClusters(
      count, (const void*)decode_kernel<T, DH>, &cfg);
}

// the (dtype, dh) instantiations: kernels/decode_attention.py::HEAD_DIMS
#define REPRO_DECODE_DISPATCH(CALL)                                          \
  switch (dh) {                                                              \
    case 16: return CALL(16);                                                \
    case 32: return CALL(32);                                                \
    case 64: return CALL(64);                                                \
    case 128: return CALL(128);                                              \
    case 256: return CALL(256);                                              \
    default: return (int)cudaErrorInvalidValue;                              \
  }

template <typename T>
int dispatch(int dtype, int dh, const void* q, const void* k, const void* v,
             void* out, int B, int Hkv, int G, int S, int pos,
             const i64* posp, int chunk, int n_split, int head_splits,
             int T_rows, int stages, const i64* st, float scale,
             cudaStream_t s) {
#define REPRO_DECODE_LAUNCH(DH)                                              \
  launch<T, DH>(dtype, q, k, v, out, B, Hkv, G, S, pos, posp, chunk,        \
                n_split, head_splits, T_rows, stages, st, scale, s)
  REPRO_DECODE_DISPATCH(REPRO_DECODE_LAUNCH)
#undef REPRO_DECODE_LAUNCH
}

template <typename T>
int dispatch_active(int dh, int heads, int T_rows, int stages, int cluster,
                    int* count) {
#define REPRO_DECODE_ACTIVE(DH)                                              \
  active<T, DH>(heads, T_rows, stages, cluster, count)
  REPRO_DECODE_DISPATCH(REPRO_DECODE_ACTIVE)
#undef REPRO_DECODE_ACTIVE
}

bool valid_tiles(int G, int T_rows, int stages) {
  return G >= 1 && T_rows >= 16 && T_rows <= 256 && T_rows % 16 == 0 &&
         stages >= 1 && stages <= MAX_STAGES;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; dh in {16, 32, 64, 128, 256}.  q is
// (B, Hkv*G, dh) and the caches (B, Hkv, S, dh) with element strides
// (b, h) and (b, h, s) and a contiguous last dim; every base and stride a
// multiple of 16 bytes (TMA's rule).  out is a contiguous (B, Hkv*G, dh)
// buffer.  The plan (kernels/decode_attention.py::cluster_plan): chunk is
// a positive multiple of 16, n_split == ceil((pos + 1) / chunk) <= 16 CTAs
// a cluster, the G heads of a kv head split over head_splits clusters of
// ceil(G / head_splits) heads (none empty), tiles of T_rows (a multiple of
// 16, at most 256) rows in a ring of `stages` (1-4).  `pos_dev` is null,
// or points at one int64 in device memory that holds the position: then
// `pos` is the plan's last position, and the kernel reads the word when
// it starts and clamps it to [0, pos], so a graph that captures the
// launch replays at whatever position the word holds then.  Returns 0, a
// CUDA error of the launch, or 1000 + the driver's error of a tensor map.
extern "C" int repro_decode_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int Hkv, int G, int dh, int S, int pos, const void* pos_dev, int chunk,
    int n_split, int head_splits, int T_rows, int stages, i64 sqb, i64 sqh,
    i64 skb, i64 skh, i64 sks, i64 svb, i64 svh, i64 svs, float scale,
    void* stream) {
  const i64 st[8] = {sqb, sqh, skb, skh, sks, svb, svh, svs};
  cudaStream_t s = (cudaStream_t)stream;
  const i64* posp = (const i64*)pos_dev;
  if (pos < 0 || pos >= S || chunk <= 0 || chunk % 16 != 0 ||
      n_split != (pos + chunk) / chunk || n_split > MAX_CLUSTER ||
      B < 1 || Hkv < 1 || !valid_tiles(G, T_rows, stages) ||
      head_splits < 1 || head_splits > G)
    return (int)cudaErrorInvalidValue;
  const int hps = (G + head_splits - 1) / head_splits;
  if ((G + hps - 1) / hps != head_splits) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(dtype, dh, q, k, v, out, B, Hkv, G, S, pos, posp,
                           chunk, n_split, head_splits, T_rows, stages, st,
                           scale, s);
  return dispatch<__nv_bfloat16>(dtype, dh, q, k, v, out, B, Hkv, G, S, pos,
                                 posp, chunk, n_split, head_splits, T_rows,
                                 stages, st, scale, s);
}

// How many clusters of `cluster` CTAs of the decode kernel at this (dtype,
// dh, heads a cluster, T_rows, stages) the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *count; returns 0 or a CUDA
// error.  The wrapper's plan takes only splits whose clusters all fit.
extern "C" int repro_decode_active_clusters(int dtype, int dh, int heads,
                                            int T_rows, int stages,
                                            int cluster, void* count) {
  if (cluster < 1 || cluster > MAX_CLUSTER ||
      !valid_tiles(heads, T_rows, stages))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_active<float>(dh, heads, T_rows, stages, cluster,
                                  (int*)count);
  return dispatch_active<__nv_bfloat16>(dh, heads, T_rows, stages, cluster,
                                        (int*)count);
}
