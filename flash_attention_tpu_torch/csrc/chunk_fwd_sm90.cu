// K1q and K1r for bf16 and fp16 queries: a prefill chunk's causal attention
// over one slot of a dense KV cache read where it lies, the cache quantized
// (int8 / fp8 e4m3 / fp8 e5m2 with one fp32 scale per row: K1q) or the
// rolling ring, 16-bit or quantized, with its StreamingLLM sinks (K1r). The
// body of ops/flash_attention.cache_attention on the card for those two
// forms (fp32 keeps the FMA body of csrc/flash_fwd.cu, fat_cache_fwd).
//
// Replaces the JAX package's ops/flash_attention.py:_fwd_kernel (:57) as its
// chunk prefill feeds it (models/attention.py:438-511): an XLA dequant of
// the slot's visible rows, or a gather of the ring's rows in position order
// with, past the window, a second pass over the sinks and an LSE merge. Here
// the kernel reads the cache where it lies and applies the scales and the
// sinks in its one walk. The function is csrc/flash_fwd_sm90.cu's: an online
// exp2 softmax with scale2 = sm_scale * log2(e) folded into one constant,
// the finite MASK_VALUE, the row max floored at M_FLOOR, output 0 and LSE
// -inf for a row that sees no key, end-aligned causal, the exact tanhf
// softcap, columns [0, sinks) visible beside the window, the base-2 LSE m +
// log2(l). A code is dequantized as code * scale in fp32 rounded to the
// query's type (as the JAX package's chunk prefill dequantizes its cache);
// P enters P V rounded to the query's type; scores, softmax and the
// accumulators stay fp32.
//
// What bounds it: at the chunk, q [1,32,256,128] over kv_end 2048 (or 4096
// window columns on the ring), every visible pair costs 4 D FLOPs against
// O((T + kv) D) bytes: operations, at the card's 989 TFLOP/s, which only
// wgmma reaches. What held csrc/flash_fwd_sm90.cu's fwd_kernel back at
// that shape: 128 blocks of one 64-row warpgroup (4 SMs idle), nothing
// overlapping inside an SM, each of a GQA group's q heads loading (and for
// a payload widening) the same K / V tiles, and the widen outlasting the
// Q K^T it hid under. The design:
//  * A block takes one kv head and every q head of its group: 128 rows
//    packed as (position, head), row r at position r / group of q head
//    hk * group + r % group, so each K / V tile is loaded (and widened)
//    once for the group; a row's causal, window and sink limits come from
//    its position, so the mask is the unpacked one. Any group size works;
//    the Q rows are loaded by the consumers themselves (16-byte loads into
//    the swizzled layout), so no box shape depends on the group.
//  * Warp specialisation: a producer warpgroup and two consumer warpgroups
//    of 64 rows (384 threads, one block an SM). The producer issues the TMA
//    loads into a ring of ST 16-bit K / V stages (full / empty mbarriers);
//    for a payload it loads the 1-byte tiles and their row scales into a
//    staging ring of its own and widens each into a 16-bit stage, so the
//    widen runs under the consumers' softmax and both products and shares
//    no warpgroup with Q K^T. setmaxnreg gives the producer PRODUCER_REGS
//    registers and the consumers the rest (ptxas still compiles a consumer
//    at the launch's entry count, 168). The consumers take turns issuing
//    their products (named barriers 1 and 2, as csrc/probes.cu's body T), so
//    one's softmax runs under the other's Q K^T and P V. Issuing tile j's
//    Q K^T with tile j - 1's P V in one turn, tile j's softmax under that
//    P V (FlashAttention-3's intra-warpgroup overlap), ran slower alone at
//    the chunk for K1q and K1r in a trial, so each warpgroup keeps its
//    products in order.
//  * The kv walk (ops/flash_attention.fwd_walk: the sink tiles, then the
//    window's first tile to the causal diagonal of the block's last row) is
//    cut into `splits` contiguous shares, one a block of a thread-block
//    cluster (ops/flash_attention.chunk_splits picks the count from the SM
//    count: 2 at the chunk on 132 SMs, 128 blocks; tools/smoke_cases.py
//    chunk_split_sweep times every count: 1 split is 1.6-1.7x slower, 3-8
//    take two waves and are slower still). Each block keeps its
//    own (O, m, l); after every block's walk the cluster's first block
//    merges them through distributed shared memory, rank by rank in order
//    (the ranks' partials land in its freed Q / stage memory), and writes o
//    and the LSE. No workspace, no atomics: two calls are bit-identical,
//    and a share that sees no key adds exactly nothing.
//  * The slot is read from device memory (clamped), as the TMA maps' batch
//    coordinate over the whole cache, so one CUDA graph of a chunk serves
//    every slot. Ring tiles: the band's grid starts at `sinks`, a tile at n0
//    >= sinks is loaded from ring_base + (n0 - sinks) % ring_mod and never
//    straddles the ring's end; the sink tiles from rows [0, 64 k), their
//    columns at or past `sinks` masked. Rows a payload tile holds at or past
//    its limit are zeroed in the widen; a 16-bit tile's are the cache's own
//    finite rows, masked.
#include <cuda.h>

#include "common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;

constexpr int BN = 64;              // kv rows a tile
constexpr int CWG = 2;              // consumer warpgroups, 64 packed rows each
constexpr int BM = 64 * CWG;        // packed (position, head) rows a block
constexpr int NT = 128 * (CWG + 1); // and the producer warpgroup
constexpr int ST = 3;               // 16-bit K / V stages, and a payload's staging stages
constexpr int MAX_SPLITS = 8;       // blocks a cluster at most (the portable size)
// Named barriers: 1 + w warpgroup w's turn to issue products, 3 + w its Q tile written, 5 the producer's widen.
constexpr int BAR_Q = 3, BAR_WIDEN = 5;

struct ChunkParams {
  CUtensorMap tm_k, tm_v;  // the whole cache: 16-bit tiles (swizzled) or a payload's rows
  const void* q;           // [1, Hq, T, D], unit stride on D
  int64_t q_sh, q_sr;
  void* o;     // [1, Hq, T, D] contiguous
  float* lse;  // [1, Hq, T] base-2, or null
  const int32_t* slot;
  int slots, group, q_len, kv_len;  // q_len: T; kv_len: kv_end
  float scale2;
  int window;
  float softcap2;
  int sinks, ring_mod, ring_base, kv_rows;
  const float* ks;  // a payload's row scales [slots, Hkv, kv_rows], unit row stride
  const float* vs;
  int64_t ks_sp, ks_sh, vs_sp, vs_sh;
  int splits;
};

template <typename P, int D>
struct Plan {
  static constexpr bool QUANT = fat::is_payload<P>;
  static constexpr int Q_TILE = BM * D * 2;
  static constexpr int KV_TILE = BN * D * 2;  // a 16-bit K or V tile
  static constexpr int PAY = BN * D;          // a payload tile
  static constexpr int STAGES = ST * 2 * KV_TILE;
  static constexpr int STAGING = QUANT ? ST * 2 * PAY : 0;
  static constexpr int SCALES = QUANT ? ST * 2 * BN * 4 : 0;
  static constexpr int BARS = 8 * 3 * ST;
  // The merge: a rank's partial, (D / 8 accumulator float4s + (m, l)) a consumer thread, lands in the freed
  // Q and stage memory of the cluster's first block.
  static constexpr int RECV = (D / 8 + 1) * 256 * 16;
  static_assert(RECV <= Q_TILE + STAGES, "the merge's receive buffer");
  static constexpr size_t SMEM = 1024 + Q_TILE + STAGES + STAGING + SCALES + BARS;
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
  // The widen needs more registers than TMA alone: of 56 / 224, 72 / 216, 88 / 208 and 120 / 184, 88 / 208 ran K1q
  // fastest (PERF.md §6). 96 / 208, the SM's whole 65,536, with 8-unit widen batches failed to launch.
  static constexpr int PRODUCER_REGS = QUANT ? 88 : 24;
  static constexpr int CONSUMER_REGS = QUANT ? 208 : 240;
};

// The byte offset of 16-bit element column c (a multiple of 8) of row r in
// an R-row tile of the swizzled layout TMA writes and the descriptors read.
template <int D, int R>
__device__ __forceinline__ int swizzled(int r, int c) {
  using L = Layout<D>;
  const int lin = r * L::ROW + (c % L::CW) * 2;
  return (c / L::CW) * R * L::ROW + (lin ^ (((lin >> 7) & (L::ROW / 16 - 1)) << 4));
}

// A staging stage's payload tiles (K then V, BN rows of D bytes) dequantized
// into a 16-bit stage (K as T at wide, V after it): each code times its
// row's scale in fp32, rounded to T; rows at or past `live` become 0. Run by
// the producer's NP threads; a batch's loads are issued before its widens.
template <typename P, typename T, int D, int NP>
__device__ __forceinline__ void widen_tile(const uint8_t* stage, const float* scales, uint8_t* wide, int live,
                                           int tid) {
  constexpr int UNITS = BN * D / 8;  // 8-column units of a tile
  constexpr int STEPS = 2 * UNITS / NP, BATCH = STEPS < 4 ? STEPS : 4;
  static_assert(UNITS % NP == 0 && STEPS % BATCH == 0, "a step's units are all K's or all V's");
#pragma unroll
  for (int i0 = 0; i0 < STEPS; i0 += BATCH) {
    uint2 raw[BATCH];
    float scale[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool is_v = (i0 + j) * NP >= UNITS;
      const int x = tid + (i0 + j) * NP - (is_v ? UNITS : 0), r = x / (D / 8), c = x % (D / 8) * 8;
      raw[j] = r < live ? *reinterpret_cast<const uint2*>(stage + (is_v ? BN * D : 0) + r * D + c) : make_uint2(0u, 0u);
      scale[j] = r < live ? scales[(is_v ? BN : 0) + r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool is_v = (i0 + j) * NP >= UNITS;
      const int x = tid + (i0 + j) * NP - (is_v ? UNITS : 0), r = x / (D / 8), c = x % (D / 8) * 8;
      *reinterpret_cast<uint4*>(wide + (is_v ? BN * D * 2 : 0) + swizzled<D, BN>(r, c)) =
          fat::dequant8<P, T>(raw[j], scale[j]);
    }
  }
}

// One (kv head, 128 packed rows, share of the walk): see the top of the file.
// P: the cache's element type (T, or a payload); MASKED: window, softcap,
// sinks or the ring.
template <typename T, typename P, int D, bool MASKED>
__global__ void __launch_bounds__(NT, 1) chunk_fwd_kernel(const __grid_constant__ ChunkParams p) {
  using Pl = Plan<P, D>;
  constexpr bool QUANT = Pl::QUANT;
  constexpr int KV_TILE = Pl::KV_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_kv = s_q + Pl::Q_TILE;  // stage s: K at 2 s KV_TILE, V after it
  uint8_t* s_stage = s_kv + Pl::STAGES;  // a payload's staging stage s: K at 2 s PAY, V after it
  float* s_scale = reinterpret_cast<float*>(s_stage + Pl::STAGING);  // its stage s's scales: K's at 2 s BN, V's after
  uint64_t* full = reinterpret_cast<uint64_t*>(s_stage + Pl::STAGING + Pl::SCALES);
  uint64_t* empty = full + ST;
  uint64_t* landed = empty + ST;  // a payload's staging stage s has landed

  const int tid = threadIdx.x, wg = tid / 128;
  const int S = p.splits, rank = static_cast<int>(blockIdx.x), hk = static_cast<int>(blockIdx.z);
  const int G = p.group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the block's first packed row (the q tiles reversed)
  const int kb = min(max(*p.slot, 0), p.slots - 1);
  // The walk (ops/flash_attention.fwd_walk over the block's positions), then this block's share of it.
  const int diag = p.kv_len - p.q_len;
  const int pa0 = m0 / G, pb0 = min((m0 + BM - 1) / G, p.q_len - 1);
  const int n_end = min(p.kv_len, pb0 + 1 + diag);
  const int origin = MASKED && p.ring_mod > 0 ? p.sinks : 0;
  const int n_begin = MASKED && p.window > 0 ? origin + max(0, pa0 + diag - p.window + 1 - origin) / BN * BN : 0;
  const int sink_end = MASKED && p.window > 0 ? min((p.sinks + BN - 1) / BN * BN, n_begin) : 0;
  const int ns = (min(sink_end, n_end) + BN - 1) / BN;
  const int nb = n_end > n_begin ? (n_end - n_begin + BN - 1) / BN : 0;
  const int n_tiles = max(ns, 0) + nb;
  const int i0 = rank * n_tiles / S, i1 = (rank + 1) * n_tiles / S;
  auto tile = [&](int i) { return i < ns ? BN * i : n_begin + BN * (i - ns); };
  // The columns a tile may show end at the sinks in a sink tile, else at kv_end.
  auto lim_of = [&](int n0) { return MASKED && n0 < n_begin ? p.sinks : p.kv_len; };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], QUANT ? 128 : 1);
      mbar_init(&empty[s], 128 * CWG);
      mbar_init(&landed[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {  // ---- the producer
    regs_dec<Pl::PRODUCER_REGS>();
    const int ptid = tid - 128 * CWG;
    // The slot's (row in the map, batch) of the tile at n0: the ring's row, or n0 itself.
    auto row_of = [&](int n0) {
      if (MASKED && p.ring_mod > 0) return n0 < p.sinks ? n0 : p.ring_base + (n0 - p.sinks) % p.ring_mod;
      return n0;
    };
    if constexpr (QUANT) {
      auto stage_in = [&](int s, int n0) {  // tile n0's payload and scales into staging stage s
        const int y = row_of(n0);
        // The scales past the slot's last row are not read.
        const uint32_t sc_bytes = 4 * min(BN, p.kv_rows - y);
        mbar_expect(&landed[s], 2 * Pl::PAY + 2 * sc_bytes);
        uint8_t* stage = s_stage + 2 * s * Pl::PAY;
        tma_load(stage, &p.tm_k, 0, y, hk, kb, &landed[s]);
        tma_load(stage + Pl::PAY, &p.tm_v, 0, y, hk, kb, &landed[s]);
        float* sc = s_scale + 2 * s * BN;
        bulk_load(sc, p.ks + static_cast<int64_t>(kb) * p.ks_sp + hk * p.ks_sh + y, sc_bytes, &landed[s]);
        bulk_load(sc + BN, p.vs + static_cast<int64_t>(kb) * p.vs_sp + hk * p.vs_sh + y, sc_bytes, &landed[s]);
      };
      if (ptid == 0) {
        prefetch_map(&p.tm_k);
        prefetch_map(&p.tm_v);
        for (int i = i0; i < min(i1, i0 + ST); ++i) stage_in((i - i0) % ST, tile(i));
      }
      for (int i = i0; i < i1; ++i) {
        const int j = i - i0, s = j % ST, n0 = tile(i);
        mbar_wait(&landed[s], (j / ST) & 1);
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        widen_tile<P, T, D, 128>(s_stage + 2 * s * Pl::PAY, s_scale + 2 * s * BN, s_kv + 2 * s * KV_TILE,
                                 min(BN, lim_of(n0) - n0), ptid);
        // The widened tiles before wgmma reads them, and the staging reads before TMA rewrites the stage.
        fence_proxy_async();
        mbar_arrive(&full[s]);
        named_sync(BAR_WIDEN, 128);
        if (ptid == 0 && i + ST < i1) stage_in(s, tile(i + ST));
      }
    } else if (ptid < 32) {  // the first warp loads
      if (ptid == 0) {
        prefetch_map(&p.tm_k);
        prefetch_map(&p.tm_v);
      }
      for (int i = i0; i < i1; ++i) {
        const int j = i - i0, s = j % ST, y = row_of(tile(i));
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        if (ptid == 0) {
          mbar_expect(&full[s], 2 * KV_TILE);
          load_tile<D, BN>(s_kv + 2 * s * KV_TILE, &p.tm_k, y, hk, kb, &full[s]);
          load_tile<D, BN>(s_kv + (2 * s + 1) * KV_TILE, &p.tm_v, y, hk, kb, &full[s]);
        }
      }
    }
    // The merge's cluster barriers, as the consumers take them.
    if (S > 1) {
      cluster_sync();
      for (int r = 1; r < S; ++r) {
        cluster_sync();
        if (r + 1 < S) cluster_sync();
      }
    }
    return;
  }

  // ---- a consumer warpgroup: packed rows m0 + 64 wg + [0, 64)
  regs_inc<Pl::CONSUMER_REGS>();
  const int w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
  const int wr0 = m0 + 64 * wg;
  {
    // Q: the warpgroup's 64 packed rows, 16 bytes a load, into the swizzled layout (rows past T zero).
    const uint16_t* q = static_cast<const uint16_t*>(p.q);
    constexpr int UNITS = 64 * D / 8;
#pragma unroll
    for (int i = 0; i < UNITS / 128; ++i) {
      const int x = tid % 128 + 128 * i, r = x / (D / 8), c = x % (D / 8) * 8;
      const int row = wr0 + r, pos = row / G, head = hk * G + row % G;
      const uint4 v = pos < p.q_len
                          ? *reinterpret_cast<const uint4*>(q + head * p.q_sh + static_cast<int64_t>(pos) * p.q_sr + c)
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(s_q + swizzled<D, BM>(64 * wg + r, c)) = v;
    }
    fence_proxy_async();
    named_sync(BAR_Q + wg, 128);
  }
  const int ra = wr0 + 16 * w4 + g, rb = ra + 8;  // this thread's packed rows
  const int pos_a = ra / G, pos_b = rb / G;
  const int pa = wr0 / G, pb = min((wr0 + 63) / G, p.q_len - 1);  // the warpgroup's positions
  const int my_turn = 1 + wg, other_turn = 2 - wg;
  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = fat::M_FLOOR, m_b = fat::M_FLOOR, l_a = 0.f, l_b = 0.f, al_a = 1.f, al_b = 1.f;
  const uint32_t q_tile = smem_u32(s_q);
  auto k_tile = [&](int s) { return smem_u32(s_kv + 2 * s * KV_TILE); };
  auto s_product = [&](float (&sc)[BN / 2], int s) {  // S = Q K^T of the tile in stage s
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(sc, desc_k<D, BM>(q_tile, 64 * wg, kk), desc_k<D, BN>(k_tile(s), 0, kk), kk);
    wg_commit();
  };
  auto pv_product = [&](uint32_t (&pf)[BN / 16][4], int s) {  // O += P V of the tile in stage s
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<T, D>(acc, pf[kk], desc_mn<D, BN>(k_tile(s) + KV_TILE, kk));
    wg_commit();
  };
  // The online softmax of tile n0's scores in place (sc becomes p); m and l advance, al_* the O rescale.
  auto softmax = [&](float (&sc)[BN / 2], int n0) {
    const int lim = lim_of(n0);
    // Whether any pair of this warpgroup's 64 x 64 tile is masked out.
    bool need = n0 + BN - 1 > pa + diag || n0 + BN > lim;
    if constexpr (MASKED) need = need || (p.window > 0 && n0 <= pb + diag - p.window);
    by_tile<MASKED>(p, need, [&](auto cap, auto mask) {
      constexpr bool CAP = decltype(cap)::value;
      // The base-2 score of a pair is x * s2: x the raw product, or with CAP
      // the capped score softcap2 * tanh(raw * scale2 / softcap2).
      const float s2 = CAP ? 1.f : p.scale2;
      float mx_a = fat::MASK_VALUE, mx_b = fat::MASK_VALUE;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const bool lo = (e & 2) == 0;
        float x = sc[e];
        if constexpr (CAP) x = p.softcap2 * tanhf(x * p.scale2 / p.softcap2);
        if constexpr (decltype(mask)::value) {
          const int col = n0 + 8 * (e / 4) + 2 * t + (e & 1), pos = lo ? pos_a : pos_b, d = pos + diag;
          bool ok = pos < p.q_len && col < lim && col <= d;
          if constexpr (MASKED) ok = ok && (p.window == 0 || col > d - p.window || col < p.sinks);
          if (!ok) x = fat::MASK_VALUE;
        }
        sc[e] = x;
        if (lo) {
          mx_a = fmaxf(mx_a, x);
        } else {
          mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(fat::FULL_MASK, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(fat::FULL_MASK, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, fmaxf(mx_a * s2, fat::M_FLOOR));
      const float mn_b = fmaxf(m_b, fmaxf(mx_b * s2, fat::M_FLOOR));
      al_a = exp2f(m_a - mn_a);
      al_b = exp2f(m_b - mn_b);
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const bool lo = (e & 2) == 0;
        const float pr = exp2f(fmaf(sc[e], s2, lo ? -mn_a : -mn_b));
        sc[e] = pr;
        if (lo) {
          rs_a += pr;
        } else {
          rs_b += pr;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rs_a += __shfl_xor_sync(fat::FULL_MASK, rs_a, off);
        rs_b += __shfl_xor_sync(fat::FULL_MASK, rs_b, off);
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
      m_a = mn_a;
      m_b = mn_b;
    });
  };
  auto rescale = [&]() {
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      acc[4 * jj] *= al_a;
      acc[4 * jj + 1] *= al_a;
      acc[4 * jj + 2] *= al_b;
      acc[4 * jj + 3] *= al_b;
    }
  };
  float sc[BN / 2];
  uint32_t pf[BN / 16][4];
  for (int i = i0; i < i1; ++i) {
    const int j = i - i0, s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    named_sync(my_turn, 256);
    wg_fence();
    s_product(sc, s);
    named_arrive(other_turn, 256);
    wg_wait_all();
    fence_regs(sc);
    softmax(sc, tile(i));
    rescale();
    to_a_frags<T, BN / 16>(pf, sc);
    named_sync(my_turn, 256);
    wg_fence();
    pv_product(pf, s);
    named_arrive(other_turn, 256);
    wg_wait_all();
    fence_regs(acc);
    fence_regs(pf);
    mbar_arrive(&empty[s]);
  }
  if (wg == 0) named_sync(my_turn, 256);  // warpgroup 1's last turn: every arrival is matched

  if (S > 1) {
    // The cluster's merge, in rank order: rank r's partials into the first block's freed Q / stage memory.
    float4* recv = reinterpret_cast<float4*>(s_q);
    constexpr int NV = D / 8;  // the accumulator's float4s a thread
    cluster_sync();  // every block's walk is done
    for (int r = 1; r < S; ++r) {
      if (rank == r) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          st_peer(peer_addr(smem_u32(&recv[v * 256 + tid]), 0),
                  make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]));
        st_peer(peer_addr(smem_u32(&recv[NV * 256 + tid]), 0), make_float4(m_a, m_b, l_a, l_b));
      }
      cluster_sync();
      if (rank == 0) {
        const float4 ml = recv[NV * 256 + tid];
        const float mn_a = fmaxf(m_a, ml.x), mn_b = fmaxf(m_b, ml.y);
        const float a0 = exp2f(m_a - mn_a), a1 = exp2f(ml.x - mn_a);
        const float b0 = exp2f(m_b - mn_b), b1 = exp2f(ml.y - mn_b);
        l_a = l_a * a0 + ml.z * a1;
        l_b = l_b * b0 + ml.w * b1;
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 x = recv[v * 256 + tid];
          acc[4 * v] = acc[4 * v] * a0 + x.x * a1;
          acc[4 * v + 1] = acc[4 * v + 1] * a0 + x.y * a1;
          acc[4 * v + 2] = acc[4 * v + 2] * b0 + x.z * b1;
          acc[4 * v + 3] = acc[4 * v + 3] * b0 + x.w * b1;
        }
      }
      if (r + 1 < S) cluster_sync();  // the buffer is read before the next rank writes it
    }
    if (rank != 0) return;
  }

  T* o = static_cast<T*>(p.o);
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a, inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
  const int64_t oa = (static_cast<int64_t>(hk * G + ra % G) * p.q_len + pos_a) * D;
  const int64_t ob = (static_cast<int64_t>(hk * G + rb % G) * p.q_len + pos_b) * D;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * t;
    if (pos_a < p.q_len) store2<T>(o + oa + col, acc[4 * jj] * inv_a, acc[4 * jj + 1] * inv_a);
    if (pos_b < p.q_len) store2<T>(o + ob + col, acc[4 * jj + 2] * inv_b, acc[4 * jj + 3] * inv_b);
  }
  if (p.lse != nullptr && t == 0) {
    if (pos_a < p.q_len) p.lse[oa / D] = l_a == 0.f ? -CUDART_INF_F : m_a + log2f(l_a);
    if (pos_b < p.q_len) p.lse[ob / D] = l_b == 0.f ? -CUDART_INF_F : m_b + log2f(l_b);
  }
}

// ---- host ----

struct ChunkCall {
  ChunkParams p;
  const void* k;
  const void* v;
  int64_t num_kv_heads, head_dim;
  const int64_t* st;  // k's and v's slot / head / row strides in elements
  int32_t dtype;
  bool masked;
  cudaStream_t stream;
};

template <typename T, typename P, int D, bool MASKED>
cudaError_t run(ChunkParams p, const ChunkCall& c) {
  using Pl = Plan<P, D>;
  const auto kernel = chunk_fwd_kernel<T, P, D, MASKED>;
  cudaError_t err = fat::reserve_smem(kernel, static_cast<int>(Pl::SMEM));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.splits),
                     static_cast<unsigned>((static_cast<int64_t>(p.q_len) * p.group + BM - 1) / BM),
                     static_cast<unsigned>(c.num_kv_heads));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Pl::SMEM;
  cfg.stream = c.stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename P, int D>
cudaError_t launch(const ChunkCall& c) {
  ChunkParams p = c.p;
  const int64_t* st = c.st;
  bool ok;
  if constexpr (fat::is_payload<P>) {
    ok = make_map_bytes(&p.tm_k, c.k, D, p.slots, c.num_kv_heads, p.kv_rows, st[0], st[1], st[2], BN) &&
         make_map_bytes(&p.tm_v, c.v, D, p.slots, c.num_kv_heads, p.kv_rows, st[3], st[4], st[5], BN);
  } else {
    ok = make_map<D>(&p.tm_k, c.k, c.dtype, p.slots, c.num_kv_heads, p.kv_rows, st[0], st[1], st[2], BN) &&
         make_map<D>(&p.tm_v, c.v, c.dtype, p.slots, c.num_kv_heads, p.kv_rows, st[3], st[4], st[5], BN);
  }
  if (!ok) return cudaErrorInvalidValue;
  return c.masked ? run<T, P, D, true>(p, c) : run<T, P, D, false>(p, c);
}

template <typename T, typename P>
cudaError_t by_head_dim(const ChunkCall& c) {
  switch (c.head_dim) {
    case 64: return launch<T, P, 64>(c);
    case 128: return launch<T, P, 128>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_payload(const ChunkCall& c, int32_t payload) {
  if (payload == c.dtype) return by_head_dim<T, T>(c);
  switch (payload) {
    case fat::kInt8: return by_head_dim<T, int8_t>(c);
    case fat::kFp8E4M3: return by_head_dim<T, __nv_fp8_e4m3>(c);
    case fat::kFp8E5M2: return by_head_dim<T, __nv_fp8_e5m2>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K1q and K1r on the tensor cores: a prefill chunk's causal attention over
// one slot of a dense KV cache, read where it lies. q [1, Hq, T, D] (D 64 or
// 128, bf16 or fp16) with unit stride on D, the chunk's rows at positions
// [kv_end - T, kv_end); k and v the whole cache [slots, Hkv, kv_rows, D] in
// q's type or a 1-byte payload (`payload`: csrc/common.cuh's code) with
// unit stride on D and the given slot / head / row strides; slot a device
// int32, the cache row attended (clamped into [0, slots)); ks and vs the row
// scales [slots, Hkv, kv_rows] fp32 of a payload (scale_strides: K's slot /
// head / row strides, then V's; unit row strides), else null. ring_mod 0:
// row = position (kv_end <= kv_rows); else the rolling ring: rows [0,
// ring_base) hold positions [0, sinks) and band position p >= sinks lies at
// row ring_base + (p - sinks) % ring_mod (needs a window, and ring_mod a
// multiple of 64 once positions have wrapped). Causal, with window (0:
// none), sinks and softcap2 (0, or cap * log2(e)); o [1, Hq, T, D]
// contiguous; lse [1, Hq, T] base-2 or null. q, the cache and the scales
// as TMA and bulk copies read them: 16-byte-aligned bases and strides,
// kv_rows a multiple of 4 for a payload. The walk is split over clusters of
// `splits` blocks (1-8; ops/flash_attention.chunk_splits). Returns a
// cudaError_t.
extern "C" int fat_chunk_fwd(const void* q, const void* k, const void* v, const float* ks, const float* vs, void* o,
                             float* lse, const int32_t* slot, int64_t slots, int64_t num_q_heads, int64_t num_kv_heads,
                             int64_t q_len, int64_t kv_end, int64_t kv_rows, int64_t head_dim, int64_t q_sh,
                             int64_t q_sr, int64_t k_sb, int64_t k_sh, int64_t k_sr, int64_t v_sb, int64_t v_sh,
                             int64_t v_sr, const int64_t* scale_strides, float scale2, int32_t window, int32_t sinks,
                             int64_t ring_mod, int64_t ring_base, float softcap2, int32_t dtype, int32_t payload,
                             void* stream, int32_t splits) {
  const bool quant = payload != dtype;
  if (dtype != fat::kBFloat16 && dtype != fat::kFloat16) return static_cast<int>(cudaErrorInvalidValue);
  if (slot == nullptr || slots < 1 || num_kv_heads < 1 || num_q_heads % num_kv_heads || q_len < 1 ||
      kv_end < q_len || kv_rows < 1 || splits < 1 || splits > MAX_SPLITS || window < 0 || sinks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // The ring: a window, its sinks below ring_base, and tiles that never straddle its end once positions have
  // wrapped; sinks only on the ring; a dense slot holds kv_end rows.
  if (ring_mod < 0 || ring_base < 0 || (ring_mod == 0 && (ring_base > 0 || sinks > 0 || kv_end > kv_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ring_mod > 0 && (window < 1 || sinks > ring_base || ring_base % BN || kv_rows != ring_base + ring_mod ||
                       (ring_mod % BN && kv_end - sinks > ring_mod)))
    return static_cast<int>(cudaErrorInvalidValue);
  // A payload's scales come in bulk copies of whole 16 bytes.
  if (quant && (ks == nullptr || vs == nullptr || scale_strides == nullptr || scale_strides[2] != 1 ||
                scale_strides[5] != 1 || kv_rows % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  ChunkCall c{};
  ChunkParams& p = c.p;
  p.q = q;
  p.q_sh = q_sh;
  p.q_sr = q_sr;
  p.o = o;
  p.lse = lse;
  p.slot = slot;
  p.slots = static_cast<int>(slots);
  p.group = static_cast<int>(num_q_heads / num_kv_heads);
  p.q_len = static_cast<int>(q_len);
  p.kv_len = static_cast<int>(kv_end);
  p.scale2 = scale2;
  p.window = window;
  p.softcap2 = softcap2;
  p.sinks = sinks;
  p.ring_mod = static_cast<int>(ring_mod);
  p.ring_base = static_cast<int>(ring_base);
  p.kv_rows = static_cast<int>(kv_rows);
  p.ks = ks;
  p.vs = vs;
  if (quant) {
    p.ks_sp = scale_strides[0];
    p.ks_sh = scale_strides[1];
    p.vs_sp = scale_strides[3];
    p.vs_sh = scale_strides[4];
  }
  p.splits = splits;
  const int64_t st[6] = {k_sb, k_sh, k_sr, v_sb, v_sh, v_sr};
  c.k = k;
  c.v = v;
  c.num_kv_heads = num_kv_heads;
  c.head_dim = head_dim;
  c.st = st;
  c.dtype = dtype;
  c.masked = window > 0 || softcap2 > 0.f || sinks > 0 || ring_mod > 0;
  c.stream = static_cast<cudaStream_t>(stream);
  if (dtype == fat::kBFloat16) return static_cast<int>(by_payload<__nv_bfloat16>(c, payload));
  return static_cast<int>(by_payload<__half>(c, payload));
}
