// K1, K1d, K2, K8 and K8q for bf16 and fp16 queries: the attention forward,
// causal or not, MHA or GQA, with its window, softcap and segment-id masks,
// over dense K / V, in place over a slot of a dense 16-bit KV cache (K1's
// kv_batch form), or over a slot's KV pages (K8, K8q: bf16 / fp16, or int8
// / fp8 e4m3 / fp8 e5m2 with one fp32 scale per row), on Hopper's tensor
// cores (wgmma) with tiles fed by TMA. fp32 keeps the FMA body of
// csrc/flash_fwd.cu, whose C entries fat_flash_fwd and fat_paged_prefill
// dispatch here by dtype. A chunk over a quantized dense slot (K1q) or the
// rolling ring (K1r) runs csrc/chunk_fwd_sm90.cu.
//
// Replaces the JAX package's ops/flash_attention.py:_fwd_kernel (:57, K1)
// with its window and softcap branches and its segment branch (K1d, :61-62,
// the packed tile skip of :1313-1330 and :1428-1431), _band_kernel (:795,
// K2, a causal window of at most 64) and ops/paged.py:_paged_prefill_kernel
// (:580, K8, chunk attention reading the slot's pages in place, with its
// dequant branch K8q, :642-690, its window, softcap and sinks). The
// function is csrc/flash_fwd.cu's: an online exp2 softmax with scale2 = sm_scale *
// log2(e) folded into one constant, a finite MASK_VALUE, the row max floored
// at M_FLOOR, output 0 and LSE -inf for a row that sees no key, end-aligned
// causal (K8: the chunk's rows at [kv_end - q_len, kv_end)), the exact
// tanhf softcap, StreamingLLM sinks (columns [0, sinks) visible beside the
// window), and the base-2 LSE m + log2(l). P enters the P V product rounded
// to the input type, as in the JAX package (:440, :520) and
// FlashAttention-2/3; the scores, the softmax, l and the output accumulator
// stay fp32. K8q scales each score by its column's K scale, and p by its
// column's V scale before p is rounded, as the JAX kernel and K6q do.
//
// What bounds it: every visible (q, kv) pair costs two products of 2 * D
// FLOPs against O((q_len + kv_len) * D) bytes, so at the serving chunk (256
// rows over kv 2048, dense or paged) and at every training length
// operations bound it, at the card's 989 TFLOP/s dense bf16 / fp16 rate,
// which only wgmma reaches. K2 at window 64 does ~128 columns a row, so its
// bytes bound it.
//
// Design (FlashAttention-3's forward without warp specialisation):
//  * A block owns (batch x q head, q tile) and keeps its Q tile in shared
//    memory; each warpgroup owns 64 of its rows. S = Q K^T is an m64n64k16
//    wgmma chain reading both operands from shared memory, K-major as
//    stored; the online softmax runs in the accumulator registers (rows g
//    and g + 8 of each warp's 16, reduced over the four threads of a row by
//    two shuffles); P is rounded and packed in place as the A fragments of
//    O += P V, whose B (V, stored [n][d]) wgmma reads with its transpose
//    flag. The O rescale by exp2(m_old - m_new) happens between products,
//    never while one is in flight.
//  * The q tile is 128 rows (two warpgroups sharing each K / V tile) where
//    that gives at least a block an SM, else 64 rows (one warpgroup, two
//    blocks an SM): the serving chunk, q [1,32,256,128], gives 64 blocks of
//    128 rows on 132 SMs but 128 of 64 (ops/flash_attention.fwd_q_tile).
//  * The grid is (batch x q head, q tile) with the q tiles reversed, so the
//    first wave takes every head's longest causal tiles.
//  * K and V go through a two-stage ring of mbarriers that one thread fills
//    with TMA: 64-row tiles at 16-bit width in the swizzled layout the
//    descriptors read (128-byte swizzle in 64-column chunks; 64-byte at D =
//    32), from tensor maps over each operand's [B, H, S, D] strides, so a
//    view of a KV cache is read in place. With a batch index (the dense
//    chunk prefill's slot) the K / V maps cover every slot of the cache and
//    the block reads its slot from device memory, as the tile's batch
//    coordinate: no map depends on the slot, so one CUDA graph of a chunk
//    serves them all. TMA zero-fills rows past kv_len, whose scores are 0
//    rather than masked: a ragged last tile takes the masked element pass.
//  * Pages (K8): a layer's pool [num_pages, Hkv, page_size, D] is a map of
//    (B, H, S) = (page, head, row), and the tile at logical row n0 is loaded
//    from (n0 % page_size, hk, table[n0 / page_size]), the page id clamped
//    into [0, num_pages). A 64-row tile never straddles a page (page_size is
//    a multiple of 64). The slot is read from device memory and the walked
//    part of its table row into shared memory at block start, so no TMA
//    issue waits on a dependent global load. Rows past kv_end inside the
//    last page are live memory, not zero-fill: the causal mask covers their
//    scores, and V's are zeroed in the stage, so that p = 0 meets no stale
//    value.
//  * K8q: the 1-byte payload tiles and their row scales land in a
//    two-stage staging ring (TMA boxes of whole rows, unswizzled, and two
//    bulk copies of up to 256 bytes); the block widens each tile, exactly
//    (every int8 and fp8 code is a bf16 and an fp16), into swizzled 16-bit
//    tiles the descriptors read, with the tile's scales beside them (its
//    TPU kernel scales the scores and p). There are two widened K / V
//    pairs: tile n + 1 is widened into one between the
//    issue of tile n's S = Q K^T and its wait, so the widen runs while the
//    tensor cores multiply and not between products (K8q widened the stage
//    behind a barrier first: 0.103 ms against K8's 0.040 at kv_end 2048).
//    A staging stage is refilled as soon as its tile is widened, so a load
//    has one and a half tiles' time to land. S = Q K^T runs in the query's
//    type; P V in bf16 whatever the query type, since p times a row's scale
//    can underflow fp16. Its shared memory (117 KB at D = 128 and 64 q rows)
//    holds one block an SM.
//  * The walk: the tiles holding [0, sinks) (the sinks, below the band,
//    each with its columns at or past `sinks` masked), then from the
//    window's first tile to the causal diagonal of the
//    block's last row (K2's window of at most 64 takes two or three tiles a
//    64-row q tile; a walk from the first visible column, unaligned, took
//    no less time, PERF.md); with segment ids it skips a kv tile whose
//    64-row id range meets neither half of the q tile. Tiles below the
//    band are never loaded, so over the paged ring a rolled-out logical
//    page, which aliases a newer physical page, is never read. The mask and
//    softcap choice is made once a tile (by_tile): only tiles crossing the
//    diagonal, the window's edge, a ragged end, a sink tile or two ids run
//    the element predicate.
#include <cuda.h>

#include "common.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;
using bf16 = __nv_bfloat16;

constexpr int BN = 64;  // kv rows a step

struct Params {
  CUtensorMap tm_q, tm_k, tm_v;
  void* o;
  float* lse;
  int num_q_heads, group, q_len, kv_len, causal;
  float scale2;
  int window;
  float softcap2;
  const int32_t* seg_q;
  const int32_t* seg_kv;
  const int32_t* q_rng;
  const int32_t* kv_rng;
  const int32_t* kv_index;  // dense: the K / V batch row of each query batch row, or null
  int kv_batch;
  const int32_t* table;  // K8: the page table [table_rows, table_stride] and the slot, on the device
  const int32_t* slot;
  int table_rows;
  int64_t table_stride;
  int page_size, num_pages, sinks;
  const float* ks;  // K8q: the row scales
  const float* vs;
  int64_t ks_sp, ks_sh, vs_sp, vs_sh;
  int kv_rows;  // the rows of a page
};

// Shared memory of an instantiation: the Q tile; the K / V ring (two stages
// of 16-bit K then V, or for a 1-byte payload P two widened K / V pairs,
// then two stages of payload K then V); the row scales of a payload (two
// stages as they land, then the two widened pairs', each K's then V's); the
// mbarriers; K8's table row.
template <typename P, int D, int WGS>
struct Plan {
  static constexpr bool QUANT = fat::is_payload<P>;
  static constexpr int Q_TILE = 64 * WGS * D * 2;
  static constexpr int KV_TILE = BN * D * 2;  // a 16-bit K or V tile
  static constexpr int PAY = BN * D;          // a payload tile
  static constexpr int KV = QUANT ? 4 * KV_TILE + 4 * PAY : 4 * KV_TILE;
  static constexpr int SCALES = QUANT ? 4 * 2 * BN * 4 : 0;
  // Bytes a stage's tiles bring (a payload stage's scales add theirs, up to 2 * BN * 4).
  static constexpr uint32_t STAGE_TX = QUANT ? 2 * PAY : 2 * KV_TILE;
  static constexpr int BARS = 64;
  static constexpr size_t bytes(int64_t table) { return 1024 + Q_TILE + KV + SCALES + BARS + 4 * table; }
};

// K8q: a stage's payload tiles widened exactly into the swizzled 16-bit
// tiles the descriptors read (K as TK, V as TV), the stage's row scales
// copied beside them; rows at or past `live` (past kv_end, or past the
// sinks in a sink tile) and their scales become 0.
template <typename P, typename TK, typename TV, int D, int NT>
__device__ __forceinline__ void widen_tile(const uint8_t* stage, uint8_t* wide_k, uint8_t* wide_v,
                                           const float* stage_scales, float* scales, int live, int tid) {
  using L = Layout<D>;
  constexpr int UNITS = BN * D / 8;  // 8-column units of a tile
  constexpr int STEPS = 2 * UNITS / NT, BATCH = STEPS < 4 ? STEPS : 4;
  static_assert(UNITS % NT == 0 && STEPS % BATCH == 0, "a step's units are all K's or all V's");
  // Units tid + i NT: K's for i < UNITS / NT, then V's. A batch's loads are issued before its widens, so one
  // warp a scheduler still has loads in flight while it converts.
#pragma unroll
  for (int i0 = 0; i0 < STEPS; i0 += BATCH) {
    uint2 raw[BATCH];
    float scale[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool is_v = (i0 + j) * NT >= UNITS;
      const int x = tid + (i0 + j) * NT - (is_v ? UNITS : 0), r = x / (D / 8), c = x % (D / 8) * 8;
      raw[j] = r < live ? *reinterpret_cast<const uint2*>(stage + (is_v ? BN * D : 0) + r * D + c) : make_uint2(0u, 0u);
      scale[j] = r < live ? stage_scales[(is_v ? BN : 0) + r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const bool is_v = (i0 + j) * NT >= UNITS;
      const int x = tid + (i0 + j) * NT - (is_v ? UNITS : 0), r = x / (D / 8), c = x % (D / 8) * 8;
      const uint4 w = is_v ? fat::widen8<P, TV>(raw[j]) : fat::widen8<P, TK>(raw[j]);
      // The unit's place as TMA would swizzle it (bits 4-6, or 4-5, XORed with the 128-byte line).
      const int lin = r * L::ROW + (c % L::CW) * 2;
      *reinterpret_cast<uint4*>((is_v ? wide_v : wide_k) + (c / L::CW) * BN * L::ROW +
                                (lin ^ (((lin >> 7) & (L::ROW / 16 - 1)) << 4))) = w;
    }
  }
  if (tid < 2 * BN) scales[tid] = tid % BN < live ? stage_scales[tid] : 0.f;
}

// Rows [from, BN) of a 16-bit tile set to 0 (whole rows, which the swizzle
// keeps in place).
template <int D, int NT>
__device__ __forceinline__ void zero_rows(uint8_t* tile, int from, int tid) {
  using L = Layout<D>;
  constexpr int UNITS = L::CHUNKS * L::ROW / 16;  // 16-byte units a row
  for (int i = tid; i < (BN - from) * UNITS; i += NT) {
    const int r = from + i / UNITS, j = i % UNITS;
    *reinterpret_cast<uint4*>(tile + (j / (L::ROW / 16)) * BN * L::ROW + r * L::ROW + (j % (L::ROW / 16)) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// One (batch x q head, q tile of 64 WGS rows): O and, with lse, the base-2
// LSE. P: the K / V element type (T, or K8q's payload); PAGED: K / V are
// page pools read through the table.
template <typename T, typename P, int D, bool MASKED, int WGS, bool PAGED>
__global__ void __launch_bounds__(128 * WGS, 1) fwd_kernel(const __grid_constant__ Params p) {
  using Pl = Plan<P, D, WGS>;
  constexpr bool QUANT = Pl::QUANT, SCALED = QUANT;  // K8q's scales go to the scores and to p
  static_assert(!QUANT || PAGED, "a payload is read through pages (K8q)");
  using TV = std::conditional_t<SCALED, bf16, T>;  // P V's operand type
  constexpr int BM = 64 * WGS, NT = 128 * WGS, KV_TILE = Pl::KV_TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_kv = s_q + Pl::Q_TILE;
  float* s_scale = reinterpret_cast<float*>(s_kv + Pl::KV);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_kv + Pl::KV + Pl::SCALES);  // [0]: Q; [1 + s]: stage s
  int32_t* s_table = reinterpret_cast<int32_t*>(bar + 8);
  // A payload's staging stage s and its scales, and the widened pair w and its scales.
  auto stage_of = [&](int s) { return s_kv + 4 * KV_TILE + 2 * s * Pl::PAY; };
  auto wide_of = [&](int w) { return s_kv + 2 * w * KV_TILE; };
  auto stage_scales = [&](int s) { return s_scale + 2 * s * BN; };
  auto wide_scales = [&](int w) { return s_scale + 4 * BN + 2 * w * BN; };

  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
  const int bh = blockIdx.x, b = bh / p.num_q_heads, h = bh % p.num_q_heads, hk = h / p.group;
  // Dense: the K / V batch row, kv_index[b] read from memory once a block (clamped into range), or b.
  const int kb = p.kv_index != nullptr ? min(max(p.kv_index[b], 0), p.kv_batch - 1) : b;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int r0 = m0 + 64 * wg;  // this warpgroup's first row
  const int diag = p.kv_len - p.q_len;
  const int last_row = min(m0 + BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + diag + 1) : p.kv_len;
  // Window: start at the tile of the first column the tile's first row sees.
  const int n_begin = MASKED && p.window > 0 ? max(0, m0 + diag - p.window + 1) / BN * BN : 0;
  // The sinks: the tiles holding [0, sinks), below the band, come first.
  const int sink_end = MASKED ? min((p.sinks + BN - 1) / BN * BN, n_begin) : 0;
  const bool segs = MASKED && p.seg_q != nullptr;
  auto next_live = [&](int n0) {
    if (segs) {
      while (n0 < n_end && !seg_meet(p, b, m0 / SEG, n0 / SEG) && !(WGS == 2 && seg_meet(p, b, m0 / SEG + 1, n0 / SEG)))
        n0 += BN;
    }
    return n0;
  };
  // The tile after n0 on the walk: after the last sink tile, the band's first.
  auto advance = [&](int n0) { return next_live(n0 < n_begin && n0 + BN >= sink_end ? n_begin : n0 + BN); };
  // The columns a tile may show end at the sinks in a sink tile, else at kv_end.
  auto lim_of = [&](int n0) { return MASKED && n0 < n_begin ? p.sinks : p.kv_len; };
  auto load_kv = [&](int s, int n0) {
    int x = kb, y = n0;  // the map's (batch or page, row) of the tile
    if constexpr (PAGED) {
      x = s_table[n0 / p.page_size], y = n0 % p.page_size;
    }
    if constexpr (QUANT) {
      // The scales past the page's last row are not read.
      const uint32_t sc_bytes = 4 * min(BN, p.kv_rows - y);
      mbar_expect(&bar[1 + s], Pl::STAGE_TX + 2 * sc_bytes);
      uint8_t* stage = stage_of(s);
      tma_load(stage, &p.tm_k, 0, y, hk, x, &bar[1 + s]);
      tma_load(stage + Pl::PAY, &p.tm_v, 0, y, hk, x, &bar[1 + s]);
      float* sc = stage_scales(s);
      bulk_load(sc, p.ks + static_cast<int64_t>(x) * p.ks_sp + hk * p.ks_sh + y, sc_bytes, &bar[1 + s]);
      bulk_load(sc + BN, p.vs + static_cast<int64_t>(x) * p.vs_sp + hk * p.vs_sh + y, sc_bytes, &bar[1 + s]);
    } else {
      mbar_expect(&bar[1 + s], Pl::STAGE_TX);
      uint8_t* stage = s_kv + 2 * s * KV_TILE;
      load_tile<D, BN>(stage, &p.tm_k, y, hk, x, &bar[1 + s]);
      load_tile<D, BN>(stage + KV_TILE, &p.tm_v, y, hk, x, &bar[1 + s]);
    }
  };
  // K8q: tile n0's payload in stage s widened into pair w.
  auto widen = [&](int s, int w, int n0) {
    uint8_t* wide = wide_of(w);
    widen_tile<P, T, TV, D, NT>(stage_of(s), wide, wide + KV_TILE, stage_scales(s), wide_scales(w),
                                min(BN, lim_of(n0) - n0), tid);
    fence_proxy_async();  // the widened tiles, before wgmma reads them
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (PAGED) {
    // The slot's table row: the slot read from memory (clamped into range).
    const int32_t* row = p.table + static_cast<int64_t>(min(max(*p.slot, 0), p.table_rows - 1)) * p.table_stride;
    const int sink_pages = (sink_end + p.page_size - 1) / p.page_size, first_page = n_begin / p.page_size;
    for (int i = tid; i < (n_end + p.page_size - 1) / p.page_size; i += NT)
      if (i < sink_pages || i >= first_page) s_table[i] = min(max(row[i], 0), p.num_pages - 1);
  }
  __syncthreads();
  const int first = sink_end > 0 ? 0 : next_live(n_begin);
  int n_load = first;  // thread 0's cursor: the next tile to load
  if (tid == 0) {
    mbar_expect(&bar[0], Pl::Q_TILE);
    load_tile<D, BM>(s_q, &p.tm_q, m0, h, b, &bar[0]);
    for (int s = 0; s < 2 && n_load < n_end; ++s) {
      load_kv(s, n_load);
      n_load = advance(n_load);
    }
  }
  if constexpr (QUANT) {
    // The first tile widened into pair 0; its stage then takes the third tile.
    if (first < n_end) {
      mbar_wait(&bar[1], 0);
      widen(0, 0, first);
    }
    __syncthreads();
    if (tid == 0 && n_load < n_end) {
      load_kv(0, n_load);
      n_load = advance(n_load);
    }
  }

  const int ra = r0 + 16 * w4 + g, rb = ra + 8;
  const int32_t* seg_kv = segs ? p.seg_kv + static_cast<int64_t>(b) * p.kv_len : nullptr;
  int32_t id_a = 0, id_b = 0;
  if (segs) {
    const int32_t* seg_q = p.seg_q + static_cast<int64_t>(b) * p.q_len;
    id_a = ra < p.q_len ? seg_q[ra] : 0;
    id_b = rb < p.q_len ? seg_q[rb] : 0;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_a = fat::M_FLOOR, m_b = fat::M_FLOOR, l_a = 0.f, l_b = 0.f;  // rows ra, rb
  const uint32_t q_tile = smem_u32(s_q);
  mbar_wait(&bar[0], 0);
  int it = 0;
  for (int n0 = first; n0 < n_end; ++it) {
    const int s = it & 1;
    const int lim = lim_of(n0);
    int n_next = 0;  // a payload's next tile, widened while this one is multiplied
    if constexpr (QUANT) n_next = advance(n0);
    const float* sc_k;  // K8q: the tile's K row scales, then V's
    uint32_t k_tile;
    if constexpr (QUANT) {
      k_tile = smem_u32(wide_of(s));
      sc_k = wide_scales(s);
    } else {
      mbar_wait(&bar[1 + s], (it >> 1) & 1);
      k_tile = smem_u32(s_kv + 2 * s * KV_TILE);
      sc_k = nullptr;
      if constexpr (PAGED) {
        if (n0 + BN > p.kv_len) {  // uniform across the block
          zero_rows<D, NT>(s_kv + 2 * s * KV_TILE + KV_TILE, p.kv_len - n0, tid);
          fence_proxy_async();
          __syncthreads();
        }
      }
    }
    const uint32_t v_tile = k_tile + KV_TILE;

    float sc[BN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(sc, desc_k<D, BM>(q_tile, 64 * wg, kk), desc_k<D, BN>(k_tile, 0, kk), kk);
    wg_commit();
    if constexpr (QUANT) {
      // The next tile widened into the other pair while the tensor cores multiply this one.
      if (n_next < n_end) {
        mbar_wait(&bar[1 + (s ^ 1)], ((it + 1) >> 1) & 1);
        widen(s ^ 1, s ^ 1, n_next);
      }
    }
    wg_wait_all();
    fence_regs(sc);

    // Whether any pair of this warpgroup's 64 x 64 tile is masked out.
    bool need = (p.causal && n0 + BN - 1 > r0 + diag) || n0 + BN > lim;
    if constexpr (MASKED) {
      need = need || (p.window > 0 && n0 <= r0 + 63 + diag - p.window) ||
             (segs && !seg_uniform(p, b, r0 / SEG, n0 / SEG));
    }
    by_tile<MASKED>(p, need, [&](auto cap, auto mask) {
      constexpr bool CAP = decltype(cap)::value;
      // The base-2 score of a pair is x * s2: x the raw product (K8q: times
      // its column's K scale), or with CAP the capped score softcap2 *
      // tanh(raw * scale2 / softcap2).
      const float s2 = CAP ? 1.f : p.scale2;
      float mx_a = fat::MASK_VALUE, mx_b = fat::MASK_VALUE;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        float x = sc[i];
        if constexpr (SCALED) x *= sc_k[8 * (i / 4) + 2 * t + (i & 1)];
        if constexpr (CAP) x = p.softcap2 * tanhf(x * p.scale2 / p.softcap2);
        if constexpr (decltype(mask)::value) {
          const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int32_t col_id = segs && col < p.kv_len ? seg_kv[col] : 0;
          if (!sees<MASKED>(p, lo ? ra : rb, col, lo ? id_a : id_b, col_id, p.sinks, lim)) x = fat::MASK_VALUE;
        }
        sc[i] = x;
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
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        const float pr = exp2f(fmaf(sc[i], s2, lo ? -mn_a : -mn_b));
        sc[i] = pr;
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
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= al_a;
        acc[4 * j + 1] *= al_a;
        acc[4 * j + 2] *= al_b;
        acc[4 * j + 3] *= al_b;
      }
    });
    if constexpr (SCALED) {  // p times its column's V scale (l sums p itself)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= sc_k[BN + 8 * (i / 4) + 2 * t + (i & 1)];
    }
    uint32_t pa[BN / 16][4];
    to_a_frags<TV, BN / 16>(pa, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<TV, D>(acc, pa[kk], desc_mn<D, BN>(v_tile, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warpgroup is done with stage s (a payload: with pair s, and stage s ^ 1 is widened)
    if (tid == 0 && n_load < n_end) {
      // A payload's stage s ^ 1 held the tile just widened; a 16-bit stage s the tile just multiplied.
      if constexpr (QUANT) {
        load_kv(s ^ 1, n_load);
      } else {
        load_kv(s, n_load);
      }
      n_load = advance(n_load);
    }
    if constexpr (QUANT) {
      n0 = n_next;
    } else {
      n0 = advance(n0);
    }
  }

  T* o = static_cast<T*>(p.o) + static_cast<int64_t>(bh) * p.q_len * D;
  const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a, inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ra < p.q_len) store2<T>(o + static_cast<int64_t>(ra) * D + col, acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    if (rb < p.q_len)
      store2<T>(o + static_cast<int64_t>(rb) * D + col, acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + static_cast<int64_t>(bh) * p.q_len;
    if (ra < p.q_len) lse[ra] = l_a == 0.f ? -CUDART_INF_F : m_a + log2f(l_a);
    if (rb < p.q_len) lse[rb] = l_b == 0.f ? -CUDART_INF_F : m_b + log2f(l_b);
  }
}

// ---- host ----

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on an H100

template <typename T, typename P, int D, bool MASKED, int WGS, bool PAGED>
cudaError_t run(const Params& p, const fat::Sm90FwdCall& c, int64_t table) {
  const size_t smem = Plan<P, D, WGS>::bytes(table);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = fat::reserve_smem(fwd_kernel<T, P, D, MASKED, WGS, PAGED>, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.batch * c.num_q_heads), static_cast<unsigned>((c.q_len + 64 * WGS - 1) / (64 * WGS)));
  fwd_kernel<T, P, D, MASKED, WGS, PAGED><<<grid, 128 * WGS, smem, c.stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P, int D, bool PAGED>
cudaError_t launch(const fat::Sm90FwdCall& c) {
  Params p{};
  const int64_t* st = c.st;
  // K / V as a map's (B, H, S): (batch, head, row) over every batch row
  // kv_index may name and its first kv_len rows, or (page, head, row).
  const int64_t kb = PAGED ? c.num_pages : (c.kv_index != nullptr ? c.kv_batch : c.batch);
  const int64_t kr = PAGED ? c.page_size : c.kv_len;
  bool ok = make_map<D>(&p.tm_q, c.q, c.dtype, c.batch, c.num_q_heads, c.q_len, st[0], st[1], st[2], c.q_tile);
  if constexpr (fat::is_payload<P>) {
    ok = ok && make_map_bytes(&p.tm_k, c.k, D, kb, c.num_kv_heads, kr, st[3], st[4], st[5], BN) &&
         make_map_bytes(&p.tm_v, c.v, D, kb, c.num_kv_heads, kr, st[6], st[7], st[8], BN);
    p.ks = c.ks;
    p.vs = c.vs;
    p.ks_sp = c.sst[0];
    p.ks_sh = c.sst[1];
    p.vs_sp = c.sst[2];
    p.vs_sh = c.sst[3];
  } else {
    ok = ok && make_map<D>(&p.tm_k, c.k, c.dtype, kb, c.num_kv_heads, kr, st[3], st[4], st[5], BN) &&
         make_map<D>(&p.tm_v, c.v, c.dtype, kb, c.num_kv_heads, kr, st[6], st[7], st[8], BN);
  }
  if (!ok) return cudaErrorInvalidValue;
  p.o = c.o;
  p.lse = c.lse;
  p.num_q_heads = static_cast<int>(c.num_q_heads);
  p.group = static_cast<int>(c.num_q_heads / c.num_kv_heads);
  p.q_len = static_cast<int>(c.q_len);
  p.kv_len = static_cast<int>(c.kv_len);
  p.causal = c.causal;
  p.scale2 = c.scale2;
  p.window = c.window;
  p.softcap2 = c.softcap2;
  p.seg_q = c.seg_q;
  p.seg_kv = c.seg_kv;
  p.q_rng = c.q_rng;
  p.kv_rng = c.kv_rng;
  p.kv_index = c.kv_index;
  p.kv_batch = static_cast<int>(c.kv_batch);
  p.table = c.table;
  p.slot = c.slot;
  p.table_rows = static_cast<int>(c.table_rows);
  p.table_stride = c.table_stride;
  p.page_size = static_cast<int>(c.page_size);
  p.num_pages = static_cast<int>(c.num_pages);
  p.sinks = c.sinks;
  p.kv_rows = static_cast<int>(c.page_size);
  const int64_t table = PAGED ? (c.kv_len + c.page_size - 1) / c.page_size : 0;
  const bool masked = c.window > 0 || c.softcap2 > 0.f || c.seg_q != nullptr;
  if (c.q_tile == 128) return masked ? run<T, P, D, true, 2, PAGED>(p, c, table) : run<T, P, D, false, 2, PAGED>(p, c, table);
  return masked ? run<T, P, D, true, 1, PAGED>(p, c, table) : run<T, P, D, false, 1, PAGED>(p, c, table);
}

template <typename T, typename P>
cudaError_t by_head_dim(const fat::Sm90FwdCall& c) {
  auto go = [&](auto dim) -> cudaError_t {
    constexpr int D = decltype(dim)::value;
    if constexpr (fat::is_payload<P>) {  // K8q only
      return c.table != nullptr ? launch<T, P, D, true>(c) : cudaErrorInvalidValue;
    } else {
      return c.table != nullptr ? launch<T, P, D, true>(c) : launch<T, P, D, false>(c);
    }
  };
  switch (c.head_dim) {
    case 32: return go(std::integral_constant<int, 32>{});
    case 64: return go(std::integral_constant<int, 64>{});
    case 128: return go(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_payload(const fat::Sm90FwdCall& c) {
  if (c.payload == c.dtype) return by_head_dim<T, T>(c);
  if (c.ks == nullptr || c.vs == nullptr || c.sst == nullptr || c.table == nullptr) return cudaErrorInvalidValue;
  switch (c.payload) {
    case fat::kInt8: return by_head_dim<T, int8_t>(c);
    case fat::kFp8E4M3: return by_head_dim<T, __nv_fp8_e4m3>(c);
    case fat::kFp8E5M2: return by_head_dim<T, __nv_fp8_e5m2>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fat {

cudaError_t sm90_fwd(const Sm90FwdCall& c) {
  if (c.window < 0 || (c.window > 0 && !c.causal) || c.sinks < 0) return cudaErrorInvalidValue;
  if (c.seg_q != nullptr && (c.seg_kv == nullptr || c.q_rng == nullptr || c.kv_rng == nullptr))
    return cudaErrorInvalidValue;
  if ((c.q_tile != 64 && c.q_tile != 128) || c.q_len < 1 || c.kv_len < 1) return cudaErrorInvalidValue;
  if (c.table != nullptr && (c.batch != 1 || !c.causal || c.seg_q != nullptr || c.page_size < BN ||
                             c.page_size % BN || c.num_pages < 1 || c.slot == nullptr || c.table_rows < 1 ||
                             c.table_stride < (c.kv_len + c.page_size - 1) / c.page_size || c.kv_index != nullptr))
    return cudaErrorInvalidValue;
  if (c.kv_index != nullptr && (c.kv_batch < 1 || c.seg_q != nullptr)) return cudaErrorInvalidValue;
  // Sinks over pages (K8).
  if (c.table == nullptr && c.sinks > 0) return cudaErrorInvalidValue;
  switch (c.dtype) {
    case kBFloat16: return by_payload<bf16>(c);
    case kFloat16: return by_payload<__half>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fat
