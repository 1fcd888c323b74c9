// K6 and K7: single-token decode attention over a dense or a paged KV cache,
// bf16 / fp16 / fp32 or quantized (int8, fp8 e4m3, fp8 e5m2 with one fp32
// scale per row and head), for Hopper.
//
// Replaces the JAX package's ops/decode.py:_decode_kernel (K6, with its
// dequant, window, softcap, ring-buffer and sink branches, :91-200) and
// ops/paged.py:_paged_decode_kernel_hb (:980) and _paged_decode_kernel
// (:1104) (K7, decode through a page table, output and base-2 LSE, with
// their dequant, window, softcap and sink branches). One query token per
// sequence attends to the rows of its cache that its mask admits. Same
// numerics as K1: fp32 scores and accumulators, exp2 softmax with scale2 =
// sm_scale * log2(e), the running max floored at M_FLOOR, output 0 and LSE
// -inf for a sequence that sees no row.
//
// Masks, by POSITION, never by slot (runtime parameters of the body's
// masked instantiation; L = lengths[b], w = window, s = sinks):
//  * dense cache or K7's logical rows: row r holds position r; visible when
//    r < L and (no window, or r >= L - w, or r < s: K7's sinks on logical
//    page 0);
//  * ring of R rows (K6, rolling cache; L counts every position written
//    and may pass R): row r holds p = L - 1 - ((L - 1 - r) mod R), visible
//    when p >= max(0, L - w);
//  * ring with sinks: rows [0, s_pad) hold positions [0, s) (s_pad = s
//    rounded up to 128), visible when r < s and r < L; the rest is a ring
//    of modulus R - s_pad over positions >= s, row r holding p = L - 1 -
//    ((L - 1 - s - (r - s_pad)) mod (R - s_pad)), visible when p >= max(s,
//    L - w);
//  * softcap: the score (after the dequant scale) becomes softcap2 *
//    tanhf(score / softcap2), softcap2 = cap * log2(e), before the mask.
// Only live rows are walked: [max(L - w, 0), min(L, rows)) for a window
// (and the rows holding [0, s) for K7's sinks), min(L, R) rows of a ring,
// and s_pad + min(max(L - s, 0), R - s_pad) rows of a ring with sinks.
//
// One body serves both caches through an address policy (Copier below):
// row r of (b, kv head h) is
//   dense:  base + b * sb + h * sh + r * sr
//   paged:  pages + clamp(table[b, r / page_size]) * sb + h * sh + (r % page_size) * sr
// and a quantized row's scale lies at the same (b or page, h, row) of the
// scale tensor through its own strides. The page id is clamped into
// [0, num_pages): a released slot keeps its length while its table points at
// dump page 0, and its lane still rides in the batched step, so an unclamped
// id would be an illegal address.
//
// What bounds it on this card: every cache row is used once per query group,
// about 4 flops a byte (8 for a 1-byte payload), so the bytes of the cache
// read bound it; a quantized cache halves them against bf16.
//
// Design (flash-decoding):
//  * the grid is (kv head, batch row, query chunk x split). A block serves
//    up to 16 query rows of one GQA group (the mma's M; a smaller group is
//    padded with zero rows), so each K/V row is read once for the group;
//  * `splits` (ops/decode.py decode_kv_splits, from the shapes alone) cuts
//    each sequence's live rows into equal pieces of whole units (RUN rows
//    for a dense cache, whole pages for K7), so that batch x kv heads blocks
//    become enough to fill the card. A split past a short sequence's end
//    finds nothing and leaves an empty part (l = 0);
//  * the block walks its rows in runs of RUN: each of its four warps takes
//    16 rows of every run and copies them itself, STAGES - 1 runs ahead of
//    its compute, into its share of a ring of STAGES stages in shared memory:
//    one TMA box of 16 rows a 128-byte column chunk (or a narrower row) for
//    K and one for V, swizzled so that the fragment reads below spread over
//    the banks, landing on the warp's mbarrier for the stage (a quantized
//    run's scales by 4-byte cp.async arriving on it too). Rows past the
//    tensor read as zeros; rows past the live range are masked, and their V
//    zeroed in the stage. A run never straddles a page (page_size is a
//    multiple of RUN). A warp reads only the rows it copied, so no block
//    barrier runs in the loop. (Per-warp 16-byte cp.async with padded rows
//    took 1.1x as long over the ring and 1.2x at phase 3's shape, and one
//    cp.async.bulk a row issued by a producer warp 1.5x and 2x: PERF.md
//    section 6.);
//  * S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16, or fp16 for an
//    fp16 cache), the operands' fragments read straight from the stage and a
//    quantized payload widened there (exact: every int8 and fp8 code is a
//    bf16); the online softmax runs on the accumulator fragments once a run.
//    An fp32 operand is split into two bf16 parts (hi + lo) and multiplied in
//    three products, so that fp32 inputs keep about 16 bits; fp16 queries
//    over a quantized cache split the same way (the product runs in bf16
//    there, so that p times a row's scale keeps its range). A quantized
//    row's scale multiplies its score (K) and its probability (V), late, as
//    the TPU kernel does;
//  * masks and softcap are an instantiation of their own (MASKED), tested
//    per element of a run; the unmasked body tests only the last run of a
//    range, for rows past its end (a runtime mask in the row loop cost 2.2x
//    in the old body);
//  * the warps merge their parts through shared memory in warp order. One
//    split writes the output (and LSE) directly; with more, each writes its
//    fp32 part (m, l, unnormalised O) to a workspace, and the last block of
//    the group to finish (a ticket counter, atomicAdd after
//    __threadfence(), which that block resets to 0) merges all parts in
//    split order. The output is bit-identical from run to run, and a CUDA
//    graph of the launch replays it.
#include <climits>

#include "common.cuh"
#include "sm90_common.cuh"

namespace {

using fat::cache_pair;
using fat::pack_split;
using fat::sm90::fence_proxy_async;
using fat::sm90::mbar_expect;
using fat::sm90::mbar_init;
using fat::sm90::mbar_wait;
using fat::sm90::smem_u32;
using fat::sm90::tma_load;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int RUN = 16 * WARPS;            // rows a stage: the copy unit
constexpr int MAX_G = 16;                  // query rows a block, the mma's M
constexpr int STAGE_TARGET = 104 * 1024;   // the stages' bytes: two blocks an SM in 16-bit types

struct DecodeParams {
  CUtensorMap tm_k, tm_v;  // K's and V's rows, dims (D, rows, Hkv, B or pages), boxes of 16 rows
  const void* q;  // [B, Hq, D], unit stride on D
  const void* k;
  const void* v;
  const float* ks;  // quantized: K's scales, one a row; else nullptr
  const float* vs;
  void* o;       // [B, Hq, D], contiguous
  float* lse;    // [B, Hq] or nullptr
  float* ws;     // splits > 1: fp32 parts, acc [B, splits, Hq, D], then m and l [B, splits, Hq]
  int* tickets;  // splits > 1: [B * Hkv * chunks] int32, 0 between launches
  const int32_t* lengths;
  const int32_t* table;  // paged: [B, pages_per_slot]; dense: unused
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_sr;  // paged: sb is the page stride
  int64_t v_sb, v_sh, v_sr;
  int64_t ks_sb, ks_sh, ks_sr;  // the scales' strides, indexed as the payload's
  int64_t vs_sb, vs_sh, vs_sr;
  int batch, num_q_heads, group, chunks, splits, max_seq;
  int page_size, pages_per_slot, num_pages;
  int window;     // 0: no window
  int ring;       // 0, or the ring buffer's rows (max_seq) of a rolling cache
  int sinks;      // attention sinks: K7's logical rows [0, sinks), or the ring's sink region
  int sinks_pad;  // ring with sinks: the sink region's rows (sinks rounded up to 128)
  float scale2;
  float softcap2;  // cap * log2(e); 0: no softcap
  // K7's self term (the deferred decode step): the current token's new K
  // and V rows [B, Hkv, D] of q's type, merged as one more part; else nullptr.
  const void* self_k;
  const void* self_v;
  int64_t sk_sb, sk_sh, sv_sb, sv_sh;
};

__device__ __forceinline__ int pmod(int x, int m) { return ((x % m) + m) % m; }

// The masks above for one sequence of length L, set up once a block so that
// the row test takes no modulo: row r holds position r, or, at or past ring0
// (the ring region's first row), pos0 + j - (j > newest ? modulus : 0) with
// j = r - ring0 (the newest position sits at ring row `newest`, older ones
// wrap behind it). Visible: pos < L and (pos >= lo or pos < sinks), and r
// outside [dead_lo, dead_hi), the sink region's padding.
struct RowMask {
  int L, lo, sinks, ring0, modulus, newest, pos0, dead_lo, dead_hi;

  __device__ __forceinline__ bool visible(int r) const {
    const int j = r - ring0;
    const int pos = r >= ring0 ? pos0 + j - (j > newest ? modulus : 0) : r;
    return pos < L && (pos >= lo || pos < sinks) && (r < dead_lo || r >= dead_hi);
  }
};

__device__ __forceinline__ RowMask row_mask(const DecodeParams& p, int L) {
  RowMask m{L, 0, p.sinks, INT_MAX, 1, 0, 0, 0, 0};
  if (p.ring == 0) {
    if (p.window > 0) m.lo = L - p.window;
    return m;
  }
  m.ring0 = p.sinks_pad;
  m.modulus = p.ring - p.sinks_pad;
  m.newest = pmod(L - 1 - p.sinks, m.modulus);
  m.pos0 = L - 1 - m.newest;
  m.lo = max(p.sinks, L - p.window);
  m.dead_lo = p.sinks;
  m.dead_hi = p.sinks_pad;
  return m;
}

// A sequence's live rows as units of U rows (RUN for a dense cache, a page
// for K7): units [0, n_a) cover rows [0, a_end), units [n_a, n_a + n_b) the
// rows [b_unit0 * U, b_end). Split s of `splits` walks units [u0, u1), its
// equal share, in runs of RUN rows from each unit's start, of which the
// first min(RUN, end(u) - r0) are live (ops/decode.py decode_split_runs
// mirrors this).
struct Walk {
  int U, a_end, n_a, b_unit0, b_end, u0, u1;

  __device__ __forceinline__ int start(int u) const { return (u < n_a ? u : b_unit0 + u - n_a) * U; }
  __device__ __forceinline__ int end(int u) const { return min(start(u) + U, u < n_a ? a_end : b_end); }
};

// The walk's runs in order (every unit is non-empty): RUN rows from r0, of
// which the first count() are cache rows of the live range.
struct Runs {
  Walk w;
  int u, r0, stop;

  __device__ __forceinline__ explicit Runs(const Walk& walk) : w(walk), u(walk.u0), r0(0), stop(0) {
    if (u < w.u1) r0 = w.start(u), stop = w.end(u);
  }
  __device__ __forceinline__ bool live() const { return u < w.u1; }
  __device__ __forceinline__ int count() const { return min(RUN, stop - r0); }
  __device__ __forceinline__ void next() {
    r0 += RUN;
    if (r0 >= stop && ++u < w.u1) r0 = w.start(u), stop = w.end(u);
  }
};

template <bool PAGED, bool MASKED>
__device__ __forceinline__ Walk make_walk(const DecodeParams& p, int length, int split) {
  const int U = PAGED ? p.page_size : RUN;
  int a_end = 0, b_start = 0, b_end = min(length, p.max_seq);
  if constexpr (MASKED) {
    if (p.ring == 0) {
      if (p.window > 0) b_start = max(length - p.window, 0) / U * U;
      a_end = min(p.sinks, b_start);
    } else if (p.sinks_pad == 0) {
      b_end = min(length, p.ring);
    } else {
      a_end = min(p.sinks, length);
      b_start = p.sinks_pad;
      b_end = p.sinks_pad + min(max(length - p.sinks, 0), p.ring - p.sinks_pad);
    }
  }
  Walk w;
  w.U = U;
  w.a_end = a_end;
  w.n_a = (a_end + U - 1) / U;
  w.b_unit0 = b_start / U;
  w.b_end = b_end;
  const int n = w.n_a + max((b_end + U - 1) / U - w.b_unit0, 0);
  const int per = (n + p.splits - 1) / p.splits;
  w.u0 = min(split * per, n);
  w.u1 = min(w.u0 + per, n);
  return w;
}

// The operand type of the products: fp16 for an fp16 cache, else bf16 (the
// payload codes widen into it exactly, and its range holds p times a scale).
template <typename T, typename P>
using Mma = std::conditional_t<std::is_same_v<T, __half> && std::is_same_v<P, __half>, __half, __nv_bfloat16>;

// Two neighbours of a cache row, x[0] and x[1] (an even column), as cache_pair.
template <typename P, typename M>
__device__ __forceinline__ void row_pair(const P* x, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same_v<P, M>) {
    hi = *reinterpret_cast<const uint32_t*>(x);
  } else if constexpr (std::is_same_v<P, float>) {
    const float2 f = *reinterpret_cast<const float2*>(x);
    pack_split<M, true>(f.x, f.y, hi, lo);
  } else {
    cache_pair<P, M>(x[0], x[1], hi, lo);
  }
}

template <typename M>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<M, __half>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// c += A B over the split parts: hi hi, then hi lo (B split), lo hi (A split).
template <typename M, bool SA, bool SB>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma<M>(c, ah, bh0, bh1);
  if constexpr (SB) mma<M>(c, ah, bl0, bl1);
  if constexpr (SA) mma<M>(c, al, bh0, bh1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(fat::FULL_MASK, x, 1);
  return x + __shfl_xor_sync(fat::FULL_MASK, x, 2);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// One arrival on bar once this thread's cp.asyncs so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The shared-memory plan of an instantiation: STAGES stages, each holding
// every warp's 16 rows of a run, K's then V's (and, quantized, their
// scales) as TMA writes them: CHUNKS column chunks of [16][CWB bytes], each
// swizzled over CWB-byte rows (CWB: 128, or a narrower row's bytes). After
// the loop the same bytes hold the warps' parts for the merge.
template <typename P, int D>
struct Plan {
  static constexpr bool QUANT = fat::is_payload<P>;
  static constexpr int ROW = D * static_cast<int>(sizeof(P));  // bytes a row
  static constexpr int CWB = ROW < 128 ? ROW : 128;             // bytes a chunk row: the swizzle span
  static constexpr int CW = CWB / static_cast<int>(sizeof(P));  // elements a chunk row
  static constexpr int CHUNKS = ROW / CWB;
  static constexpr int TILE = 16 * ROW;                          // one warp's 16 rows of K, or of V
  static constexpr int WARP_STAGE = (2 * TILE + (QUANT ? 2 * 16 * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int STAGE = WARPS * WARP_STAGE;
  static constexpr int STAGES = STAGE_TARGET / STAGE < 3 ? 3 : (STAGE_TARGET / STAGE > 8 ? 8 : STAGE_TARGET / STAGE);
  static constexpr int MERGE = WARPS * MAX_G * (D + 2) * 4;
  static constexpr int BARS = STAGES * WARPS * 8;
  static constexpr int BYTES = 1024 + (STAGES * STAGE > MERGE ? STAGES * STAGE : MERGE) + BARS;

  // The byte of (row, byte of the row) in a tile as TMA swizzles it: the
  // 16-byte unit (bits 4-6) XORed with the 128-byte line (bits 7-9), in as
  // many bits as the swizzle span has units.
  __device__ static __forceinline__ int at(int row, int byte) {
    const int lin = row * CWB + byte % CWB;
    return byte / CWB * 16 * CWB + (lin ^ (((lin >> 7) & (CWB / 16 - 1)) << 4));
  }
};

__device__ __forceinline__ int page_of(const DecodeParams& p, int b, int r0) {
  return p.table[static_cast<int64_t>(b) * p.pages_per_slot + r0 / p.page_size];
}

// One warp's copies of its 16 rows of the walk's runs, one run a stage,
// ahead of its compute: two TMA boxes of 16 rows a column chunk (K, V)
// onto the stage's mbarrier, and a quantized run's scales by 4-byte
// cp.async arriving on the same barrier (zero past the run's live range).
// K7's page id of each run is read one run ahead, so that its latency hides
// behind the copies before it.
template <typename P, int D, bool PAGED>
struct Copier {
  using Pl = Plan<P, D>;
  const DecodeParams& p;
  Runs ahead;
  int b, hk, w16, lane, page;

  __device__ __forceinline__ Copier(const DecodeParams& params, const Walk& walk, int b_, int hk_, int w16_, int lane_)
      : p(params), ahead(walk), b(b_), hk(hk_), w16(w16_), lane(lane_), page(0) {
    if (PAGED && ahead.live()) page = page_of(p, b, ahead.r0);
  }

  // The next run into `dst` (this warp's share of a stage), landing on
  // `bar`; nothing past the walk's end.
  __device__ __forceinline__ void issue(uint8_t* dst, uint64_t* bar) {
    if (!ahead.live()) return;
    const int live = ahead.count() - w16;  // this warp's rows that are cache rows
    int x = b, y = ahead.r0 + w16;
    if constexpr (PAGED) x = min(max(page, 0), p.num_pages - 1), y = ahead.r0 % p.page_size + w16;
    ahead.next();
    if (PAGED && ahead.live()) page = page_of(p, b, ahead.r0);
    if (lane == 0) {
      fence_proxy_async();  // the warp's reads of this stage (ordered by __syncwarp) before the copy's writes
      mbar_expect(bar, 2 * Pl::TILE);
#pragma unroll
      for (int c = 0; c < Pl::CHUNKS; ++c) {
        tma_load(dst + c * 16 * Pl::CWB, &p.tm_k, c * Pl::CW, y, hk, x, bar);
        tma_load(dst + Pl::TILE + c * 16 * Pl::CWB, &p.tm_v, c * Pl::CW, y, hk, x, bar);
      }
    }
    if constexpr (Pl::QUANT) {
      const int i = lane % 16;
      const bool ok = i < live, is_v = lane >= 16;
      const float* sc = is_v ? p.vs + x * p.vs_sb + hk * p.vs_sh + (y + i) * p.vs_sr
                             : p.ks + x * p.ks_sb + hk * p.ks_sh + (y + i) * p.ks_sr;
      cp_async4(reinterpret_cast<float*>(dst + 2 * Pl::TILE) + lane, ok ? sc : p.ks, ok);
      cp_async_arrive(bar);
    }
  }
};

// T: query and output type; P: the cache's element type (T, or a payload
// type whose rows are scaled). MASKED: a window, ring, sinks or softcap.
template <typename T, typename P, int D, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(THREADS) decode_kernel(const __grid_constant__ DecodeParams p) {
  using M = Mma<T, P>;
  using Pl = Plan<P, D>;
  constexpr bool QUANT = Pl::QUANT;
  constexpr bool SPLIT_Q = !std::is_same_v<T, M>;     // q keeps a low part
  constexpr bool SPLIT_P = std::is_same_v<T, float>;  // so do the probabilities
  constexpr bool SPLIT_KV = std::is_same_v<P, float>;
  constexpr int KSTEPS = D / 16, NT = D / 8, ES = static_cast<int>(sizeof(P));
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* stages = fat::sm90::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + Pl::BYTES - Pl::BARS);  // [STAGES][WARPS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int chunk = blockIdx.z % p.chunks, split = blockIdx.z / p.chunks;
  const int g0 = chunk * MAX_G;
  const int ng = min(MAX_G, p.group - g0);
  const int h0 = hk * p.group + g0;  // first q head of this block
  const int length = max(p.lengths[b], 0);
  const Walk walk = make_walk<PAGED, MASKED>(p, length, split);
  RowMask mask{};
  if constexpr (MASKED) mask = row_mask(p, length);
  const int w16 = warp * 16;  // this warp's first row of a run
  auto warp_stage = [&](int st) { return stages + (st * WARPS + warp) * Pl::WARP_STAGE; };
  auto warp_bar = [&](int st) { return &bars[st * WARPS + warp]; };

  if (lane == 0) {
    for (int st = 0; st < Pl::STAGES; ++st) mbar_init(warp_bar(st), QUANT ? 33 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  Copier<P, D, PAGED> copier(p, walk, b, hk, w16, lane);
#pragma unroll
  for (int st = 0; st < Pl::STAGES - 1; ++st) copier.issue(warp_stage(st), warp_bar(st));

  // The q rows' A fragments (rows g and g + 8 of the chunk, zero past the
  // group), while the first copies fly.
  uint32_t qh[KSTEPS][4], ql[KSTEPS][4];
  {
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int row = g + 8 * (f & 1), col = kk * 16 + 2 * t + 8 * (f >> 1);
        const T* x = q + row * p.q_sh + col;
        const bool live = row < ng;
        pack_split<M, SPLIT_Q>(live ? fat::to_float(x[0]) : 0.f, live ? fat::to_float(x[1]) : 0.f, qh[kk][f],
                               ql[kk][f]);
      }
    }
  }

  float m[2] = {fat::M_FLOOR, fat::M_FLOOR}, l[2] = {0.f, 0.f};  // q rows g and g + 8
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int j = 0;
  for (Runs run(walk); run.live(); run.next(), ++j) {
    const int st = (j + Pl::STAGES - 1) % Pl::STAGES;
    copier.issue(warp_stage(st), warp_bar(st));
    mbar_wait(warp_bar(j % Pl::STAGES), (j / Pl::STAGES) & 1);  // run j has landed
    const int r0 = run.r0, live = run.count() - w16;  // this warp's rows that are cache rows
    if (live > 0) {
      uint8_t* stage = warp_stage(j % Pl::STAGES);
      const uint8_t* k_rows = stage;
      uint8_t* v_rows = stage + Pl::TILE;
      const float* k_scale = reinterpret_cast<const float*>(stage + 2 * Pl::TILE);
      const float* v_scale = k_scale + 16;
      if (live < 16) {
        // The last run of a range: rows past it are cache rows never
        // written, or zeros past the cache; their p is 0, but V must not
        // be NaN. (Each row stays in its own bytes under the swizzle.)
        for (int c = 0; c < Pl::CHUNKS; ++c)
          for (int i = live * Pl::CWB / 16 + lane; i < Pl::CWB; i += 32)
            reinterpret_cast<uint4*>(v_rows + c * 16 * Pl::CWB)[i] = make_uint4(0, 0, 0, 0);
        fence_proxy_async();  // before the next copy into this stage
        __syncwarp();
      }

      // S = Q K^T over two n-tiles of 8 rows.
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int row = nt * 8 + g, col = kk * 16 + 2 * t;
          uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
          row_pair<P, M>(reinterpret_cast<const P*>(k_rows + Pl::at(row, col * ES)), bh0, bl0);
          row_pair<P, M>(reinterpret_cast<const P*>(k_rows + Pl::at(row, (col + 8) * ES)), bh1, bl1);
          mma3<M, SPLIT_Q, SPLIT_KV>(s[nt], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
        }
      }
      // Element e of n-tile nt: q row g + 8 (e >> 1), this warp's row nt * 8 + 2 t + (e & 1).
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * p.scale2;
          if constexpr (QUANT) x *= k_scale[nt * 8 + 2 * t + (e & 1)];
          s[nt][e] = x;
        }
      }
      if constexpr (MASKED) {
        if (p.softcap2 > 0.f) {  // uniform across the block
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = p.softcap2 * tanhf(s[nt][e] / p.softcap2);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = nt * 8 + 2 * t + (e & 1);
            if (!(row < live && mask.visible(r0 + w16 + row))) s[nt][e] = fat::MASK_VALUE;
          }
      } else if (live < 16) {  // the last run of the range: its zero-filled rows
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (nt * 8 + 2 * t + (e & 1) >= live) s[nt][e] = fat::MASK_VALUE;
      }

      // The online softmax of q rows g (i = 0) and g + 8 (i = 1).
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]), fmaxf(s[1][2 * i], s[1][2 * i + 1]));
        mx = fmaxf(m[i], quad_max(mx));
        alpha[i] = exp2f(m[i] - mx);
        m[i] = mx;
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[nt][e] = exp2f(s[nt][e] - mx);
            rs += s[nt][e];
          }
        }
        l[i] = l[i] * alpha[i] + rs;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V: P's A fragment is the score fragments' layout.
      if constexpr (QUANT) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] *= v_scale[nt * 8 + 2 * t + (e & 1)];
      }
      uint32_t ph[4], pl[4];
      pack_split<M, SPLIT_P>(s[0][0], s[0][1], ph[0], pl[0]);
      pack_split<M, SPLIT_P>(s[0][2], s[0][3], ph[1], pl[1]);
      pack_split<M, SPLIT_P>(s[1][0], s[1][1], ph[2], pl[2]);
      pack_split<M, SPLIT_P>(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int byte = (n * 8 + g) * ES;
        auto v = [&](int row) { return *reinterpret_cast<const P*>(v_rows + Pl::at(row, byte)); };
        uint32_t bh0, bh1, bl0 = 0, bl1 = 0;
        cache_pair<P, M>(v(2 * t), v(2 * t + 1), bh0, bl0);
        cache_pair<P, M>(v(2 * t + 8), v(2 * t + 9), bh1, bl1);
        mma3<M, SPLIT_P, SPLIT_KV>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
    __syncwarp();  // every lane is done with the stage the next copy fills
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // Merge the warps' parts, in warp order. Every copy has landed, so the
  // stages' bytes are free once every warp is here.
  __syncthreads();
  float* s_o = reinterpret_cast<float*>(stages);  // [WARPS][MAX_G][D]
  float* s_m = s_o + WARPS * MAX_G * D;           // [WARPS][MAX_G]
  float* s_l = s_m + WARPS * MAX_G;
  {
    float* o = s_o + warp * MAX_G * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      o[g * D + col] = acc[n][0];
      o[g * D + col + 1] = acc[n][1];
      o[(g + 8) * D + col] = acc[n][2];
      o[(g + 8) * D + col + 1] = acc[n][3];
    }
    if (t == 0) {
      s_m[warp * MAX_G + g] = m[0];
      s_m[warp * MAX_G + g + 8] = m[1];
      s_l[warp * MAX_G + g] = l[0];
      s_l[warp * MAX_G + g + 8] = l[1];
    }
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(b) * p.num_q_heads + h0;
  // The self term's score of each q row, q . k_new in fp32 through the
  // scale and the softcap, by the block that writes the output; the block
  // barrier is reached by every thread of that block.
  __shared__ float s_self[MAX_G];
  auto self_scores = [&]() {
    if (p.self_k == nullptr) return;
    const T* kn = static_cast<const T*>(p.self_k) + b * p.sk_sb + hk * p.sk_sh;
    for (int gi = warp; gi < ng; gi += WARPS) {
      const T* q = static_cast<const T*>(p.q) + b * p.q_sb + (h0 + gi) * p.q_sh;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot = fmaf(fat::to_float(q[d]), fat::to_float(kn[d]), dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(fat::FULL_MASK, dot, off);
      float x = dot * p.scale2;
      if (p.softcap2 > 0.f) x = p.softcap2 * tanhf(x / p.softcap2);
      if (lane == 0) s_self[gi] = x;
    }
    __syncthreads();
  };
  // Writes element d of q row gi from its merged (max, sum of p, sum of p
  // v), the self term (score s_self, value v_new, weight 1 at its own max)
  // merged in first.
  auto finish = [&](int gi, int d, float mx, float sum_l, float sum_o) {
    if (p.self_k != nullptr) {
      const float sc = s_self[gi], m2 = fmaxf(mx, sc);
      const float a = exp2f(mx - m2), w = exp2f(sc - m2);
      const T* vn = static_cast<const T*>(p.self_v) + b * p.sv_sb + hk * p.sv_sh;
      sum_l = fmaf(sum_l, a, w);
      sum_o = fmaf(sum_o, a, w * fat::to_float(vn[d]));
      mx = m2;
    }
    static_cast<T*>(p.o)[(row0 + gi) * D + d] = fat::from_float<T>(sum_l == 0.f ? 0.f : sum_o / sum_l);
    if (p.lse != nullptr && d == 0) p.lse[row0 + gi] = sum_l == 0.f ? -CUDART_INF_F : mx + log2f(sum_l);
  };
  const int64_t hq = p.num_q_heads, parts = static_cast<int64_t>(p.batch) * p.splits * hq;
  float* ws_o = p.ws;                         // [B, splits, Hq, D]
  float* ws_m = p.splits > 1 ? p.ws + parts * D : nullptr;  // [B, splits, Hq]
  float* ws_l = p.splits > 1 ? ws_m + parts : nullptr;
  if (p.splits == 1) self_scores();
  for (int i = threadIdx.x; i < ng * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    float mx = fat::M_FLOOR;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * MAX_G + gi]);
    float sum_l = 0.f, sum_o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(s_m[w * MAX_G + gi] - mx);
      sum_l = fmaf(s_l[w * MAX_G + gi], wt, sum_l);
      sum_o = fmaf(s_o[(w * MAX_G + gi) * D + d], wt, sum_o);
    }
    if (p.splits == 1) {
      finish(gi, d, mx, sum_l, sum_o);
    } else {
      const int64_t part = (static_cast<int64_t>(b) * p.splits + split) * hq + h0 + gi;
      ws_o[part * D + d] = sum_o;
      if (d == 0) {
        ws_m[part] = mx;
        ws_l[part] = sum_l;
      }
    }
  }
  if (p.splits == 1) return;

  // The last block of (b, hk, chunk) to finish merges the splits in order.
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = p.tickets + (static_cast<int64_t>(b) * gridDim.x + hk) * p.chunks + chunk;
    s_last = atomicAdd(ticket, 1) == p.splits - 1;
    if (s_last) *ticket = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  self_scores();
  for (int i = threadIdx.x; i < ng * D; i += THREADS) {
    const int gi = i / D, d = i % D;
    const int64_t part0 = static_cast<int64_t>(b) * p.splits * hq + h0 + gi;
    float mx = fat::M_FLOOR;
    for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, __ldcg(ws_m + part0 + s * hq));
    float sum_l = 0.f, sum_o = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float ls = __ldcg(ws_l + part0 + s * hq);
      if (ls == 0.f) continue;  // an empty part, whose O was never summed
      const float wt = exp2f(__ldcg(ws_m + part0 + s * hq) - mx);
      sum_l = fmaf(ls, wt, sum_l);
      sum_o = fmaf(__ldcg(ws_o + (part0 + s * hq) * D + d), wt, sum_o);
    }
    finish(gi, d, mx, sum_l, sum_o);
  }
}

// A TMA map over a cache's rows for Plan<P, D>: dims (D, rows, heads,
// outer: batch rows or pages) at the given element strides, boxes of one
// column chunk by 16 rows, swizzled over the chunk's bytes.
template <typename P, int D>
bool make_row_map(CUtensorMap* map, const void* base, int64_t rows, int64_t heads, int64_t outer, int64_t sr,
                  int64_t sh, int64_t so) {
  using Pl = Plan<P, D>;
  const fat::sm90::EncodeTiled encode = fat::sm90::encode_tiled();
  if (encode == nullptr) return false;
  constexpr int64_t es = sizeof(P);
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(outer)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sr * es), static_cast<cuuint64_t>(sh * es),
                           static_cast<cuuint64_t>(so * es)};
  // A dimension of extent 1 is never stepped over: give it the stride a
  // contiguous layout would have, whatever the view reports.
  if (rows == 1) strides[0] = Pl::ROW;
  if (heads == 1) strides[1] = strides[0] * rows;
  if (outer == 1) strides[2] = strides[1] * heads;
  cuuint32_t box[4] = {static_cast<cuuint32_t>(Pl::CW), 16, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = es == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                             : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  const CUtensorMapSwizzle swizzle = Pl::CWB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Pl::CWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, type, 4, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool PAGED>
struct DecodeLaunch {
  DecodeParams p;
  int64_t num_kv_heads;
  cudaStream_t stream;

  template <typename T, typename P, int D, bool MASKED>
  cudaError_t run(const DecodeParams& params) const {
    constexpr int bytes = Plan<P, D>::BYTES;
    auto kernel = decode_kernel<T, P, D, PAGED, MASKED>;
    const cudaError_t err = fat::reserve_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(num_kv_heads), static_cast<unsigned>(params.batch),
                    static_cast<unsigned>(params.chunks * params.splits));
    kernel<<<grid, THREADS, bytes, stream>>>(params);
    return cudaGetLastError();
  }

  template <typename T, typename P, int D>
  cudaError_t launch() const {
    if (fat::is_payload<P> && (p.ks == nullptr || p.vs == nullptr)) return cudaErrorInvalidValue;
    DecodeParams q = p;
    const int64_t rows = PAGED ? p.page_size : p.max_seq, outer = PAGED ? p.num_pages : p.batch;
    if (!make_row_map<P, D>(&q.tm_k, p.k, rows, num_kv_heads, outer, p.k_sr, p.k_sh, p.k_sb) ||
        !make_row_map<P, D>(&q.tm_v, p.v, rows, num_kv_heads, outer, p.v_sr, p.v_sh, p.v_sb))
      return cudaErrorInvalidValue;
    if (p.window > 0 || p.ring > 0 || p.sinks > 0 || p.softcap2 > 0.f) return run<T, P, D, true>(q);
    return run<T, P, D, false>(q);
  }
};

// The C entries' shape array: what a decode step passes unchanged from call
// to call, so that the wrappers (ops/decode.py, ops/paged.py) build it once
// and pass it by pointer. Strides in elements; the paged fields are 0 for K6.
enum Shape : int {
  kBatch, kQHeads, kKvHeads, kRows, kHeadDim, kQsb, kQsh, kWindow, kRing, kSinks, kSplits, kDtype, kPayload,
  kKsb, kKsh, kKsr, kVsb, kVsh, kVsr, kKSsb, kKSsh, kKSsr, kVSsb, kVSsh, kVSsr,  // K, V, K's scales, V's scales
  kPages, kPageSize, kPagesPerSlot,
  kSelfKsb, kSelfKsh, kSelfVsb, kSelfVsh,  // K7's self term: the new rows' batch and head strides
  kShapeLen
};

DecodeParams make_params(const void* q, const void* k, const void* v, const float* ks, const float* vs, void* o,
                         float* lse, const int32_t* lengths, float* ws, int32_t* tickets, const int64_t* shape,
                         float scale2, float softcap2) {
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.o = o;
  p.lse = lse;
  p.ws = ws;
  p.tickets = tickets;
  p.lengths = lengths;
  p.q_sb = shape[kQsb];
  p.q_sh = shape[kQsh];
  p.k_sb = shape[kKsb];
  p.k_sh = shape[kKsh];
  p.k_sr = shape[kKsr];
  p.v_sb = shape[kVsb];
  p.v_sh = shape[kVsh];
  p.v_sr = shape[kVsr];
  p.ks_sb = shape[kKSsb];
  p.ks_sh = shape[kKSsh];
  p.ks_sr = shape[kKSsr];
  p.vs_sb = shape[kVSsb];
  p.vs_sh = shape[kVSsh];
  p.vs_sr = shape[kVSsr];
  p.batch = static_cast<int>(shape[kBatch]);
  p.num_q_heads = static_cast<int>(shape[kQHeads]);
  p.group = static_cast<int>(shape[kQHeads] / shape[kKvHeads]);
  p.chunks = (p.group + MAX_G - 1) / MAX_G;
  p.splits = static_cast<int>(shape[kSplits]);
  p.max_seq = static_cast<int>(shape[kRows]);
  p.scale2 = scale2;
  p.window = static_cast<int>(shape[kWindow]);
  p.sinks = static_cast<int>(shape[kSinks]);
  p.softcap2 = softcap2;
  p.sk_sb = shape[kSelfKsb];
  p.sk_sh = shape[kSelfKsh];
  p.sv_sb = shape[kSelfVsb];
  p.sv_sh = shape[kSelfVsh];
  return p;
}

bool valid_params(const DecodeParams& p) {
  if (p.splits < 1 || (p.splits > 1 && (p.ws == nullptr || p.tickets == nullptr))) return false;
  if (p.window < 0 || p.sinks < 0 || p.ring < 0) return false;
  if (p.ring == 0) return p.sinks == 0 || p.window > 0;
  // A ring holds the whole window in its ring region.
  return p.window > 0 && p.ring % 128 == 0 && p.sinks_pad < p.ring && p.window <= p.ring - p.sinks_pad;
}

}  // namespace

// shape: the Shape array above. Strides of K and V (batch or page, head,
// row) and of their scales (read only when quantized). K's and V's base
// pointers and their strides in bytes must be multiples of 16 (TMA reads
// their rows). splits: how many blocks share a sequence's rows (ops/decode.py
// decode_kv_splits); with more than one, ws is an fp32 workspace of batch *
// splits * Hq * (D + 2) elements and tickets an int32 buffer of batch * Hkv *
// ceil(group / 16) zeros, which every launch leaves zero. dtype is q's and
// o's element type, payload the cache's (equal to dtype when not
// quantized); softcap2: 0 or cap * log2(e). Each returns a cudaError_t.

// K6. q [B, Hq, D] with unit stride on D; k and v caches [B, Hkv, rows, D]
// with unit stride on D; ks and vs their scales [B, Hkv, rows(, 1)] fp32
// when payload is a quantized type, else null; lengths [B] int32; o [B, Hq,
// D] contiguous; lse [B, Hq] fp32 or null. window: 0 or the sliding window;
// ring: 1 for a rolling cache of `rows` rows (a 128 multiple; needs the
// window); sinks: the ring's attention sinks.
extern "C" int fat_decode(const void* q, const void* k, const void* v, const float* ks, const float* vs, void* o,
                          float* lse, const int32_t* lengths, float* ws, int32_t* tickets, const int64_t* shape,
                          float scale2, float softcap2, void* stream) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, ws, tickets, shape, scale2, softcap2);
  if (shape[kRing]) {
    p.ring = p.max_seq;
    p.sinks_pad = (p.sinks + 127) / 128 * 128;
  } else if (p.sinks) {
    return static_cast<int>(cudaErrorInvalidValue);  // dense sinks live in a ring
  }
  if (!valid_params(p)) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeLaunch<false> launcher{p, shape[kKvHeads], static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(static_cast<int>(shape[kDtype]), static_cast<int>(shape[kPayload]),
                                        shape[kHeadDim], launcher));
}

// K7. q [S, Hq, D] with unit stride on D; k and v pages [pages, Hkv,
// page_size, D] with unit stride on D; ks and vs their scales [pages, Hkv,
// page_size] fp32 when quantized, else null; table [S, pages_per_slot] int32
// contiguous; lengths [S] int32 (rows past pages_per_slot * page_size, the
// shape's rows, are not read); o [S, Hq, D] contiguous; lse [S, Hq] fp32 or
// null. window: 0 or the sliding window over logical rows; sinks: logical
// rows [0, sinks) stay visible (needs the window; sinks < page_size); a
// split walks whole pages. page_size must be a multiple of 64. self_k,
// self_v: null, or the current token's K and V rows [S, Hkv, D] of q's type
// at the shape's self strides (unit stride on D), attended beside the
// pages at full precision (score through the scale and softcap; a slot of
// length 0 gets v itself); o and lse are then the merged ones.
extern "C" int fat_paged_decode(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                                void* o, float* lse, const int32_t* lengths, const int32_t* table, float* ws,
                                int32_t* tickets, const int64_t* shape, float scale2, float softcap2,
                                void* stream, const void* self_k, const void* self_v) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, ws, tickets, shape, scale2, softcap2);
  if ((self_k == nullptr) != (self_v == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  p.self_k = self_k;
  p.self_v = self_v;
  p.table = table;
  p.page_size = static_cast<int>(shape[kPageSize]);
  p.pages_per_slot = static_cast<int>(shape[kPagesPerSlot]);
  p.num_pages = static_cast<int>(shape[kPages]);
  if (!valid_params(p) || p.sinks >= p.page_size || p.page_size % RUN ||
      static_cast<int64_t>(p.page_size) * p.pages_per_slot != shape[kRows])
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeLaunch<true> launcher{p, shape[kKvHeads], static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(static_cast<int>(shape[kDtype]), static_cast<int>(shape[kPayload]),
                                        shape[kHeadDim], launcher));
}
