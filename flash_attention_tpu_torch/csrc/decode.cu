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
// One body serves both caches through an address policy (run_index below):
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
// Design:
//  * one block per (kv head, batch row, chunk of up to 8 query rows of the
//    GQA group): the group's query rows are served together, so each K/V row
//    is read once for the whole group (the TPU kernel's group-as-M-rows);
//  * only the live rows above are read, as up to two ranges of runs; the 8
//    warps take interleaved runs of 4 rows, issuing all 4 rows' loads
//    before using them (a row its mask hides reads as 0), and each warp
//    keeps its own online-softmax state (lane i holds D/32 elements of the
//    row); the warps merge through shared memory at the end. A run of 4 rows
//    never straddles a page (page_size is a multiple of 4), so the page
//    table is read once a run;
//  * a quantized payload is widened and multiplied by its row's scale as it
//    is loaded (early scaling; the TPU kernel scales the scores and p, late,
//    which is the same up to fp32 rounding), so nothing but the payload and
//    one scale a row comes from memory and no dequantized copy exists;
//  * the body is instantiated twice, masked and not: at 8 warps an SM the
//    row loop is latency-bound, and the mask's per-row work and the
//    softcap's branch made the unmasked decode ~1.4x slower when they were
//    runtime parameters of one instantiation (PERF.md);
//  * at batch 8 with 8 kv heads this is 64 blocks for 132 SMs; splitting the
//    kv range across blocks (flash-decoding, with an LSE merge) to fill the
//    card at small batch is later work.
#include "common.cuh"

#include <climits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 8;   // query rows per block; larger groups take more blocks
constexpr int UNROLL = 4;  // cache rows a warp loads before it uses them

struct DecodeParams {
  const void* q;  // [B, Hq, D], unit stride on D
  const void* k;
  const void* v;
  const float* ks;  // quantized: K's scales, one a row; else nullptr
  const float* vs;
  void* o;       // [B, Hq, D], contiguous
  float* lse;    // [B, Hq] or nullptr
  const int32_t* lengths;
  const int32_t* table;  // paged: [B, pages_per_slot]; dense: unused
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_sr;  // paged: sb is the page stride
  int64_t v_sb, v_sh, v_sr;
  int64_t ks_sb, ks_sh, ks_sr;  // the scales' strides, indexed as the payload's
  int64_t vs_sb, vs_sh, vs_sr;
  int num_q_heads, group, max_seq;
  int page_size, pages_per_slot, num_pages;
  int window;     // 0: no window
  int ring;       // 0, or the ring buffer's rows (max_seq) of a rolling cache
  int sinks;      // attention sinks: K7's logical rows [0, sinks), or the ring's sink region
  int sinks_pad;  // ring with sinks: the sink region's rows (sinks rounded up to 128)
  float scale2;
  float softcap2;  // cap * log2(e); 0: no softcap
};

__device__ __forceinline__ int pmod(int x, int m) { return ((x % m) + m) % m; }

// The masks above for one sequence of length L, set up once a block so that
// the row loop takes no modulo and no branch: row r holds position r, or,
// at or past ring0 (the ring region's first row), pos0 + j - (j > newest ?
// modulus : 0) with j = r - ring0 (the newest position sits at ring row
// `newest`, older ones wrap behind it). Visible: pos < L and (pos >= lo or
// pos < sinks), and r outside [dead_lo, dead_hi), the sink region's padding.
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

// Where the run of UNROLL rows starting at r0 (a multiple of UNROLL) of
// batch row b lies: .x is what the first stride indexes (the batch row, or
// the clamped physical page), .y the run's first row in it.
template <bool PAGED>
__device__ __forceinline__ int2 run_index(const DecodeParams& p, int b, int r0) {
  if constexpr (PAGED) {
    const int page = p.table[static_cast<int64_t>(b) * p.pages_per_slot + r0 / p.page_size];
    return make_int2(min(max(page, 0), p.num_pages - 1), r0 % p.page_size);
  } else {
    return make_int2(b, r0);
  }
}

// One warp's run of UNROLL rows [r0, r0 + UNROLL) (rows at or past r_hi,
// and with MASKED the rows the mask hides, read as 0 and score MASK_VALUE),
// folded into the online softmax of the block's query rows: m, l and acc
// are the lane's state (registers once inlined). MASKED: a window, ring,
// sinks or softcap is set. The row loop is latency-bound (8 warps an SM),
// so the unmasked instantiation keeps no mask or softcap instruction on its
// chain, and its select stays inside the reduction loop.
template <typename T, typename P, int D, bool PAGED, bool MASKED>
__device__ __forceinline__ void attend_run(const DecodeParams& p, const RowMask& mask, int b, int hk, int lane,
                                           int ng, int r0, int r_hi, const float (&qv)[MAX_G][D / 32],
                                           float (&m)[MAX_G], float (&l)[MAX_G], float (&acc)[MAX_G][D / 32]) {
  constexpr bool QUANT = fat::is_payload<P>;
  constexpr int EPL = D / 32;  // elements of a row per lane
  bool vis[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) vis[u] = r0 + u < r_hi && (!MASKED || mask.visible(r0 + u));
  const int2 at = run_index<PAGED>(p, b, r0);
  const P* k = static_cast<const P*>(p.k) + at.x * p.k_sb + hk * p.k_sh + at.y * p.k_sr + lane * EPL;
  const P* v = static_cast<const P*>(p.v) + at.x * p.v_sb + hk * p.v_sh + at.y * p.v_sr + lane * EPL;
  float kr[UNROLL][EPL], vr[UNROLL][EPL];
  float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool live = vis[u];
    if constexpr (QUANT) {
      ksc[u] = live ? p.ks[at.x * p.ks_sb + hk * p.ks_sh + (at.y + u) * p.ks_sr] : 0.f;
      vsc[u] = live ? p.vs[at.x * p.vs_sb + hk * p.vs_sh + (at.y + u) * p.vs_sr] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kr[u][e] = live ? fat::to_float(k[u * p.k_sr + e]) : 0.f;
      vr[u][e] = live ? fat::to_float(v[u * p.v_sr + e]) : 0.f;
      if constexpr (QUANT) {
        kr[u][e] *= ksc[u];
        vr[u][e] *= vsc[u];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= ng) continue;  // uniform across the block
    float s[UNROLL];
    float mx = m[g];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qv[g][e], kr[u][e], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(fat::FULL_MASK, dot, off);
      if constexpr (MASKED) {
        s[u] = dot;
      } else {
        s[u] = vis[u] ? dot : fat::MASK_VALUE;
        mx = fmaxf(mx, s[u]);
      }
    }
    if constexpr (MASKED) {
      // After all UNROLL reductions, so that they still interleave.
      if (p.softcap2 > 0.f) {  // uniform across the block
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) s[u] = p.softcap2 * tanhf(s[u] / p.softcap2);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!vis[u]) s[u] = fat::MASK_VALUE;
        mx = fmaxf(mx, s[u]);
      }
    }
    const float alpha = exp2f(m[g] - mx);
    float rs = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float pr = exp2f(s[u] - mx);
      rs += pr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, vr[u][e], acc[g][e]);
    }
    l[g] = l[g] * alpha + rs;
    m[g] = mx;
  }
}

// T: query and output type; P: the cache's element type (T, or a payload
// type whose rows are scaled); MASKED as for attend_run.
template <typename T, typename P, int D, bool PAGED, bool MASKED>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeParams p) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float s_m[WARPS][MAX_G];
  __shared__ float s_l[WARPS][MAX_G];
  __shared__ float s_acc[WARPS][MAX_G][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * MAX_G;
  const int ng = min(MAX_G, p.group - g0);
  const int length = max(p.lengths[b], 0);
  const int h0 = hk * p.group + g0;  // first q head of this block

  // The live rows: [0, a_end) then [b_start, b_end), b_start a multiple of
  // UNROLL; a run may hold rows the mask hides.
  int a_end = 0, b_start = 0, b_end = min(length, p.max_seq);
  RowMask mask{};
  if constexpr (MASKED) {
    if (p.ring == 0) {
      if (p.window > 0) b_start = max(length - p.window, 0) / UNROLL * UNROLL;
      a_end = min(p.sinks, b_start);
    } else if (p.sinks_pad == 0) {
      b_end = min(length, p.ring);
    } else {
      a_end = min(p.sinks, length);
      b_start = p.sinks_pad;
      b_end = p.sinks_pad + min(max(length - p.sinks, 0), p.ring - p.sinks_pad);
    }
    mask = row_mask(p, length);
  }

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + lane * EPL;

  float qv[MAX_G][EPL], m[MAX_G], l[MAX_G], acc[MAX_G][EPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = fat::M_FLOOR;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qv[g][e] = g < ng ? fat::to_float(q[(h0 + g) * p.q_sh + e]) * p.scale2 : 0.f;
      acc[g][e] = 0.f;
    }
  }

  for (int r0 = warp * UNROLL; r0 < a_end; r0 += WARPS * UNROLL)
    attend_run<T, P, D, PAGED, MASKED>(p, mask, b, hk, lane, ng, r0, a_end, qv, m, l, acc);
  for (int r0 = b_start + warp * UNROLL; r0 < b_end; r0 += WARPS * UNROLL)
    attend_run<T, P, D, PAGED, MASKED>(p, mask, b, hk, lane, ng, r0, b_end, qv, m, l, acc);

#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(b) * p.num_q_heads + h0;
  T* o = static_cast<T*>(p.o) + row0 * D;
  for (int i = threadIdx.x; i < ng * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = fat::M_FLOOR;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float sum_l = 0.f, sum_o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(s_m[w][g] - mx);
      sum_l = fmaf(s_l[w][g], wt, sum_l);
      sum_o = fmaf(s_acc[w][g][d], wt, sum_o);
    }
    o[i] = fat::from_float<T>(sum_l == 0.f ? 0.f : sum_o / sum_l);
    if (p.lse != nullptr && d == 0)
      p.lse[row0 + g] = sum_l == 0.f ? -CUDART_INF_F : mx + log2f(sum_l);
  }
}

template <bool PAGED>
struct DecodeLaunch {
  DecodeParams p;
  int64_t batch, num_kv_heads;
  cudaStream_t stream;

  template <typename T, typename P, int D>
  cudaError_t launch() const {
    if (fat::is_payload<P> && (p.ks == nullptr || p.vs == nullptr)) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(num_kv_heads), static_cast<unsigned>(batch),
                    (p.group + MAX_G - 1) / MAX_G);
    if (p.window > 0 || p.ring > 0 || p.sinks > 0 || p.softcap2 > 0.f)
      decode_kernel<T, P, D, PAGED, true><<<grid, THREADS, 0, stream>>>(p);
    else
      decode_kernel<T, P, D, PAGED, false><<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

DecodeParams make_params(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, void* o, float* lse, const int32_t* lengths,
                         int64_t num_q_heads, int64_t num_kv_heads, int64_t q_sb, int64_t q_sh,
                         const int64_t* kv_strides, float scale2, int32_t window, int32_t sinks,
                         float softcap2) {
  DecodeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.o = o;
  p.lse = lse;
  p.lengths = lengths;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = kv_strides[0];
  p.k_sh = kv_strides[1];
  p.k_sr = kv_strides[2];
  p.v_sb = kv_strides[3];
  p.v_sh = kv_strides[4];
  p.v_sr = kv_strides[5];
  p.ks_sb = kv_strides[6];
  p.ks_sh = kv_strides[7];
  p.ks_sr = kv_strides[8];
  p.vs_sb = kv_strides[9];
  p.vs_sh = kv_strides[10];
  p.vs_sr = kv_strides[11];
  p.num_q_heads = static_cast<int>(num_q_heads);
  p.group = static_cast<int>(num_q_heads / num_kv_heads);
  p.scale2 = scale2;
  p.window = window;
  p.sinks = sinks;
  p.softcap2 = softcap2;
  return p;
}

bool valid_masks(const DecodeParams& p) {
  if (p.window < 0 || p.sinks < 0 || p.ring < 0) return false;
  if (p.ring == 0) return p.sinks == 0 || p.window > 0;
  // A ring holds the whole window in its ring region.
  return p.window > 0 && p.ring % 128 == 0 && p.sinks_pad < p.ring && p.window <= p.ring - p.sinks_pad;
}

}  // namespace

// kv_strides, in elements: K's batch (K7: page) / head / row strides, then
// V's, then those of K's scales and V's scales (read only when quantized).

// K6. q [B, Hq, D] with unit stride on D; k and v caches [B, Hkv, max_seq, D]
// with unit stride on D; ks and vs their scales [B, Hkv, max_seq(, 1)] fp32
// when payload is a quantized type, else null; lengths [B] int32; o [B, Hq,
// D] contiguous; lse [B, Hq] fp32 or null. dtype is q's and o's element
// type, payload the cache's (equal to dtype when not quantized). window: 0
// or the sliding window; ring: 1 for a rolling cache of max_seq rows (a
// 128 multiple; needs the window); sinks: the ring's attention sinks;
// softcap2: 0 or cap * log2(e). Returns a cudaError_t.
extern "C" int fat_decode(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, void* o, float* lse, const int32_t* lengths,
                          int64_t batch, int64_t num_q_heads, int64_t num_kv_heads,
                          int64_t max_seq, int64_t head_dim, int64_t q_sb, int64_t q_sh,
                          const int64_t* kv_strides, float scale2, int32_t window, int32_t ring,
                          int32_t sinks, float softcap2, int32_t dtype, int32_t payload,
                          void* stream) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, num_q_heads, num_kv_heads, q_sb,
                               q_sh, kv_strides, scale2, window, sinks, softcap2);
  p.max_seq = static_cast<int>(max_seq);
  if (ring) {
    p.ring = p.max_seq;
    p.sinks_pad = (sinks + 127) / 128 * 128;
  } else if (sinks) {
    return static_cast<int>(cudaErrorInvalidValue);  // dense sinks live in a ring
  }
  if (!valid_masks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeLaunch<false> launcher{p, batch, num_kv_heads, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, head_dim, launcher));
}

// K7. q [S, Hq, D] with unit stride on D; k and v pages [num_pages, Hkv,
// page_size, D] with unit stride on D; ks and vs their scales [num_pages,
// Hkv, page_size] fp32 when quantized, else null; table [S, pages_per_slot]
// int32 contiguous; lengths [S] int32 (rows past pages_per_slot * page_size
// are not read); o [S, Hq, D] contiguous; lse [S, Hq] fp32 or null.
// window: 0 or the sliding window over logical rows; sinks: logical rows
// [0, sinks) stay visible (needs the window; sinks < page_size); softcap2:
// 0 or cap * log2(e). page_size must be a multiple of 4.
extern "C" int fat_paged_decode(const void* q, const void* k, const void* v, const float* ks,
                                const float* vs, void* o, float* lse, const int32_t* lengths,
                                const int32_t* table, int64_t num_slots, int64_t num_q_heads,
                                int64_t num_kv_heads, int64_t num_pages, int64_t page_size,
                                int64_t pages_per_slot, int64_t head_dim, int64_t q_sb,
                                int64_t q_sh, const int64_t* kv_strides, float scale2,
                                int32_t window, int32_t sinks, float softcap2, int32_t dtype,
                                int32_t payload, void* stream) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, num_q_heads, num_kv_heads, q_sb,
                               q_sh, kv_strides, scale2, window, sinks, softcap2);
  p.table = table;
  p.page_size = static_cast<int>(page_size);
  p.pages_per_slot = static_cast<int>(pages_per_slot);
  p.num_pages = static_cast<int>(num_pages);
  p.max_seq = static_cast<int>(page_size * pages_per_slot);
  if (!valid_masks(p) || sinks >= page_size) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeLaunch<true> launcher{p, num_slots, num_kv_heads, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, head_dim, launcher));
}
