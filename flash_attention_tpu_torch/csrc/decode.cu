// K6 and K7: single-token decode attention over a dense or a paged KV cache,
// bf16 / fp16 / fp32 or quantized (int8, fp8 e4m3, fp8 e5m2 with one fp32
// scale per row and head), for Hopper.
//
// Replaces the JAX package's ops/decode.py:_decode_kernel (K6, and its
// dequant branch) and ops/paged.py:_paged_decode_kernel_hb (:980) and
// _paged_decode_kernel (:1104) (K7, decode through a page table, output and
// base-2 LSE, and their dequant branches). Window, softcap, ring buffer and
// sinks come with later work. One query token per sequence attends to rows
// [0, lengths[b]) of its cache. Same numerics as K1: fp32 scores and
// accumulators, exp2 softmax with scale2 = sm_scale * log2(e), the running
// max floored at M_FLOOR, output 0 and LSE -inf for lengths[b] == 0.
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
//  * rows are read only up to lengths[b]; the 8 warps take interleaved runs
//    of 4 rows, issuing all 4 rows' loads before using them, and each warp
//    keeps its own online-softmax state (lane i holds D/32 elements of the
//    row); the warps merge through shared memory at the end. A run of 4 rows
//    never straddles a page (page_size is a multiple of 4), so the page
//    table is read once a run;
//  * a quantized payload is widened and multiplied by its row's scale as it
//    is loaded (early scaling; the TPU kernel scales the scores and p, late,
//    which is the same up to fp32 rounding), so nothing but the payload and
//    one scale a row comes from memory and no dequantized copy exists;
//  * at batch 8 with 8 kv heads this is 64 blocks for 132 SMs; splitting the
//    kv range across blocks (flash-decoding, with an LSE merge) to fill the
//    card at small batch is later work.
#include "common.cuh"

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
  float scale2;
};

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

// T: query and output type; P: the cache's element type (T, or a payload
// type whose rows are scaled).
template <typename T, typename P, int D, bool PAGED>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeParams p) {
  constexpr bool QUANT = fat::is_payload<P>;
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float s_m[WARPS][MAX_G];
  __shared__ float s_l[WARPS][MAX_G];
  __shared__ float s_acc[WARPS][MAX_G][D];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * MAX_G;
  const int ng = min(MAX_G, p.group - g0);
  const int length = min(max(p.lengths[b], 0), p.max_seq);
  const int h0 = hk * p.group + g0;  // first q head of this block

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

  for (int r0 = warp * UNROLL; r0 < length; r0 += WARPS * UNROLL) {
    const int2 at = run_index<PAGED>(p, b, r0);
    const P* k = static_cast<const P*>(p.k) + at.x * p.k_sb + hk * p.k_sh + at.y * p.k_sr + lane * EPL;
    const P* v = static_cast<const P*>(p.v) + at.x * p.v_sb + hk * p.v_sh + at.y * p.v_sr + lane * EPL;
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool live = r0 + u < length;
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
        s[u] = r0 + u < length ? dot : fat::MASK_VALUE;
        mx = fmaxf(mx, s[u]);
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
    decode_kernel<T, P, D, PAGED><<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

DecodeParams make_params(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, void* o, float* lse, const int32_t* lengths,
                         int64_t num_q_heads, int64_t num_kv_heads, int64_t q_sb, int64_t q_sh,
                         const int64_t* kv_strides, float scale2) {
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
  return p;
}

}  // namespace

// kv_strides, in elements: K's batch (K7: page) / head / row strides, then
// V's, then those of K's scales and V's scales (read only when quantized).

// K6. q [B, Hq, D] with unit stride on D; k and v caches [B, Hkv, max_seq, D]
// with unit stride on D; ks and vs their scales [B, Hkv, max_seq(, 1)] fp32
// when payload is a quantized type, else null; lengths [B] int32; o [B, Hq,
// D] contiguous; lse [B, Hq] fp32 or null. dtype is q's and o's element
// type, payload the cache's (equal to dtype when not quantized). Returns a
// cudaError_t.
extern "C" int fat_decode(const void* q, const void* k, const void* v, const float* ks,
                          const float* vs, void* o, float* lse, const int32_t* lengths,
                          int64_t batch, int64_t num_q_heads, int64_t num_kv_heads,
                          int64_t max_seq, int64_t head_dim, int64_t q_sb, int64_t q_sh,
                          const int64_t* kv_strides, float scale2, int32_t dtype, int32_t payload,
                          void* stream) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, num_q_heads, num_kv_heads, q_sb,
                               q_sh, kv_strides, scale2);
  p.max_seq = static_cast<int>(max_seq);
  const DecodeLaunch<false> launcher{p, batch, num_kv_heads, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, head_dim, launcher));
}

// K7. q [S, Hq, D] with unit stride on D; k and v pages [num_pages, Hkv,
// page_size, D] with unit stride on D; ks and vs their scales [num_pages,
// Hkv, page_size] fp32 when quantized, else null; table [S, pages_per_slot]
// int32 contiguous; lengths [S] int32 (rows past pages_per_slot * page_size
// are not read); o [S, Hq, D] contiguous; lse [S, Hq] fp32 or null.
// page_size must be a multiple of 4.
extern "C" int fat_paged_decode(const void* q, const void* k, const void* v, const float* ks,
                                const float* vs, void* o, float* lse, const int32_t* lengths,
                                const int32_t* table, int64_t num_slots, int64_t num_q_heads,
                                int64_t num_kv_heads, int64_t num_pages, int64_t page_size,
                                int64_t pages_per_slot, int64_t head_dim, int64_t q_sb,
                                int64_t q_sh, const int64_t* kv_strides, float scale2,
                                int32_t dtype, int32_t payload, void* stream) {
  DecodeParams p = make_params(q, k, v, ks, vs, o, lse, lengths, num_q_heads, num_kv_heads, q_sb,
                               q_sh, kv_strides, scale2);
  p.table = table;
  p.page_size = static_cast<int>(page_size);
  p.pages_per_slot = static_cast<int>(pages_per_slot);
  p.num_pages = static_cast<int>(num_pages);
  p.max_seq = static_cast<int>(page_size * pages_per_slot);
  const DecodeLaunch<true> launcher{p, num_slots, num_kv_heads, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, head_dim, launcher));
}
