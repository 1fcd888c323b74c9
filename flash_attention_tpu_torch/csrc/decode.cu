// K6: single-token decode attention over a dense KV cache, for Hopper.
//
// Replaces flash_attention_tpu/ops/decode.py:_decode_kernel (the bf16, fp16
// and fp32 cache path; int8/fp8 dequant, window, softcap, ring buffer, sinks
// and the LSE output come with later work). One query token per sequence
// attends to rows [0, lengths[b]) of its cache; the new token's K/V must
// already be written at lengths[b] - 1. Same numerics as K1: fp32 scores and
// accumulators, exp2 softmax with scale2 = sm_scale * log2(e), the running
// max floored at M_FLOOR, and output 0 for lengths[b] == 0.
//
// What bounds it on this card: every cache row is used once per query group,
// about 4 flops a byte, so the bytes of the cache read bound it.
//
// Design:
//  * one block per (kv head, batch row, chunk of up to 8 query rows of the
//    GQA group): the group's query rows are served together, so each K/V row
//    is read once for the whole group (the TPU kernel's group-as-M-rows);
//  * rows are read only up to lengths[b]; the 8 warps take interleaved runs
//    of 4 rows, issuing all 4 rows' loads before using them, and each warp
//    keeps its own online-softmax state (lane i holds D/32 elements of the
//    row); the warps merge through shared memory at the end;
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
  void* o;  // [B, Hq, D], contiguous
  const int32_t* lengths;
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sh, k_sr;
  int64_t v_sb, v_sh, v_sr;
  int num_q_heads, group, max_seq;
  float scale2;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(const DecodeParams p) {
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
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + lane * EPL;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + lane * EPL;

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
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = r < length ? fat::to_float(k[r * p.k_sr + e]) : 0.f;
        vr[u][e] = r < length ? fat::to_float(v[r * p.v_sr + e]) : 0.f;
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

  T* o = static_cast<T*>(p.o) + (static_cast<int64_t>(b) * p.num_q_heads + h0) * D;
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
  }
}

struct DecodeLaunch {
  DecodeParams p;
  int64_t batch, num_kv_heads;
  cudaStream_t stream;

  template <typename T, int D>
  cudaError_t launch() const {
    const dim3 grid(static_cast<unsigned>(num_kv_heads), static_cast<unsigned>(batch),
                    (p.group + MAX_G - 1) / MAX_G);
    decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// q [B, Hq, D] with unit stride on D; k and v caches [B, Hkv, max_seq, D]
// with unit stride on D and the given batch / head / row strides (in
// elements); lengths [B] int32; o [B, Hq, D] contiguous. Returns a
// cudaError_t.
extern "C" int fat_decode(const void* q, const void* k, const void* v, void* o,
                          const int32_t* lengths, int64_t batch, int64_t num_q_heads,
                          int64_t num_kv_heads, int64_t max_seq, int64_t head_dim, int64_t q_sb,
                          int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_sr, int64_t v_sb,
                          int64_t v_sh, int64_t v_sr, float scale2, int32_t dtype, void* stream) {
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lengths = lengths;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sr = k_sr;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sr = v_sr;
  p.num_q_heads = static_cast<int>(num_q_heads);
  p.group = static_cast<int>(num_q_heads / num_kv_heads);
  p.max_seq = static_cast<int>(max_seq);
  p.scale2 = scale2;
  const DecodeLaunch launcher{p, batch, num_kv_heads, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, head_dim, launcher));
}
