// F1-F3: the decode step's elementwise glue as hand-written kernels for
// Hopper, in bf16, fp16 and fp32.
//
// These replace no Pallas kernel: each computes what one of the JAX
// package's XLA fusions computes inside the jitted decode block (its
// serving/decode_loop.py:160-216), which eager PyTorch
// issued as 5-15 small launches each:
//
//  * F1 add_rms_norm_kernel — the residual add and the RMSNorm that follows
//    it (the JAX package's models/transformer.py:86-89 with the residuals
//    of :211-218): x_new = x + delta rounded to x's type, then h = x_new *
//    rsqrt(mean(x_new^2) + eps) * weight in fp32, rounded to x's type. One
//    block a row: a pass that writes x_new and sums its squares, a block
//    reduction, a pass that writes h; a row of up to 4096 stays in
//    registers between the passes (8 elements a thread, all loads of a pass
//    issued before its stores).
//  * F2 rope_kernel — RoPE on q [B, Hq, T, D] and k [B, Hkv, T, D] at
//    per-(b, t) positions (the JAX package's models/rope.py:19-45): angle
//    = float(position) * freq (the caller's table), accurate cosf / sinf,
//    the even / odd pairs rotated in fp32. With a dense KV cache (T == 1)
//    the same launch writes the rotated k and the new v into each slot's
//    row by write_cache's rules (the JAX package's models/attention.py:146;
//    the port's models/attention.py:192-240): dropped at capacity with the
//    length held at the cache's rows, ring row p % rows on a rolling cache,
//    the sink mapping of ops/common.ring_rows with sinks, and on a quantized cache
//    the payload and one fp32 scale a row by common.cuh's quantize (the
//    quantizer of K9q/K10q, bit-equal to ops/quant.py's quantize_values).
//    It also writes the new lengths. A token's blocks: one for each 4 q
//    heads (a pair a thread at head_dim 128), and one more for k and v,
//    each head row one warp (the quantizer's absmax is a warp reduction).
//    Its chunk form, rope_chunk_kernel (F2c), takes a prefill chunk: q and
//    k rotated at start + t and the chunk's K / V rows written into the
//    slot's rows of a dense cache, a rolling ring (with sinks) or a page
//    pool through the slot's table row, quantized or not, with the slot's
//    new length, in one launch a layer (its design: below).
//  * F3 swiglu_act_kernel — silu(gate) * up in fp32, rounded to gate's type
//    (the JAX package's models/transformer.py:103). Elementwise.
//
// Every product and sum that eager PyTorch rounds on its own is written
// with the _rn intrinsics, which nvcc never contracts into a fused
// multiply-add, so F2's rotated rows and cache rows and F3's output are the
// plain versions' (flash_attention_tpu_torch/ops/fused.py) bits on the
// card; F1's sum runs in another order.
//
// What bounds them on this card: bytes, and at decode shapes the launch.
// At 8 slots F1 moves 8 x 4096 x 2 x (2 read + 2 written) bytes, ~0.2 MB,
// F2 ~0.1 MB and F3 at MLP 14336 ~0.7 MB: 0.03-0.2 us at 3.35 TB/s, under
// a launch's few microseconds, so the design is one launch for what eager
// PyTorch issued as many (no intermediate reaches device memory), and
// nothing allocated or synchronised, so each runs inside the decode
// programs' CUDA graphs.
#include "common.cuh"

namespace {

constexpr int NORM_THREADS = 512;
constexpr int NORM_PER = 8;  // elements a thread holds: rows up to 4096 stay in registers
constexpr int ROPE_THREADS = 256;
constexpr int ROPE_QHEADS = 4;  // q heads a block
constexpr int ACT_THREADS = 256;
constexpr int MAX_HALF = 128;  // head_dim / 2 at most

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(fat::FULL_MASK, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, off));
  return x;
}

// ---- F1 ----

struct NormParams {
  const void* x;      // [rows, width], contiguous
  const void* delta;  // [rows, width] or nullptr
  const void* weight;  // [width]
  void* x_new;        // [rows, width], written when delta is given
  void* h;            // [rows, width]
  int64_t width;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(NORM_THREADS) add_rms_norm_kernel(const NormParams p) {
  __shared__ float part[NORM_THREADS / 32];
  constexpr int64_t SPAN = NORM_THREADS * NORM_PER;  // elements a pass holds
  const int64_t base = static_cast<int64_t>(blockIdx.x) * p.width;
  const T* __restrict__ x = static_cast<const T*>(p.x) + base;
  const T* __restrict__ delta = p.delta == nullptr ? nullptr : static_cast<const T*>(p.delta) + base;
  T* __restrict__ x_new = static_cast<T*>(p.x_new) + base;
  const bool held = p.width <= SPAN;  // the row stays in registers between the passes
  float vals[NORM_PER];
  float ss = 0.f;
  for (int64_t i0 = 0; i0 < p.width; i0 += SPAN) {
    float a[NORM_PER], d[NORM_PER];
#pragma unroll
    for (int j = 0; j < NORM_PER; ++j) {
      const int64_t i = i0 + j * NORM_THREADS + threadIdx.x;
      a[j] = i < p.width ? fat::to_float(x[i]) : 0.f;
      d[j] = delta != nullptr && i < p.width ? fat::to_float(delta[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NORM_PER; ++j) {
      const int64_t i = i0 + j * NORM_THREADS + threadIdx.x;
      float v = a[j];
      if (delta != nullptr && i < p.width) {
        const T sum = fat::from_float<T>(__fadd_rn(v, d[j]));
        x_new[i] = sum;
        v = fat::to_float(sum);
      }
      vals[j] = v;
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NORM_THREADS / 32; ++w) total += part[w];
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(p.width)), p.eps));
  const T* __restrict__ w = static_cast<const T*>(p.weight);
  T* __restrict__ h = static_cast<T*>(p.h) + base;
  for (int64_t i0 = 0; i0 < p.width; i0 += SPAN) {
    float wv[NORM_PER];
#pragma unroll
    for (int j = 0; j < NORM_PER; ++j) {
      const int64_t i = i0 + j * NORM_THREADS + threadIdx.x;
      wv[j] = i < p.width ? fat::to_float(w[i]) : 0.f;
      // A wider row is read back: each thread only the x_new elements it wrote.
      if (!held && i < p.width) vals[j] = fat::to_float(delta != nullptr ? x_new[i] : x[i]);
    }
#pragma unroll
    for (int j = 0; j < NORM_PER; ++j) {
      const int64_t i = i0 + j * NORM_THREADS + threadIdx.x;
      if (i < p.width) h[i] = fat::from_float<T>(__fmul_rn(__fmul_rn(vals[j], rstd), wv[j]));
    }
  }
}

// ---- F3 ----

template <typename T>
__global__ void __launch_bounds__(ACT_THREADS) swiglu_act_kernel(const T* gate, const T* up, T* out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(ACT_THREADS) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * ACT_THREADS) {
    const float g = fat::to_float(gate[i]);
    const float silu = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));  // torch's CUDA silu
    out[i] = fat::from_float<T>(__fmul_rn(silu, fat::to_float(up[i])));
  }
}

// ---- F2 ----

// The C entry's shape array (ops/fused.py passes it by pointer, built once
// per shape). Strides in elements; a position stride of 0 broadcasts.
enum RopeShape : int {
  kBatch, kT, kQHeads, kKvHeads, kHeadDim,
  kQsb, kQsh, kQst, kKsb, kKsh, kKst, kVsb, kVsh, kVst, kPsb, kPst,
  kCsb, kCsh, kCsr, kSsb, kSsh, kSsr,  // the cache's K / V rows, and their scales
  kRows, kRing, kSinks, kRopeShapeLen
};

struct RopeParams {
  const void* q;
  const void* k;
  const void* v;   // the write's new V rows, or nullptr
  void* q_out;     // [B, Hq, T, D], contiguous
  void* k_out;     // [B, Hkv, T, D], contiguous
  const float* freqs;  // [D / 2]
  const int32_t* pos;
  void* k_cache;   // nullptr: no write
  void* v_cache;
  float* k_scales;  // a quantized cache's, else nullptr
  float* v_scales;
  int32_t* new_lengths;  // [B]
  int64_t q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, p_sb, p_st;
  int64_t c_sb, c_sh, c_sr, s_sb, s_sh, s_sr;
  int t_len, hq, hkv, half, rows, ring, sinks, sinks_pad;
};

__device__ __forceinline__ int pmod(int x, int m) { return ((x % m) + m) % m; }

// Pair i of the row at x rotated by (c, s): (x1 c - x2 s, x1 s + x2 c),
// each product and sum rounded as eager PyTorch rounds it.
template <typename T>
__device__ __forceinline__ float2 rotate(const T* x, int i, float c, float s) {
  const float x1 = fat::to_float(x[2 * i]), x2 = fat::to_float(x[2 * i + 1]);
  return make_float2(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)), __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

// One warp's store of a row it holds (lane's pairs i = lane + 32 j) into a
// cache row: as it is, or quantized with the row's scale beside it.
template <typename T, typename P>
__device__ __forceinline__ void store_row(const float (&vals)[2 * (MAX_HALF / 32)], int half, int lane, P* dst,
                                          float* scale) {
  if constexpr (fat::is_payload<P>) {
    float absmax = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_HALF / 32; ++j)
      if (lane + 32 * j < half) absmax = fmaxf(absmax, fmaxf(fabsf(vals[2 * j]), fabsf(vals[2 * j + 1])));
    const float sc = fat::row_scale(warp_max(absmax), fat::payload_qmax<P>);
#pragma unroll
    for (int j = 0; j < MAX_HALF / 32; ++j) {
      const int i = lane + 32 * j;
      if (i < half) {
        dst[2 * i] = fat::quantize<P>(vals[2 * j], sc);
        dst[2 * i + 1] = fat::quantize<P>(vals[2 * j + 1], sc);
      }
    }
    if (lane == 0) *scale = sc;
  } else {
#pragma unroll
    for (int j = 0; j < MAX_HALF / 32; ++j) {
      const int i = lane + 32 * j;
      if (i < half) {
        dst[2 * i] = fat::from_float<P>(vals[2 * j]);
        dst[2 * i + 1] = fat::from_float<P>(vals[2 * j + 1]);
      }
    }
  }
}

// T: q / k / v type; P: the cache's element type (T, or a payload type).
// Block (token, y): q heads [4 y, 4 y + 4) for y below the last, k (and
// the write) for the last.
template <typename T, typename P>
__global__ void __launch_bounds__(ROPE_THREADS) rope_kernel(const RopeParams p) {
  __shared__ float s_cos[MAX_HALF], s_sin[MAX_HALF];
  const int b = blockIdx.x / p.t_len, t = blockIdx.x % p.t_len;
  const bool kv_block = blockIdx.y == gridDim.y - 1;
  const int position = p.pos[b * p.p_sb + t * p.p_st];
  for (int i = threadIdx.x; i < p.half; i += ROPE_THREADS) {
    const float angle = __fmul_rn(static_cast<float>(position), p.freqs[i]);
    s_cos[i] = cosf(angle);
    s_sin[i] = sinf(angle);
  }
  __syncthreads();
  const int d = 2 * p.half;
  if (!kv_block) {
    const int h0 = blockIdx.y * ROPE_QHEADS, heads = min(ROPE_QHEADS, p.hq - h0);
    for (int idx = threadIdx.x; idx < heads * p.half; idx += ROPE_THREADS) {
      const int h = h0 + idx / p.half, i = idx % p.half;
      const float2 r = rotate(static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + t * p.q_st, i, s_cos[i],
                              s_sin[i]);
      T* out = static_cast<T*>(p.q_out) + ((static_cast<int64_t>(b) * p.hq + h) * p.t_len + t) * d + 2 * i;
      out[0] = fat::from_float<T>(r.x);
      out[1] = fat::from_float<T>(r.y);
    }
    return;
  }

  // The write's row (T == 1): write_cache's rules.
  const bool write = p.k_cache != nullptr;
  int row = 0;
  bool keep = false;
  if (write) {
    if (p.ring) {
      keep = true;
      const int ring_row = p.sinks_pad + pmod(position - p.sinks, p.rows - p.sinks_pad);
      row = p.sinks == 0 ? pmod(position, p.rows) : (position < p.sinks ? position : ring_row);
    } else {
      keep = position < p.rows;
      row = min(position, p.rows - 1);
    }
    if (threadIdx.x == 0) p.new_lengths[b] = p.ring ? position + 1 : min(position + 1, p.rows);
  }

  // k and v head rows, one warp each: k rotated into k_out (and the cache),
  // v into the cache.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int units = write ? 2 * p.hkv : p.hkv;
  for (int unit = warp; unit < units; unit += ROPE_THREADS / 32) {
    const bool is_v = unit >= p.hkv;
    const int h = unit % p.hkv;
    float vals[2 * (MAX_HALF / 32)];
#pragma unroll
    for (int j = 0; j < MAX_HALF / 32; ++j) {
      const int i = lane + 32 * j;
      vals[2 * j] = vals[2 * j + 1] = 0.f;
      if (i >= p.half) continue;
      if (is_v) {
        const T* x = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + t * p.v_st;
        vals[2 * j] = fat::to_float(x[2 * i]);
        vals[2 * j + 1] = fat::to_float(x[2 * i + 1]);
      } else {
        const float2 r = rotate(static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + t * p.k_st, i, s_cos[i],
                                s_sin[i]);
        T* out = static_cast<T*>(p.k_out) + ((static_cast<int64_t>(b) * p.hkv + h) * p.t_len + t) * d + 2 * i;
        const T r0 = fat::from_float<T>(r.x), r1 = fat::from_float<T>(r.y);
        out[0] = r0;
        out[1] = r1;
        // The cache stores k as the model holds it, rounded to T.
        vals[2 * j] = fat::to_float(r0);
        vals[2 * j + 1] = fat::to_float(r1);
      }
    }
    if (keep) {  // uniform across the warp
      const int64_t at = b * p.c_sb + h * p.c_sh + row * p.c_sr;
      float* scale = nullptr;
      if constexpr (fat::is_payload<P>)
        scale = (is_v ? p.v_scales : p.k_scales) + b * p.s_sb + h * p.s_sh + row * p.s_sr;
      store_row<T, P>(vals, p.half, lane, static_cast<P*>(is_v ? p.v_cache : p.k_cache) + at, scale);
    }
  }
}

template <typename T, typename P>
cudaError_t launch_rope(const RopeParams& p, int tokens, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(tokens), static_cast<unsigned>((p.hq + ROPE_QHEADS - 1) / ROPE_QHEADS + 1));
  rope_kernel<T, P><<<grid, ROPE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---- F2, the chunk form ----
//
// A prefill chunk's q [1, Hq, T, D] and k [1, Hkv, T, D] rotated at
// positions start + t, and k (rotated, rounded to T) and v [1, Hkv, T, D]
// written into the slot's rows of the cache, with the slot's new length,
// in one launch: what the JAX package's jitted chunk step fuses
// (models/attention.py:363-433 over the dense cache, ops/paged.py:488-546
// over pages). The rotation is rope_kernel's arithmetic (the same angles,
// cosf / sinf and _rn products), the quantizer store_row's (common.cuh's
// row_scale and quantize), so q, the cache rows and their scales are the
// plain version's bits.
//
// At phase 5's chunk (T 256, 32 q / 8 kv heads, D 128, bf16) the launch
// moves ~6.3 MB, ~1.9 us at 3.35 TB/s: bytes bound it. So the design keeps
// every access 16 bytes wide and many of them in flight: a block takes
// CHUNK_TOKENS tokens x CHUNK_UNITS head rows (q heads, then k heads, then v
// heads) and computes its tokens' cos / sin once into shared memory; a head
// row is D / VEC threads, each holding 16 bytes of it, and every thread
// issues all its loads before its first store. A quantized row's absmax is
// a reduction over the row's threads (shuffles within an aligned group of
// lanes, so a warp's rows are reduced at once).

constexpr int CHUNK_THREADS = 256;
constexpr int CHUNK_TOKENS = 8;  // tokens a block
constexpr int CHUNK_UNITS = 8;   // head rows of each token a block

enum ChunkShape : int {
  kCT, kCQHeads, kCKvHeads, kCHeadDim,
  kCQsh, kCQst, kCKsh, kCKst, kCVsh, kCVst,  // q / k / v strides (head, token), in elements
  kCCsb, kCCsh, kCCsr, kCSsb, kCSsh, kCSsr,  // the cache's K / V and scale strides (slot or page, head, row)
  kCRows, kCRing, kCSinks, kCStart, kCNewLen, kCSlots, kCTableStride, kCNumPages, kChunkShapeLen
};

struct ChunkParams {
  const void* q;
  const void* k;
  const void* v;
  void* q_out;  // [1, Hq, T, D], contiguous
  const float* freqs;
  const int32_t* slot;     // [1], the slot (or the page table's row)
  const int32_t* lengths;  // [slots]
  int32_t* new_lengths;    // [slots]
  void* k_cache;
  void* v_cache;
  float* k_scales;       // a quantized cache's, else nullptr
  float* v_scales;
  const int32_t* table;  // a paged cache's page table, else nullptr (a dense cache)
  int64_t q_sh, q_st, k_sh, k_st, v_sh, v_st;
  int64_t c_sb, c_sh, c_sr, s_sb, s_sh, s_sr, table_stride;
  int t_len, hq, hkv, rows, ring, sinks, sinks_pad, start, new_len, slots, num_pages;
};

// The (K / V element, scale) offsets of head h's row for position pos: a
// dense cache's row pos, a ring's ring_rows(pos), or a page table's page
// (its physical id clamped as ops/paged._clamped clamps it).
__device__ __forceinline__ int2 chunk_row(const ChunkParams& p, int slot, int pos) {
  if (p.table != nullptr) {
    const int phys = min(max(p.table[slot * p.table_stride + pos / p.rows], 0), p.num_pages - 1);
    return make_int2(phys, pos % p.rows);
  }
  if (!p.ring) return make_int2(slot, pos);
  if (p.sinks == 0) return make_int2(slot, pos % p.rows);
  return make_int2(slot, pos < p.sinks ? pos : p.sinks_pad + (pos - p.sinks) % (p.rows - p.sinks_pad));
}

template <int N>
__device__ __forceinline__ void store_bytes(void* dst, const void* src) {
  if constexpr (N == 16) *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  else if constexpr (N == 8) *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  else *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
}

// T: q / k / v type; P: the cache's element type (T, or a payload type).
// Block (token tile x, unit group y).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(CHUNK_THREADS) rope_chunk_kernel(const ChunkParams p) {
  constexpr int VEC = 16 / sizeof(T);         // elements of a 16-byte access
  constexpr int LANES = D / VEC;              // threads a head row
  constexpr int RPP = CHUNK_THREADS / LANES;  // head rows a pass
  constexpr int PASSES = CHUNK_TOKENS * CHUNK_UNITS / RPP;
  static_assert(32 % LANES == 0 && (32 / LANES) <= CHUNK_TOKENS && PASSES * RPP == CHUNK_TOKENS * CHUNK_UNITS,
                "a warp's rows must be of one unit");
  __shared__ float s_cos[CHUNK_TOKENS][D / 2], s_sin[CHUNK_TOKENS][D / 2];
  const int t0 = blockIdx.x * CHUNK_TOKENS, u0 = blockIdx.y * CHUNK_UNITS;
  const int units = p.hq + 2 * p.hkv;
  const int slot = *p.slot;
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < p.slots; i += CHUNK_THREADS) p.new_lengths[i] = i == slot ? p.new_len : p.lengths[i];

  // Every load first: each thread's 16 bytes of its row in each pass.
  const int lane = threadIdx.x % LANES, e0 = lane * VEC;
  uint4 raw[PASSES];
#pragma unroll
  for (int s = 0; s < PASSES; ++s) {
    const int r = s * RPP + threadIdx.x / LANES;
    const int u = u0 + r / CHUNK_TOKENS, t = t0 + r % CHUNK_TOKENS;
    raw[s] = make_uint4(0u, 0u, 0u, 0u);
    if (u < units && t < p.t_len) {
      const T* src = u < p.hq            ? static_cast<const T*>(p.q) + u * p.q_sh + t * p.q_st
                     : u < p.hq + p.hkv ? static_cast<const T*>(p.k) + (u - p.hq) * p.k_sh + t * p.k_st
                                        : static_cast<const T*>(p.v) + (u - p.hq - p.hkv) * p.v_sh + t * p.v_st;
      raw[s] = *reinterpret_cast<const uint4*>(src + e0);
    }
  }
  if (u0 < p.hq + p.hkv) {  // the block rotates (uniform): its tokens' angles
    for (int idx = threadIdx.x; idx < CHUNK_TOKENS * (D / 2); idx += CHUNK_THREADS) {
      const int tt = idx / (D / 2), i = idx % (D / 2);
      const float angle = __fmul_rn(static_cast<float>(p.start + t0 + tt), p.freqs[i]);
      s_cos[tt][i] = cosf(angle);
      s_sin[tt][i] = sinf(angle);
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < PASSES; ++s) {
    const int r = s * RPP + threadIdx.x / LANES;
    const int u = u0 + r / CHUNK_TOKENS, tt = r % CHUNK_TOKENS, t = t0 + tt;
    if (u >= units) continue;  // uniform across the warp: its rows are of one unit
    const bool valid = t < p.t_len, is_q = u < p.hq, is_v = u >= p.hq + p.hkv;
    const T* in = reinterpret_cast<const T*>(&raw[s]);
    alignas(16) T vals[VEC];
    float x[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = fat::to_float(in[j]);
    if (!is_v) {
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) {
        const int i = e0 / 2 + j;
        const float c = s_cos[tt][i], sn = s_sin[tt][i];
        const float x1 = x[2 * j], x2 = x[2 * j + 1];
        vals[2 * j] = fat::from_float<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sn)));
        vals[2 * j + 1] = fat::from_float<T>(__fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, c)));
      }
      if (is_q) {
        if (valid)
          store_bytes<16>(static_cast<T*>(p.q_out) + (static_cast<int64_t>(u) * p.t_len + t) * D + e0, vals);
        continue;
      }
      // The cache stores k as the model holds it, rounded to T.
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = fat::to_float(vals[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = in[j];
    }
    const int h = is_v ? u - p.hq - p.hkv : u - p.hq;
    const int2 at = chunk_row(p, slot, p.start + t);
    P* dst = static_cast<P*>(is_v ? p.v_cache : p.k_cache) + at.x * p.c_sb + h * p.c_sh + at.y * p.c_sr + e0;
    if constexpr (fat::is_payload<P>) {
      float absmax = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) absmax = fmaxf(absmax, fabsf(x[j]));
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        absmax = fmaxf(absmax, __shfl_xor_sync(fat::FULL_MASK, absmax, off));
      const float sc = fat::row_scale(absmax, fat::payload_qmax<P>);
      alignas(VEC) P codes[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) codes[j] = fat::quantize<P>(x[j], sc);
      if (valid) {
        store_bytes<VEC>(dst, codes);
        if (lane == 0) (is_v ? p.v_scales : p.k_scales)[at.x * p.s_sb + h * p.s_sh + at.y * p.s_sr] = sc;
      }
    } else if (valid) {
      store_bytes<16>(dst, vals);
    }
  }
}

struct ChunkLaunch {
  ChunkParams p;
  cudaStream_t stream;
  template <typename T, typename P, int D>
  cudaError_t launch() const {
    const dim3 grid(static_cast<unsigned>((p.t_len + CHUNK_TOKENS - 1) / CHUNK_TOKENS),
                    static_cast<unsigned>((p.hq + 2 * p.hkv + CHUNK_UNITS - 1) / CHUNK_UNITS));
    rope_chunk_kernel<T, P, D><<<grid, CHUNK_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// F1. x, delta (or null), x_new (written when delta is given) and h
// [rows, width] contiguous, weight [width] contiguous, all of `dtype`
// (float32, float16 or bfloat16). Returns a cudaError_t.
extern "C" int fat_add_rms_norm(const void* x, const void* delta, const void* weight, void* x_new, void* h,
                                int64_t rows, int64_t width, float eps, int32_t dtype, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const NormParams p{x, delta, weight, x_new, h, width, eps};
  return static_cast<int>(fat::by_type(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    add_rms_norm_kernel<T><<<static_cast<unsigned>(rows), NORM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
  }));
}

// F3. gate, up and out [n] contiguous, of `dtype`. Returns a cudaError_t.
extern "C" int fat_swiglu_act(const void* gate, const void* up, void* out, int64_t n, int32_t dtype, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + ACT_THREADS - 1) / ACT_THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
  return static_cast<int>(fat::by_type(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    swiglu_act_kernel<T><<<grid, ACT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<T*>(out), n);
    return cudaGetLastError();
  }));
}

// F2. q, k (and v when writing) of `dtype` with unit stride on D at the
// shape's strides; q_out, k_out contiguous; freqs [D / 2] fp32; pos int32
// at the shape's (batch, t) strides. With k_cache (T == 1): the cache's K
// and V rows [B, Hkv, rows, D] of `payload` (dtype itself, or int8 / fp8
// with k_scales, v_scales [B, Hkv, rows(, 1)] fp32) at the shape's strides,
// new_lengths [B] int32; ring: 1 for a rolling cache; sinks: its sinks.
// head_dim even and at most 256. Returns a cudaError_t.
extern "C" int fat_rope(const void* q, const void* k, const void* v, void* q_out, void* k_out, const float* freqs,
                        const int32_t* pos, void* k_cache, void* v_cache, float* k_scales, float* v_scales,
                        int32_t* new_lengths, const int64_t* shape, int32_t dtype, int32_t payload, void* stream) {
  RopeParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_out = q_out;
  p.k_out = k_out;
  p.freqs = freqs;
  p.pos = pos;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.new_lengths = new_lengths;
  p.q_sb = shape[kQsb];
  p.q_sh = shape[kQsh];
  p.q_st = shape[kQst];
  p.k_sb = shape[kKsb];
  p.k_sh = shape[kKsh];
  p.k_st = shape[kKst];
  p.v_sb = shape[kVsb];
  p.v_sh = shape[kVsh];
  p.v_st = shape[kVst];
  p.p_sb = shape[kPsb];
  p.p_st = shape[kPst];
  p.c_sb = shape[kCsb];
  p.c_sh = shape[kCsh];
  p.c_sr = shape[kCsr];
  p.s_sb = shape[kSsb];
  p.s_sh = shape[kSsh];
  p.s_sr = shape[kSsr];
  p.t_len = static_cast<int>(shape[kT]);
  p.hq = static_cast<int>(shape[kQHeads]);
  p.hkv = static_cast<int>(shape[kKvHeads]);
  p.half = static_cast<int>(shape[kHeadDim] / 2);
  p.rows = static_cast<int>(shape[kRows]);
  p.ring = static_cast<int>(shape[kRing]);
  p.sinks = static_cast<int>(shape[kSinks]);
  p.sinks_pad = (p.sinks + 127) / 128 * 128;
  const int64_t tokens = shape[kBatch] * shape[kT];
  const bool write = k_cache != nullptr;
  if (tokens <= 0 || shape[kHeadDim] % 2 || p.half > MAX_HALF || p.half < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (write && (v == nullptr || v_cache == nullptr || new_lengths == nullptr || p.t_len != 1 || p.rows < 1 ||
                (p.sinks > 0 && (!p.ring || p.sinks_pad >= p.rows))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fat::by_type(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if (payload == dtype) return launch_rope<T, T>(p, static_cast<int>(tokens), st);
    if (k_scales == nullptr || v_scales == nullptr) return cudaErrorInvalidValue;
    switch (payload) {
      case fat::kInt8: return launch_rope<T, int8_t>(p, static_cast<int>(tokens), st);
      case fat::kFp8E4M3: return launch_rope<T, __nv_fp8_e4m3>(p, static_cast<int>(tokens), st);
      case fat::kFp8E5M2: return launch_rope<T, __nv_fp8_e5m2>(p, static_cast<int>(tokens), st);
      default: return cudaErrorInvalidValue;
    }
  }));
}


// F2's chunk form (T >= 1, batch 1). q, k, v [1, H, T, D] of `dtype` with
// unit stride on D, 16-byte-aligned rows, at the shape's (head, token)
// strides; q_out [1, Hq, T, D] contiguous; freqs [D / 2] fp32; slot [1]
// int32 on the device; lengths, new_lengths [slots] int32. The cache: with
// table null, a dense cache's K and V [slots, Hkv, rows, D] (ring: a
// rolling one with `sinks`); with table [slots, pages_per_slot] int32 at
// table_stride, a page pool [num_pages, Hkv, page_size = rows, D]; of
// `payload` (dtype itself, or int8 / fp8 with k_scales, v_scales fp32), at
// the shape's strides, rows 16-byte aligned. Positions start + t; the slot's
// new length new_len. head_dim 32, 64 or 128. Returns a cudaError_t.
extern "C" int fat_rope_chunk(const void* q, const void* k, const void* v, void* q_out, const float* freqs,
                              const int32_t* slot, const int32_t* lengths, int32_t* new_lengths, void* k_cache,
                              void* v_cache, float* k_scales, float* v_scales, const int32_t* table,
                              const int64_t* shape, int32_t dtype, int32_t payload, void* stream) {
  ChunkParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_out = q_out;
  p.freqs = freqs;
  p.slot = slot;
  p.lengths = lengths;
  p.new_lengths = new_lengths;
  p.k_cache = k_cache;
  p.v_cache = v_cache;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.table = table;
  p.q_sh = shape[kCQsh];
  p.q_st = shape[kCQst];
  p.k_sh = shape[kCKsh];
  p.k_st = shape[kCKst];
  p.v_sh = shape[kCVsh];
  p.v_st = shape[kCVst];
  p.c_sb = shape[kCCsb];
  p.c_sh = shape[kCCsh];
  p.c_sr = shape[kCCsr];
  p.s_sb = shape[kCSsb];
  p.s_sh = shape[kCSsh];
  p.s_sr = shape[kCSsr];
  p.table_stride = shape[kCTableStride];
  p.t_len = static_cast<int>(shape[kCT]);
  p.hq = static_cast<int>(shape[kCQHeads]);
  p.hkv = static_cast<int>(shape[kCKvHeads]);
  p.rows = static_cast<int>(shape[kCRows]);
  p.ring = static_cast<int>(shape[kCRing]);
  p.sinks = static_cast<int>(shape[kCSinks]);
  p.sinks_pad = (p.sinks + 127) / 128 * 128;
  p.start = static_cast<int>(shape[kCStart]);
  p.new_len = static_cast<int>(shape[kCNewLen]);
  p.slots = static_cast<int>(shape[kCSlots]);
  p.num_pages = static_cast<int>(shape[kCNumPages]);
  const bool quant = payload != dtype;
  if (p.t_len < 1 || p.hq < 1 || p.hkv < 1 || p.rows < 1 || p.start < 0 || p.slots < 1 || q == nullptr ||
      k == nullptr || v == nullptr || k_cache == nullptr || v_cache == nullptr || new_lengths == nullptr ||
      lengths == nullptr || slot == nullptr || (quant && (k_scales == nullptr || v_scales == nullptr)) ||
      (table != nullptr && (p.ring || p.num_pages < 1 || p.start % p.rows || p.t_len % p.rows)) ||
      (p.sinks > 0 && (!p.ring || p.sinks_pad >= p.rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChunkLaunch launcher{p, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, shape[kCHeadDim], launcher));
}
