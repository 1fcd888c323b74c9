// W1 and W2: x @ w8_dequant(w), the W8A16 matmul, reading the int8 weight.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the widen of
// ops/quant.py:124-128 (w8_dequant: values.astype(bf16) * scales.astype(bf16))
// into the weight read of every dot it feeds (models/attention.py:241-260,
// models/transformer.py:93-106 and the tied unembed, :219-223), so an int8
// weight never reaches device memory at 16 bits. These kernels are that
// fusion: the payload is read from device memory once and widened in
// registers (W1) or shared memory (W2).
//
// The function, per weight element q (int8) of output column n with fp32
// scale s[n]:
//  * scale on the weight (every layer weight): w = bf16_rn(float(q) *
//    float(bf16_rn(s[n]))), then rounded to the activation type T (exact for
//    bf16; fp16 rounds a second time, as w8_dequant(w).to(fp16) does; fp32 is
//    exact). The product of a 7-bit integer and an 8-bit mantissa is exact,
//    so mul.rn.bf16x2 on the two bf16 operands gives w8_dequant's bits.
//  * scale on the output (the tied unembed, models/transformer.py:219-223):
//    w = T(q), exact, and the fp32 sum is multiplied by s[n] in fp32.
//  * out[m, n] = sum_k x[m, k] w[k, n] with fp32 accumulators, rounded once
//    to the output type (x's, or fp32), the sums in an order fixed by the
//    shapes alone: two calls, and a CUDA graph's replay, give the same bits.
// Two layouts as they lie in memory, each with its leading stride: [K, N]
// with N contiguous (the layer weights, and a tensor-parallel shard's
// strided view of them) and [N, K] with K contiguous (the embedding).
//
// What bounds them on this card: at decode (M <= 32 rows) the weight's
// bytes, K * N at 3.35 TB/s (a decode step of ModelConfig() streams 5.8 GB:
// 1.73 ms); at a prefill chunk (M = 256 and up) the products, 2 M N K at
// 989 TFLOP/s.
//
// W1, the decode weight stream (bf16 / fp16 activations):
//  * [K, N], w8_gemv_group_kernel: one launch for up to W1_GROUP weights
//    that read the same x (q / k / v, gate / up), each with its own
//    pointer, stride, scales and output. A block owns one 128-column strip of
//    one weight over a range of K; a producer warp streams the range by TMA
//    in boxes of 128 k rows by the strip's 128 bytes (16 KB) into a ring of
//    W1_STAGES boxes, behind full and empty mbarriers, and eight consumer
//    warps take a 16-row k-step of each box. A lane reads 16 bytes at a time
//    (four k rows of 16 columns) and widens them in registers into the A
//    fragments of mma.sync m16n8k16 (the weight is A: 16 output columns by
//    16 k; up to 32 rows of x are B, 8 a tile), so the tensor cores do the
//    multiply-adds and the lanes only widen (about three integer and float
//    operations an element: an int8 code becomes an exact float by the
//    0x4B000000 magic-number add, two are packed into a bf16 pair, one
//    mul.rn.bf16x2 scales the pair). The product sums over k in any order,
//    so the k of the fragments is permuted to what one 16-byte read holds.
//    The block's warps are summed in shared memory in warp order, in one
//    pass over a slot a warp. Where the strips leave the card idle, K is
//    split over the blocks of a thread-block cluster (up to W1_MAX_SPLITS):
//    each block sends each peer its share of the partial sums through
//    distributed shared memory, and each adds its share in rank order and
//    writes it. A shard whose leading stride TMA cannot take (not a multiple
//    of 16 bytes) is read byte by byte by the consumer warps, with no
//    producer.
//  * [N, K], w8_gemv_kernel: a warp owns 16 weight rows over the whole of
//    K (the unembed's 32,000 rows are 2,000 warps); each lane copies its
//    bytes (cp.async) into shared-memory slots of its own.
// fp32 activations take w8_gemv_fma_kernel: one thread a column, eight x
// rows a block row, FMAs (the tiny fp32 configurations).
//
// W2, w8_gemm_kernel (bf16 / fp16 activations, M above W1's rows): a
// warp-specialised wgmma GEMM with the operands swapped, out^T = W^T x^T, so
// that the widened weight is wgmma's A operand in registers and never
// touches shared memory. Persistent blocks, one a multiprocessor, walk
// tiles of 128 weight columns by BM (64 or 128, ops/quant.py w2_plan) x
// rows, rows fastest. Warp 8, the producer, loads each k-block's x tile
// (128-byte swizzle: wgmma's K-major B) and int8 weight tile by TMA into a
// ring of stages. Warps 0-7, two consumer warpgroups of 64 weight columns
// each, read their columns' int8 fragments from the stage ([K, N]: two
// transposed 8 x 8 loads of 16-bit column pairs a k-block, 128-byte
// swizzle; [N, K]: 16-bit k pairs, 64-byte swizzle), widen them in
// registers with the same widen as W1, and issue the k-block's four RS
// m64nBMk16 products; the fragments are double-buffered, so the next
// k-block's widen runs under these products, and a stage is released once
// the products that read it are done. Each int8 element is read from
// shared memory and widened once a block, whatever the rows. A weight
// column pair is adjacent in the accumulator, so the epilogue (scale on the
// output, rounding) stores 4- or 8-byte words.
#include <cuda.h>

#include <algorithm>

#include "common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;
using bf16 = __nv_bfloat16;

constexpr int KN_COLS = 128;    // [K, N]: columns a strip (16 a lane group)
constexpr int W1_WARPS = 8;     // [K, N]: consumer warps a block, a 16-row k-step of each box apiece
constexpr int W1_THREADS = (W1_WARPS + 1) * 32;  // and the producer warp
constexpr int W1_BOX = 16 * W1_WARPS * KN_COLS;  // bytes a TMA box: 128 k rows by the strip's 128 bytes
constexpr int W1_STAGES = 4;    // boxes in flight a block
constexpr int W1_GROUP = 3;     // weights a launch at most
constexpr int W1_MAX_SPLITS = 8;  // blocks a cluster at most (the portable size)
constexpr int NK_ROWS = 16;     // [N, K]: weight rows a warp
constexpr int NK_WARPS = 4;     // [N, K]: warps a block (the unembed's 32,000 rows: 500 blocks)
constexpr int NK_STAGES = 4;    // [N, K]: k-blocks each lane's cp.async ring runs ahead; a power of two
constexpr int NK_PIECES = 2;    // [N, K]: a k-block (rows g and g + 8)
constexpr int FMA_THREADS = 256;
constexpr int FMA_ROWS = 8;

// ---- widening ----

// The signed int8 code in byte SEL of a word whose bytes were XORed with
// 0x80, as an exact float: 2^23 + (q + 128) - (2^23 + 128).
template <int SEL>
__device__ __forceinline__ float code(uint32_t biased) {
  return __fadd_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | SEL)), -8388736.f);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two codes (lo, hi: exact floats) as a T pair, low half lo: scaled, w8_dequant's
// bf16 bits, rounded once more for fp16; else the codes themselves.
template <typename T>
__device__ __forceinline__ uint32_t widen(float lo, float hi, uint32_t scale2, bool scaled) {
  uint32_t w = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);  // exact bf16 pair
  if (scaled) w = mul_bf16x2(w, scale2);
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 h = __floats2half2_rn(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
    w = *reinterpret_cast<const uint32_t*>(&h);
  }
  return w;
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __half>) {
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

// ---- W1 ----

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The [N, K] and fp32 bodies' operands.
struct GemvParams {
  const void* x;  // [M, K] at row stride ldx
  const int8_t* w;
  const float* scales;  // [N]
  void* out;            // [M, N] at row stride ldo
  int64_t M, N, K, ldx, ldw, ldo;
  int nk, scaled, out_f32;
};

// One weight of a [K, N] group launch.
struct GroupWeight {
  CUtensorMap tm;  // VEC: the weight as [K rows, N bytes], boxes of 128 rows by 128, 128-byte swizzle
  const int8_t* w;
  const float* scales;  // [N]
  void* out;            // [M, N] at row stride ldo
  int64_t N, ldw, ldo;
  int strips;  // 128-column strips
};

struct GroupParams {
  GroupWeight wt[W1_GROUP];
  const void* x;  // [M, K] at row stride ldx, shared by the group
  int64_t M, K, ldx;
  int count, scaled, out_f32;
  int splits, steps;  // K split over a cluster of `splits` blocks, `steps` 16-row k-steps each
};

// 16 weight bytes from `src`, zero where `ok` is false; VEC: one aligned
// 16-byte load, else byte by byte over the `n` valid bytes.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* src, bool ok, int64_t n) {
  if (!ok) return make_uint4(0u, 0u, 0u, 0u);
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 16 && i < n; ++i) v[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * (i % 4));
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// 16 weight bytes from `src` into this lane's slot `dst`, zero where `ok`
// is false: VEC, an asynchronous 16-byte copy (cp.async, zero-filled when
// off); else byte by byte (load16), stored at once.
template <bool VEC>
__device__ __forceinline__ void stage16(uint4* dst, const int8_t* src, bool ok, int64_t n) {
  if constexpr (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    *dst = load16<false>(src, ok, n);
  }
}

__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x[k .. k + 2 * PAIRS) of one row as packed 16-bit pairs, 0 past K or for
// an absent row; VEC: whole aligned vectors (K a multiple of 16).
template <int PAIRS, bool VEC>
__device__ __forceinline__ void load_x(uint32_t (&out)[PAIRS], const uint16_t* row, int64_t k, int64_t K, bool ok) {
  if constexpr (VEC) {
    if (!ok) {
#pragma unroll
      for (int i = 0; i < PAIRS; ++i) out[i] = 0u;
    } else if constexpr (PAIRS == 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + k));
      out[0] = v.x;
      out[1] = v.y;
    } else {
#pragma unroll
      for (int i = 0; i < PAIRS; i += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + k + 2 * i));
        out[i] = v.x;
        out[i + 1] = v.y;
        out[i + 2] = v.z;
        out[i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int64_t e = k + 2 * i;
      const uint32_t lo = ok && e < K ? __ldg(row + e) : 0u;
      const uint32_t hi = ok && e + 1 < K ? __ldg(row + e + 1) : 0u;
      out[i] = lo | (hi << 16);
    }
  }
}

// One fp32 result of W1 written: scaled on the output where the weight was
// not, rounded to the output type.
template <typename T>
__device__ __forceinline__ void store_out(const float* scales, void* out, int64_t ldo, bool scaled, bool out_f32,
                                          int64_t m, int64_t n, float v) {
  if (!scaled) v = __fmul_rn(v, __ldg(scales + n));
  if (out_f32) {
    static_cast<float*>(out)[m * ldo + n] = v;
  } else {
    static_cast<T*>(out)[m * ldo + n] = fat::from_float<T>(v);
  }
}

// The output place of accumulator element e (0-3) of m-tile t, x tile j,
// lane (g, c): [K, N] maps the tile's A rows g / g + 8 to columns 16 g + 2 t
// and 16 g + 2 t + 1 of the strip; [N, K] to the warp's rows g / g + 8.
template <bool NK>
__device__ __forceinline__ void place(int t, int j, int e, int g, int c, int64_t col0, int64_t row0, int64_t& m,
                                      int64_t& n) {
  m = row0 + 8 * j + 2 * c + (e & 1);
  n = NK ? col0 + g + 8 * (e >> 1) : col0 + 16 * g + 2 * t + (e >> 1);
}

// [N, K]: 16 weight rows a warp over the whole of K, k-blocks of 64, each
// lane's bytes by cp.async into slots of its own, NK_STAGES k-blocks ahead.
// grid: (blocks of NK_WARPS warps, 1, row groups of 8 XT rows).
template <typename T, int XT, bool VEC>
__global__ void __launch_bounds__(NK_WARPS * 32) w8_gemv_kernel(const __grid_constant__ GemvParams p) {
  constexpr int THREADS = NK_WARPS * 32;
  constexpr int PIECES = NK_PIECES;
  extern __shared__ __align__(16) uint8_t nk_smem[];
  // [NK_STAGES][PIECES][THREADS] 16-byte slots, each lane's own.
  uint4* const lane_ring = reinterpret_cast<uint4*>(nk_smem) + threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, c = lane % 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.z) * 8 * XT;
  const uint16_t* x = static_cast<const uint16_t*>(p.x);
  const uint16_t* xrow[XT];
  bool xok[XT];
#pragma unroll
  for (int j = 0; j < XT; ++j) {
    xok[j] = row0 + 8 * j + g < p.M;
    xrow[j] = x + (xok[j] ? (row0 + 8 * j + g) * p.ldx : 0);
  }
  float acc[XT][4];
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int64_t r0 = (static_cast<int64_t>(blockIdx.x) * NK_WARPS + warp) * NK_ROWS;
  const int64_t na = r0 + g, nb = r0 + g + 8;
  const float s_a = na < p.N ? __ldg(p.scales + na) : 0.f, s_b = nb < p.N ? __ldg(p.scales + nb) : 0.f;
  const uint32_t sa = bf16_pair(s_a, s_a), sb = bf16_pair(s_b, s_b);
  const int8_t* wa = p.w + (na < p.N ? na : 0) * p.ldw;
  const int8_t* wb = p.w + (nb < p.N ? nb : 0) * p.ldw;
  if (r0 < p.N) {
    // k-block i (k from 64 i) sits in slot i % NK_STAGES.
    auto fetch = [&](int i) {
      const int k = 64 * i + 16 * c;  // this lane's 16 k
      const bool ok = k < p.K;
      uint4* dst = lane_ring + (i & (NK_STAGES - 1)) * PIECES * THREADS;
      stage16<VEC>(dst, ok && na < p.N ? wa + k : p.w, ok && na < p.N, p.K - k);
      stage16<VEC>(dst + THREADS, ok && nb < p.N ? wb + k : p.w, ok && nb < p.N, p.K - k);
      async_commit();
    };
    // x's pairs of k-block i (registers), loaded a k-block ahead.
    auto fetch_x = [&](uint32_t (&xb)[XT][8], int i) {
      const int k = 64 * i + 16 * c;
#pragma unroll
      for (int j = 0; j < XT; ++j) load_x<8, VEC>(xb[j], xrow[j], k, p.K, xok[j] && k < p.K);
    };
#pragma unroll
    for (int i = 0; i < NK_STAGES - 1; ++i) fetch(i);
    uint32_t x_next[XT][8];
    fetch_x(x_next, 0);
    for (int i = 0; 64 * i < p.K; ++i) {
      fetch(i + NK_STAGES - 1);
      uint32_t xb[XT][8];
#pragma unroll
      for (int j = 0; j < XT; ++j)
#pragma unroll
        for (int u = 0; u < 8; ++u) xb[j][u] = x_next[j][u];
      fetch_x(x_next, i + 1);
      async_wait<NK_STAGES - 1>();
      const uint4* slot = lane_ring + (i & (NK_STAGES - 1)) * PIECES * THREADS;
      const uint4 va = slot[0], vb = slot[THREADS];
      const uint4 wa4 = make_uint4(va.x ^ 0x80808080u, va.y ^ 0x80808080u, va.z ^ 0x80808080u, va.w ^ 0x80808080u);
      const uint4 wb4 = make_uint4(vb.x ^ 0x80808080u, vb.y ^ 0x80808080u, vb.z ^ 0x80808080u, vb.w ^ 0x80808080u);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // k-step s: the lane's k + 4s + {0, 1} (a0 / a1) and + {2, 3} (a2 / a3).
        const uint32_t wa_s = word(wa4, s), wb_s = word(wb4, s);
        uint32_t a[4];
        a[0] = widen<T>(code<0>(wa_s), code<1>(wa_s), sa, p.scaled);
        a[1] = widen<T>(code<0>(wb_s), code<1>(wb_s), sb, p.scaled);
        a[2] = widen<T>(code<2>(wa_s), code<3>(wa_s), sa, p.scaled);
        a[3] = widen<T>(code<2>(wb_s), code<3>(wb_s), sb, p.scaled);
#pragma unroll
        for (int j = 0; j < XT; ++j) mma<T>(acc[j], a, xb[j][2 * s], xb[j][2 * s + 1]);
      }
    }
    async_wait<0>();
  }
  // The warps are independent: each writes its own rows.
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int64_t m, n;
      place<true>(0, j, e, g, c, r0, row0, m, n);
      if (m < p.M && n < p.N) store_out<T>(p.scales, p.out, p.ldo, p.scaled, p.out_f32, m, n, acc[j][e]);
    }
}

// [K, N], one launch for a group of weights that read the same x. A block
// owns a strip of 128 columns of one weight over a range of `steps` 16-row
// k-steps. grid: (the group's strips x splits, row groups of 8 XT rows);
// clusters of `splits` blocks along x, one a range. VEC, producer warp 8
// streams the range in boxes of 128 k rows by the strip's 128 bytes
// (unswizzled: a lane's four 16-byte reads of a k-step already spread over
// the banks) and consumer warp w takes k-step w of each box; without VEC the
// consumers load their bytes themselves.
// Dynamic shared memory: the ring of boxes (VEC), which each consumer
// warp's sums reuse once the boxes are read, then the peers' shares of the
// block's sum.
template <int XT, bool VEC>
__host__ __device__ constexpr int w1_ring_bytes() {  // the boxes, or each warp's sums
  return VEC && W1_STAGES * W1_BOX > 4 * W1_WARPS * XT * 1024 ? W1_STAGES * W1_BOX : 4 * W1_WARPS * XT * 1024;
}
template <int XT, bool VEC>
__host__ __device__ constexpr int w1_smem_bytes() {
  return 1024 + w1_ring_bytes<XT, VEC>() + 4 * (XT * 1024 + W1_MAX_SPLITS);
}

template <typename T, int XT, bool VEC>
__global__ void __launch_bounds__(W1_THREADS) w8_gemv_group_kernel(const __grid_constant__ GroupParams p) {
  constexpr int TOTAL = XT * 8 * 4 * 32;  // a warp's sums (XT x tiles, 8 m-tiles), and the block's, in fragment order
  constexpr int CONSUMERS = W1_WARPS * 32;
  __shared__ uint64_t full[W1_STAGES], empty[W1_STAGES];
  extern __shared__ uint8_t w1_smem[];
  uint8_t* const ring = align_1024(w1_smem);
  float* const red = reinterpret_cast<float*>(ring);  // [W1_WARPS][TOTAL], once the boxes are read
  float* const recv = reinterpret_cast<float*>(ring + w1_ring_bytes<XT, VEC>());  // by rank, a slice each
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, c = lane % 4;
  const int splits = p.splits;
  const int rank = splits > 1 ? static_cast<int>(cluster_rank()) : 0;
  if (splits > 1) cluster_arrive_relaxed();
  // The block's strip: item-th over the group's weights in order.
  int item = static_cast<int>(blockIdx.x) / splits, wi = 0;
  while (wi + 1 < p.count && item >= p.wt[wi].strips) item -= p.wt[wi].strips, ++wi;
  const GroupWeight& wt = wi == 0 ? p.wt[0] : (wi == 1 ? p.wt[1] : p.wt[2]);
  const int64_t col0 = static_cast<int64_t>(item) * KN_COLS;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * 8 * XT;
  const int ksteps = static_cast<int>((p.K + 15) / 16);
  const int s_begin = rank * p.steps, s_end = min(ksteps, s_begin + p.steps);
  const int boxes = (s_end - s_begin + W1_WARPS - 1) / W1_WARPS;  // box i: k-steps s_begin + 8 i ..
  if (VEC && threadIdx.x == 0) {
    prefetch_map(&wt.tm);
    for (int s = 0; s < W1_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W1_WARPS);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W1_WARPS) {
    // The producer: box i into stage i % W1_STAGES once the consumers have read what it held.
    if constexpr (VEC) {
      for (int i = 0; i < boxes; ++i) {
        const int s = i % W1_STAGES;
        mbar_wait(&empty[s], ((i / W1_STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect(&full[s], W1_BOX);
          tma_load_2d(ring + s * W1_BOX, &wt.tm, static_cast<int>(col0), (s_begin + W1_WARPS * i) * 16, &full[s]);
        }
      }
    }
  } else {
    const uint16_t* x = static_cast<const uint16_t*>(p.x);
    const uint16_t* xrow[XT];
    bool xok[XT];
#pragma unroll
    for (int j = 0; j < XT; ++j) {
      xok[j] = row0 + 8 * j + g < p.M;
      xrow[j] = x + (xok[j] ? (row0 + 8 * j + g) * p.ldx : 0);
    }
    float acc[XT][8][4];
#pragma unroll
    for (int j = 0; j < XT; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
    const int64_t ncol = col0 + 16 * g;  // the lane's 16 columns
    const bool col_ok = ncol < wt.N;
    // x's pairs of box i's k-step (registers), loaded two boxes ahead.
    auto fetch_x = [&](uint32_t (&b)[XT][2], int i) {
      const int st = s_begin + W1_WARPS * i + warp;
#pragma unroll
      for (int j = 0; j < XT; ++j) load_x<2, VEC>(b[j], xrow[j], st * 16 + 4 * c, p.K, xok[j] && st < s_end);
    };
    uint32_t b_next[XT][2], b_after[XT][2];
    fetch_x(b_next, 0);
    fetch_x(b_after, 1);
    uint32_t sc[16];  // the lane's 16 columns' bf16 scales, paired; read under the first boxes
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float s = ncol + i < wt.N ? __ldg(wt.scales + ncol + i) : 0.f;
      sc[i] = bf16_pair(s, s);
    }
    const int at = (16 * warp + 4 * c) * KN_COLS + 16 * g;  // the lane's 16 bytes of its first k row, in a stage
    for (int i = 0; i < boxes; ++i) {
      const int st = s_begin + W1_WARPS * i + warp;
      uint32_t b[XT][2];
#pragma unroll
      for (int j = 0; j < XT; ++j) {
        b[j][0] = b_next[j][0], b[j][1] = b_next[j][1];
        b_next[j][0] = b_after[j][0], b_next[j][1] = b_after[j][1];
      }
      fetch_x(b_after, i + 2);
      uint4 w4[4];
      if constexpr (VEC) {
        const int s = i % W1_STAGES;
        mbar_wait(&full[s], (i / W1_STAGES) & 1);
        const uint8_t* tile = ring + s * W1_BOX + at;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint4 v = *reinterpret_cast<const uint4*>(tile + r * KN_COLS);
          w4[r] = make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u, v.w ^ 0x80808080u);
        }
        fence_proxy_async();  // the box's reads before the copy that refills its stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      } else {
        const int64_t k0 = static_cast<int64_t>(st) * 16 + 4 * c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint4 v = load16<false>(wt.w + (k0 + r) * wt.ldw + ncol, col_ok && st < s_end && k0 + r < p.K,
                                        wt.N - ncol);
          w4[r] = make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u, v.w ^ 0x80808080u);
        }
      }
      if (st < s_end) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          // Columns 2t (A row g) and 2t + 1 (A row g + 8) of the lane's 16:
          // bytes 2t % 4 and 2t % 4 + 1 of word t / 2 of each k row.
          uint32_t a[4];
          const uint32_t r0 = word(w4[0], t / 2), r1 = word(w4[1], t / 2);
          const uint32_t r2 = word(w4[2], t / 2), r3 = word(w4[3], t / 2);
          if (t % 2 == 0) {
            a[0] = widen<T>(code<0>(r0), code<0>(r1), sc[2 * t], p.scaled);
            a[1] = widen<T>(code<1>(r0), code<1>(r1), sc[2 * t + 1], p.scaled);
            a[2] = widen<T>(code<0>(r2), code<0>(r3), sc[2 * t], p.scaled);
            a[3] = widen<T>(code<1>(r2), code<1>(r3), sc[2 * t + 1], p.scaled);
          } else {
            a[0] = widen<T>(code<2>(r0), code<2>(r1), sc[2 * t], p.scaled);
            a[1] = widen<T>(code<3>(r0), code<3>(r1), sc[2 * t + 1], p.scaled);
            a[2] = widen<T>(code<2>(r2), code<2>(r3), sc[2 * t], p.scaled);
            a[3] = widen<T>(code<3>(r2), code<3>(r3), sc[2 * t + 1], p.scaled);
          }
#pragma unroll
          for (int j = 0; j < XT; ++j) mma<T>(acc[j][t], a, b[j][0], b[j][1]);
        }
      }
    }
    // Each warp's sums into a slot of its own over the ring, once every
    // consumer has read its last box.
    named_sync(1, CONSUMERS);
    float* const mine = red + warp * TOTAL + lane;
#pragma unroll
    for (int j = 0; j < XT; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[((j * 8 + t) * 4 + e) * 32] = acc[j][t][e];
    named_sync(1, CONSUMERS);
  }

  // Element i of the block's sum (lane l = i % 32, accumulator i / 32): the
  // eight warps' added in warp order.
  auto total = [&](int i) {
    float v = red[i];
    for (int w = 1; w < W1_WARPS; ++w) v = __fadd_rn(v, red[w * TOTAL + i]);
    return v;
  };
  auto store = [&](int i, float v) {
    const int l = i % 32, idx = i / 32, e = idx % 4, t = (idx / 4) % 8, j = idx / 32;
    int64_t m, n;
    place<false>(t, j, e, l / 4, l % 4, col0, row0, m, n);
    if (m < p.M && n < wt.N) store_out<T>(wt.scales, wt.out, wt.ldo, p.scaled, p.out_f32, m, n, v);
  };
  if (splits == 1) {
    if (warp < W1_WARPS) {
      for (int i = threadIdx.x; i < TOTAL; i += CONSUMERS) store(i, total(i));
    }
    return;
  }
  // The cluster's K split: rank r adds slice r of the sum over the ranks in
  // rank order. Each block first sends each peer its share, into the peer's
  // recv slot of this rank (every thread of the cluster takes part in the
  // barriers; the producer warp sends nothing).
  const int slice = (TOTAL + splits - 1) / splits;
  cluster_wait();  // the start's arrival: every peer runs
  if (warp < W1_WARPS) {
    for (int i = threadIdx.x; i < TOTAL; i += CONSUMERS) {
      const int to = i / slice;
      st_peer(peer_addr(smem_u32(&recv[rank * slice + (i - to * slice)]), to), total(i));
    }
  }
  cluster_sync();
  if (warp < W1_WARPS) {
    for (int e = threadIdx.x; e < slice && rank * slice + e < TOTAL; e += CONSUMERS) {
      float v = recv[e];
      for (int r = 1; r < splits; ++r) v = __fadd_rn(v, recv[r * slice + e]);
      store(rank * slice + e, v);
    }
  }
}

// fp32 activations: a thread a column, FMA_ROWS rows of x a block row.
__global__ void __launch_bounds__(FMA_THREADS) w8_gemv_fma_kernel(const GemvParams p) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * FMA_THREADS + threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * FMA_ROWS;
  if (n >= p.N) return;
  const int64_t sk = p.nk ? 1 : p.ldw, sn = p.nk ? p.ldw : 1;
  const float s = __ldg(p.scales + n);
  const float sbf = __bfloat162float(__float2bfloat16_rn(s));
  const float* x = static_cast<const float*>(p.x);
  float acc[FMA_ROWS];
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) acc[r] = 0.f;
  for (int64_t k = 0; k < p.K; ++k) {
    const float q = static_cast<float>(__ldg(p.w + k * sk + n * sn));
    const float w = p.scaled ? __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, sbf))) : q;
#pragma unroll
    for (int r = 0; r < FMA_ROWS; ++r)
      if (row0 + r < p.M) acc[r] = __fmaf_rn(__ldg(x + (row0 + r) * p.ldx + k), w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < FMA_ROWS; ++r) {
    if (row0 + r >= p.M) break;
    const float v = p.scaled ? acc[r] : __fmul_rn(acc[r], s);
    static_cast<float*>(p.out)[(row0 + r) * p.ldo + n] = v;
  }
}

// ---- W2 ----

constexpr int BK = 64;                  // k a stage
constexpr int W2_BN = 128;              // weight columns a tile: 64 a consumer warpgroup
constexpr int W2_MMA_THREADS = 256;     // warps 0-7, two warpgroups
constexpr int W2_PRODUCER = 8;          // the TMA warp
constexpr int W2_THREADS = W2_MMA_THREADS + 32;
constexpr int W2_W8_TILE = BK * W2_BN;  // bytes of an int8 weight tile

// A tile of BM x rows (the products' N) by W2_BN weight columns: the ring's
// stages (the x tile, then the int8 weight tile) as many as 200 KB holds, at
// most 8: a stage is released a k-block after its products are issued, so
// the depth is what hides the loads' latency.
template <int BM>
struct W2Tiles {
  static constexpr int X = BM * BK * 2;
  static constexpr int STAGE = X + W2_W8_TILE;
  static constexpr int STAGES = 200 * 1024 / STAGE > 8 ? 8 : 200 * 1024 / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "W2's shared memory");
};

struct GemmParams {
  CUtensorMap tm_x, tm_w;
  const float* scales;
  void* out;
  int M, N, K;
  int64_t ldo;
  int scaled, out_f32;
  int tiles_m, tiles;  // row tiles; tile pairs (rows fastest)
};

// D[64 x N] += A[64 x 16] B[16 x N]: A from registers (the mma.m16n8k16
// A fragment of each warp's 16 rows), B K-major in shared memory; N 64, 128
// or 256.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64 && std::is_same_v<T, bf16>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 128 && std::is_same_v<T, bf16>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 256 && std::is_same_v<T, bf16>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

// Four 8 x 8 matrices of 16-bit elements, transposed: lanes 8 i .. 8 i + 7
// give the row addresses of matrix i, r[i] its elements (rows 2c, 2c + 1 of
// column g for lane (g, c)).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

// The A fragments of a k-block's four k-steps for this thread's two weight
// columns n (A row g) and n + 1 (A row g + 8), n the warp's 16-byte chunk
// `chunk` + 2g, widened: [K, N] by two transposed 8 x 8 loads of 16-bit
// pairs (columns n, n + 1) over k rows 2c, 2c + 1 (128-byte swizzle); [N, K]
// by 16-bit loads of k pairs 2c, 2c + 1 and 2c + 8, 2c + 9 of rows n and
// n + 1 (64-byte swizzle).
template <typename T, bool NK>
__device__ __forceinline__ void w2_frags(uint32_t (&a)[4][4], uint32_t tile, int chunk, int lane, uint32_t s0,
                                         uint32_t s1, bool scaled) {
  const int g = lane / 4, c = lane % 4;
  if constexpr (NK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 16 * chunk + 2 * g + h;
      const uint32_t row = tile + n * 64, sw = (n >> 1) & 3;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t at = row + ((kk ^ sw) << 4) + 2 * c;
        const uint32_t lo = lds_u16(at) ^ 0x8080u, hi = lds_u16(at + 8) ^ 0x8080u;
        a[kk][h] = widen<T>(code<0>(lo), code<1>(lo), h ? s1 : s0, scaled);
        a[kk][2 + h] = widen<T>(code<0>(hi), code<1>(hi), h ? s1 : s0, scaled);
      }
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = 32 * half + lane;  // this lane's row address: matrix lane / 8, row lane % 8
      uint32_t r[4];
      ldsm_x4_t(r, tile + k * 128 + ((chunk ^ (k & 7)) << 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t v = r[i] ^ 0x80808080u;  // k rows 2c, 2c + 1 (bytes 0-1, 2-3) of columns n, n + 1
        const int kk = 2 * half + i / 2, lo = 2 * (i % 2);
        a[kk][lo] = widen<T>(code<0>(v), code<2>(v), s0, scaled);
        a[kk][lo + 1] = widen<T>(code<1>(v), code<3>(v), s1, scaled);
      }
    }
  }
}

// Persistent: min(tiles, multiprocessors) blocks, block b walking tiles b,
// b + grid, ...; warps 0-7 two consumer warpgroups, warp 8 the producer;
// each consumer warp releases a stage with one arrival. `it` counts the
// k-blocks a role has walked over all its tiles: stage it % STAGES and each
// mbarrier's phase from it.
template <typename T, bool NK, int BM>
__global__ void __launch_bounds__(W2_THREADS, 1) w8_gemm_kernel(const __grid_constant__ GemmParams p) {
  using Tl = W2Tiles<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);  // STAGES x (x tile, int8 tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::STAGES * Tl::STAGE);  // a stage's loads landed
  uint64_t* empty = full + Tl::STAGES;  // a stage read by the consumers
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nkb = (p.K + BK - 1) / BK;
  if (tid == 0) {
    prefetch_map(&p.tm_x);
    prefetch_map(&p.tm_w);
    for (int s = 0; s < Tl::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W2_MMA_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int it = 0;

  if (warp == W2_PRODUCER) {
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = t % p.tiles_m * BM, n0 = t / p.tiles_m * W2_BN;
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % Tl::STAGES;
        mbar_wait(&empty[s], ((it / Tl::STAGES) & 1) ^ 1);
        if (lane == 0) {
          uint8_t* stage = ring + s * Tl::STAGE;
          mbar_expect(&full[s], Tl::STAGE);
          tma_load_2d(stage, &p.tm_x, kb * BK, m0, &full[s]);
          if constexpr (NK) {
            tma_load_2d(stage + Tl::X, &p.tm_w, kb * BK, n0, &full[s]);
          } else {
            tma_load_2d(stage + Tl::X, &p.tm_w, n0, kb * BK, &full[s]);
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg owns the tile's weight columns 64 wg .. 64 wg
  // + 63, D = 64 weight columns by BM x rows; warp lw's A rows g and g + 8
  // are columns 16 lw + 2g and 16 lw + 2g + 1 of them.
  const int wg = warp / 4, lw = warp % 4, g = lane / 4, c = lane % 4;
  const int chunk = 4 * wg + lw;  // the warp's 16-byte chunk of a weight row
  const bool pairs = p.ldo % 2 == 0;  // adjacent columns stored as one 4- or 8-byte word
  float d[BM / 2];
  uint32_t a[2][4][4];  // the A fragments of two k-blocks: one in flight while the next is built
  // A consumer warp's release of stage s, once its products and reads of it are done.
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int m0 = t % p.tiles_m * BM, n0 = t / p.tiles_m * W2_BN;
    const int n = n0 + 16 * chunk + 2 * g;  // this thread's columns n, n + 1
    const float sn0 = n < p.N ? __ldg(p.scales + n) : 0.f, sn1 = n + 1 < p.N ? __ldg(p.scales + n + 1) : 0.f;
    const uint32_t s0 = bf16_pair(sn0, sn0), s1 = bf16_pair(sn1, sn1);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) d[i] = 0.f;
    int prev = -1;  // the stage of the k-block whose products are in flight
    auto step = [&](auto parity) {
      constexpr int P = decltype(parity)::value;
      const int s = it % Tl::STAGES;
      const uint32_t stage = smem_u32(ring + s * Tl::STAGE);
      mbar_wait(&full[s], (it / Tl::STAGES) & 1);
      w2_frags<T, NK>(a[P], stage + Tl::X, chunk, lane, s0, s1, p.scaled);
      fence_proxy_async();  // the weight tile's reads before the copy that refills the stage
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_k<T, BM>(d, a[P][kk], desc_k<64, BM>(stage, 0, kk));
      wg_commit();
      wg_wait<1>();  // the previous k-block's products are done: its fragments and stage are free
      fence_regs(a[P ^ 1]);
      if (prev >= 0) release(prev);
      prev = s;
      ++it;
    };
    for (int kb = 0; kb < nkb; kb += 2) {
      step(std::integral_constant<int, 0>{});
      if (kb + 1 < nkb) step(std::integral_constant<int, 1>{});
    }
    wg_wait_all();
    fence_regs(d);
    fence_regs(a[0]);
    fence_regs(a[1]);
    if (prev >= 0) release(prev);
    // D row 16 lw + g + 8 h is column n + h; D column 8 j + 2 c + e is x row m0 + 8 j + 2 c + e.
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * c + e;
        if (m >= p.M || n >= p.N) continue;
        float v0 = d[4 * j + e], v1 = d[4 * j + 2 + e];
        if (!p.scaled) {
          v0 = __fmul_rn(v0, sn0);
          v1 = __fmul_rn(v1, sn1);
        }
        const bool two = pairs && n + 1 < p.N;
        const int64_t at = static_cast<int64_t>(m) * p.ldo + n;
        if (p.out_f32) {
          float* o = static_cast<float*>(p.out) + at;
          if (two) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (n + 1 < p.N) o[1] = v1;
          }
        } else {
          T* o = static_cast<T*>(p.out) + at;
          if (two) {
            store2<T>(o, v0, v1);
          } else {
            o[0] = fat::from_float<T>(v0);
            if (n + 1 < p.N) o[1] = fat::from_float<T>(v1);
          }
        }
      }
  }
}

// A 2-D tensor map: `outer` rows of `inner` elements of `elem` bytes at a
// row pitch of `ld` elements, boxes of box_outer rows by box_inner elements.
bool map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem, int64_t inner, int64_t outer,
            int64_t ld, int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  // One row is never stepped over: give it a pitch TMA takes, whatever the view reports.
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(outer == 1 ? (inner * elem + 15) / 16 * 16 : ld * elem)};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner), static_cast<cuuint32_t>(box_outer)};
  cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shape array of fat_w8_matmul (ops/quant.py builds it).
enum Shape : int { kM, kN, kK, kLdx, kLdw, kLdo, kNK, kScaled, kOutF32, kKernel, kXT, kVec, kBM, kGrid, kShapeLen };

template <typename T, int XT, bool VEC>
cudaError_t launch_nk(const GemvParams& p, cudaStream_t stream) {
  const int64_t groups = (p.M + 8 * XT - 1) / (8 * XT);
  const dim3 grid(static_cast<unsigned>((p.N + NK_WARPS * NK_ROWS - 1) / (NK_WARPS * NK_ROWS)), 1,
                  static_cast<unsigned>(groups));
  const int ring = NK_STAGES * NK_PIECES * NK_WARPS * 32 * 16;  // each lane's cp.async slots
  const cudaError_t err = fat::reserve_smem(w8_gemv_kernel<T, XT, VEC>, ring);
  if (err != cudaSuccess) return err;
  w8_gemv_kernel<T, XT, VEC><<<grid, NK_WARPS * 32, ring, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int XT, bool VEC>
cudaError_t launch_group(const GroupParams& p, int items, int groups, cudaStream_t stream) {
  const auto kernel = w8_gemv_group_kernel<T, XT, VEC>;
  constexpr int smem = w1_smem_bytes<XT, VEC>();
  cudaError_t err = fat::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(items * p.splits), static_cast<unsigned>(groups));
  cfg.blockDim = dim3(W1_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Runs fn(std::integral_constant<int, XT>) for x tiles XT of 1, 2 or 4.
template <typename Fn>
cudaError_t by_tiles(int xt, const Fn& fn) {
  switch (xt) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool NK, int BM>
cudaError_t launch_w2(const void* x, const void* w, const float* scales, void* out, const int64_t* s, int dtype,
                      cudaStream_t stream) {
  GemmParams p{};
  const CUtensorMapDataType xtype =
      dtype == fat::kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (!map_2d(&p.tm_x, x, xtype, 2, s[kK], s[kM], s[kLdx], BK, BM, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  // The weight tile: [N, K] as W2_BN rows of BK bytes (64-byte swizzle); [K, N] as BK rows of W2_BN bytes (128-byte).
  const bool ok = NK ? map_2d(&p.tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, s[kK], s[kN], s[kLdw], BK, W2_BN,
                              CU_TENSOR_MAP_SWIZZLE_64B)
                     : map_2d(&p.tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, s[kN], s[kK], s[kLdw], W2_BN, BK,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  p.scales = scales;
  p.out = out;
  p.M = static_cast<int>(s[kM]);
  p.N = static_cast<int>(s[kN]);
  p.K = static_cast<int>(s[kK]);
  p.ldo = s[kLdo];
  p.scaled = static_cast<int>(s[kScaled]);
  p.out_f32 = static_cast<int>(s[kOutF32]);
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles = p.tiles_m * ((p.N + W2_BN - 1) / W2_BN);
  const auto kernel = w8_gemm_kernel<T, NK, BM>;
  cudaError_t err = fat::reserve_smem(kernel, W2Tiles<BM>::SMEM);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(std::min<int64_t>(p.tiles, s[kGrid]));
  kernel<<<grid, W2_THREADS, W2Tiles<BM>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t w2_by_layout(const void* x, const void* w, const float* scales, void* out, const int64_t* s, int dtype,
                         cudaStream_t stream) {
  const bool nk = s[kNK] != 0;
  if (s[kBM] == 64) return nk ? launch_w2<T, true, 64>(x, w, scales, out, s, dtype, stream)
                              : launch_w2<T, false, 64>(x, w, scales, out, s, dtype, stream);
  if (s[kBM] == 128) return nk ? launch_w2<T, true, 128>(x, w, scales, out, s, dtype, stream)
                               : launch_w2<T, false, 128>(x, w, scales, out, s, dtype, stream);
  return cudaErrorInvalidValue;
}

// The head of fat_w8_group's shape array, then kPer values a weight.
enum GroupShape : int { gCount, gM, gK, gLdx, gScaled, gOutF32, gXT, gSplits, gSteps, gVec, gHead };
enum GroupWeightShape : int { gN, gLdw, gLdo, gPer };

}  // namespace

// x [M, K] (row pitch ldx, of `dtype`) times the int8 weight w ([K, N] or,
// with shape[kNK], [N, K], leading pitch ldw) widened by its fp32 scales
// [N], into out [M, N] (row pitch ldo; fp32 with shape[kOutF32], else
// dtype). shape[kKernel]: 1 for W1 (fp32 x on the FMA body, 16-bit x with an
// [N, K] weight in shape[kXT] x tiles; a [K, N] weight with 16-bit x goes
// through fat_w8_group), 2 for W2 (tiles of shape[kBM] x rows, at most
// shape[kGrid] blocks).
extern "C" int fat_w8_matmul(const void* x, const void* w, const float* scales, void* out, const int64_t* shape,
                             int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nk = shape[kNK] != 0;
  if (shape[kKernel] == 2) {
    if (dtype == fat::kBFloat16) return w2_by_layout<bf16>(x, w, scales, out, shape, dtype, st);
    if (dtype == fat::kFloat16) return w2_by_layout<__half>(x, w, scales, out, shape, dtype, st);
    return cudaErrorInvalidValue;
  }
  GemvParams p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scales = scales;
  p.out = out;
  p.M = shape[kM];
  p.N = shape[kN];
  p.K = shape[kK];
  p.ldx = shape[kLdx];
  p.ldw = shape[kLdw];
  p.ldo = shape[kLdo];
  p.nk = static_cast<int>(nk);
  p.scaled = static_cast<int>(shape[kScaled]);
  p.out_f32 = static_cast<int>(shape[kOutF32]);
  if (dtype == fat::kFloat32) {
    const dim3 grid(static_cast<unsigned>((p.N + FMA_THREADS - 1) / FMA_THREADS),
                    static_cast<unsigned>((p.M + FMA_ROWS - 1) / FMA_ROWS));
    w8_gemv_fma_kernel<<<grid, FMA_THREADS, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (!nk || (dtype != fat::kBFloat16 && dtype != fat::kFloat16)) return cudaErrorInvalidValue;
  const bool vec = shape[kVec] != 0;
  return by_tiles(static_cast<int>(shape[kXT]), [&](auto xt_tag) -> cudaError_t {
    constexpr int XT = decltype(xt_tag)::value;
    if (dtype == fat::kBFloat16) return vec ? launch_nk<bf16, XT, true>(p, st) : launch_nk<bf16, XT, false>(p, st);
    return vec ? launch_nk<__half, XT, true>(p, st) : launch_nk<__half, XT, false>(p, st);
  });
}

// x [M, K] (16-bit `dtype`, row pitch ldx) times each of shape[gCount] (at
// most W1_GROUP) int8 [K, N_i] weights, one launch of W1's group body.
// ptrs: (weight, scales, out) a weight; shape: the GroupShape head, then
// (N, ldw, ldo) a weight. shape[gVec]: every weight by TMA (leading pitches
// multiples of 16 bytes, K and x's pitch whole vectors), else byte by byte.
// shape[gSplits] blocks of shape[gSteps] 16-row k-steps a strip, one cluster.
extern "C" int fat_w8_group(const void* x, const int64_t* ptrs, const int64_t* shape, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  GroupParams p{};
  p.count = static_cast<int>(shape[gCount]);
  p.x = x;
  p.M = shape[gM];
  p.K = shape[gK];
  p.ldx = shape[gLdx];
  p.scaled = static_cast<int>(shape[gScaled]);
  p.out_f32 = static_cast<int>(shape[gOutF32]);
  p.splits = static_cast<int>(shape[gSplits]);
  p.steps = static_cast<int>(shape[gSteps]);
  const bool vec = shape[gVec] != 0;
  const int xt = static_cast<int>(shape[gXT]);
  if (p.count < 1 || p.count > W1_GROUP || p.splits < 1 || p.splits > W1_MAX_SPLITS || p.steps < 1 ||
      (dtype != fat::kBFloat16 && dtype != fat::kFloat16)) {
    return cudaErrorInvalidValue;
  }
  int items = 0;
  for (int i = 0; i < p.count; ++i) {
    GroupWeight& g = p.wt[i];
    const int64_t* s = shape + gHead + gPer * i;
    g.w = reinterpret_cast<const int8_t*>(ptrs[3 * i]);
    g.scales = reinterpret_cast<const float*>(ptrs[3 * i + 1]);
    g.out = reinterpret_cast<void*>(ptrs[3 * i + 2]);
    g.N = s[gN];
    g.ldw = s[gLdw];
    g.ldo = s[gLdo];
    g.strips = static_cast<int>((g.N + KN_COLS - 1) / KN_COLS);
    items += g.strips;
    if (vec && !map_2d(&g.tm, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.N, p.K, g.ldw, KN_COLS, 16 * W1_WARPS,
                       CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return cudaErrorInvalidValue;
    }
  }
  const int groups = static_cast<int>((p.M + 8 * xt - 1) / (8 * xt));
  return by_tiles(xt, [&](auto xt_tag) -> cudaError_t {
    constexpr int XT = decltype(xt_tag)::value;
    if (dtype == fat::kBFloat16) {
      return vec ? launch_group<bf16, XT, true>(p, items, groups, st) : launch_group<bf16, XT, false>(p, items, groups, st);
    }
    return vec ? launch_group<__half, XT, true>(p, items, groups, st) : launch_group<__half, XT, false>(p, items, groups, st);
  });
}
