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
//    to the output type (x's, or fp32).
// Two layouts as they lie in memory, each with its leading stride: [K, N]
// with N contiguous (the layer weights, and a tensor-parallel shard's
// strided view of them) and [N, K] with K contiguous (the embedding).
//
// What bounds them on this card: at decode (M <= 32 rows) the weight's
// bytes, K * N at 3.35 TB/s (a decode step of ModelConfig() streams 5.8 GB:
// 1.73 ms); at a prefill chunk (M = 256 and up) the products, 2 M N K at
// 989 TFLOP/s.
//
// W1, w8_gemv_kernel (bf16 / fp16 activations): a weight stream into
// shared memory, W1_STAGES steps ahead of the widen. Each lane reads 16
// bytes at a time from there and widens them in registers into the A
// fragments of mma.sync m16n8k16 (the weight is A: 16 output columns by 16
// k; up to 32 rows of x are B, 8 a tile), so the tensor cores do the
// multiply-adds and the lanes only widen (about three integer and float
// operations an element: an int8 code becomes an exact float by the
// 0x4B000000 magic-number add, two are packed into a bf16 pair, one
// mul.rn.bf16x2 scales the pair). The product sums over k in any order, so
// the k of the fragments is permuted to what one 16-byte read holds:
//  * [K, N]: a lane reads four k rows (16 columns each); a warp covers 128
//    columns and a block's eight warps split its k range, reduced in shared
//    memory in warp order. Each warp streams its k-steps (16 rows by 128
//    bytes) by TMA into a ring of its own, 128-byte swizzled so the lanes'
//    reads spread over the banks: 1.7 TB/s at w_gate against 0.8-1.3 by
//    per-lane cp.async or plain 16-byte loads with the same compute. The
//    K axis is split over blocks as well where N / 128 column strips leave the
//    card idle (wo, w_down: N = 4096); each split writes an fp32 partial and
//    the last block of a strip to finish (a ticket counter, left at 0) adds
//    the partials in split order, so a call gives the same bits every time
//    and under a graph's replay.
//  * [N, K]: a warp owns 16 weight rows over the whole of K (the unembed's
//    32,000 rows are 2,000 warps: no split); each lane copies its bytes
//    (cp.async) into shared-memory slots of its own.
// fp32 activations take w8_gemv_fma_kernel: one thread a column, eight x
// rows a block row, FMAs (the tiny fp32 configurations).
//
// W2, w8_gemm_kernel (bf16 / fp16 activations, M above W1's rows): wgmma.
// A block owns 64 rows by 128 columns; the x tile (128-byte swizzle) and the
// int8 weight tile come by TMA into a four-stage ring, and the block
// widens each int8 tile into a swizzled 16-bit tile (MN-major for [K, N],
// read with wgmma's transpose flag; K-major for [N, K]) while the tensor
// cores run the previous k-block's m64n128k16 chain from the other widened
// buffer; a block's two warpgroups widen, the first also multiplies. The
// epilogue scales (on the output) and rounds the fp32 accumulators. Not yet
// at the compute bound.
#include <cuda.h>

#include "common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;
using bf16 = __nv_bfloat16;

constexpr int W1_THREADS = 256;
constexpr int W1_WARPS = W1_THREADS / 32;
constexpr int KN_COLS = 128;  // [K, N]: columns a strip (a warp, 16 a lane group)
constexpr int NK_ROWS = 16;   // [N, K]: weight rows a warp
constexpr int NK_WARPS = 4;   // [N, K]: warps a block (the unembed's 32,000 rows: 500 blocks)
// W1's weight stream runs W1_STAGES k-steps (k-blocks for [N, K]) ahead of
// the widen: per warp by TMA for [K, N], per lane by cp.async for [N, K].
constexpr int W1_STAGES = 4;  // a power of two
constexpr int NK_PIECES = 2;  // [N, K]: a k-block (rows g and g + 8)
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


struct GemvParams {
  CUtensorMap tm_w;  // [K, N] with VEC: the weight as [K rows, N bytes], boxes of 16 rows by 128, 128-byte swizzle
  const void* x;  // [M, K] at row stride ldx
  const int8_t* w;
  const float* scales;  // [N]
  void* out;            // [M, N] at row stride ldo
  float* ws;            // splits > 1: each block's fp32 partial, in fragment order
  int32_t* tickets;     // splits > 1: a counter a (row group, strip), 0 between launches
  int64_t M, N, K, ldx, ldw, ldo;
  int nk, scaled, out_f32, splits, steps;  // steps: 16-row k-steps a split
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
__device__ __forceinline__ void store_out(const GemvParams& p, int64_t m, int64_t n, float v) {
  if (m >= p.M || n >= p.N) return;
  if (!p.scaled) v = __fmul_rn(v, __ldg(p.scales + n));
  if (p.out_f32) {
    static_cast<float*>(p.out)[m * p.ldo + n] = v;
  } else {
    static_cast<T*>(p.out)[m * p.ldo + n] = fat::from_float<T>(v);
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

// grid: [K, N]: (column strips, splits, row groups); [N, K]: (row blocks of
// 8 warps x 16 rows, 1, row groups). XT: 8-row x tiles a row group.
template <typename T, bool NK, int XT, bool VEC>
__global__ void __launch_bounds__(W1_THREADS) w8_gemv_kernel(const __grid_constant__ GemvParams p) {
  constexpr int TILES = NK ? 1 : 8;  // m-tiles a warp
  constexpr int PIECES = NK_PIECES;
  __shared__ float red[XT * TILES * 4 * 32];
  __shared__ int s_last;
  constexpr int THREADS = NK ? NK_WARPS * 32 : W1_THREADS;
  extern __shared__ __align__(1024) uint8_t w1_smem[];
  // [N, K]: [W1_STAGES][PIECES][THREADS] 16-byte slots, each lane's own.
  uint4* const lane_ring = reinterpret_cast<uint4*>(w1_smem) + threadIdx.x;  // slot (stage, piece) at + (stage * PIECES + piece) * THREADS
  __shared__ uint64_t full_bar[NK ? 1 : W1_WARPS][W1_STAGES];  // [K, N]: each warp's TMA ring
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
  float acc[XT][TILES][4];
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;

  int64_t col0;
  if constexpr (!NK) {
    // ---- [K, N]: a strip of 128 columns, k-steps of 16 rows ----
    col0 = static_cast<int64_t>(blockIdx.x) * KN_COLS;
    const int64_t ncol = col0 + 16 * g;
    const bool col_ok = ncol < p.N;
    const int ksteps = static_cast<int>((p.K + 15) / 16);
    const int s_begin = static_cast<int>(blockIdx.y) * p.steps, s_end = min(ksteps, s_begin + p.steps);
    const int first = s_begin + warp;  // the warp's k-steps: first + 8 i, step i in slot i % W1_STAGES
    // This lane's first k row (4c of step `first`), and the bytes from one of its steps to the next.
    // [K, N] with VEC: each warp streams its k-steps (16 rows by the strip's
    // 128 bytes, 2 KB) by TMA into a ring of W1_STAGES tiles of its own,
    // 128-byte swizzled; lane 0 issues, every lane waits on the tile's
    // barrier. Otherwise each lane loads its bytes one by one.
    uint8_t* const tiles = align_1024(w1_smem) + warp * (W1_STAGES * 2048);
    uint64_t* const bars = full_bar[NK ? 0 : warp];
    auto issue = [&](int i) {  // lane 0: step i of the warp into tile i % W1_STAGES
      const int st = first + W1_WARPS * i;
      if (st < s_end) {
        uint64_t* bar = &bars[i & (W1_STAGES - 1)];
        mbar_expect(bar, 2048);
        tma_load_2d(tiles + (i & (W1_STAGES - 1)) * 2048, &p.tm_w, static_cast<int>(col0), st * 16, bar);
      }
    };
    if constexpr (VEC) {
      if (lane == 0) {
        for (int s = 0; s < W1_STAGES; ++s) mbar_init(&bars[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int i = 0; i < W1_STAGES; ++i) issue(i);
      }
      __syncwarp();
    }
    // x's pairs of step i (registers), loaded a step ahead.
    auto fetch_x = [&](uint32_t (&b)[XT][2], int i) {
      const int st = first + W1_WARPS * i;
#pragma unroll
      for (int j = 0; j < XT; ++j) load_x<2, VEC>(b[j], xrow[j], st * 16 + 4 * c, p.K, xok[j] && st < s_end);
    };
    uint32_t b_next[XT][2];
    fetch_x(b_next, 0);
    uint32_t sc[16];  // the lane's 16 columns' bf16 scales, paired; read under the first copies
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float s = ncol + i < p.N ? __ldg(p.scales + ncol + i) : 0.f;
      sc[i] = bf16_pair(s, s);
    }
    for (int i = 0; first + W1_WARPS * i < s_end; ++i) {
      uint32_t b[XT][2];
#pragma unroll
      for (int j = 0; j < XT; ++j) b[j][0] = b_next[j][0], b[j][1] = b_next[j][1];
      fetch_x(b_next, i + 1);
      uint4 w4[4];
      if constexpr (VEC) {
        mbar_wait(&bars[i & (W1_STAGES - 1)], (i / W1_STAGES) & 1);
        const uint8_t* tile = tiles + (i & (W1_STAGES - 1)) * 2048;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * c + r;  // the lane's rows of the step, chunk g, as TMA swizzled them
          const uint4 v = *reinterpret_cast<const uint4*>(tile + row * 128 + ((g ^ (row & 7)) << 4));
          w4[r] = make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u, v.w ^ 0x80808080u);
        }
        __syncwarp();
        if (lane == 0) {
          fence_proxy_async();  // the tile's reads before the copy that refills it
          issue(i + W1_STAGES);
        }
      } else {
        const int k0 = (first + W1_WARPS * i) * 16 + 4 * c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint4 v = load16<false>(p.w + (k0 + r) * p.ldw + ncol, col_ok && k0 + r < p.K, p.N - ncol);
          w4[r] = make_uint4(v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u, v.w ^ 0x80808080u);
        }
      }
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
  } else {
    // ---- [N, K]: 16 weight rows a warp, k-blocks of 64 ----
    const int64_t r0 = (static_cast<int64_t>(blockIdx.x) * NK_WARPS + warp) * NK_ROWS;
    col0 = r0;
    const int64_t na = r0 + g, nb = r0 + g + 8;
    const float s_a = na < p.N ? __ldg(p.scales + na) : 0.f, s_b = nb < p.N ? __ldg(p.scales + nb) : 0.f;
    const uint32_t sa = bf16_pair(s_a, s_a), sb = bf16_pair(s_b, s_b);
    const int8_t* wa = p.w + (na < p.N ? na : 0) * p.ldw;
    const int8_t* wb = p.w + (nb < p.N ? nb : 0) * p.ldw;
    if (r0 < p.N) {
      // k-block i (k from 64 i) sits in slot i % W1_STAGES.
      auto fetch = [&](int i) {
        const int k = 64 * i + 16 * c;  // this lane's 16 k
        const bool ok = k < p.K;
        uint4* dst = lane_ring + (i & (W1_STAGES - 1)) * PIECES * THREADS;
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
      for (int i = 0; i < W1_STAGES - 1; ++i) fetch(i);
      uint32_t x_next[XT][8];
      fetch_x(x_next, 0);
      for (int i = 0; 64 * i < p.K; ++i) {
        fetch(i + W1_STAGES - 1);
        uint32_t xb[XT][8];
#pragma unroll
        for (int j = 0; j < XT; ++j)
#pragma unroll
          for (int u = 0; u < 8; ++u) xb[j][u] = x_next[j][u];
        fetch_x(x_next, i + 1);
        async_wait<W1_STAGES - 1>();
        const uint4* slot = lane_ring + (i & (W1_STAGES - 1)) * PIECES * THREADS;
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
          for (int j = 0; j < XT; ++j) mma<T>(acc[j][0], a, xb[j][2 * s], xb[j][2 * s + 1]);
        }
      }
      async_wait<0>();
    }
    // [N, K] warps are independent: each writes its own rows.
#pragma unroll
    for (int j = 0; j < XT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int64_t m, n;
        place<true>(0, j, e, g, c, col0, row0, m, n);
        store_out<T>(p, m, n, acc[j][0][e]);
      }
    return;
  }

  // ---- [K, N]: the block's eight warps reduced in warp order ----
  constexpr int PER = XT * TILES * 4;  // accumulators a lane
  for (int w = 0; w < W1_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < XT; ++j)
#pragma unroll
        for (int t = 0; t < TILES; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& slot = red[((j * TILES + t) * 4 + e) * 32 + lane];
            slot = w == 0 ? acc[j][t][e] : __fadd_rn(slot, acc[j][t][e]);
          }
    }
    __syncthreads();
  }
  const int64_t group = static_cast<int64_t>(blockIdx.z) * gridDim.x + blockIdx.x;  // (row group, strip)
  if (p.splits > 1) {
    float* part = p.ws + (group * p.splits + blockIdx.y) * (PER * 32);
    for (int i = threadIdx.x; i < PER * 32; i += W1_THREADS) part[i] = red[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      int* ticket = p.tickets + group;
      s_last = atomicAdd(ticket, 1) == p.splits - 1;
      if (s_last) *ticket = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }
  for (int i = threadIdx.x; i < PER * 32; i += W1_THREADS) {
    float v = red[i];
    if (p.splits > 1) {
      const float* parts = p.ws + group * p.splits * (PER * 32) + i;
      // Eight partials' loads in flight at a time, added in split order.
      for (int s0 = 0; s0 < p.splits; s0 += 8) {
        float part[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          part[u] = s0 + u < p.splits ? __ldcg(parts + static_cast<int64_t>(s0 + u) * PER * 32) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (s0 + u < p.splits) v = s0 + u == 0 ? part[u] : __fadd_rn(v, part[u]);
        }
      }
    }
    const int l = i % 32, idx = i / 32, e = idx % 4, t = (idx / 4) % TILES, j = idx / (4 * TILES);
    int64_t m, n;
    place<false>(t, j, e, l / 4, l % 4, col0, row0, m, n);
    store_out<T>(p, m, n, v);
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

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int W2_THREADS = 256;  // two warpgroups widen; the first multiplies
constexpr int STAGES = 4;  // the TMA ring: k-blocks in flight ahead of the widen
constexpr int X_TILE = BM * BK * 2;  // bytes of a 16-bit x tile
constexpr int W8_TILE = BK * BN;      // bytes of an int8 weight tile
constexpr int WIDE_TILE = BK * BN * 2;
constexpr size_t W2_SMEM = 1024 + STAGES * (X_TILE + W8_TILE) + 2 * WIDE_TILE + 2 * BN * 4 + STAGES * 8;

struct GemmParams {
  CUtensorMap tm_x, tm_w;
  const float* scales;
  void* out;
  int M, N, K;
  int64_t ldo;
  int scaled, out_f32;
};


// D[64 x 128] += A B, A K-major in shared memory, B K-major (TB 0) or
// MN-major (TB 1, read with the transpose flag).
template <typename T, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (std::is_same_v<T, bf16>) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %66;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "n"(TB), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %66;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "n"(TB), "r"(1));
  }
}

// The int8 tile of a stage widened into the swizzled 16-bit tile the B
// descriptors read: [N, K] as [BN rows n][BK k] K-major (one 128-byte
// chunk a row); [K, N] as [BK rows k][BN n] MN-major in two 64-column chunks.
// Eight codes (8 bytes) a unit, 16 bytes written.
// s_pair: the block's bf16 scales as pairs, [N, K]: (s[n], s[n]) by row n;
// [K, N]: (s[2i], s[2i + 1]) by i.
template <typename T, bool NK>
__device__ __forceinline__ void widen_tile(const uint8_t* src, uint8_t* dst, const uint32_t* s_pair, bool scaled,
                                           int tid) {
#pragma unroll 2
  for (int u = tid; u < BK * BN / 8; u += W2_THREADS) {
    int lin, chunk;
    uint2 raw;
    uint4 s2;
    if constexpr (NK) {
      const int n = u / (BK / 8), k8 = u % (BK / 8) * 8;
      raw = *reinterpret_cast<const uint2*>(src + n * BK + k8);
      lin = n * 128 + k8 * 2;
      chunk = 0;
      s2 = make_uint4(s_pair[n], s_pair[n], s_pair[n], s_pair[n]);
    } else {
      const int k = u / (BN / 8), n8 = u % (BN / 8) * 8;
      raw = *reinterpret_cast<const uint2*>(src + k * BN + n8);
      lin = k * 128 + (n8 % 64) * 2;
      chunk = n8 / 64;
      s2 = *reinterpret_cast<const uint4*>(s_pair + n8 / 2);
    }
    const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
    uint4 w;
    w.x = widen<T>(code<0>(lo), code<1>(lo), s2.x, scaled);
    w.y = widen<T>(code<2>(lo), code<3>(lo), s2.y, scaled);
    w.z = widen<T>(code<0>(hi), code<1>(hi), s2.z, scaled);
    w.w = widen<T>(code<2>(hi), code<3>(hi), s2.w, scaled);
    *reinterpret_cast<uint4*>(dst + chunk * BK * 128 + (lin ^ (((lin >> 7) & 7) << 4))) = w;
  }
}

// grid (row tiles of 64, column tiles of 128), two warpgroups.
template <typename T, bool NK>
__global__ void __launch_bounds__(W2_THREADS, 1) w8_gemm_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align_1024(smem_raw);    // STAGES stages of the x tile
  uint8_t* w8 = xs + STAGES * X_TILE;    // STAGES stages of the int8 tile
  uint8_t* wide = w8 + STAGES * W8_TILE;  // 2 widened tiles
  float* s_scale = reinterpret_cast<float*>(wide + 2 * WIDE_TILE);
  uint32_t* s_pair = reinterpret_cast<uint32_t*>(s_scale + BN);
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_pair + BN);
  const int tid = threadIdx.x;
  const bool mma_wg = tid < 128;  // the warpgroup that multiplies
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nkb = (p.K + BK - 1) / BK;

  if (tid == 0) {
    prefetch_map(&p.tm_x);
    prefetch_map(&p.tm_w);
    for (int st = 0; st < STAGES; ++st) mbar_init(&bar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += W2_THREADS) s_scale[i] = n0 + i < p.N ? __ldg(p.scales + n0 + i) : 0.f;
  __syncthreads();
  for (int i = tid; i < BN; i += W2_THREADS) {
    s_pair[i] = NK ? bf16_pair(s_scale[i], s_scale[i]) : (i < BN / 2 ? bf16_pair(s_scale[2 * i], s_scale[2 * i + 1]) : 0u);
  }
  __syncthreads();
  auto load = [&](int kb) {
    const int st = kb % STAGES;
    mbar_expect(&bar[st], X_TILE + W8_TILE);
    tma_load_2d(xs + st * X_TILE, &p.tm_x, kb * BK, m0, &bar[st]);
    if constexpr (NK) {
      tma_load_2d(w8 + st * W8_TILE, &p.tm_w, kb * BK, n0, &bar[st]);
    } else {
      tma_load_2d(w8 + st * W8_TILE, &p.tm_w, n0, kb * BK, &bar[st]);
    }
  };
  if (tid == 0) {
    for (int kb = 0; kb < STAGES && kb < nkb; ++kb) load(kb);
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  mbar_wait(&bar[0], 0);
  widen_tile<T, NK>(w8, wide, s_pair, p.scaled, tid);
  fence_proxy_async();
  __syncthreads();
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % STAGES, wi = kb & 1;  // the ring's stage, the widened buffer
    const uint32_t xa = smem_u32(xs + st * X_TILE), wb = smem_u32(wide + wi * WIDE_TILE);
    if (mma_wg) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (NK) {
          wgmma_n128<T, 0>(d, desc_k<64, BM>(xa, 0, kk), desc_k<64, BN>(wb, 0, kk));
        } else {
          wgmma_n128<T, 1>(d, desc_k<64, BM>(xa, 0, kk), desc_mn<BN, BK>(wb, kk));
        }
      }
      wg_commit();
    }
    if (kb + 1 < nkb) {
      // The next k-block's widen runs under this one's products.
      const int nst = (kb + 1) % STAGES;
      mbar_wait(&bar[nst], ((kb + 1) / STAGES) & 1);
      widen_tile<T, NK>(w8 + nst * W8_TILE, wide + (wi ^ 1) * WIDE_TILE, s_pair, p.scaled, tid);
      fence_proxy_async();
    }
    if (mma_wg) {
      wg_wait_all();
      fence_regs(d);
    }
    __syncthreads();
    if (tid == 0 && kb + STAGES < nkb) load(kb + STAGES);  // stage st is free: its x tile read, its int8 tile widened
  }

  if (!mma_wg) return;
  const int warp = tid / 32, g = (tid % 32) / 4, c = tid % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 16 * warp + g + 8 * h, nl = 8 * j + 2 * c + e, n = n0 + nl;
        if (m >= p.M || n >= p.N) continue;
        float v = d[4 * j + 2 * h + e];
        if (!p.scaled) v = __fmul_rn(v, s_scale[nl]);
        if (p.out_f32) {
          static_cast<float*>(p.out)[m * p.ldo + n] = v;
        } else {
          static_cast<T*>(p.out)[m * p.ldo + n] = fat::from_float<T>(v);
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
enum Shape : int { kM, kN, kK, kLdx, kLdw, kLdo, kNK, kScaled, kOutF32, kKernel, kXT, kSplits, kSteps, kVec, kShapeLen };

template <typename T, bool NK, int XT, bool VEC>
cudaError_t launch_w1(const GemvParams& p, cudaStream_t stream) {
  const int64_t groups = (p.M + 8 * XT - 1) / (8 * XT);
  const dim3 grid = NK ? dim3(static_cast<unsigned>((p.N + NK_WARPS * NK_ROWS - 1) / (NK_WARPS * NK_ROWS)), 1,
                              static_cast<unsigned>(groups))
                       : dim3(static_cast<unsigned>((p.N + KN_COLS - 1) / KN_COLS), static_cast<unsigned>(p.splits),
                              static_cast<unsigned>(groups));
  const int threads = NK ? NK_WARPS * 32 : W1_THREADS;
  // [N, K]: each lane's cp.async slots; [K, N]: each warp's TMA tiles, 1024-aligned.
  const int ring = NK ? W1_STAGES * NK_PIECES * threads * 16 : 1024 + W1_WARPS * W1_STAGES * 2048;
  const cudaError_t err = fat::reserve_smem(w8_gemv_kernel<T, NK, XT, VEC>, ring);
  if (err != cudaSuccess) return err;
  w8_gemv_kernel<T, NK, XT, VEC><<<grid, threads, ring, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool NK>
cudaError_t w1_by_tiles(const GemvParams& p, int xt, bool vec, cudaStream_t stream) {
  auto by_vec = [&](auto xt_tag) -> cudaError_t {
    constexpr int XT = decltype(xt_tag)::value;
    return vec ? launch_w1<T, NK, XT, true>(p, stream) : launch_w1<T, NK, XT, false>(p, stream);
  };
  switch (xt) {
    case 1: return by_vec(std::integral_constant<int, 1>{});
    case 2: return by_vec(std::integral_constant<int, 2>{});
    case 4: return by_vec(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool NK>
cudaError_t launch_w2(const void* x, const void* w, const float* scales, void* out, const int64_t* s, int dtype,
                      cudaStream_t stream) {
  GemmParams p{};
  const CUtensorMapDataType xtype =
      dtype == fat::kBFloat16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (!map_2d(&p.tm_x, x, xtype, 2, s[kK], s[kM], s[kLdx], BK, BM, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  const bool ok = NK ? map_2d(&p.tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, s[kK], s[kN], s[kLdw], BK, BN,
                              CU_TENSOR_MAP_SWIZZLE_NONE)
                     : map_2d(&p.tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, s[kN], s[kK], s[kLdw], BN, BK,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  p.scales = scales;
  p.out = out;
  p.M = static_cast<int>(s[kM]);
  p.N = static_cast<int>(s[kN]);
  p.K = static_cast<int>(s[kK]);
  p.ldo = s[kLdo];
  p.scaled = static_cast<int>(s[kScaled]);
  p.out_f32 = static_cast<int>(s[kOutF32]);
  cudaError_t err = fat::reserve_smem(w8_gemm_kernel<T, NK>, static_cast<int>(W2_SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM), static_cast<unsigned>((p.N + BN - 1) / BN));
  w8_gemm_kernel<T, NK><<<grid, W2_THREADS, W2_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] (row pitch ldx, of `dtype`) times the int8 weight w ([K, N] or,
// with shape[kNK], [N, K], leading pitch ldw) widened by its fp32 scales
// [N], into out [M, N] (row pitch ldo; fp32 with shape[kOutF32], else
// dtype). shape[kKernel]: 1 for W1 (with shape[kXT] x tiles, shape[kSplits]
// splits of shape[kSteps] k-steps over ws and tickets), 2 for W2.
extern "C" int fat_w8_matmul(const void* x, const void* w, const float* scales, void* out, float* ws,
                             int32_t* tickets, const int64_t* shape, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool nk = shape[kNK] != 0;
  if (shape[kKernel] == 2) {
    if (dtype == fat::kBFloat16) return nk ? launch_w2<bf16, true>(x, w, scales, out, shape, dtype, st)
                                           : launch_w2<bf16, false>(x, w, scales, out, shape, dtype, st);
    if (dtype == fat::kFloat16) return nk ? launch_w2<__half, true>(x, w, scales, out, shape, dtype, st)
                                          : launch_w2<__half, false>(x, w, scales, out, shape, dtype, st);
    return cudaErrorInvalidValue;
  }
  GemvParams p{};
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.scales = scales;
  p.out = out;
  p.ws = ws;
  p.tickets = tickets;
  p.M = shape[kM];
  p.N = shape[kN];
  p.K = shape[kK];
  p.ldx = shape[kLdx];
  p.ldw = shape[kLdw];
  p.ldo = shape[kLdo];
  p.nk = static_cast<int>(nk);
  p.scaled = static_cast<int>(shape[kScaled]);
  p.out_f32 = static_cast<int>(shape[kOutF32]);
  p.splits = static_cast<int>(shape[kSplits]);
  p.steps = static_cast<int>(shape[kSteps]);
  if (p.splits < 1 || (p.splits > 1 && (ws == nullptr || tickets == nullptr || nk))) return cudaErrorInvalidValue;
  const int xt = static_cast<int>(shape[kXT]);
  const bool vec = shape[kVec] != 0;
  if (!nk && vec && dtype != fat::kFloat32 &&
      !map_2d(&p.tm_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.N, p.K, p.ldw, 128, 16, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case fat::kFloat32: {
      const dim3 grid(static_cast<unsigned>((p.N + FMA_THREADS - 1) / FMA_THREADS),
                      static_cast<unsigned>((p.M + FMA_ROWS - 1) / FMA_ROWS));
      w8_gemv_fma_kernel<<<grid, FMA_THREADS, 0, st>>>(p);
      return cudaGetLastError();
    }
    case fat::kBFloat16: return nk ? w1_by_tiles<bf16, true>(p, xt, vec, st) : w1_by_tiles<bf16, false>(p, xt, vec, st);
    case fat::kFloat16: return nk ? w1_by_tiles<__half, true>(p, xt, vec, st) : w1_by_tiles<__half, false>(p, xt, vec, st);
    default: return cudaErrorInvalidValue;
  }
}
