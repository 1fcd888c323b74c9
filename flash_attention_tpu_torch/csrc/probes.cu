// P1-P6: the TPU kernel probes of the repository's tools/ as two bodies for
// Hopper whose two products, S = Q K^T and P V, run on tensor cores
// (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, operands fed from
// shared memory by ldmatrix, .trans for V). bf16 inputs [heads, seq, 128],
// contiguous; bf16 output of the same shape. Only head_dim 128 and bf16 are
// instantiated: the probes' only shapes.
//
// Replaces tools/softmax_probe.py:make_fn (P1), tools/grid_probe.py:make_call
// (P3) and tools/causal_probe.py:make_fn (P4) with body T, and
// tools/mfu_probe.py:probe_kernel / perhead_kernel (P2),
// tools/gap_probe.py:single_step_kernel (P5) and tools/epilogue_probe.py:kernel
// (P6) with body S. Each body computes what its TPU kernels compute; the
// Python side (flash_attention_tpu_torch/tools/probes.py) holds every
// variant against a plain PyTorch version of the same function.
//
// Body T, tiled with an online softmax (P1, P3, P4). A block of BM / 16
// warps takes one (head, BM-row q tile); each warp owns 16 q rows. The kv
// tiles of BN rows are a loop inside the block (the TPU grid's sequential
// "arbitrary" axis), double-buffered through shared memory by cp.async; m,
// l and the fp32 accumulator live in registers, and the scores never leave
// them: the S fragments of QK^T are, after the softmax, the A fragments of
// PV. Compile-time variants:
//  * ARITH: the softmax in fp32, or as softmax_probe.py's bf16 variant does
//    it (scores rounded to bf16 after QK^T, mask value -0.7 * bf16 max, row
//    max into fp32 m, p = exp2(s - bf16(m)) in bf16 by h2exp2, row sum in
//    fp32);
//  * SKIP: the kv loop stops at the tile holding the block's last row
//    (causal tile skipping; the TPU clamped its index map and ran pl.when);
//  * MASK: none, always (every tile takes the causal iota mask) or cond
//    (only tiles whose last column passes the block's first row, a branch
//    uniform over the block). Without SKIP, none is wrong by design for a
//    causal probe, as in causal_probe.py;
//  * BM x BN: 64x64, 128x64, 64x128, 128x128, in place of the TPU's 256-2048
//    row VMEM blocks;
//  * GRID, the block order, standing in for grid_probe.py's dimension
//    semantics: head-major 2-D (head = blockIdx.y, q tile = blockIdx.x:
//    neighbouring blocks share K/V in L2; the "par" column), q-tile-major
//    2-D (the two swapped: neighbouring blocks are different heads; the
//    "arb" column, whose sequential order the card has no counterpart of),
//    and one collapsed 1-D grid deriving both indices by a division in the
//    kernel (the "2d" column, whose index maps did the same).
// Only the combinations the probes run are instantiated: every (SKIP, MASK)
// in fp32 head-major, bf16 unmasked or skip + always, and the other two
// grid orders unmasked in fp32.
//
// Body S, one pass over the whole row with no rescale (P2, P5, P6). The row
// max is taken over all seq columns before any exp2 and floored at
// M_FLOOR, as the TPU bodies do over their [hb, S, S] block. A block of 8
// warps holds 32 q rows' fp32 scores [32][seq] in shared memory (132 KB at
// seq 1024; the 227 KB a block may use does not hold 64 rows): warps (rg,
// wc) = (w % 2, w / 2) compute QK^T for row group rg over a quarter of each
// 128-row kv stage and store the fragments (masked by their own row and
// column, from the accumulator map) into that array; then all 256 threads
// make the row passes over it, 8 threads a row (max; exp2 in place and the
// sum); then each warp runs PV for its 16 rows and a quarter of head_dim,
// reading its A fragments from the array. The scores go through shared
// memory in every stage, mma included, so the stage breakdown prices the
// passes over an on-chip score tile as the TPU's did over VMEM; QK^T is
// computed once. Compile-time variants:
//  * STAGE: mma (p = bf16(s)), max (p = bf16(s - m)), softmax (p =
//    exp2(s * scale2 - m)), as mfu_probe.py's stages;
//  * EPI, where 1/l goes: none (no normalise; mfu_probe.py's exp2 stage),
//    before_pv (p * inv before PV; mfu_probe.py's full), after_pv (PV * inv;
//    the shipped K1 and gap_probe.py), after_pv_noguard (PV / l),
//    after_pv_bf16 (bf16(PV) * bf16(inv) in bf16), as epilogue_probe.py;
//  * MASK: full plus the causal iota mask (mfu_probe.py's mask stage);
//  * HB: 1, the block's 32 rows from one head, or 2 (mfu_probe.py's
//    perhead): 16 rows from each of two heads, whose kv stages (64 rows of
//    each head) and products interleave in one loop, so a block carries two
//    independent chains; the TPU probe asked Mosaic the same question by
//    unrolling its batched dot per head.
//
// What bounds them on this card: at seq >= 512 and head_dim 128 the
// products are O(seq^2 * 128) against O(seq * 128) bytes, so arithmetic
// bounds them (989 TFLOP/s dense bf16). The probes measure what stands
// between a body and that bound: the softmax passes (P2, P1), the masking
// and the skipped tiles (P4), the block shape and order (P3), the host
// wrapper (P5) and the epilogue (P6). mma.sync is the Ampere-era path to
// the tensor cores, the source reference's own; wgmma and TMA, the only way
// to the full rate, are a later step.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 128;       // head_dim, the probes' only width
constexpr int LD = D + 8;    // shared-memory row stride in bf16: 272 bytes, so ldmatrix rows hit distinct banks
constexpr float MASK_VALUE_BF16 = -0.7f * 3.3895313892515355e38f;

enum Arith : int { kF32 = 0, kBF16 = 1 };
enum Mask : int { kNone = 0, kAlways = 1, kCond = 2 };
enum Grid : int { kHeadMajor = 0, kQTileMajor = 1, kFlat = 2 };
enum Stage : int { kMma = 0, kMax = 1, kSoftmax = 2 };
enum Epi : int { kNoNorm = 0, kBeforePV = 1, kAfterPV = 2, kAfterPVNoGuard = 3, kAfterPVBf16 = 4 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b on one 16x8x16 tile. Fragments (g = lane / 4, t = lane % 4): a0
// (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g, k 2t+8..), a3 (row
// g+8, k 2t+8..); b0 (k 2t.., col g), b1 (k 2t+8.., col g); c0, c1 (row g,
// cols 2t, 2t+1), c2, c3 (row g+8, same cols).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) { return bits(__floats2bfloat162_rn(lo, hi)); }

// R rows of 128 bf16 from contiguous global rows into shared rows of stride LD.
template <int R, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int tid) {
#pragma unroll
  for (int c = tid; c < R * (D / 8); c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    cp_async16(dst + r * LD + col, src + static_cast<int64_t>(r) * D + col);
  }
}

// The A fragment of k step kk from 16 shared rows.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows16, int kk, int lane) {
  ldmatrix_x4(a, rows16 + (lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// s[n] += A_kk K^T over NS n-tiles of 8 kv rows from k_rows: two n-tiles per ldmatrix.
template <int NS>
__device__ __forceinline__ void qk_step(float (&s)[NS][4], const uint32_t (&a)[4], const bf16* k_rows, int kk,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < NS; n += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, k_rows + (n * 8 + lane % 8 + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
    mma_bf16(s[n], a, b[0], b[1]);
    mma_bf16(s[n + 1], a, b[2], b[3]);
  }
}

// acc[n] += A V over NO n-tiles of 8 head_dim columns; v_rows is the 16 kv
// rows of this k step, at its first column.
template <int NO>
__device__ __forceinline__ void pv_step(float (&acc)[NO][4], const uint32_t (&a)[4], const bf16* v_rows, int lane) {
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, v_rows + (lane % 8 + ((lane / 8) % 2) * 8) * LD + n * 8 + (lane / 16) * 8);
    mma_bf16(acc[n], a, b[0], b[1]);
    mma_bf16(acc[n + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(fat::FULL_MASK, x, 1);
  return x + __shfl_xor_sync(fat::FULL_MASK, x, 2);
}

struct ProbeParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int heads;
  int seq;
  float scale2;  // body S: sm_scale * log2(e); body T takes q already scaled (P1) or unscaled (P3, P4)
};

// ---------------------------------------------------------------- body T

template <int BM, int BN>
constexpr size_t tiled_smem() {
  return static_cast<size_t>(BM + 4 * BN) * LD * sizeof(bf16);  // Q, then K and V double-buffered
}

template <int BM, int BN, int ARITH, bool SKIP, int MASK, int GRID>
__global__ void __launch_bounds__(BM * 2) tiled_kernel(const ProbeParams p) {
  constexpr int THREADS = BM * 2;  // BM / 16 warps
  constexpr int NS = BN / 8;       // score n-tiles of a warp
  constexpr int NO = D / 8;        // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + BM * LD;
  bf16* sv = sk + 2 * BN * LD;

  const int nq = p.seq / BM;
  int head, iq;
  if constexpr (GRID == kHeadMajor) {
    iq = blockIdx.x;
    head = blockIdx.y;
  } else if constexpr (GRID == kQTileMajor) {
    head = blockIdx.x;
    iq = blockIdx.y;
  } else {
    head = blockIdx.x / nq;
    iq = blockIdx.x - head * nq;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int64_t hoff = static_cast<int64_t>(head) * p.seq * D;
  const bf16* kh = p.k + hoff;
  const bf16* vh = p.v + hoff;
  const int nkv = SKIP ? ((iq + 1) * BM - 1) / BN + 1 : p.seq / BN;

  copy_rows<BM, THREADS>(sq, p.q + hoff + static_cast<int64_t>(iq) * BM * D, tid);
  copy_rows<BN, THREADS>(sk, kh, tid);
  copy_rows<BN, THREADS>(sv, vh, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const int row0 = iq * BM + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const bf16* q_rows = sq + warp * 16 * LD;

  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) {
      const int b = (j + 1) % 2;
      copy_rows<BN, THREADS>(sk + b * BN * LD, kh + static_cast<int64_t>(j + 1) * BN * D, tid);
      copy_rows<BN, THREADS>(sv + b * BN * LD, vh + static_cast<int64_t>(j + 1) * BN * D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ck = sk + (j % 2) * BN * LD;
    const bf16* cv = sv + (j % 2) * BN * LD;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, q_rows, kk, lane);
      qk_step<NS>(s, a, ck, kk, lane);
    }

    float mask_value = fat::MASK_VALUE;
    if constexpr (ARITH == kBF16) {
      mask_value = __bfloat162float(__float2bfloat16_rn(MASK_VALUE_BF16));
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __bfloat162float(__float2bfloat16_rn(s[n][e]));
    }
    if (MASK == kAlways || (MASK == kCond && (j + 1) * BN - 1 > iq * BM)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * BN + n * 8 + 2 * t + (e % 2) > row0 + (e / 2) * 8) s[n][e] = mask_value;
    }

    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mc = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NS; ++n) mc = fmaxf(mc, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float mn = fmaxf(m[i], quad_max(mc));
      alpha[i] = exp2f(m[i] - mn);
      m[i] = mn;
    }

    uint32_t pk[NS][2];  // p as packed bf16 pairs: [n][0] row g, [n][1] row g + 8
    float lc[2] = {0.f, 0.f};
    if constexpr (ARITH == kF32) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = exp2f(s[n][2 * i] - m[i]), p1 = exp2f(s[n][2 * i + 1] - m[i]);
          lc[i] += p0 + p1;
          pk[n][i] = pack_bf16(p0, p1);
        }
    } else {
      const __nv_bfloat162 mb[2] = {__float2bfloat162_rn(m[0]), __float2bfloat162_rn(m[1])};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // s is already a bf16 value, so this pack is exact.
          const __nv_bfloat162 pb = h2exp2(__hsub2(__floats2bfloat162_rn(s[n][2 * i], s[n][2 * i + 1]), mb[i]));
          lc[i] += __low2float(pb) + __high2float(pb);
          pk[n][i] = bits(pb);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(lc[i]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
      pv_step<NO>(acc, a, cv + kk * 16 * LD, lane);
    }
    __syncthreads();  // every warp is done with buffer j % 2 before tile j + 2 lands in it
  }

  bf16* o = p.o + hoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    bf16* orow = o + static_cast<int64_t>(row0 + 8 * i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

struct TiledLaunch {
  ProbeParams p;
  cudaStream_t stream;

  template <int BM, int BN, int ARITH, bool SKIP, int MASK, int GRID>
  cudaError_t run() const {
    constexpr size_t smem = tiled_smem<BM, BN>();
    const auto kernel = tiled_kernel<BM, BN, ARITH, SKIP, MASK, GRID>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const unsigned nq = p.seq / BM, heads = p.heads;
    const dim3 grid = GRID == kHeadMajor ? dim3(nq, heads) : GRID == kQTileMajor ? dim3(heads, nq) : dim3(nq * heads);
    kernel<<<grid, BM * 2, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

template <int BM, int BN>
cudaError_t tiled_variant(const TiledLaunch& L, int arith, bool skip, int mask, int grid) {
  if (grid != kHeadMajor) {  // grid_probe.py's body: fp32, no skip, no mask
    if (arith != kF32 || skip || mask != kNone) return cudaErrorInvalidValue;
    if (grid == kQTileMajor) return L.run<BM, BN, kF32, false, kNone, kQTileMajor>();
    if (grid == kFlat) return L.run<BM, BN, kF32, false, kNone, kFlat>();
    return cudaErrorInvalidValue;
  }
  if (arith == kBF16) {  // softmax_probe.py's bf16 variant, non-causal or causal
    if (!skip && mask == kNone) return L.run<BM, BN, kBF16, false, kNone, kHeadMajor>();
    if (skip && mask == kAlways) return L.run<BM, BN, kBF16, true, kAlways, kHeadMajor>();
    return cudaErrorInvalidValue;
  }
  if (arith != kF32) return cudaErrorInvalidValue;
  switch (mask) {
    case kNone: return skip ? L.run<BM, BN, kF32, true, kNone, kHeadMajor>() : L.run<BM, BN, kF32, false, kNone, kHeadMajor>();
    case kAlways:
      return skip ? L.run<BM, BN, kF32, true, kAlways, kHeadMajor>() : L.run<BM, BN, kF32, false, kAlways, kHeadMajor>();
    case kCond: return skip ? L.run<BM, BN, kF32, true, kCond, kHeadMajor>() : L.run<BM, BN, kF32, false, kCond, kHeadMajor>();
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- body S

constexpr int S_THREADS = 256;
constexpr int S_ROWS = 32;   // score rows a block holds
constexpr int S_STAGE = 128; // kv rows a ring stage holds (over HB heads)
constexpr int S_MAX_SEQ = 1024;

inline size_t single_smem(int seq) {
  return static_cast<size_t>(S_ROWS + 2 * S_STAGE) * LD * sizeof(bf16) +
         static_cast<size_t>(S_ROWS) * (seq + 8) * sizeof(float) + 3 * S_ROWS * sizeof(float);
}

template <int STAGE, int EPI, bool MASK, int HB>
__global__ void __launch_bounds__(S_THREADS) single_kernel(const ProbeParams p) {
  constexpr int BN = S_STAGE / HB;  // kv rows of one head in a stage
  constexpr int WN = BN / 4;        // score columns a warp computes in a stage
  constexpr int NS = WN / 8;
  constexpr int NO = D / 4 / 8;     // a warp's output n-tiles: a quarter of head_dim
  constexpr int RH = S_ROWS / HB;   // q rows of one head in the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [32][LD]: head hh's rows at hh * RH
  bf16* ring = sq + S_ROWS * LD;                  // [2][S_STAGE][LD]: head hh's BN rows at hh * BN
  float* ss = reinterpret_cast<float*>(ring + 2 * S_STAGE * LD);  // [32][seq + 8] fp32 scores
  const int ld_s = p.seq + 8;  // 8 floats of padding: the fragments' float2 stores hit distinct banks
  float* sm = ss + S_ROWS * ld_s;
  float* sl = sm + S_ROWS;
  float* sinv = sl + S_ROWS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 2, wc = warp / 2;  // row group (16 score rows) and column / head_dim quarter
  const int hh = HB == 2 ? rg : 0;         // this warp's head within the block
  const int head0 = blockIdx.y * HB, q0 = blockIdx.x * RH;
  const int qrow0 = q0 + (HB == 1 ? rg * 16 : 0) + g;  // this thread's q rows: qrow0 and qrow0 + 8
  const int nk = p.seq / BN;  // K stages; the V stages follow them in one stream
  const int64_t head_elems = static_cast<int64_t>(p.seq) * D;

  auto load_stage = [&](int jj) {
    bf16* dst = ring + (jj % 2) * S_STAGE * LD;
    const bf16* src = (jj < nk ? p.k : p.v) + static_cast<int64_t>(jj % nk) * BN * D;
#pragma unroll
    for (int h = 0; h < HB; ++h) copy_rows<BN, S_THREADS>(dst + h * BN * LD, src + (head0 + h) * head_elems, tid);
  };
#pragma unroll
  for (int h = 0; h < HB; ++h)
    copy_rows<RH, S_THREADS>(sq + h * RH * LD, p.q + (head0 + h) * head_elems + static_cast<int64_t>(q0) * D, tid);
  load_stage(0);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {0.f, 0.f}, l_r[2] = {0.f, 0.f}, inv_r[2] = {0.f, 0.f};

  for (int jj = 0; jj < 2 * nk; ++jj) {
    if (jj + 1 < 2 * nk) {
      load_stage(jj + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* st = ring + (jj % 2) * S_STAGE * LD + hh * BN * LD;
    if (jj == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sq + rg * 16 * LD, kk, lane);
    }
    if (jj < nk) {
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) qk_step<NS>(s, qf[kk], st + wc * WN * LD, kk, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = jj * BN + wc * WN + n * 8 + 2 * t;
          float2 x = make_float2(s[n][2 * i], s[n][2 * i + 1]);
          if constexpr (MASK) {
            const int row = qrow0 + 8 * i;
            if (col > row) x.x = fat::MASK_VALUE;
            if (col + 1 > row) x.y = fat::MASK_VALUE;
          }
          *reinterpret_cast<float2*>(ss + (rg * 16 + g + 8 * i) * ld_s + col) = x;
        }
      if (jj == nk - 1 && STAGE != kMma) {
        __syncthreads();
        // The row passes: 8 threads a row, float4 at a time.
        const int r = tid / 8, sub = tid % 8;
        float* row = ss + r * ld_s;
        float mx = -CUDART_INF_F;
        for (int c = sub * 4; c < p.seq; c += 32) {
          const float4 x = *reinterpret_cast<const float4*>(row + c);
          mx = fmaxf(mx, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
        }
#pragma unroll
        for (int o = 1; o < 8; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(fat::FULL_MASK, mx, o));
        const float m = fmaxf(mx * p.scale2, fat::M_FLOOR);
        if constexpr (STAGE == kSoftmax) {
          float l = 0.f;
          for (int c = sub * 4; c < p.seq; c += 32) {
            float4 x = *reinterpret_cast<const float4*>(row + c);
            x.x = exp2f(x.x * p.scale2 - m);
            x.y = exp2f(x.y * p.scale2 - m);
            x.z = exp2f(x.z * p.scale2 - m);
            x.w = exp2f(x.w * p.scale2 - m);
            if constexpr (EPI != kNoNorm) l += (x.x + x.y) + (x.z + x.w);
            *reinterpret_cast<float4*>(row + c) = x;
          }
          if constexpr (EPI != kNoNorm) {
#pragma unroll
            for (int o = 1; o < 8; o *= 2) l += __shfl_xor_sync(fat::FULL_MASK, l, o);
            if (sub == 0) {
              sl[r] = l;
              sinv[r] = l == 0.f ? 0.f : 1.f / l;
            }
          }
        }
        if (sub == 0) sm[r] = m;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = rg * 16 + g + 8 * i;
          m_r[i] = sm[rr];
          if constexpr (STAGE == kSoftmax && EPI != kNoNorm) {
            l_r[i] = sl[rr];
            inv_r[i] = sinv[rr];
          }
        }
      }
    } else {
      const int jv = jj - nk;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2 x = *reinterpret_cast<const float2*>(ss + (rg * 16 + g + 8 * i) * ld_s + jv * BN + kk * 16 +
                                                        8 * half + 2 * t);
            if constexpr (STAGE == kMax) {
              x.x -= m_r[i];
              x.y -= m_r[i];
            } else if constexpr (STAGE == kSoftmax && EPI == kBeforePV) {
              x.x *= inv_r[i];
              x.y *= inv_r[i];
            }
            a[2 * half + i] = pack_bf16(x.x, x.y);
          }
        pv_step<NO>(acc, a, st + kk * 16 * LD + wc * (D / 4), lane);
      }
    }
    __syncthreads();  // every warp is done with stage jj % 2 (and, at the turn, with the row passes)
  }

  bf16* o = p.o + (head0 + hh) * head_elems + wc * (D / 4) + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* orow = o + static_cast<int64_t>(qrow0 + 8 * i) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = acc[n][2 * i], x1 = acc[n][2 * i + 1];
      __nv_bfloat162 y;
      if constexpr (EPI == kAfterPV) {
        y = __floats2bfloat162_rn(x0 * inv_r[i], x1 * inv_r[i]);
      } else if constexpr (EPI == kAfterPVNoGuard) {
        y = __floats2bfloat162_rn(x0 / l_r[i], x1 / l_r[i]);
      } else if constexpr (EPI == kAfterPVBf16) {
        y = __hmul2(__floats2bfloat162_rn(x0, x1), __float2bfloat162_rn(inv_r[i]));
      } else {
        y = __floats2bfloat162_rn(x0, x1);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = y;
    }
  }
}

struct SingleLaunch {
  ProbeParams p;
  cudaStream_t stream;

  template <int STAGE, int EPI, bool MASK, int HB>
  cudaError_t run() const {
    const size_t smem = single_smem(p.seq);
    const auto kernel = single_kernel<STAGE, EPI, MASK, HB>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(single_smem(S_MAX_SEQ)));
    if (err != cudaSuccess) return err;
    const dim3 grid(p.seq / (S_ROWS / HB), p.heads / HB);
    kernel<<<grid, S_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// Body T (P1, P3, P4). q, k, v, o [heads, seq, 128] bf16 contiguous; seq a
// multiple of bm and bn; (bm, bn) in {64, 128}^2; arith, skip, mask and
// grid as the enums above, in the combinations tiled_variant instantiates.
// Returns a cudaError_t.
extern "C" int fat_probe_tiled(const void* q, const void* k, const void* v, void* o, int64_t heads, int64_t seq,
                               int32_t bm, int32_t bn, int32_t arith, int32_t skip, int32_t mask, int32_t grid,
                               void* stream) {
  if (heads < 1 || seq < bm || seq < bn || seq % bm || seq % bn) return cudaErrorInvalidValue;
  const TiledLaunch L{{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                       static_cast<bf16*>(o), static_cast<int>(heads), static_cast<int>(seq), 0.f},
                      static_cast<cudaStream_t>(stream)};
  const bool sk = skip != 0;
  switch (bm * 1000 + bn) {
    case 64064: return static_cast<int>(tiled_variant<64, 64>(L, arith, sk, mask, grid));
    case 128064: return static_cast<int>(tiled_variant<128, 64>(L, arith, sk, mask, grid));
    case 64128: return static_cast<int>(tiled_variant<64, 128>(L, arith, sk, mask, grid));
    case 128128: return static_cast<int>(tiled_variant<128, 128>(L, arith, sk, mask, grid));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Body S (P2, P5, P6). q, k, v, o [heads, seq, 128] bf16 contiguous; seq a
// multiple of 128 in [128, 1024]; heads a multiple of hb (1 or 2); scale2 =
// sm_scale * log2(e); stage, epilogue as the enums above (stage mma and max
// take epilogue none), mask 1 for the causal mask (softmax, before_pv, hb 1
// only). Returns a cudaError_t.
extern "C" int fat_probe_single(const void* q, const void* k, const void* v, void* o, int64_t heads, int64_t seq,
                                float scale2, int32_t stage, int32_t epilogue, int32_t mask, int32_t hb,
                                void* stream) {
  if (heads < 1 || seq < S_STAGE || seq > S_MAX_SEQ || seq % S_STAGE || (hb != 1 && hb != 2) || heads % hb)
    return static_cast<int>(cudaErrorInvalidValue);
  const SingleLaunch L{{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                        static_cast<bf16*>(o), static_cast<int>(heads), static_cast<int>(seq), scale2},
                       static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (hb == 2) {
    if (stage == kSoftmax && epilogue == kBeforePV && !mask) err = L.run<kSoftmax, kBeforePV, false, 2>();
  } else if (mask) {
    if (stage == kSoftmax && epilogue == kBeforePV) err = L.run<kSoftmax, kBeforePV, true, 1>();
  } else if (stage == kMma && epilogue == kNoNorm) {
    err = L.run<kMma, kNoNorm, false, 1>();
  } else if (stage == kMax && epilogue == kNoNorm) {
    err = L.run<kMax, kNoNorm, false, 1>();
  } else if (stage == kSoftmax) {
    switch (epilogue) {
      case kNoNorm: err = L.run<kSoftmax, kNoNorm, false, 1>(); break;
      case kBeforePV: err = L.run<kSoftmax, kBeforePV, false, 1>(); break;
      case kAfterPV: err = L.run<kSoftmax, kAfterPV, false, 1>(); break;
      case kAfterPVNoGuard: err = L.run<kSoftmax, kAfterPVNoGuard, false, 1>(); break;
      case kAfterPVBf16: err = L.run<kSoftmax, kAfterPVBf16, false, 1>(); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}
