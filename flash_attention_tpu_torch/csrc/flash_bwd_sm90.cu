// K3, K4 and K5 for bf16 and fp16: the attention backward's fused MHA pass,
// its dq pass and its dk / dv pass summed over the GQA group, on Hopper's
// tensor cores (wgmma) with tiles fed by TMA. fp32 keeps the FMA bodies of
// csrc/flash_bwd.cu, whose C entries (fat_flash_bwd_fused, fat_flash_bwd_dq,
// fat_flash_bwd_dkv) dispatch here by dtype. The Hopper layer (tile layout,
// TMA, mbarriers, wgmma, fragment packing) is csrc/sm90_common.cuh.
//
// Replaces the JAX package's Pallas kernels, with their window, softcap and
// segment-id branches:
//   K3  ops/attention_bwd.py:594  _bwd_fused_kernel -> dkv_kernel<FUSED = true>
//   K4  ops/attention_bwd.py:65   _bwd_dq_kernel    -> dq_kernel
//   K5  ops/attention_bwd.py:317  _bwd_dkv_kernel   -> dkv_kernel (+ split_sum_kernel)
// The function is csrc/flash_bwd.cu's (its note states the recurrence, the
// masks and the live-tile walks), with one change of numerics: P and dS
// enter the tensor-core products rounded to the input type, as the JAX
// package and FlashAttention-2/3 do; the scores, dP, the softmax and every
// accumulator stay fp32.
//
// What bounds them: every visible (q, kv) pair costs 3 (K4), 4 (K5) or 5 (K3)
// products of 2 * D FLOPs against O((q_len + kv_len) * D) bytes, so at every
// training length (T >= 1024 at D = 128) operations bound all three, at the
// card's 989 TFLOP/s dense bf16 / fp16 rate, which only wgmma reaches.
//
// Design (FlashAttention-3's arrangement, raw PTX, no warp specialisation):
//  * Two warpgroups a block (256 threads); each owns 64 rows of the block's
//    resident tile and issues its products as m64nNk16 wgmma with fp32
//    accumulators in registers, whose fragment map (rows g and g + 8,
//    columns 2t and 2t + 1 of each 8-column block) the mask, exp2, softcap
//    and the row-wise lse / delta use directly.
//  * K4: a block owns (batch x q head, 128-row q tile); Q and dO stay in
//    shared memory and the block walks the live 64-row kv tiles. S = Q K^T
//    and dP = dO V^T read both operands from shared memory, K-major as
//    stored; dS = P (dP - delta) is made in the accumulator registers,
//    rounded and packed in place as the A fragments of dQ += dS K, whose B
//    (K, stored [n][d]) wgmma reads with its transpose flag. Each dq element
//    is written once.
//  * K5: a block owns (batch x kv head x split, 128-row kv tile); K and V
//    stay resident and the block walks its heads of the GQA group and their
//    live 64-row q tiles: S^T = K Q^T and dP^T = V dO^T from shared memory,
//    then dV += P^T dO and dK += dS^T Q with A from registers and B (dO, Q)
//    transposed. lse and delta of the q tile arrive with it (a bulk copy
//    from rows padded to 64 by the wrapper).
//  * Tiles live in shared memory at 16-bit width in the swizzled layout
//    wgmma's descriptors read (128-byte swizzle in chunks of 64 columns; at
//    D = 32, 64-byte swizzle), written by TMA from one tensor map per
//    operand over its [B, H, S, D] strides; TMA zero-fills rows past q_len
//    and kv_len, whose products then add exactly 0. The walked tiles (K/V in
//    K4; Q, dO, lse, delta in K5) go through a two-stage ring of mbarriers:
//    one thread loads tile i + 2 as soon as both warpgroups are done with
//    tile i, so the next tile loads while this one multiplies.
//  * Masking costs only where a tile needs it: the element predicate runs on
//    tiles that cross the causal diagonal, the window's edge, a ragged end
//    or two segment ids. That choice and the softcap's are made once a tile
//    (by_tile), each element loop compiled without branches for each case:
//    with both branches inside the unrolled loop the masked bodies ran 2.0x
//    (K5) and 2.4x (K4) slower at Mistral's window. The walks skip dead
//    tiles as flash_bwd.cu's do; segment ranges are over 64-row tiles
//    (ops/common.py), so a 128-row tile meets a tile when either half does.
//  * Each tile step ends in a block-wide barrier, after which one thread
//    refills the stage both warpgroups are done with. A version without it
//    (each warpgroup releasing stages on its own, three stages, the next
//    tile's products issued before this tile's softmax) measured no faster.
//  * K5's grid is kv tiles x B x Hkv x splits: where kv tiles x B x Hkv is
//    under two blocks an SM the wrapper (ops/attention_bwd.dkv_splits) splits
//    the group's q heads over blocks; each split writes fp32 partial dk, dv
//    into a workspace [2, B, Hkv, splits, Skv, D] and split_sum_kernel, a
//    launch of its own, sums the splits in a fixed order and casts. K4 and
//    K5 use no atomics: dq, dk and dv are bit-identical from run to run.
//  * K3 (MHA self-attention, group 1) is K5's body with a fifth product per
//    step, dQ_tile = sm_scale dS K. Each warpgroup writes its dS^T rows at
//    16-bit width into shared memory in the swizzled layout TMA would write,
//    and after a block barrier wgmma reads it as A (transposed) against K as
//    B (transposed): at D = 128 each warpgroup makes 64 of dq's columns over
//    all 128 kv rows (m64n64, reusing the score registers, since 64 more
//    would not fit beside dk and dv); at D = 32 / 64 each makes every column
//    over its own 64 kv rows. The fp32 partial is staged in shared memory
//    (rows 8 floats longer than D, so the float2 writes meet no bank
//    conflict) and one warp adds each row into the caller's fp32 dq buffer
//    with an asynchronous bulk reduce (cp.reduce.async.bulk .add.f32, as
//    FlashAttention-3 does), which drains while the next step multiplies.
//    dq's additions from the kv tiles' blocks come in a run-dependent
//    order; dk and dv are written once and are bit-identical run to run.
#include <cuda.h>

#include "common.cuh"
#include "flash_bwd_sm90.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;           // two warpgroups
constexpr int DQ_BM = 128, DQ_BN = 64;   // K4: q rows a block, kv rows a step
constexpr int DKV_BN = 128, DKV_BM = 64; // K5: kv rows a block, q rows a step

struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  const float* lse;
  const float* delta;
  void* out0;
  void* out1;
  int64_t lse_pitch;
  int num_q_heads, num_kv_heads, group, q_len, kv_len, causal, splits;
  float scale2, sm_scale;
  int window;
  float softcap2;
  const int32_t* seg_q;
  const int32_t* seg_kv;
  const int32_t* q_rng;
  const int32_t* kv_rng;
  float* dq_acc;  // K3: [B, Hq, Sq, D] fp32, zeroed by the caller; dq is added into it
};

// ---- the function: mask and P, as csrc/flash_bwd.cu's ----

// P of one pair from its raw score s = q . k: exp2 of the forward's base-2
// score less the row's LSE. With CAP the score is capped as the forward caps
// it, and dcap gets tanh's derivative 1 - t^2 (else it stays 1).
template <bool CAP>
__device__ __forceinline__ float prob(const Params& p, float s, float lse, float& dcap) {
  if constexpr (CAP) {
    const float t = tanhf(s * p.scale2 / p.softcap2);
    dcap = 1.f - t * t;
    return exp2f(p.softcap2 * t - lse);
  }
  return exp2f(fmaf(s, p.scale2, -lse));
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024 + 2 * DQ_BM * D * 2 + 4 * DQ_BN * D * 2 + 64;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + 2 * DKV_BN * D * 2 + 4 * DKV_BM * D * 2 + 4 * DKV_BM * 4 + 64;
}

// K3's dq partial of a step, staged in shared memory as fp32 rows DQ_PITCH
// apart (a row's banks 8 rows apart cover all 32 for float2 writes): one
// plane at D = 128, where each warpgroup owns 64 columns, else one a
// warpgroup, each holding the partial over its 64 kv rows.
template <int D>
constexpr int DQ_PITCH = D + 8;
template <int D>
constexpr int DQ_PLANES = D == 128 ? 1 : 2;

// K3: K5's tiles, dS^T of a step ([128 kv][64 q] at 16-bit), the staged dq.
template <int D>
constexpr size_t fused_smem_bytes() {
  return dkv_smem_bytes<D>() + DKV_BN * DKV_BM * 2 + DQ_PLANES<D> * DKV_BM * DQ_PITCH<D> * 4;
}

constexpr int REDUCER = 1;  // K3: the warp that adds the staged dq rows into dq_acc

// K4: dq of one (batch x q head, 128-row q tile).
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1) dq_kernel(const __grid_constant__ Params p) {
  constexpr int Q_TILE = DQ_BM * D * 2, KV_TILE = DQ_BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_do = s_q + Q_TILE;
  uint8_t* s_kv = s_do + Q_TILE;  // stage s: K at s_kv + 2 s KV_TILE, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_kv + 4 * KV_TILE);  // [0]: Q and dO; [1 + s]: stage s

  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
  const int bh = blockIdx.y, b = bh / p.num_q_heads, h = bh % p.num_q_heads, hk = h / p.group;
  // Causal tiles grow with the row index: start the longest ones first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;
  const int r0 = m0 + 64 * wg;  // this warpgroup's first row
  const int diag = p.kv_len - p.q_len;
  const int last_row = min(m0 + DQ_BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + diag + 1) : p.kv_len;
  // Window: start at the tile of the first column the tile's first row sees.
  const int n_begin = MASKED && p.window > 0 ? max(0, m0 + diag - p.window + 1) / DQ_BN * DQ_BN : 0;
  const bool segs = MASKED && p.seg_q != nullptr;
  auto next_live = [&](int n0) {
    if (segs) {
      while (n0 < n_end && !seg_meet(p, b, m0 / SEG, n0 / SEG) && !seg_meet(p, b, m0 / SEG + 1, n0 / SEG)) n0 += DQ_BN;
    }
    return n0;
  };
  auto load_kv = [&](int s, int n0) {
    uint8_t* stage = s_kv + 2 * s * KV_TILE;
    mbar_expect(&bar[1 + s], 2 * KV_TILE);
    load_tile<D, DQ_BN>(stage, &p.tm_k, n0, hk, b, &bar[1 + s]);
    load_tile<D, DQ_BN>(stage + KV_TILE, &p.tm_v, n0, hk, b, &bar[1 + s]);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int n_load = next_live(n_begin);  // thread 0's cursor: the next tile to load
  if (tid == 0) {
    mbar_expect(&bar[0], 2 * Q_TILE);
    load_tile<D, DQ_BM>(s_q, &p.tm_q, m0, h, b, &bar[0]);
    load_tile<D, DQ_BM>(s_do, &p.tm_do, m0, h, b, &bar[0]);
    for (int s = 0; s < 2 && n_load < n_end; ++s) {
      load_kv(s, n_load);
      n_load = next_live(n_load + DQ_BN);
    }
  }

  const int ra = r0 + 16 * w4 + g, rb = ra + 8;
  const int64_t rows_at = static_cast<int64_t>(bh) * p.lse_pitch;
  const float lse_a = ra < p.q_len ? p.lse[rows_at + ra] : 0.f, lse_b = rb < p.q_len ? p.lse[rows_at + rb] : 0.f;
  const float delta_a = ra < p.q_len ? p.delta[rows_at + ra] : 0.f;
  const float delta_b = rb < p.q_len ? p.delta[rows_at + rb] : 0.f;
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
  const uint32_t q_tile = smem_u32(s_q), do_tile = smem_u32(s_do);
  mbar_wait(&bar[0], 0);
  int it = 0;
  for (int n0 = next_live(n_begin); n0 < n_end; n0 = next_live(n0 + DQ_BN), ++it) {
    const int s = it & 1;
    const uint32_t k_tile = smem_u32(s_kv + 2 * s * KV_TILE), v_tile = k_tile + KV_TILE;
    mbar_wait(&bar[1 + s], (it >> 1) & 1);

    float sc[DQ_BN / 2], dp[DQ_BN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(sc, desc_k<D, DQ_BM>(q_tile, 64 * wg, kk), desc_k<D, DQ_BN>(k_tile, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(dp, desc_k<D, DQ_BM>(do_tile, 64 * wg, kk), desc_k<D, DQ_BN>(v_tile, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // Whether any pair of this warpgroup's 64 x 64 tile is masked out.
    bool need = (p.causal && n0 + DQ_BN - 1 > r0 + diag) || n0 + DQ_BN > p.kv_len;
    if constexpr (MASKED) {
      need = need || (p.window > 0 && n0 <= r0 + 63 + diag - p.window) ||
             (segs && !seg_uniform(p, b, r0 / SEG, n0 / SEG));
    }
    by_tile<MASKED>(p, need, [&](auto cap, auto mask) {
#pragma unroll
      for (int i = 0; i < DQ_BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        float dcap = 1.f;
        float pr = prob<decltype(cap)::value>(p, sc[i], lo ? lse_a : lse_b, dcap);
        if constexpr (decltype(mask)::value) {
          const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int32_t col_id = segs && col < p.kv_len ? seg_kv[col] : 0;
          if (!sees<MASKED>(p, lo ? ra : rb, col, lo ? id_a : id_b, col_id)) pr = 0.f;
        }
        dp[i] = pr * (dp[i] - (lo ? delta_a : delta_b)) * dcap;
      }
    });
    uint32_t a[DQ_BN / 16][4];
    to_a_frags<T, DQ_BN / 16>(a, dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk) mma_rs<T, D>(acc, a[kk], desc_mn<D, DQ_BN>(k_tile, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && n_load < n_end) {
      load_kv(s, n_load);
      n_load = next_live(n_load + DQ_BN);
    }
  }

  T* dq = static_cast<T*>(p.out0) + static_cast<int64_t>(bh) * p.q_len * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ra < p.q_len) store2<T>(dq + static_cast<int64_t>(ra) * D + col, acc[4 * j] * p.sm_scale, acc[4 * j + 1] * p.sm_scale);
    if (rb < p.q_len)
      store2<T>(dq + static_cast<int64_t>(rb) * D + col, acc[4 * j + 2] * p.sm_scale, acc[4 * j + 3] * p.sm_scale);
  }
}

// K5: dk and dv of one (batch x kv head x split, 128-row kv tile), summed
// over the split's q heads; with one split written as T, else as fp32
// partials into the workspace. FUSED (K3, MHA, one split): each step also
// adds its q tile's dq partial, sm_scale dS K, into dq_acc.
template <typename T, int D, bool MASKED, bool FUSED = false>
__global__ void __launch_bounds__(THREADS, 1) dkv_kernel(const __grid_constant__ Params p) {
  constexpr int KV_TILE = DKV_BN * D * 2, Q_TILE = DKV_BM * D * 2;
  constexpr int DS_TILE = FUSED ? DKV_BN * DKV_BM * 2 : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_k = align_1024(smem_raw);
  uint8_t* s_v = s_k + KV_TILE;
  uint8_t* s_qdo = s_v + KV_TILE;  // stage s: Q at s_qdo + 2 s Q_TILE, dO after it
  uint8_t* s_ds = s_qdo + 4 * Q_TILE;  // K3: dS^T of the step
  float* s_rows = reinterpret_cast<float*>(s_ds + DS_TILE);  // stage s: lse [64], delta [64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_rows + 4 * DKV_BM);  // [0]: K and V; [1 + s]: stage s
  float* s_dq = reinterpret_cast<float*>(bar + 4);  // K3: the step's dq partial (DQ_PLANES, DQ_PITCH)

  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
  const int hps = p.group / p.splits;  // q heads a split walks
  const int by = blockIdx.y, sp = by % p.splits, bhk = by / p.splits;
  const int b = bhk / p.num_kv_heads, hk = bhk % p.num_kv_heads, h0 = hk * p.group + sp * hps;
  // Causal: the first kv tiles are seen by the most q rows; they start first.
  const int n0 = blockIdx.x * DKV_BN;
  const int c0 = n0 + 64 * wg;  // this warpgroup's first kv row
  const int diag = p.kv_len - p.q_len;
  // The first q tile holding a row that sees the block's first column, and,
  // with a window, the end of the rows whose window holds its last column.
  const int m_first = p.causal ? max(0, n0 - diag) / DKV_BM * DKV_BM : 0;
  const int m_end = MASKED && p.window > 0 ? min(p.q_len, n0 + DKV_BN - 1 + p.window - diag) : p.q_len;
  const bool segs = MASKED && p.seg_q != nullptr;
  // Moves (gi, m0) to the next live (head, q tile) pair at or after it; gi
  // reaches hps at the end of the walk.
  auto advance = [&](int& gi, int& m0) {
    while (gi < hps) {
      if (segs) {
        while (m0 < m_end && !seg_meet(p, b, m0 / SEG, n0 / SEG) && !seg_meet(p, b, m0 / SEG, n0 / SEG + 1))
          m0 += DKV_BM;
      }
      if (m0 < m_end) return;
      ++gi;
      m0 = m_first;
    }
  };
  auto load_q = [&](int s, int gi, int m0) {
    const int h = h0 + gi;
    uint8_t* stage = s_qdo + 2 * s * Q_TILE;
    mbar_expect(&bar[1 + s], 2 * Q_TILE + 2 * DKV_BM * 4);
    load_tile<D, DKV_BM>(stage, &p.tm_q, m0, h, b, &bar[1 + s]);
    load_tile<D, DKV_BM>(stage + Q_TILE, &p.tm_do, m0, h, b, &bar[1 + s]);
    const int64_t at = static_cast<int64_t>(b * p.num_q_heads + h) * p.lse_pitch + m0;
    bulk_load(s_rows + 2 * s * DKV_BM, p.lse + at, DKV_BM * 4, &bar[1 + s]);
    bulk_load(s_rows + (2 * s + 1) * DKV_BM, p.delta + at, DKV_BM * 4, &bar[1 + s]);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int g_load = 0, m_load = m_first;  // thread 0's cursor: the next pair to load
  advance(g_load, m_load);
  if (tid == 0) {
    mbar_expect(&bar[0], 2 * KV_TILE);
    load_tile<D, DKV_BN>(s_k, &p.tm_k, n0, hk, b, &bar[0]);
    load_tile<D, DKV_BN>(s_v, &p.tm_v, n0, hk, b, &bar[0]);
    for (int s = 0; s < 2 && g_load < hps; ++s) {
      load_q(s, g_load, m_load);
      m_load += DKV_BM;
      advance(g_load, m_load);
    }
  }

  const int ca = c0 + 16 * w4 + g, cb = ca + 8;
  const int32_t* seg_q = segs ? p.seg_q + static_cast<int64_t>(b) * p.q_len : nullptr;
  int32_t id_a = 0, id_b = 0;
  if (segs) {
    const int32_t* seg_kv = p.seg_kv + static_cast<int64_t>(b) * p.kv_len;
    id_a = ca < p.kv_len ? seg_kv[ca] : 0;
    id_b = cb < p.kv_len ? seg_kv[cb] : 0;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_tile = smem_u32(s_k), v_tile = smem_u32(s_v);
  mbar_wait(&bar[0], 0);
  int gi = 0, m0 = m_first, it = 0;
  for (advance(gi, m0); gi < hps; ++it) {
    const int s = it & 1;
    const uint32_t q_tile = smem_u32(s_qdo + 2 * s * Q_TILE), do_tile = q_tile + Q_TILE;
    const float* lse = s_rows + 2 * s * DKV_BM;
    const float* delta = lse + DKV_BM;
    mbar_wait(&bar[1 + s], (it >> 1) & 1);

    // S^T and dP^T: rows are this warpgroup's kv rows, columns the q rows.
    float st[DKV_BM / 2], dpt[DKV_BM / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(st, desc_k<D, DKV_BN>(k_tile, 64 * wg, kk), desc_k<D, DKV_BM>(q_tile, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(dpt, desc_k<D, DKV_BN>(v_tile, 64 * wg, kk), desc_k<D, DKV_BM>(do_tile, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    bool need = (p.causal && c0 + 63 > m0 + diag) || m0 + DKV_BM > p.q_len || c0 + 64 > p.kv_len;
    if constexpr (MASKED) {
      need = need || (p.window > 0 && c0 <= m0 + 63 + diag - p.window) ||
             (segs && !seg_uniform(p, b, m0 / SEG, c0 / SEG));
    }
    by_tile<MASKED>(p, need, [&](auto cap, auto mask) {
#pragma unroll
      for (int i = 0; i < DKV_BM / 2; ++i) {
        const bool lo = (i & 2) == 0;
        const int qc = 8 * (i / 4) + 2 * t + (i & 1);
        float dcap = 1.f;
        float pr = prob<decltype(cap)::value>(p, st[i], lse[qc], dcap);
        if constexpr (decltype(mask)::value) {
          const int row = m0 + qc;
          const int32_t row_id = segs && row < p.q_len ? seg_q[row] : 0;
          if (!sees<MASKED>(p, row, lo ? ca : cb, row_id, lo ? id_a : id_b)) pr = 0.f;
        }
        dpt[i] = pr * (dpt[i] - delta[qc]) * dcap;
        st[i] = pr;
      }
    });
    uint32_t pa[DKV_BM / 16][4], da[DKV_BM / 16][4];
    to_a_frags<T, DKV_BM / 16>(pa, st);
    to_a_frags<T, DKV_BM / 16>(da, dpt);
    constexpr int NQ = D == 128 ? 64 : D;  // K3: dq columns a warpgroup's product makes
    float dq[NQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BM / 16; ++kk) mma_rs<T, D>(dv, pa[kk], desc_mn<D, DKV_BM>(do_tile, kk));
#pragma unroll
    for (int kk = 0; kk < DKV_BM / 16; ++kk) mma_rs<T, D>(dk, da[kk], desc_mn<D, DKV_BM>(q_tile, kk));
    if constexpr (FUSED) {
      // While dV and dK multiply, dS^T (rounded, as da) goes into s_ds: a
      // [128 kv][64 q] tile in the 128-byte swizzle TMA writes (row r's
      // 16-byte chunk j at chunk j ^ r % 8), which dQ's product reads as its
      // A operand, transposed. da[kk] holds rows ra, rb of column blocks
      // 2 kk and 2 kk + 1.
      const int ra = 64 * wg + 16 * w4 + g, rb = ra + 8;
      auto put = [&](int r, int j, uint32_t x) {
        *reinterpret_cast<uint32_t*>(s_ds + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) = x;
      };
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk) {
        put(ra, 2 * kk, da[kk][0]);
        put(rb, 2 * kk, da[kk][1]);
        put(ra, 2 * kk + 1, da[kk][2]);
        put(rb, 2 * kk + 1, da[kk][3]);
      }
      if (tid / 32 == REDUCER) bulk_wait_read();  // the last step's dq rows have left s_dq
      fence_proxy_async();
      __syncthreads();  // dS^T is whole
      const uint32_t ds_tile = smem_u32(s_ds);
      wg_fence();
      if constexpr (D == 128) {
        // dQ's columns [64 wg, 64 wg + 64) over all 128 kv rows: B is K's
        // column chunk wg.
#pragma unroll
        for (int kk = 0; kk < DKV_BN / 16; ++kk)
          mma_ss_tt<T, NQ>(dq, desc_mn<64, DKV_BN>(ds_tile, kk), desc_mn<D, DKV_BN>(k_tile + wg * DKV_BN * 128, kk), kk);
      } else {
        // dQ's partial over this warpgroup's 64 kv rows, every column.
#pragma unroll
        for (int kk = 0; kk < 64 / 16; ++kk)
          mma_ss_tt<T, NQ>(dq, desc_mn<64, DKV_BN>(ds_tile + wg * 64 * 128, kk),
                           desc_mn<D, DKV_BN>(k_tile + wg * 64 * Layout<D>::ROW, kk), kk);
      }
    }
    wg_commit();
    wg_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    if constexpr (FUSED) {
      fence_regs(dq);
      // Stage sm_scale * dq: rows 16 w4 + g and + 8 of the q tile.
      constexpr int PITCH = DQ_PITCH<D>;
      float* plane = s_dq + (D == 128 ? 64 * wg : wg * DKV_BM * PITCH);
      const int qa = 16 * w4 + g;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(plane + qa * PITCH + col) = make_float2(dq[4 * j] * p.sm_scale, dq[4 * j + 1] * p.sm_scale);
        *reinterpret_cast<float2*>(plane + (qa + 8) * PITCH + col) =
            make_float2(dq[4 * j + 2] * p.sm_scale, dq[4 * j + 3] * p.sm_scale);
      }
      fence_proxy_async();
    }

    __syncthreads();  // both warpgroups are done with stage s (K3: and the dq rows are staged)
    if (tid == 0 && g_load < hps) {
      load_q(s, g_load, m_load);
      m_load += DKV_BM;
      advance(g_load, m_load);
    }
    if constexpr (FUSED) {
      // One bulk reduce a staged row (a plane each) into dq_acc; the adds
      // from the kv tiles' blocks land in a run-dependent order.
      if (tid / 32 == REDUCER) {
        constexpr int PITCH = DQ_PITCH<D>;
        float* dq_rows = p.dq_acc + static_cast<int64_t>(b * p.num_q_heads + h0) * p.q_len * D;
        for (int i = tid % 32; i < DQ_PLANES<D> * DKV_BM; i += 32) {
          const int row = m0 + i % DKV_BM;
          if (row < p.q_len) bulk_reduce_add(dq_rows + static_cast<int64_t>(row) * D, s_dq + i * PITCH, D * 4);
        }
        bulk_commit();
      }
    }
    m0 += DKV_BM;
    advance(gi, m0);
  }
  if constexpr (FUSED) {
    if (tid / 32 == REDUCER) bulk_wait();  // s_dq is read until the reduces complete
  }

  if (FUSED || p.splits == 1) {
    const int64_t at = static_cast<int64_t>(bhk) * p.kv_len * D;
    T* dk_out = static_cast<T*>(p.out0) + at;
    T* dv_out = static_cast<T*>(p.out1) + at;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (ca < p.kv_len) {
        store2<T>(dk_out + static_cast<int64_t>(ca) * D + col, dk[4 * j] * p.sm_scale, dk[4 * j + 1] * p.sm_scale);
        store2<T>(dv_out + static_cast<int64_t>(ca) * D + col, dv[4 * j], dv[4 * j + 1]);
      }
      if (cb < p.kv_len) {
        store2<T>(dk_out + static_cast<int64_t>(cb) * D + col, dk[4 * j + 2] * p.sm_scale, dk[4 * j + 3] * p.sm_scale);
        store2<T>(dv_out + static_cast<int64_t>(cb) * D + col, dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  } else {
    // Workspace [2][B * Hkv][splits][Skv][D]: this block's plane is `by`.
    float* wk = static_cast<float*>(p.out0) + static_cast<int64_t>(by) * p.kv_len * D;
    float* wv = wk + static_cast<int64_t>(gridDim.y) * p.kv_len * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (ca < p.kv_len) {
        const int64_t at = static_cast<int64_t>(ca) * D + col;
        *reinterpret_cast<float2*>(wk + at) = make_float2(dk[4 * j] * p.sm_scale, dk[4 * j + 1] * p.sm_scale);
        *reinterpret_cast<float2*>(wv + at) = make_float2(dv[4 * j], dv[4 * j + 1]);
      }
      if (cb < p.kv_len) {
        const int64_t at = static_cast<int64_t>(cb) * D + col;
        *reinterpret_cast<float2*>(wk + at) = make_float2(dk[4 * j + 2] * p.sm_scale, dk[4 * j + 3] * p.sm_scale);
        *reinterpret_cast<float2*>(wv + at) = make_float2(dv[4 * j + 2], dv[4 * j + 3]);
      }
    }
  }
}

// The split sum: out[w][head][x] = sum over s = 0, 1, ... of ws[w][head][s][x]
// in that order, in fp32, then rounded to T; w = 0 is dk, 1 is dv. Four
// elements a thread.
template <typename T>
__global__ void __launch_bounds__(256) split_sum_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                                                       T* __restrict__ dv, int64_t heads, int splits, int64_t per) {
  const int64_t n4 = 2 * heads * per / 4;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = 4 * i, x = e % per, hw = e / per;
    const float* src = ws + hw * splits * per + x;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int s = 1; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(src + s * per);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    T* out = (hw < heads ? dk + hw * per : dv + (hw - heads) * per) + x;
    store2<T>(out, acc.x, acc.y);
    store2<T>(out + 2, acc.z, acc.w);
  }
}

// ---- host ----

enum class Pass { kDq, kDkv, kFused };  // K4, K5, K3

template <typename Kernel>
cudaError_t start(Kernel kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool MASKED>
cudaError_t run(const Params& p, const fat::Sm90BwdCall& c, Pass pass) {
  const unsigned kv_tiles = static_cast<unsigned>((c.kv_len + DKV_BN - 1) / DKV_BN);
  switch (pass) {
    case Pass::kDq:
      return start(dq_kernel<T, D, MASKED>, dq_smem_bytes<D>(),
                   dim3((c.q_len + DQ_BM - 1) / DQ_BM, static_cast<unsigned>(c.batch * c.num_q_heads)), p, c.stream);
    case Pass::kDkv:
      return start(dkv_kernel<T, D, MASKED>, dkv_smem_bytes<D>(),
                   dim3(kv_tiles, static_cast<unsigned>(c.batch * c.num_kv_heads * c.splits)), p, c.stream);
    default:
      return start(dkv_kernel<T, D, MASKED, true>, fused_smem_bytes<D>(),
                   dim3(kv_tiles, static_cast<unsigned>(c.batch * c.num_kv_heads)), p, c.stream);
  }
}

template <typename T, int D>
cudaError_t launch(const fat::Sm90BwdCall& c, Pass pass) {
  Params p{};
  const int64_t* st = c.st;
  const bool dq = pass == Pass::kDq;
  const int q_rows = dq ? DQ_BM : DKV_BM, kv_rows = dq ? DQ_BN : DKV_BN;
  if (!make_map<D>(&p.tm_q, c.q, c.dtype, c.batch, c.num_q_heads, c.q_len, st[0], st[1], st[2], q_rows) ||
      !make_map<D>(&p.tm_k, c.k, c.dtype, c.batch, c.num_kv_heads, c.kv_len, st[3], st[4], st[5], kv_rows) ||
      !make_map<D>(&p.tm_v, c.v, c.dtype, c.batch, c.num_kv_heads, c.kv_len, st[6], st[7], st[8], kv_rows) ||
      !make_map<D>(&p.tm_do, c.dout, c.dtype, c.batch, c.num_q_heads, c.q_len, st[9], st[10], st[11], q_rows))
    return cudaErrorInvalidValue;
  p.lse = c.lse;
  p.delta = c.delta;
  p.out0 = c.out0;
  p.out1 = c.out1;
  p.lse_pitch = c.lse_pitch;
  p.num_q_heads = static_cast<int>(c.num_q_heads);
  p.num_kv_heads = static_cast<int>(c.num_kv_heads);
  p.group = static_cast<int>(c.num_q_heads / c.num_kv_heads);
  p.q_len = static_cast<int>(c.q_len);
  p.kv_len = static_cast<int>(c.kv_len);
  p.causal = c.causal;
  p.splits = pass == Pass::kDkv ? c.splits : 1;
  p.scale2 = c.scale2;
  p.sm_scale = c.sm_scale;
  p.window = c.window;
  p.softcap2 = c.softcap2;
  p.seg_q = c.seg_q;
  p.seg_kv = c.seg_kv;
  p.q_rng = c.q_rng;
  p.kv_rng = c.kv_rng;
  p.dq_acc = c.dq_acc;
  if (c.window > 0 || c.softcap2 > 0.f || c.seg_q != nullptr) return run<T, D, true>(p, c, pass);
  return run<T, D, false>(p, c, pass);
}

template <typename T>
cudaError_t by_head_dim(const fat::Sm90BwdCall& c, Pass pass) {
  switch (c.head_dim) {
    case 32: return launch<T, 32>(c, pass);
    case 64: return launch<T, 64>(c, pass);
    case 128: return launch<T, 128>(c, pass);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_call(const fat::Sm90BwdCall& c, Pass pass) {
  if (c.window < 0 || (c.window > 0 && !c.causal)) return cudaErrorInvalidValue;
  if (c.seg_q != nullptr && (c.seg_kv == nullptr || c.q_rng == nullptr || c.kv_rng == nullptr))
    return cudaErrorInvalidValue;
  if (c.lse_pitch % 64 != 0 || c.lse_pitch < c.q_len) return cudaErrorInvalidValue;
  const int64_t group = c.num_q_heads / c.num_kv_heads;
  if (pass == Pass::kDkv && (c.splits < 1 || group % c.splits != 0)) return cudaErrorInvalidValue;
  if (pass == Pass::kFused && (group != 1 || c.dq_acc == nullptr)) return cudaErrorInvalidValue;
  switch (c.dtype) {
    case fat::kBFloat16: return by_head_dim<bf16>(c, pass);
    case fat::kFloat16: return by_head_dim<__half>(c, pass);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fat {

cudaError_t sm90_bwd_dq(const Sm90BwdCall& c) { return dispatch_call(c, Pass::kDq); }
cudaError_t sm90_bwd_dkv(const Sm90BwdCall& c) { return dispatch_call(c, Pass::kDkv); }
cudaError_t sm90_bwd_fused(const Sm90BwdCall& c) { return dispatch_call(c, Pass::kFused); }

}  // namespace fat

// K5's split sum: ws [2, heads, splits, per] fp32 (dk's partials, already
// scaled by sm_scale, then dv's) into dk and dv [heads, per] of dtype
// (bf16 or fp16). Returns a cudaError_t.
extern "C" int fat_flash_bwd_dkv_sum(const float* ws, void* dk, void* dv, int64_t heads, int32_t splits,
                                     int64_t per, int32_t dtype, void* stream) {
  if (splits < 1 || per % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = 2 * heads * per / 4;
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  if (blocks == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fat::kBFloat16:
      split_sum_kernel<bf16><<<blocks, 256, 0, s>>>(ws, static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, splits, per);
      break;
    case fat::kFloat16:
      split_sum_kernel<__half><<<blocks, 256, 0, s>>>(ws, static_cast<__half*>(dk), static_cast<__half*>(dv), heads,
                                                      splits, per);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
