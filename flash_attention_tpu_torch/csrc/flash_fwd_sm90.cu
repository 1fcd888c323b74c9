// K1 and K1d for bf16 and fp16: the attention forward, causal or not, MHA or
// GQA, with its window, softcap and segment-id masks, on Hopper's tensor
// cores (wgmma) with tiles fed by TMA. fp32, and K2 (the band walk of a
// window of at most 64), keep the FMA body of csrc/flash_fwd.cu, whose C
// entry fat_flash_fwd dispatches here by dtype and band; K8 (paged) keeps it
// too.
//
// Replaces the JAX package's ops/flash_attention.py:_fwd_kernel (:57, K1)
// with its window and softcap branches and its segment branch (K1d, :61-62,
// the packed tile skip of :1313-1330 and :1428-1431). The function is
// csrc/flash_fwd.cu's: an online exp2 softmax with scale2 = sm_scale *
// log2(e) folded into one constant, a finite MASK_VALUE, the row max floored
// at M_FLOOR, output 0 and LSE -inf for a row that sees no key, end-aligned
// causal, the exact tanhf softcap, and the base-2 LSE m + log2(l). One
// change of numerics, as the JAX package (:440, :520) and FlashAttention-2/3
// make it: P enters the P V product rounded to the input type; the scores,
// the softmax, l and the output accumulator stay fp32.
//
// What bounds it: every visible (q, kv) pair costs two products of 2 * D
// FLOPs against O((q_len + kv_len) * D) bytes, so at the serving chunk (256
// rows over kv 2048) and at every training length operations bound it, at the
// card's 989 TFLOP/s dense bf16 / fp16 rate, which only wgmma reaches.
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
//    view of a KV cache is read in place. TMA zero-fills rows past kv_len,
//    whose scores are 0 rather than masked: a ragged last tile takes the
//    masked element pass.
//  * The walk starts at the window's first tile and stops at the causal
//    diagonal of the block's last row; with segment ids it skips a kv tile
//    whose 64-row id range meets neither half of the q tile. The mask and
//    softcap choice is made once a tile (by_tile): only tiles crossing the
//    diagonal, the window's edge, a ragged end or two ids run the element
//    predicate.
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
};

template <int D, int WGS>
constexpr size_t smem_bytes() {
  return 1024 + WGS * 64 * D * 2 + 4 * BN * D * 2 + 64;
}

// One (batch x q head, q tile of 64 WGS rows): O and, with lse, the base-2 LSE.
template <typename T, int D, bool MASKED, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1) fwd_kernel(const __grid_constant__ Params p) {
  constexpr int BM = 64 * WGS, Q_TILE = BM * D * 2, KV_TILE = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_kv = s_q + Q_TILE;  // stage s: K at s_kv + 2 s KV_TILE, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_kv + 4 * KV_TILE);  // [0]: Q; [1 + s]: stage s

  const int tid = threadIdx.x, wg = tid / 128, w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
  const int bh = blockIdx.x, b = bh / p.num_q_heads, h = bh % p.num_q_heads, hk = h / p.group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int r0 = m0 + 64 * wg;  // this warpgroup's first row
  const int diag = p.kv_len - p.q_len;
  const int last_row = min(m0 + BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + diag + 1) : p.kv_len;
  // Window: start at the tile of the first column the tile's first row sees.
  const int n_begin = MASKED && p.window > 0 ? max(0, m0 + diag - p.window + 1) / BN * BN : 0;
  const bool segs = MASKED && p.seg_q != nullptr;
  auto next_live = [&](int n0) {
    if (segs) {
      while (n0 < n_end && !seg_meet(p, b, m0 / SEG, n0 / SEG) && !(WGS == 2 && seg_meet(p, b, m0 / SEG + 1, n0 / SEG)))
        n0 += BN;
    }
    return n0;
  };
  auto load_kv = [&](int s, int n0) {
    uint8_t* stage = s_kv + 2 * s * KV_TILE;
    mbar_expect(&bar[1 + s], 2 * KV_TILE);
    load_tile<D, BN>(stage, &p.tm_k, n0, hk, b, &bar[1 + s]);
    load_tile<D, BN>(stage + KV_TILE, &p.tm_v, n0, hk, b, &bar[1 + s]);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int n_load = next_live(n_begin);  // thread 0's cursor: the next tile to load
  if (tid == 0) {
    mbar_expect(&bar[0], Q_TILE);
    load_tile<D, BM>(s_q, &p.tm_q, m0, h, b, &bar[0]);
    for (int s = 0; s < 2 && n_load < n_end; ++s) {
      load_kv(s, n_load);
      n_load = next_live(n_load + BN);
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
  for (int n0 = next_live(n_begin); n0 < n_end; n0 = next_live(n0 + BN), ++it) {
    const int s = it & 1;
    const uint32_t k_tile = smem_u32(s_kv + 2 * s * KV_TILE), v_tile = k_tile + KV_TILE;
    mbar_wait(&bar[1 + s], (it >> 1) & 1);

    float sc[BN / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<T>(sc, desc_k<D, BM>(q_tile, 64 * wg, kk), desc_k<D, BN>(k_tile, 0, kk), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // Whether any pair of this warpgroup's 64 x 64 tile is masked out.
    bool need = (p.causal && n0 + BN - 1 > r0 + diag) || n0 + BN > p.kv_len;
    if constexpr (MASKED) {
      need = need || (p.window > 0 && n0 <= r0 + 63 + diag - p.window) ||
             (segs && !seg_uniform(p, b, r0 / SEG, n0 / SEG));
    }
    by_tile<MASKED>(p, need, [&](auto cap, auto mask) {
      constexpr bool CAP = decltype(cap)::value;
      // The base-2 score of a pair is x * s2: x the raw product, or with CAP
      // the capped score softcap2 * tanh(raw * scale2 / softcap2).
      const float s2 = CAP ? 1.f : p.scale2;
      float mx_a = fat::MASK_VALUE, mx_b = fat::MASK_VALUE;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool lo = (i & 2) == 0;
        float x = sc[i];
        if constexpr (CAP) x = p.softcap2 * tanhf(x * p.scale2 / p.softcap2);
        if constexpr (decltype(mask)::value) {
          const int col = n0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int32_t col_id = segs && col < p.kv_len ? seg_kv[col] : 0;
          if (!sees<MASKED>(p, lo ? ra : rb, col, lo ? id_a : id_b, col_id)) x = fat::MASK_VALUE;
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
    uint32_t pa[BN / 16][4];
    to_a_frags<T, BN / 16>(pa, sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<T, D>(acc, pa[kk], desc_mn<D, BN>(v_tile, kk));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && n_load < n_end) {
      load_kv(s, n_load);
      n_load = next_live(n_load + BN);
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

template <typename T, int D, bool MASKED, int WGS>
cudaError_t run(const Params& p, const fat::Sm90FwdCall& c) {
  constexpr size_t smem = smem_bytes<D, WGS>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, D, MASKED, WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(c.batch * c.num_q_heads), static_cast<unsigned>((c.q_len + 64 * WGS - 1) / (64 * WGS)));
  fwd_kernel<T, D, MASKED, WGS><<<grid, 128 * WGS, smem, c.stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const fat::Sm90FwdCall& c) {
  Params p{};
  const int64_t* st = c.st;
  if (!make_map<D>(&p.tm_q, c.q, c.dtype, c.batch, c.num_q_heads, c.q_len, st[0], st[1], st[2], c.q_tile) ||
      !make_map<D>(&p.tm_k, c.k, c.dtype, c.batch, c.num_kv_heads, c.kv_len, st[3], st[4], st[5], BN) ||
      !make_map<D>(&p.tm_v, c.v, c.dtype, c.batch, c.num_kv_heads, c.kv_len, st[6], st[7], st[8], BN))
    return cudaErrorInvalidValue;
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
  const bool masked = c.window > 0 || c.softcap2 > 0.f || c.seg_q != nullptr;
  if (c.q_tile == 128) return masked ? run<T, D, true, 2>(p, c) : run<T, D, false, 2>(p, c);
  return masked ? run<T, D, true, 1>(p, c) : run<T, D, false, 1>(p, c);
}

template <typename T>
cudaError_t by_head_dim(const fat::Sm90FwdCall& c) {
  switch (c.head_dim) {
    case 32: return launch<T, 32>(c);
    case 64: return launch<T, 64>(c);
    case 128: return launch<T, 128>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace fat {

cudaError_t sm90_fwd(const Sm90FwdCall& c) {
  if (c.window < 0 || (c.window > 0 && !c.causal)) return cudaErrorInvalidValue;
  if (c.seg_q != nullptr && (c.seg_kv == nullptr || c.q_rng == nullptr || c.kv_rng == nullptr))
    return cudaErrorInvalidValue;
  if ((c.q_tile != 64 && c.q_tile != 128) || c.q_len < 1 || c.kv_len < 1) return cudaErrorInvalidValue;
  switch (c.dtype) {
    case kBFloat16: return by_head_dim<bf16>(c);
    case kFloat16: return by_head_dim<__half>(c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fat
