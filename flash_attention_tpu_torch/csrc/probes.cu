// P1-P6: the TPU kernel probes of the repository's tools/ as two bodies for
// Hopper on wgmma with TMA-fed tiles (csrc/sm90_common.cuh). bf16 inputs
// [heads, seq, 128], contiguous; bf16 output of the same shape. Only head_dim
// 128 and bf16 are instantiated: the probes' only shapes.
//
// Replaces tools/softmax_probe.py:make_fn (P1), tools/grid_probe.py:make_call
// (P3) and tools/causal_probe.py:make_fn (P4) with body T, and
// tools/mfu_probe.py:probe_kernel / perhead_kernel (P2),
// tools/gap_probe.py:single_step_kernel (P5) and tools/epilogue_probe.py:kernel
// (P6) with body S. Each body computes what its TPU kernels compute; the
// Python side (flash_attention_tpu_torch/tools/probes.py) holds every
// variant against a plain PyTorch version of the same function.
//
// What each body computes.
//
// Body T (P1, P3, P4): a tiled attention forward with an online softmax. A
// block takes one (head, BM-row q tile) and walks the kv tiles of BN rows in
// order (the TPU grid's sequential "arbitrary" axis); q is taken as given,
// unscaled, and p enters P V rounded to bf16. Compile-time variants:
//  * ARITH: the softmax in fp32, or as softmax_probe.py's bf16 variant does
//    it (scores rounded to bf16 after QK^T, mask value -0.7 * bf16 max, row
//    max into fp32 m, p = exp2(s - bf16(m)) in bf16 by h2exp2, row sum in
//    fp32);
//  * SKIP: the walk ends at the tile holding the block's last row (causal
//    tile skipping; the TPU clamped its index map and ran pl.when);
//  * MASK: none, always (every tile takes the causal iota mask) or cond
//    (only tiles whose last column passes the block's first row: the choice
//    made once a tile). Without SKIP, none is wrong by design for a causal
//    probe, as in causal_probe.py;
//  * BM x BN: 64x64, 128x64, 64x128, 128x128, in place of the TPU's 256-2048
//    row VMEM blocks;
//  * GRID, the block order, standing in for grid_probe.py's dimension
//    semantics: head-major 2-D (head = blockIdx.y, q tile = blockIdx.x:
//    neighbouring blocks share K/V in L2; the "par" column), q-tile-major
//    2-D (the two swapped: neighbouring blocks are different heads; the
//    "arb" column, whose sequential order the card has no counterpart of),
//    and one collapsed 1-D grid deriving both indices by a division in the
//    kernel (the "2d" column, whose index maps did the same). The order is
//    the one given: the q tiles are not reversed.
// Only the combinations the probes run are instantiated: every (SKIP, MASK)
// in fp32 head-major, bf16 unmasked or skip + always, and the other two
// grid orders unmasked in fp32, each at the four tile shapes.
//
// Body S (P2, P5, P6): one pass over the whole row with no rescale. The row
// max is taken over all seq columns before any exp2 and floored at M_FLOOR
// after scaling, as the TPU bodies do over their [hb, S, S] block, and QK^T
// is computed once. Compile-time variants:
//  * STAGE: mma (p = bf16(s)), max (p = bf16(s - m)), softmax (p =
//    exp2(s * scale2 - m)), as mfu_probe.py's stages;
//  * EPI, where 1/l goes: none (no normalise; mfu_probe.py's exp2 stage),
//    before_pv (p * inv before PV; mfu_probe.py's full), after_pv (PV * inv;
//    the shipped K1 and gap_probe.py), after_pv_noguard (PV / l),
//    after_pv_bf16 (bf16(PV) * bf16(inv) in bf16), as epilogue_probe.py;
//  * MASK: full plus the causal iota mask (mfu_probe.py's mask stage);
//  * HB: 1, a warpgroup's 64 rows from one head a block, or 2
//    (mfu_probe.py's perhead): two warpgroups, one a head, two independent
//    chains in one block, the Hopper form of the TPU probe's per-head
//    unrolled dots.
//
// What bounds them on this card: at seq >= 512 and head_dim 128 the
// products are O(seq^2 * 128) against O(seq * 128) bytes, so arithmetic
// bounds them (989 TFLOP/s dense bf16), which only wgmma reaches. The
// probes measure what stands between a body and that bound: the softmax
// passes (P2, P1), the masking and the skipped tiles (P4), the block shape
// and order (P3), the host wrapper (P5) and the epilogue (P6).
//
// Body T's design: FlashAttention-3's forward (Shah et al. 2024, sections
// 3.1-3.2), warp-specialised.
//  * The last warpgroup is the producer: at BM 128 it gives its registers
//    to the consumers (setmaxnreg: 24 against 240 a thread), and one of
//    its threads loads the Q tile once and fills a three-stage ring of
//    K / V tiles by TMA from tensor maps over [1, heads, seq, 128], each
//    stage with a full mbarrier (the bytes landed) and an empty one (every
//    consumer thread is done with it).
//  * BM / 64 consumer warpgroups, 64 q rows each. S = Q K^T is an SS
//    wgmma at N = BN; the softmax runs in the accumulator registers, and p,
//    rounded to bf16, is the A operand of O += P V from registers. Within
//    a warpgroup the products are pipelined: tile j's S
//    product and tile j - 1's P V are issued together, and tile j's softmax
//    runs while that P V is in flight; O is rescaled once it lands. At
//    128 x 128 S, P and O together are more registers than ptxas (CUDA
//    12.9) gives a consumer: it compiles each role at the launch's entry
//    count (168 at 384 threads), setmaxnreg or not, and spilled and
//    serialised the wgmma chain (PERF.md, section 6). There each warpgroup runs
//    S, its softmax and P V in order and relies on the ping-pong alone.
//  * At BM 128 the two consumer warpgroups take turns on two named
//    barriers (ping-pong): each issues its products only after the other
//    has issued its own, so one's softmax runs under the other's products.
//
// Body S's design: the row's scores stay on chip, split over a thread-block
// cluster. 64 rows of fp32 scores over 1024 columns are 256 KB, more than
// the 232,448 bytes a block may use, so each row's columns are split over
// PARTS blocks of a cluster (2 at hb 1; 4 at hb 2, whose blocks hold two
// heads), each holding 64 x seq / PARTS fp32 scores a warpgroup in its own
// shared memory:
//  * each warpgroup computes S = Q K^T over its block's share of the kv
//    rows by SS wgmma (K tiles of 64 rows at hb 1, 32 at hb 2, by TMA
//    through a three-stage ring, one thread issuing), stores the
//    accumulators, masked, into the score array in the thread's own
//    fragment layout (16-byte stores, consecutive threads on consecutive
//    addresses) while the next tile's product runs, and keeps each row's
//    running max;
//  * the row max is taken over all blocks: each writes its 64 partial
//    maxima into every peer's shared memory (distributed shared memory)
//    across a cluster barrier. The same goes for l, before P V where 1/l
//    goes before it, else beside the partial outputs;
//  * each warpgroup runs P V over its own share (V tiles through the same
//    ring), with P read from its score array, transformed and rounded as
//    the stage and epilogue say;
//  * the partial outputs are added through distributed shared memory: each
//    block owns 128 / PARTS output columns, receives every block's partial
//    of them (its own included, 16-byte stores in the fragment layout) and
//    adds them in rank order, so every call gives the same bits; then it
//    applies the epilogue and writes them. At hb 1 they land in a buffer of
//    their own, so one cluster barrier covers them; at hb 2 they take the
//    score array's place after a barrier. The last cluster barrier comes
//    after the last access to a peer's shared memory, so no block exits
//    while a peer may still write into it.
//
// Tried and dropped (PERF.md, section 6): two warpgroups sharing one K / V ring
// over a 128-row q tile at hb 1, clusters of 4, which halved the bytes read
// from L2 but ran slower on 32-row tiles.

#include <cuda.h>

#include "common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fat::sm90;
using bf16 = __nv_bfloat16;

constexpr int D = 128;  // head_dim, the probes' only width
constexpr float MASK_VALUE_BF16 = -0.7f * 3.3895313892515355e38f;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on an H100

enum Arith : int { kF32 = 0, kBF16 = 1 };
enum Mask : int { kNone = 0, kAlways = 1, kCond = 2 };
enum Grid : int { kHeadMajor = 0, kQTileMajor = 1, kFlat = 2 };
enum Stage : int { kMma = 0, kMax = 1, kSoftmax = 2 };
enum Epi : int { kNoNorm = 0, kBeforePV = 1, kAfterPV = 2, kAfterPVNoGuard = 3, kAfterPVBf16 = 4 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 1));
  return fmaxf(x, __shfl_xor_sync(fat::FULL_MASK, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(fat::FULL_MASK, x, 1);
  return x + __shfl_xor_sync(fat::FULL_MASK, x, 2);
}

// ---------------------------------------------------------------- body T

struct TiledParams {
  CUtensorMap tm_q, tm_k, tm_v;  // [1, heads, seq, 128]: boxes of BM rows (Q) and BN rows (K, V)
  bf16* o;
  int heads, seq;
};

// Threads, registers and shared memory of a tile shape (tools/probes.py
// tiled_smem mirrors SMEM). One block an SM: 168 registers a thread at 384
// threads, which setmaxnreg moves to 24 for the producer and 240 for the
// consumers at run time (64,512 of the SM's 65,536); 255 at 256 threads.
template <int BM, int BN>
struct TPlan {
  static constexpr int CWG = BM / 64;         // consumer warpgroups
  static constexpr int NT = 128 * (CWG + 1);  // and the producer warpgroup
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;  // a K or V tile
  static constexpr int BARS = 8 * (1 + 2 * STAGES);
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BARS;
};

// The online softmax of one tile's scores in place: s (the S accumulator of
// rows ra, ra + 8, columns col0 + 8 (i / 4) + 2 t + (i & 1)) becomes p
// (bf16-exact values in the bf16 variant); m and l advance, al_* are the O
// rescale factors.
template <int BN, int ARITH, bool MASKED>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float& m_a, float& m_b, float& l_a, float& l_b,
                                               float& al_a, float& al_b, int col0, int ra, int t) {
  float mask_value = fat::MASK_VALUE;
  if constexpr (ARITH == kBF16) mask_value = __bfloat162float(__float2bfloat16_rn(MASK_VALUE_BF16));
  float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const bool lo = (i & 2) == 0;
    float x = s[i];
    if constexpr (ARITH == kBF16) x = __bfloat162float(__float2bfloat16_rn(x));
    if constexpr (MASKED) {
      if (col0 + 8 * (i / 4) + 2 * t + (i & 1) > (lo ? ra : ra + 8)) x = mask_value;
    }
    s[i] = x;
    if (lo) {
      mx_a = fmaxf(mx_a, x);
    } else {
      mx_b = fmaxf(mx_b, x);
    }
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
  al_a = exp2f(m_a - mn_a);
  al_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  float rs_a = 0.f, rs_b = 0.f;
  if constexpr (ARITH == kF32) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const bool lo = (i & 2) == 0;
      const float pr = exp2f(s[i] - (lo ? mn_a : mn_b));
      s[i] = pr;
      if (lo) {
        rs_a += pr;
      } else {
        rs_b += pr;
      }
    }
  } else {
    const __nv_bfloat162 mb_a = __float2bfloat162_rn(mn_a), mb_b = __float2bfloat162_rn(mn_b);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const bool lo = (i & 2) == 0;
      // s is already a bf16 value, so this pack is exact.
      const __nv_bfloat162 pb = h2exp2(__hsub2(__floats2bfloat162_rn(s[i], s[i + 1]), lo ? mb_a : mb_b));
      s[i] = __low2float(pb);
      s[i + 1] = __high2float(pb);
      if (lo) {
        rs_a += s[i] + s[i + 1];
      } else {
        rs_b += s[i] + s[i + 1];
      }
    }
  }
  l_a = al_a * l_a + quad_sum(rs_a);
  l_b = al_b * l_b + quad_sum(rs_b);
}

template <int BN, int ARITH, int MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float& m_a, float& m_b, float& l_a, float& l_b,
                                             float& al_a, float& al_b, int j, int block_row0, int ra, int t) {
  // cond: the block's first row against the tile's last column, once a tile.
  if (MASK == kAlways || (MASK == kCond && (j + 1) * BN - 1 > block_row0)) {
    online_softmax<BN, ARITH, true>(s, m_a, m_b, l_a, l_b, al_a, al_b, j * BN, ra, t);
  } else {
    online_softmax<BN, ARITH, false>(s, m_a, m_b, l_a, l_b, al_a, al_b, j * BN, ra, t);
  }
}

template <int BM, int BN, int ARITH, bool SKIP, int MASK, int GRID>
__global__ void __launch_bounds__(TPlan<BM, BN>::NT, 1) tiled_kernel(const __grid_constant__ TiledParams p) {
  using Pl = TPlan<BM, BN>;
  constexpr int CWG = Pl::CWG, ST = Pl::STAGES, KV = Pl::KV_BYTES;
  constexpr bool PING = CWG == 2;
  // The intra-warpgroup pipeline holds S, P and O at once: at 128 x 128 that is more than
  // the 168 registers ptxas compiles a consumer of a 384-thread block at, and it spills.
  constexpr bool PIPE = !(BM == 128 && BN == 128);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = align_1024(smem_raw);
  uint8_t* s_kv = s_q + Pl::Q_BYTES;  // stage s: K at 2 s KV, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(s_kv + 2 * ST * KV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

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
  const int nkv = SKIP ? ((iq + 1) * BM - 1) / BN + 1 : p.seq / BN;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CWG) {  // the producer: its first warp loads
    if constexpr (CWG == 2) regs_dec<Pl::PRODUCER_REGS>();
    if (tid / 32 == 4 * CWG) {
      const bool leader = tid % 32 == 0;
      if (leader) {
        prefetch_map(&p.tm_q);
        prefetch_map(&p.tm_k);
        prefetch_map(&p.tm_v);
        mbar_expect(q_full, Pl::Q_BYTES);
        load_tile<D, BM>(s_q, &p.tm_q, iq * BM, head, 0, q_full);
      }
      for (int j = 0; j < nkv; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        if (leader) {
          mbar_expect(&full[s], 2 * KV);
          load_tile<D, BN>(s_kv + 2 * s * KV, &p.tm_k, j * BN, head, 0, &full[s]);
          load_tile<D, BN>(s_kv + (2 * s + 1) * KV, &p.tm_v, j * BN, head, 0, &full[s]);
        }
      }
    }
  } else {  // a consumer: 64 q rows
    if constexpr (CWG == 2) regs_inc<Pl::CONSUMER_REGS>();
    const int w4 = (tid / 32) % 4, g = (tid % 32) / 4, t = tid % 4;
    const int ra = iq * BM + 64 * wg + 16 * w4 + g;  // this thread's rows: ra and ra + 8
    const int block_row0 = iq * BM;
    // Ping-pong: barrier 1 + w is warpgroup w's turn to issue products.
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (PING && wg == 1) named_arrive(1, 256);  // warpgroup 0 goes first
    const uint32_t q_desc_tile = smem_u32(s_q);
    auto k_tile = [&](int s) { return smem_u32(s_kv + 2 * s * KV); };
    auto v_tile = [&](int s) { return smem_u32(s_kv + (2 * s + 1) * KV); };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];
    float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f, al_a, al_b;

    auto s_product = [&](int s) {  // S = Q K^T of the tile in stage s
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_bf16<BN>(sc, desc_k<D, BM>(q_desc_tile, 64 * wg, kk), desc_k<D, BN>(k_tile(s), 0, kk), kk);
      wg_commit();
    };
    auto pv_product = [&](int s) {  // O += P V of the tile in stage s
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) mma_rs<bf16, D>(o, pa[kk], desc_mn<D, BN>(v_tile(s), kk));
      wg_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= al_a;
        o[4 * i + 1] *= al_a;
        o[4 * i + 2] *= al_b;
        o[4 * i + 3] *= al_b;
      }
    };

    mbar_wait(q_full, 0);
    if constexpr (PIPE) {
      mbar_wait(&full[0], 0);
      if (PING) named_sync(my_turn, 256);
      s_product(0);
      if (PING) named_arrive(other_turn, 256);
      wg_wait<0>();
      fence_regs(sc);
      softmax_tile<BN, ARITH, MASK>(sc, m_a, m_b, l_a, l_b, al_a, al_b, 0, block_row0, ra, t);
      for (int j = 1; j < nkv; ++j) {
        const int s = j % ST, sp = (j - 1) % ST;
        to_a_frags<bf16, BN / 16>(pa, sc);  // P of tile j - 1
        mbar_wait(&full[s], (j / ST) & 1);
        if (PING) named_sync(my_turn, 256);
        s_product(s);
        pv_product(sp);
        if (PING) named_arrive(other_turn, 256);
        wg_wait<1>();  // S of tile j; P V of tile j - 1 stays in flight under the softmax
        fence_regs(sc);
        softmax_tile<BN, ARITH, MASK>(sc, m_a, m_b, l_a, l_b, al_a, al_b, j, block_row0, ra, t);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&empty[sp]);
        rescale();
      }
      to_a_frags<bf16, BN / 16>(pa, sc);
      if (PING) named_sync(my_turn, 256);
      wg_fence();
      pv_product((nkv - 1) % ST);
      if (PING) named_arrive(other_turn, 256);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    } else {  // 128 x 128: each warpgroup in turn, S then P V, its softmax under the other's products
      for (int j = 0; j < nkv; ++j) {
        const int s = j % ST;
        mbar_wait(&full[s], (j / ST) & 1);
        if (PING) named_sync(my_turn, 256);
        s_product(s);
        if (PING) named_arrive(other_turn, 256);
        wg_wait<0>();
        fence_regs(sc);
        softmax_tile<BN, ARITH, MASK>(sc, m_a, m_b, l_a, l_b, al_a, al_b, j, block_row0, ra, t);
        rescale();
        to_a_frags<bf16, BN / 16>(pa, sc);
        if (PING) named_sync(my_turn, 256);
        wg_fence();
        pv_product(s);
        if (PING) named_arrive(other_turn, 256);
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&empty[s]);
      }
    }
    if (PING && wg == 0) named_sync(my_turn, 256);  // warpgroup 1's last turn: every arrival is matched

    bf16* orow = p.o + (static_cast<int64_t>(head) * p.seq + ra) * D + 2 * t;
    const float inv_a = l_a == 0.f ? 0.f : 1.f / l_a, inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * D + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
  }
}

struct TiledLaunch {
  TiledParams p;
  cudaStream_t stream;

  template <int BM, int BN, int ARITH, bool SKIP, int MASK, int GRID>
  cudaError_t run() const {
    using Pl = TPlan<BM, BN>;
    static_assert(Pl::SMEM <= MAX_SMEM, "body T's shared memory");
    const auto kernel = tiled_kernel<BM, BN, ARITH, SKIP, MASK, GRID>;
    cudaError_t err = fat::reserve_smem(kernel, static_cast<int>(Pl::SMEM));
    if (err != cudaSuccess) return err;
    const unsigned nq = p.seq / BM, heads = p.heads;
    const dim3 grid = GRID == kHeadMajor ? dim3(nq, heads) : GRID == kQTileMajor ? dim3(heads, nq) : dim3(nq * heads);
    kernel<<<grid, Pl::NT, Pl::SMEM, stream>>>(p);
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

struct SingleParams {
  CUtensorMap tm_q, tm_k, tm_v;  // [1, heads, seq, 128]: boxes of 64 rows (Q) and TN rows (K, V)
  bf16* o;
  int heads, seq;
  float scale2;
};

constexpr int S_MAX_SEQ = 1024;
constexpr int S_SEQ_STEP = 128;

// A warpgroup of 64 q rows for each of a block's HB heads, and each row's
// columns split over a cluster of PARTS blocks. A warpgroup's share of a
// block is its Q tile, its K / V ring and its score array (64 rows x seq /
// PARTS fp32), with the 32 KB of partial outputs it receives apart at hb 1
// and in the score array's place at hb 2, where two warpgroups' shares leave
// no room; then the row statistics the blocks exchange and the mbarriers
// (tools/probes.py single_smem mirrors bytes()).
template <int HB>
struct SPlan {
  static constexpr int PARTS = 2 * HB;         // blocks of a cluster: each takes seq / PARTS kv rows
  static constexpr int TN = HB == 1 ? 64 : 32;  // kv rows of a ring stage: seq / PARTS is a multiple
  static constexpr int STAGES = 3;
  static constexpr int NT = 128 * HB;
  static constexpr bool RECV_APART = HB == 1;
  static constexpr int Q_BYTES = 64 * D * 2;
  static constexpr int TILE_BYTES = TN * D * 2;
  static constexpr int O_BYTES = 64 * D * 4;  // the partial outputs a warpgroup receives
  static constexpr int STATS = 2 * HB * PARTS * 64 * 4;
  static constexpr int BARS = 8 * HB * (1 + STAGES);
  __host__ __device__ static constexpr size_t scores(int seq) {
    return RECV_APART || 64 * (seq / PARTS) * 4 > O_BYTES ? 64 * (seq / PARTS) * 4 : O_BYTES;
  }
  __host__ __device__ static constexpr size_t region(int seq) {
    return Q_BYTES + STAGES * TILE_BYTES + scores(seq) + (RECV_APART ? O_BYTES : 0);
  }
  __host__ __device__ static constexpr size_t bytes(int seq) { return 1024 + HB * region(seq) + STATS + BARS; }
};

// p of one score by stage (the before_pv pass has already made it p).
template <int STAGE, int EPI>
__device__ __forceinline__ float p_of(float s, float m, float inv, float scale2, float& l) {
  if constexpr (STAGE == kMma) {
    return s;
  } else if constexpr (STAGE == kMax) {
    return s - m;
  } else if constexpr (EPI == kBeforePV) {
    return s * inv;
  } else {
    const float x = exp2f(fmaf(s, scale2, -m));
    if constexpr (EPI != kNoNorm) l += x;
    return x;
  }
}

template <int STAGE, int EPI, bool MASK, int HB>
__global__ void __launch_bounds__(SPlan<HB>::NT, 1) single_kernel(const __grid_constant__ SingleParams p) {
  using Pl = SPlan<HB>;
  constexpr int PARTS = Pl::PARTS, TN = Pl::TN, ST = Pl::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const int cols = p.seq / PARTS, ntile = cols / TN;
  const int tid = threadIdx.x, hh = tid / 128, wt = tid % 128, w4 = wt / 32, g = (wt % 32) / 4, t = wt % 4;
  uint8_t* s_q = base + hh * Pl::region(p.seq);
  uint8_t* s_ring = s_q + Pl::Q_BYTES;
  float4* s_sc = reinterpret_cast<float4*>(s_ring + ST * Pl::TILE_BYTES);  // [tile][group][128 threads]
  float* s_mx = reinterpret_cast<float*>(base + HB * Pl::region(p.seq));  // [HB][PARTS][64]
  float* s_l = s_mx + HB * PARTS * 64;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(s_l + HB * PARTS * 64) + hh * (1 + ST);
  uint64_t* full = q_bar + 1;  // a stage each
  const uint32_t rank = cluster_rank();
  const int q0 = blockIdx.x / PARTS * 64, head = blockIdx.y * HB + hh, col0 = rank * cols;
  const int lrow = 16 * w4 + g, ra = q0 + lrow;  // this thread's rows: ra and ra + 8
  const int nstream = 2 * ntile;                  // the K tiles, then the V tiles

  if (wt == 0) {
    for (int i = 0; i <= ST; ++i) mbar_init(&q_bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();

  auto load = [&](int u) {
    const int s = u % ST, row = col0 + (u % ntile) * TN;
    uint8_t* dst = s_ring + s * Pl::TILE_BYTES;
    mbar_expect(&full[s], Pl::TILE_BYTES);
    if (u < ntile) {
      load_tile<D, TN>(dst, &p.tm_k, row, head, 0, &full[s]);
    } else {
      load_tile<D, TN>(dst, &p.tm_v, row, head, 0, &full[s]);
    }
  };
  // Once the warpgroup is done with stream tile u, its stage takes tile u + ST.
  auto release = [&](int u) {
    named_sync(1 + hh, 128);
    if (wt == 0 && u + ST < nstream) load(u + ST);
  };
  if (wt == 0) {
    prefetch_map(&p.tm_q);
    prefetch_map(&p.tm_k);
    prefetch_map(&p.tm_v);
    mbar_expect(q_bar, Pl::Q_BYTES);
    load_tile<D, 64>(s_q, &p.tm_q, q0, head, 0, q_bar);
    for (int u = 0; u < ST && u < nstream; ++u) load(u);
  }

  // S = Q K^T over this block's columns into the score array.
  // Tile u + 1's product runs while tile u's scores are stored (sn lands, sc is stored).
  float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
  float sc[TN / 2], sn[TN / 2];
  const uint32_t q_tile = smem_u32(s_q);
  auto s_product = [&](int u) {
    const int s = u % ST;
    mbar_wait(&full[s], (u / ST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_bf16<TN>(sn, desc_k<D, 64>(q_tile, 0, kk), desc_k<D, TN>(smem_u32(s_ring + s * Pl::TILE_BYTES), 0, kk), kk);
    wg_commit();
  };
  mbar_wait(q_bar, 0);
  s_product(0);
  for (int u = 0; u < ntile; ++u) {
    wg_wait<0>();
    fence_regs(sn);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) sc[i] = sn[i];
    if (u + 1 < ntile) s_product(u + 1);
    release(u);
    const int c0 = col0 + u * TN;
    if (MASK && c0 + TN - 1 > q0) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i)
        if (c0 + 8 * (i / 4) + 2 * t + (i & 1) > ra + ((i & 2) ? 8 : 0)) sc[i] = fat::MASK_VALUE;
    }
#pragma unroll
    for (int c = 0; c < TN / 8; ++c) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
      s_sc[(u * (TN / 8) + c) * 128 + wt] = make_float4(sc[4 * c], sc[4 * c + 1], sc[4 * c + 2], sc[4 * c + 3]);
    }
  }

  // Every block's partial of a row statistic into every block's [PARTS]
  // slots of it (then the cluster barrier).
  auto exchange = [&](float* stat, float x_a, float x_b) {
    if (t == 0) {
      const uint32_t a = smem_u32(stat + (hh * PARTS + rank) * 64 + lrow);
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        st_peer(peer_addr(a, q), x_a);
        st_peer(peer_addr(a + 32, q), x_b);  // row + 8
      }
    }
  };
  cluster_wait();  // the start's arrival: every peer runs
  float m_a = 0.f, m_b = 0.f;
  if constexpr (STAGE != kMma) {
    exchange(s_mx, quad_max(mx_a), quad_max(mx_b));
    cluster_sync();
    float x_a = -CUDART_INF_F, x_b = -CUDART_INF_F;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      x_a = fmaxf(x_a, s_mx[(hh * PARTS + q) * 64 + lrow]);
      x_b = fmaxf(x_b, s_mx[(hh * PARTS + q) * 64 + lrow + 8]);
    }
    m_a = fmaxf(x_a * p.scale2, fat::M_FLOOR);
    m_b = fmaxf(x_b * p.scale2, fat::M_FLOOR);
  }
  constexpr bool NORM = STAGE == kSoftmax && EPI != kNoNorm;
  float l_a = 0.f, l_b = 0.f, inv_a = 0.f, inv_b = 0.f;
  // l over every block's partial, in rank order.
  auto total_l = [&]() {
    l_a = 0.f;
    l_b = 0.f;
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {
      l_a += s_l[(hh * PARTS + q) * 64 + lrow];
      l_b += s_l[(hh * PARTS + q) * 64 + lrow + 8];
    }
    inv_a = l_a == 0.f ? 0.f : 1.f / l_a;
    inv_b = l_b == 0.f ? 0.f : 1.f / l_b;
  };
  if constexpr (STAGE == kSoftmax && EPI == kBeforePV) {  // p and l first: 1/l multiplies p
    float r_a = 0.f, r_b = 0.f;
    for (int i = wt; i < ntile * (TN / 8) * 128; i += 128) {
      float4 x = s_sc[i];
      x.x = exp2f(fmaf(x.x, p.scale2, -m_a));
      x.y = exp2f(fmaf(x.y, p.scale2, -m_a));
      x.z = exp2f(fmaf(x.z, p.scale2, -m_b));
      x.w = exp2f(fmaf(x.w, p.scale2, -m_b));
      r_a += x.x + x.y;
      r_b += x.z + x.w;
      s_sc[i] = x;
    }
    exchange(s_l, quad_sum(r_a), quad_sum(r_b));
    cluster_sync();
    total_l();
  }

  // O += P V over this block's columns.
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float r_a = 0.f, r_b = 0.f;  // l's partial where it comes after P V
  // Each tile's A fragments are built, then multiplied: building tile u + 1's
  // while tile u's product reads its copy gave wrong sums at hb 2, with no
  // wait injected by ptxas (PERF.md, section 6).
  for (int u = ntile; u < nstream; ++u) {
    const int s = u % ST, tv = u - ntile;
    uint32_t a[TN / 16][4];
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 x = s_sc[(tv * (TN / 8) + 2 * kk + half) * 128 + wt];
        a[kk][2 * half] = bits(__floats2bfloat162_rn(p_of<STAGE, EPI>(x.x, m_a, inv_a, p.scale2, r_a),
                                                     p_of<STAGE, EPI>(x.y, m_a, inv_a, p.scale2, r_a)));
        a[kk][2 * half + 1] = bits(__floats2bfloat162_rn(p_of<STAGE, EPI>(x.z, m_b, inv_b, p.scale2, r_b),
                                                         p_of<STAGE, EPI>(x.w, m_b, inv_b, p.scale2, r_b)));
      }
    }
    mbar_wait(&full[s], (u / ST) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TN / 16; ++kk)
      mma_rs<bf16, D>(o, a[kk], desc_mn<D, TN>(smem_u32(s_ring + s * Pl::TILE_BYTES), kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(a);
    release(u);
  }
  if constexpr (NORM && EPI != kBeforePV) exchange(s_l, quad_sum(r_a), quad_sum(r_b));
  // At hb 2 the partial outputs go where the scores were: every block must be done with them.
  if constexpr (!Pl::RECV_APART) cluster_sync();

  // The partial outputs to their columns' owners: block q owns the
  // accumulator's 8-column blocks [q F, (q + 1) F), 128 / PARTS columns, and
  // keeps every block's partial of them as [rank][block][thread] float4s in
  // the fragment layout, which the same thread of the owner reads back.
  constexpr int F = D / 8 / PARTS;
  float4* recv = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(s_sc) + (Pl::RECV_APART ? Pl::scores(p.seq) : 0));
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int q = i / F;
    float4* slot = recv + (rank * F + i % F) * 128 + wt;
    const float4 x = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    if (q == static_cast<int>(rank)) {
      *slot = x;
    } else {
      st_peer(peer_addr(smem_u32(slot), q), x);
    }
  }
  cluster_sync();  // the last: no block reads or writes a peer's shared memory after it
  if constexpr (NORM && EPI != kBeforePV) total_l();

  bf16* orow = p.o + (static_cast<int64_t>(head) * p.seq + ra) * D + 2 * t;
  for (int f = 0; f < F; ++f) {
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < PARTS; ++q) {  // rank order, on every call
      const float4 x = recv[(q * F + f) * 128 + wt];
      y.x += x.x;
      y.y += x.y;
      y.z += x.z;
      y.w += x.w;
    }
    __nv_bfloat162 out_a, out_b;
    if constexpr (EPI == kAfterPV) {
      out_a = __floats2bfloat162_rn(y.x * inv_a, y.y * inv_a);
      out_b = __floats2bfloat162_rn(y.z * inv_b, y.w * inv_b);
    } else if constexpr (EPI == kAfterPVNoGuard) {
      out_a = __floats2bfloat162_rn(y.x / l_a, y.y / l_a);
      out_b = __floats2bfloat162_rn(y.z / l_b, y.w / l_b);
    } else if constexpr (EPI == kAfterPVBf16) {
      out_a = __hmul2(__floats2bfloat162_rn(y.x, y.y), __float2bfloat162_rn(inv_a));
      out_b = __hmul2(__floats2bfloat162_rn(y.z, y.w), __float2bfloat162_rn(inv_b));
    } else {
      out_a = __floats2bfloat162_rn(y.x, y.y);
      out_b = __floats2bfloat162_rn(y.z, y.w);
    }
    const int col = 8 * (static_cast<int>(rank) * F + f);
    *reinterpret_cast<__nv_bfloat162*>(orow + col) = out_a;
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * D + col) = out_b;
  }
}

struct SingleLaunch {
  SingleParams p;
  cudaStream_t stream;

  template <int STAGE, int EPI, bool MASK, int HB>
  cudaError_t run() const {
    using Pl = SPlan<HB>;
    static_assert(Pl::bytes(S_MAX_SEQ) <= MAX_SMEM, "body S's shared memory");
    const auto kernel = single_kernel<STAGE, EPI, MASK, HB>;
    cudaError_t err = fat::reserve_smem(kernel, static_cast<int>(Pl::bytes(S_MAX_SEQ)));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Pl::PARTS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(Pl::PARTS * (p.seq / 64), p.heads / HB);
    cfg.blockDim = dim3(Pl::NT);
    cfg.dynamicSmemBytes = Pl::bytes(p.seq);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// Tensor maps over q, k, v [heads, seq, 128] bf16 as [1, heads, seq, 128],
// boxes of q_rows (Q) and kv_rows (K, V) rows.
template <typename P>
bool make_maps(P& p, const void* q, const void* k, const void* v, int64_t heads, int64_t seq, int q_rows, int kv_rows) {
  const int64_t sh = seq * D, sb = heads * sh;
  return make_map<D>(&p.tm_q, q, fat::kBFloat16, 1, heads, seq, sb, sh, D, q_rows) &&
         make_map<D>(&p.tm_k, k, fat::kBFloat16, 1, heads, seq, sb, sh, D, kv_rows) &&
         make_map<D>(&p.tm_v, v, fat::kBFloat16, 1, heads, seq, sb, sh, D, kv_rows);
}

}  // namespace

// Body T (P1, P3, P4). q, k, v, o [heads, seq, 128] bf16 contiguous; seq a
// multiple of bm and bn; (bm, bn) in {64, 128}^2; arith, skip, mask and
// grid as the enums above, in the combinations tiled_variant instantiates.
// Returns a cudaError_t.
extern "C" int fat_probe_tiled(const void* q, const void* k, const void* v, void* o, int64_t heads, int64_t seq,
                               int32_t bm, int32_t bn, int32_t arith, int32_t skip, int32_t mask, int32_t grid,
                               void* stream) {
  if (heads < 1 || seq < bm || seq < bn || seq % bm || seq % bn || (bm != 64 && bm != 128) || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  TiledLaunch L{};
  if (!make_maps(L.p, q, k, v, heads, seq, bm, bn)) return static_cast<int>(cudaErrorInvalidValue);
  L.p.o = static_cast<bf16*>(o);
  L.p.heads = static_cast<int>(heads);
  L.p.seq = static_cast<int>(seq);
  L.stream = static_cast<cudaStream_t>(stream);
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
// only). Launched as clusters of 2 hb blocks. Returns a cudaError_t.
extern "C" int fat_probe_single(const void* q, const void* k, const void* v, void* o, int64_t heads, int64_t seq,
                                float scale2, int32_t stage, int32_t epilogue, int32_t mask, int32_t hb,
                                void* stream) {
  if (heads < 1 || seq < S_SEQ_STEP || seq > S_MAX_SEQ || seq % S_SEQ_STEP || (hb != 1 && hb != 2) || heads % hb)
    return static_cast<int>(cudaErrorInvalidValue);
  SingleLaunch L{};
  if (!make_maps(L.p, q, k, v, heads, seq, 64, hb == 1 ? SPlan<1>::TN : SPlan<2>::TN))
    return static_cast<int>(cudaErrorInvalidValue);
  L.p.o = static_cast<bf16*>(o);
  L.p.heads = static_cast<int>(heads);
  L.p.seq = static_cast<int>(seq);
  L.p.scale2 = scale2;
  L.stream = static_cast<cudaStream_t>(stream);
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
