// K1, K1d, K2 and K8: fused attention forward (causal or not, MHA or GQA)
// over dense K/V or, in place, over a slot's KV pages (bf16 / fp16 / fp32, or
// K8 over quantized pages: int8, fp8 e4m3, fp8 e5m2 with one fp32 scale per
// row and head), with an optional sliding window, logit softcap and (dense
// only) packed-sequence segment ids, for Hopper.
//
// Replaces the JAX package's ops/flash_attention.py:_fwd_kernel (K1, the
// Pallas forward, with its window and softcap branches, :318-331, :408-490,
// and its segment branch K1d, :61-62, :336-337, :495-496, with the packed
// tile skip of :1313-1330 and :1428-1431),
// ops/flash_attention.py:_band_kernel (:795, K2, the window == block band
// case) and ops/paged.py:_paged_prefill_kernel (:580, K8, chunked-prefill
// attention reading K/V pages in place, with its dequant, window, softcap
// and sink branches, :642, :666-682). Same function: S = Q K^T in fp32, an
// online exp2 softmax with scale2 = sm_scale * log2(e), P V accumulated in
// fp32, the output normalised by l (0 where l == 0), and optionally the
// base-2 LSE m + log2(l) (-inf where l == 0). Causal masking is
// end-aligned: row i sees columns j <= i + (kv_len - q_len); for K8, kv_len
// is the chunk's kv_end and the chunk's rows sit at positions [kv_end -
// q_len, kv_end). The kv head of q head h is h / group.
//
// Masks (runtime parameters of the body's masked instantiation; the
// unmasked one is compiled without them):
//  * softcap: the fp32 score becomes softcap2 * tanhf(s / softcap2), with
//    softcap2 = cap * log2(e), i.e. cap * tanh(qk * sm_scale / cap) in the
//    exp2 domain, before any mask (exact tanhf, not tanh.approx);
//  * window w: row i (at position i + kv_len - q_len) also needs column
//    j > i + kv_len - q_len - w. Each q tile starts its kv walk at the tile
//    holding its first row's first visible column, so tiles below the band
//    are skipped, not masked: a chunk past the window costs O(window);
//  * sinks s (K8, StreamingLLM): columns j < s are visible beside the
//    window band, so the walk also takes the tiles holding [0, s);
//  * segment ids (K1d, packed sequences): row i sees column j only where
//    seg_q[i] == seg_kv[j]. The walk skips a (q tile, kv tile) pair whose id
//    ranges [min, max] are disjoint (the wrapper reduces each 64-row tile's
//    ids to its range), before its K/V are loaded: exact for any ids, and
//    for contiguous documents the walk costs O(document), not O(row). The
//    TPU kernel's scalar-prefetch triangular enumeration (:919-1000), which
//    Mosaic needed to skip grid steps, is not carried over.
// K2 is this body when the window fits one kv tile (w <= 64): rows [m0, m0
// + 64) see at most 64 - 1 + w <= 127 columns from the first row's first
// visible one, so the walk is two tiles starting at that column (unaligned;
// dense K/V only), unrolled. The TPU kernel's sub-tiled leading edge,
// diag_pipe and window_lead are not ported.
//
// One body serves both through a kv address policy (tile_index below): the
// 64-row kv tile starting at row n0 of (b, kv head h) is
//   dense:  base + b * sb + h * sh + n0 * sr
//   paged:  pages + clamp(table[n0 / page_size]) * sb + h * sh + (n0 % page_size) * sr
// and a quantized tile's row scales lie at the same (page, h, row) of the
// scale pool. A tile never straddles a page (page_size is a multiple of 64),
// so the table is read once a tile, and the page id is clamped into
// [0, num_pages). A quantized payload is widened and multiplied by its row's
// scale as the tile is loaded into shared memory (the TPU kernel scales the
// score tile and p instead; the same up to fp32 rounding), so only the
// payload and the scales are read and no dequantized copy exists.
//
// K1 and K1d in bf16 and fp16 run csrc/flash_fwd_sm90.cu's tensor-core body
// (wgmma on TMA-fed tiles), to which fat_flash_fwd dispatches; this body
// serves them in fp32, and K2 and K8 in every dtype.
//
// What bounds it on this card: at long kv the score and PV products are
// O(q_len * kv_len * D) (O(q_len * window * D) with a window) against
// O((q_len + kv_len) * D) bytes, so arithmetic bounds it. This body does
// that arithmetic as fp32 FMAs over shared-memory tiles, not on the tensor
// cores, so it runs far below the card's bf16 rate (K8's and K2's redesign
// is later work). K2's band at window 64 does ~128 columns a row against a
// bound set by its bytes, and is launch- and latency-bound.
//
// Design:
//  * one block per (batch * q_head, 64-row q tile); 128 threads, each owning
//    4 query rows x 8 score columns of a 64 x 64 score tile and 4 rows x D/8
//    output columns; the rows' m, l and accumulators stay in registers;
//  * the block loops over 64-row kv tiles from the window's first tile (0
//    without a window) and stops at the causal diagonal of its last row, so
//    tiles (and pages) above the diagonal or below the window are never
//    loaded; over the paged ring a rolled-out logical page aliases a newer
//    physical one, and it is never read because it lies below the band;
//  * K and V take turns in one fp32 shared tile (rows padded by one float
//    against bank conflicts); P goes through shared memory for the PV step;
//  * q, k and v are read through their batch, head and row strides, so a
//    slice of a KV cache is attended in place without a copy.
#include "common.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int ROWS = 4;       // query rows per thread: 16 * 4 == BM
constexpr int COLS = 8;       // score columns per thread: 8 * 8 == BN

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // K8 quantized: the pages' row scales; else nullptr
  const float* vs;
  void* o;     // [B, Hq, Sq, D], contiguous
  float* lse;  // [B, Hq, Sq] or nullptr
  const int32_t* table;  // paged: the slot's [pages_per_slot] row; dense: unused
  int64_t q_sb, q_sh, q_sr;
  int64_t k_sb, k_sh, k_sr;  // paged: sb is the page stride
  int64_t v_sb, v_sh, v_sr;
  int64_t ks_sp, ks_sh, ks_sr;  // the scale pools' page / head / row strides
  int64_t vs_sp, vs_sh, vs_sr;
  int num_q_heads, group, q_len, kv_len, causal;
  int page_size, num_pages;
  int window;  // 0: no window
  int sinks;   // K8: columns [0, sinks) are visible beside the window
  float scale2;
  float softcap2;  // cap * log2(e); 0: no softcap
  const int32_t* seg_q;   // K1d: [B, Sq] segment ids; else nullptr
  const int32_t* seg_kv;  // K1d: [B, Skv]
  const int32_t* q_rng;   // K1d: [B, ceil(Sq / 64), 2], each q tile's min / max id
  const int32_t* kv_rng;  // K1d: [B, ceil(Skv / 64), 2]
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BM * (D + 1) + BN * (D + 1) + BM * (BN + 1));
}

// Loads BN rows of a matrix with row stride `sr`, starting at `src`, into
// the fp32 tile `dst` (row pitch D + 1), each multiplied by `scale` and, for
// a quantized payload, by its row's scale row_scale[r * ssr]; rows at or
// past `n` read as 0.
template <typename P, int D>
__device__ __forceinline__ void load_tile(float* dst, const P* src, int64_t sr, int n, float scale,
                                          const float* row_scale = nullptr, int64_t ssr = 0) {
  for (int i = threadIdx.x; i < BN * D; i += THREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < n) {
      x = fat::to_float(src[r * sr + d]) * scale;
      if constexpr (fat::is_payload<P>) x *= row_scale[r * ssr];
    }
    dst[r * (D + 1) + d] = x;
  }
}

// Where the kv tile starting at row n0 of batch row b lies: .x is what the
// first stride indexes (the batch row, or the clamped physical page), .y the
// tile's first row in it.
template <bool PAGED>
__device__ __forceinline__ int2 tile_index(const FwdParams& p, int b, int n0) {
  if constexpr (PAGED) {
    return make_int2(min(max(p.table[n0 / p.page_size], 0), p.num_pages - 1), n0 % p.page_size);
  } else {
    return make_int2(b, n0);
  }
}

// One kv tile, rows [n0, n0 + BN), folded into the online softmax of the
// block's q rows: scores, softcap, mask, exp2 update, then P V. m, l and acc
// are the calling thread's rows' state (registers once inlined). MASKED: a
// window, sinks, softcap or segment ids are set; the unmasked instantiation
// has none of their instructions (with them as runtime parameters of one
// instantiation the unmasked K1 ran ~8 % slower, PERF.md).
template <typename P, int D, bool PAGED, bool MASKED>
__device__ __forceinline__ void attend_tile(const FwdParams& p, int b, int hk, int m0, int n0, const P* k_base,
                                            const P* v_base, const float* s_q, float* s_kv, float* s_p,
                                            float (&m)[ROWS], float (&l)[ROWS], float (&acc)[ROWS][D / COLS]) {
  constexpr int LD = D + 1;
  constexpr int LDP = BN + 1;
  constexpr int DC = D / COLS;
  const int tid = threadIdx.x;
  const int ty = tid / COLS, tx = tid % COLS;
  const int diag = p.kv_len - p.q_len;

  const int2 at = tile_index<PAGED>(p, b, n0);
  __syncthreads();  // the previous tile's V and P are no longer read
  load_tile<P, D>(s_kv, k_base + at.x * p.k_sb + at.y * p.k_sr, p.k_sr, p.kv_len - n0, 1.f,
                  p.ks + (at.x * p.ks_sp + hk * p.ks_sh + at.y * p.ks_sr), p.ks_sr);
  __syncthreads();

  float s[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[ROWS], kk[COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) a[i] = s_q[(ty * ROWS + i) * LD + d];
#pragma unroll
    for (int j = 0; j < COLS; ++j) kk[j] = s_kv[(tx + COLS * j) * LD + d];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
  }
  if constexpr (MASKED) {
    if (p.softcap2 > 0.f) {  // uniform across the block
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = p.softcap2 * tanhf(s[i][j] / p.softcap2);
    }
  }

  // K1d: this batch row's ids (a row past q_len reads none).
  const int32_t* seg_kv = nullptr;
  int32_t row_id[ROWS] = {};
  if constexpr (MASKED) {
    if (p.seg_q != nullptr) {  // uniform across the block
      seg_kv = p.seg_kv + static_cast<int64_t>(b) * p.kv_len;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = m0 + ty * ROWS + i;
        row_id[i] = row < p.q_len ? p.seg_q[static_cast<int64_t>(b) * p.q_len + row] : 0;
      }
    }
  }

  // Online softmax; the 8 lanes of a row group share its rows, so row
  // reductions are three xor-shuffles within the group.
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int pos = m0 + ty * ROWS + i + diag;  // the row's position among the columns
    float mx = fat::MASK_VALUE;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = n0 + tx + COLS * j;
      bool ok = col < p.kv_len && (!p.causal || col <= pos);
      if constexpr (MASKED) {
        ok = ok && (p.window == 0 || col > pos - p.window || col < p.sinks);
        if (seg_kv != nullptr) ok = ok && row_id[i] == seg_kv[col];
      }
      if (!ok) s[i][j] = fat::MASK_VALUE;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < COLS; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(fat::FULL_MASK, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = exp2f(m[i] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      s[i][j] = exp2f(s[i][j] - m_new);
      rs += s[i][j];
    }
#pragma unroll
    for (int off = 1; off < COLS; off <<= 1) rs += __shfl_xor_sync(fat::FULL_MASK, rs, off);
    l[i] = l[i] * alpha + rs;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
#pragma unroll
    for (int j = 0; j < COLS; ++j) s_p[(ty * ROWS + i) * LDP + tx + COLS * j] = s[i][j];
  }
  __syncthreads();  // K is no longer read; P is complete
  load_tile<P, D>(s_kv, v_base + at.x * p.v_sb + at.y * p.v_sr, p.v_sr, p.kv_len - n0, 1.f,
                  p.vs + (at.x * p.vs_sp + hk * p.vs_sh + at.y * p.vs_sr), p.vs_sr);
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < BN; ++j) {
    float pr[ROWS], vv[DC];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) pr[i] = s_p[(ty * ROWS + i) * LDP + j];
#pragma unroll
    for (int c = 0; c < DC; ++c) vv[c] = s_kv[j * LD + tx + COLS * c];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
  }
}

// T: query and output type; P: the K/V element type (T, or a payload type
// whose rows are scaled; K8 only). MASKED as for attend_tile; BAND: K2, the
// two-tile walk of a window no wider than a kv tile (dense K/V only).
template <typename T, typename P, int D, bool PAGED, bool MASKED, bool BAND>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FwdParams p) {
  static_assert(!(PAGED && BAND), "K2 walks unaligned tiles, which may straddle a page");
  static_assert(MASKED || !BAND, "K2 is a window's walk");
  constexpr int LD = D + 1;
  constexpr int DC = D / COLS;  // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;              // [BM][LD], pre-scaled by scale2
  float* s_kv = s_q + BM * LD;    // [BN][LD], K then V of the current tile
  float* s_p = s_kv + BN * LD;    // [BM][LDP], probabilities of the tile

  const int tid = threadIdx.x;
  const int ty = tid / COLS, tx = tid % COLS;
  const int bh = blockIdx.y;
  const int b = bh / p.num_q_heads, h = bh % p.num_q_heads;
  const int hk = h / p.group;
  // Causal tiles grow with the row index: start the longest ones first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int diag = p.kv_len - p.q_len;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;

  load_tile<T, D>(s_q, q + m0 * p.q_sr, p.q_sr, p.q_len - m0, p.scale2);
  const P* k_base = static_cast<const P*>(p.k) + hk * p.k_sh;
  const P* v_base = static_cast<const P*>(p.v) + hk * p.v_sh;

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = fat::M_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(m0 + BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + diag + 1) : p.kv_len;
  if constexpr (MASKED) {
    // The first column the tile's first row sees through the window.
    const int w_lo = p.window > 0 ? max(0, m0 + diag - p.window + 1) : 0;
    if constexpr (BAND) {
      // n_end - w_lo <= BM - 1 + window <= 2 * BN - 1: two tiles from w_lo.
      attend_tile<P, D, PAGED, true>(p, b, hk, m0, w_lo, k_base, v_base, s_q, s_kv, s_p, m, l, acc);
      if (w_lo + BN < n_end)  // uniform across the block
        attend_tile<P, D, PAGED, true>(p, b, hk, m0, w_lo + BN, k_base, v_base, s_q, s_kv, s_p, m, l, acc);
    } else {
      const int first = w_lo / BN * BN;
      // K8's sinks: the tiles holding [0, sinks) below the window's first.
      const int sink_end = min((p.sinks + BN - 1) / BN * BN, first);
      for (int n0 = 0; n0 < sink_end; n0 += BN)
        attend_tile<P, D, PAGED, true>(p, b, hk, m0, n0, k_base, v_base, s_q, s_kv, s_p, m, l, acc);
      const int nq = (p.q_len + BM - 1) / BM, nkv = (p.kv_len + BN - 1) / BN;
      for (int n0 = first; n0 < n_end; n0 += BN) {
        // K1d: a tile pair of disjoint id ranges is skipped, K/V unloaded.
        if (p.seg_q != nullptr && !fat::segment_tiles_meet(p.q_rng, p.kv_rng, b, nq, nkv, m0 / BM, n0 / BN))
          continue;  // uniform across the block
        attend_tile<P, D, PAGED, true>(p, b, hk, m0, n0, k_base, v_base, s_q, s_kv, s_p, m, l, acc);
      }
    }
  } else {
    for (int n0 = 0; n0 < n_end; n0 += BN)
      attend_tile<P, D, PAGED, false>(p, b, hk, m0, n0, k_base, v_base, s_q, s_kv, s_p, m, l, acc);
  }

  T* o = static_cast<T*>(p.o) + static_cast<int64_t>(bh) * p.q_len * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m0 + ty * ROWS + i;
    if (row >= p.q_len) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      o[static_cast<int64_t>(row) * D + tx + COLS * c] = fat::from_float<T>(acc[i][c] * inv);
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<int64_t>(bh) * p.q_len + row] =
          l[i] == 0.f ? -CUDART_INF_F : m[i] + log2f(l[i]);
  }
}

template <bool PAGED>
struct FwdLaunch {
  FwdParams p;
  int64_t batch;
  bool band;  // K2 (dense only, no segment ids): a causal window of at most BN columns
  cudaStream_t stream;

  template <typename T, typename P, int D, bool MASKED, bool BAND>
  cudaError_t run() const {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, P, D, PAGED, MASKED, BAND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((p.q_len + BM - 1) / BM, static_cast<unsigned>(batch * p.num_q_heads));
    flash_fwd_kernel<T, P, D, PAGED, MASKED, BAND><<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
  }

  template <typename T, typename P, int D>
  cudaError_t launch() const {
    if (fat::is_payload<P> && (p.ks == nullptr || p.vs == nullptr)) return cudaErrorInvalidValue;
    if (p.window < 0 || (p.window > 0 && !p.causal) || p.sinks < 0) return cudaErrorInvalidValue;
    if (p.seg_q != nullptr && (PAGED || band || p.seg_kv == nullptr || p.q_rng == nullptr || p.kv_rng == nullptr))
      return cudaErrorInvalidValue;
    if constexpr (!PAGED) {
      if (band) {
        if (p.window < 1 || p.window > BN) return cudaErrorInvalidValue;
        return run<T, P, D, true, true>();
      }
    } else {
      if (band) return cudaErrorInvalidValue;
    }
    if constexpr (!PAGED && !std::is_same_v<T, float>) {
      return cudaErrorInvalidValue;  // dense K1 / K1d take this body in fp32 only (else flash_fwd_sm90.cu)
    } else {
      if (p.window > 0 || p.sinks > 0 || p.softcap2 > 0.f || p.seg_q != nullptr) return run<T, P, D, true, false>();
      return run<T, P, D, false, false>();
    }
  }
};

FwdParams make_params(const void* q, const void* k, const void* v, void* o, float* lse,
                      int64_t num_q_heads, int64_t num_kv_heads, int64_t q_len, int64_t kv_len,
                      int64_t q_sb, int64_t q_sh, int64_t q_sr, int64_t k_sb, int64_t k_sh,
                      int64_t k_sr, int64_t v_sb, int64_t v_sh, int64_t v_sr, float scale2,
                      int32_t causal) {
  FwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sr = q_sr;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_sr = k_sr;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_sr = v_sr;
  p.num_q_heads = static_cast<int>(num_q_heads);
  p.group = static_cast<int>(num_q_heads / num_kv_heads);
  p.q_len = static_cast<int>(q_len);
  p.kv_len = static_cast<int>(kv_len);
  p.causal = causal;
  p.scale2 = scale2;
  return p;
}

}  // namespace

// K1, K1d and K2. q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], each with unit
// stride on D and the given batch / head / row strides (in elements); o [B,
// Hq, Sq, D] contiguous; lse [B, Hq, Sq] fp32 or null. seg_q [B, Sq] and
// seg_kv [B, Skv] int32 contiguous with their tile ranges q_rng [B,
// ceil(Sq / 64), 2] and kv_rng [B, ceil(Skv / 64), 2] (K1d), or all null.
// window: 0, or the causal sliding window; softcap2: 0, or cap * log2(e);
// band: 1 for K2 (requires 1 <= window <= 64 and no segment ids). bf16 and
// fp16 without band run csrc/flash_fwd_sm90.cu, which needs operands TMA can
// read (16-byte-aligned base and strides) and q_tile, its q rows a block (64
// or 128); this body ignores q_tile. Returns a cudaError_t.
extern "C" int fat_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             const int32_t* seg_q, const int32_t* seg_kv, const int32_t* q_rng,
                             const int32_t* kv_rng, int64_t batch, int64_t num_q_heads, int64_t num_kv_heads,
                             int64_t q_len, int64_t kv_len, int64_t head_dim, int64_t q_sb,
                             int64_t q_sh, int64_t q_sr, int64_t k_sb, int64_t k_sh, int64_t k_sr,
                             int64_t v_sb, int64_t v_sh, int64_t v_sr, float scale2,
                             int32_t causal, int32_t window, float softcap2, int32_t band,
                             int32_t dtype, void* stream, int32_t q_tile) {
  if (dtype != fat::kFloat32 && band == 0) {
    const int64_t st[9] = {q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr};
    return static_cast<int>(fat::sm90_fwd(fat::Sm90FwdCall{
        q, k, v, o, lse, batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim, st, scale2, causal, window,
        softcap2, seg_q, seg_kv, q_rng, kv_rng, q_tile, dtype, static_cast<cudaStream_t>(stream)}));
  }
  FwdParams p = make_params(q, k, v, o, lse, num_q_heads, num_kv_heads, q_len, kv_len, q_sb, q_sh,
                            q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, scale2, causal);
  p.window = window;
  p.softcap2 = softcap2;
  p.seg_q = seg_q;
  p.seg_kv = seg_kv;
  p.q_rng = q_rng;
  p.kv_rng = kv_rng;
  const FwdLaunch<false> launcher{p, batch, band != 0, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch<false>(dtype, dtype, head_dim, launcher));
}

// K8. q [1, Hq, T, D] with unit stride on D; k and v pages [num_pages, Hkv,
// page_size, D] with unit stride on D and the given page / head / row
// strides; ks and vs their scales [num_pages, Hkv, page_size] fp32 when
// payload is a quantized type (scale_strides: K's page / head / row
// strides, then V's), else null; table the slot's [pages_per_slot] int32
// row; causal over kv_end rows, the chunk's rows at [kv_end - T, kv_end),
// with window (0: none), sinks (columns [0, sinks) visible beside the
// window) and softcap2 (0, or cap * log2(e)); o [1, Hq, T, D] contiguous.
// page_size must be a multiple of 64. Returns a cudaError_t.
extern "C" int fat_paged_prefill(const void* q, const void* k, const void* v, const float* ks,
                                 const float* vs, void* o, const int32_t* table,
                                 int64_t num_q_heads, int64_t num_kv_heads, int64_t num_pages,
                                 int64_t page_size, int64_t q_len, int64_t kv_end,
                                 int64_t head_dim, int64_t q_sh, int64_t q_sr, int64_t k_sp,
                                 int64_t k_sh, int64_t k_sr, int64_t v_sp, int64_t v_sh,
                                 int64_t v_sr, const int64_t* scale_strides, float scale2,
                                 int32_t window, int32_t sinks, float softcap2, int32_t dtype,
                                 int32_t payload, void* stream) {
  FwdParams p = make_params(q, k, v, o, nullptr, num_q_heads, num_kv_heads, q_len, kv_end, 0, q_sh,
                            q_sr, k_sp, k_sh, k_sr, v_sp, v_sh, v_sr, scale2, 1);
  p.ks = ks;
  p.vs = vs;
  if (ks != nullptr) {
    p.ks_sp = scale_strides[0];
    p.ks_sh = scale_strides[1];
    p.ks_sr = scale_strides[2];
    p.vs_sp = scale_strides[3];
    p.vs_sh = scale_strides[4];
    p.vs_sr = scale_strides[5];
  }
  p.table = table;
  p.page_size = static_cast<int>(page_size);
  p.num_pages = static_cast<int>(num_pages);
  p.window = window;
  p.sinks = sinks;
  p.softcap2 = softcap2;
  const FwdLaunch<true> launcher{p, 1, false, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch(dtype, payload, head_dim, launcher));
}

extern "C" const char* fat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
