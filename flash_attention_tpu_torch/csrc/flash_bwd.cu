// K3, K4 and K5: the attention backward (causal or not, MHA or GQA, bf16 /
// fp16 / fp32; with an optional sliding window, logit softcap and
// packed-sequence segment ids), for Hopper.
//
// Replaces the JAX package's three Pallas backward kernels, reached from
// ops/attention_bwd.py:flash_attention_bwd (:978), with their window,
// softcap and segment branches (:131-132, :171-189, :206-240, :440-445,
// :474-495, :764-821, :1222-1225, :1682-1686):
//   K4  ops/attention_bwd.py:65   _bwd_dq_kernel     -> flash_bwd_dq_kernel
//   K5  ops/attention_bwd.py:317  _bwd_dkv_kernel    -> flash_bwd_dkv_kernel<FUSED = false>
//   K3  ops/attention_bwd.py:594  _bwd_fused_kernel  -> flash_bwd_dkv_kernel<FUSED = true>
// All three run these bodies in fp32 only: in bf16 and fp16 the C entries
// fat_flash_bwd_dq, fat_flash_bwd_dkv and fat_flash_bwd_fused dispatch to
// the tensor-core bodies of csrc/flash_bwd_sm90.cu, which round P and dS to
// the input type before their products.
// Same function, the flash-attention-2 recurrence in fp32 with P recomputed
// from the forward's base-2 LSE (the caller has replaced an LSE of -inf by 0
// and computed delta = rowsum(dO * O) in fp32):
//   P = exp2(S * scale2 - lse),  S = Q K^T,  scale2 = sm_scale * log2(e)
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta)
//   dQ = sm_scale * dS K;  dK = sm_scale * dS^T Q
// under the forward's end-aligned causal mask (row i sees columns j <= i +
// kv_len - q_len); a masked or out-of-range pair has P = 0. The kv head of q
// head h is h / group. What the TPU kernels do to fit Mosaic (head blocks,
// sub-tiles, the diagonal pipeline, the chunked whole-KV accumulators, the
// scalar-prefetched liveness tables) is not carried over.
//
// Masks (runtime parameters of each body's masked instantiation; the
// unmasked one is compiled without them, as in csrc/flash_fwd.cu):
//  * window w: the forward's predicate, column j > i + kv_len - q_len - w;
//  * softcap: the score is recomputed as the forward does, softcap2 *
//    tanhf(S * scale2 / softcap2) (exact tanhf), and tanh's derivative is
//    folded into the score gradient, dS = P * (dP - delta) * (1 - t^2),
//    before the dQ and dK products;
//  * segment ids: a pair is visible only where seg_q[i] == seg_kv[j].
// The walks narrow to the live tiles: K4 starts at the window's first kv
// tile for its tile's first row; K5 and K3 stop at the last q tile whose
// rows' window still holds the kv tile's last column; and every kernel
// skips a (q tile, kv tile) pair whose segment-id ranges are disjoint
// (fat::segment_tiles_meet) before loading it. A window or a packed batch
// therefore costs O(window) or O(document) per row, not O(row).
//
// What bounds them on this card: every (q, kv) pair the mask leaves costs
// 3 (K4), 4 (K5) or 5 (K3) products of 2 * D FLOPs against O((q_len +
// kv_len) * D) bytes, so at training lengths arithmetic bounds all three.
// These fp32 bodies do that arithmetic as FMAs over shared-memory tiles (the
// tensor cores take no fp32 product at full precision).
//
// Design (256 threads a block; each thread owns 2 rows x 8 columns of a
// 64 x 64 score tile and 2 rows x D/8 columns of a 64 x D accumulator):
//  * K4: one block per (batch * q head, 64-row q tile). Q and dO stay in
//    shared memory; the block walks the kv tiles up to its last row's
//    causal diagonal, recomputes S and dP, and accumulates dQ in registers.
//    Each dq element is written once: deterministic.
//  * K5: one block per (batch * kv head, 64-row kv tile). K and V stay in
//    shared memory; the block walks every q head of its GQA group and, from
//    the first q tile that sees the kv tile, every q tile, recomputing the
//    transposed tiles S^T and dP^T, so the per-q-row lse and delta are read
//    by column. dK and dV accumulate over the whole group in registers and
//    are written once: the group's sum needs no atomics and is deterministic.
//  * K3 (MHA): K5's body that also adds each tile pair's sm_scale * dS K
//    into an fp32 dq buffer with atomicAdd (as FA2 does on this card); the
//    wrapper zeroes the buffer and casts it. dq therefore sums in an order
//    that changes from run to run; dk and dv do not.
//  * Operand tiles are held in fp32 with rows padded by one float against
//    bank conflicts; q, k, v and dO are read through their batch, head and
//    row strides, so a strided cotangent or a view is not copied.
#include "common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

constexpr int BM = 64;        // q rows per tile
constexpr int BN = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 32 row groups x 8 column lanes
constexpr int ROWS = 2;       // tile rows per thread: 32 * 2 == 64
constexpr int COLS = 8;       // tile columns per thread: 8 * 8 == 64
constexpr int LDP = BN + 1;   // pitch of a 64 x 64 score tile

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, Sq] base-2, -inf already replaced by 0
  const float* delta;  // [B, Hq, Sq]
  void* dq;  // K4: [B, Hq, Sq, D] of T; K3: fp32, accumulated with atomics
  void* dk;  // [B, Hkv, Skv, D] of T, contiguous
  void* dv;
  int64_t q_sb, q_sh, q_sr;
  int64_t k_sb, k_sh, k_sr;
  int64_t v_sb, v_sh, v_sr;
  int64_t o_sb, o_sh, o_sr;  // dO's strides
  int num_q_heads, num_kv_heads, group, q_len, kv_len, causal;
  float scale2, sm_scale;
  int window;             // 0: none
  float softcap2;         // cap * log2(e); 0: none
  const int32_t* seg_q;   // [B, Sq] segment ids, or nullptr
  const int32_t* seg_kv;  // [B, Skv]
  const int32_t* q_rng;   // [B, ceil(Sq / 64), 2]: each q tile's min / max id
  const int32_t* kv_rng;  // [B, ceil(Skv / 64), 2]
};

// K4: Q, dO, K, V tiles and one score tile (dS).
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * LDP);
}

// K5 / K3: K, V, Q, dO tiles, two score tiles (P^T, dS^T), the q tile's
// lse, delta and segment ids.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * LDP + 3 * BM);
}

// Loads 64 rows of a matrix with row stride `sr`, starting at `src`, into the
// fp32 tile `dst` (row pitch D + 1); rows at or past `n` read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t sr, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r < n ? fat::to_float(src[r * sr + d]) : 0.f;
  }
}

// Whether q row `row` sees kv column `col` under the forward's mask; the ids
// are the row's and the column's segment ids (equal, 0, without segments).
template <bool MASKED>
__device__ __forceinline__ bool visible(const BwdParams& p, int row, int col, int32_t row_id, int32_t col_id) {
  const int pos = row + p.kv_len - p.q_len;
  bool ok = row < p.q_len && col < p.kv_len && (!p.causal || col <= pos);
  if constexpr (MASKED) ok = ok && (p.window == 0 || col > pos - p.window) && row_id == col_id;
  return ok;
}

// P of one pair from its raw score s = q . k: exp2 of the forward's base-2
// score less the row's LSE. With a softcap the score is capped as the
// forward caps it, and *dcap gets tanh's derivative 1 - t^2 (else it stays
// 1).
template <bool MASKED>
__device__ __forceinline__ float recompute_p(const BwdParams& p, float s, float lse, float& dcap) {
  if constexpr (MASKED) {
    if (p.softcap2 > 0.f) {  // uniform across the block
      const float t = tanhf(s * p.scale2 / p.softcap2);
      dcap = 1.f - t * t;
      return exp2f(p.softcap2 * t - lse);
    }
  }
  return exp2f(fmaf(s, p.scale2, -lse));
}

// The segment id of row `i` of `ids` (this batch row's), 0 without segments
// or past `n`.
template <bool MASKED>
__device__ __forceinline__ int32_t segment_id(const int32_t* ids, int i, int n) {
  if constexpr (MASKED) return ids != nullptr && i < n ? ids[i] : 0;
  return 0;
}

__device__ __forceinline__ bool tiles_meet(const BwdParams& p, int b, int m0, int n0) {
  return fat::segment_tiles_meet(p.q_rng, p.kv_rng, b, (p.q_len + BM - 1) / BM, (p.kv_len + BN - 1) / BN, m0 / BM,
                                 n0 / BN);
}

template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / COLS;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;            // [BM][LD]
  float* s_do = s_q + BM * LD;  // [BM][LD]
  float* s_k = s_do + BM * LD;  // [BN][LD]
  float* s_v = s_k + BN * LD;   // [BN][LD]
  float* s_ds = s_v + BN * LD;  // [BM][LDP]

  const int tid = threadIdx.x;
  const int ty = tid / COLS, tx = tid % COLS;
  const int bh = blockIdx.y;
  const int b = bh / p.num_q_heads, h = bh % p.num_q_heads;
  const int hk = h / p.group;
  // Causal tiles grow with the row index: start the longest ones first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D>(s_q, q + m0 * p.q_sr, p.q_sr, p.q_len - m0);
  load_tile<T, D>(s_do, dout + m0 * p.o_sr, p.o_sr, p.q_len - m0);

  const int32_t* seg_q = MASKED && p.seg_q != nullptr ? p.seg_q + static_cast<int64_t>(b) * p.q_len : nullptr;
  const int32_t* seg_kv = MASKED && p.seg_q != nullptr ? p.seg_kv + static_cast<int64_t>(b) * p.kv_len : nullptr;
  float lse[ROWS], delta[ROWS], acc[ROWS][DC];
  int32_t row_id[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m0 + ty * ROWS + i;
    const int64_t at = static_cast<int64_t>(bh) * p.q_len + row;
    lse[i] = row < p.q_len ? p.lse[at] : 0.f;
    delta[i] = row < p.q_len ? p.delta[at] : 0.f;
    row_id[i] = segment_id<MASKED>(seg_q, row, p.q_len);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int diag = p.kv_len - p.q_len;
  const int last_row = min(m0 + BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + diag + 1) : p.kv_len;
  // Window: start at the tile of the first column the tile's first row sees.
  const int n_begin = MASKED && p.window > 0 ? max(0, m0 + diag - p.window + 1) / BN * BN : 0;

  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    if (seg_q != nullptr && !tiles_meet(p, b, m0, n0)) continue;  // uniform: a dead tile pair
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile<T, D>(s_k, k + n0 * p.k_sr, p.k_sr, p.kv_len - n0);
    load_tile<T, D>(s_v, v + n0 * p.v_sr, p.v_sr, p.kv_len - n0);
    __syncthreads();

    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[ROWS], o[ROWS], kk[COLS], vv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        a[i] = s_q[(ty * ROWS + i) * LD + d];
        o[i] = s_do[(ty * ROWS + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        kk[j] = s_k[(tx + COLS * j) * LD + d];
        vv[j] = s_v[(tx + COLS * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
        }
    }

    int32_t col_id[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) col_id[j] = segment_id<MASKED>(seg_kv, n0 + tx + COLS * j, p.kv_len);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = m0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = n0 + tx + COLS * j;
        float dcap = 1.f;
        const float pr = visible<MASKED>(p, row, col, row_id[i], col_id[j]) ? recompute_p<MASKED>(p, s[i][j], lse[i], dcap) : 0.f;
        s_ds[(ty * ROWS + i) * LDP + tx + COLS * j] = pr * (dp[i][j] - delta[i]) * dcap;
      }
    }
    __syncthreads();  // dS is complete

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float ds[ROWS], kk[DC];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) ds[i] = s_ds[(ty * ROWS + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kk[c] = s_k[j * LD + tx + COLS * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq) + static_cast<int64_t>(bh) * p.q_len * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m0 + ty * ROWS + i;
    if (row >= p.q_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[static_cast<int64_t>(row) * D + tx + COLS * c] = fat::from_float<T>(acc[i][c] * p.sm_scale);
  }
}

template <typename T, int D, bool FUSED, bool MASKED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int DC = D / COLS;
  extern __shared__ float smem[];
  float* s_k = smem;               // [BN][LD], resident
  float* s_v = s_k + BN * LD;      // [BN][LD], resident
  float* s_q = s_v + BN * LD;      // [BM][LD]
  float* s_do = s_q + BM * LD;     // [BM][LD]
  float* s_p = s_do + BM * LD;     // [BN][LDP], P^T
  float* s_ds = s_p + BN * LDP;    // [BN][LDP], dS^T
  float* s_lse = s_ds + BN * LDP;  // [BM]
  float* s_delta = s_lse + BM;     // [BM]
  int32_t* s_qid = reinterpret_cast<int32_t*>(s_delta + BM);  // [BM], the q rows' segment ids

  const int tid = threadIdx.x;
  const int ty = tid / COLS, tx = tid % COLS;
  const int bh = blockIdx.y;
  const int b = bh / p.num_kv_heads, hk = bh % p.num_kv_heads;
  // Causal: the first kv tiles are seen by the most q rows; they start first.
  const int n0 = blockIdx.x * BN;
  const int diag = p.kv_len - p.q_len;

  load_tile<T, D>(s_k, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + n0 * p.k_sr, p.k_sr,
                  p.kv_len - n0);
  load_tile<T, D>(s_v, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + n0 * p.v_sr, p.v_sr,
                  p.kv_len - n0);

  const int32_t* seg_q = MASKED && p.seg_q != nullptr ? p.seg_q + static_cast<int64_t>(b) * p.q_len : nullptr;
  const int32_t* seg_kv = MASKED && p.seg_q != nullptr ? p.seg_kv + static_cast<int64_t>(b) * p.kv_len : nullptr;
  float dk[ROWS][DC], dv[ROWS][DC];
  int32_t col_id[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    col_id[i] = segment_id<MASKED>(seg_kv, n0 + ty * ROWS + i, p.kv_len);
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  // The first q tile holding a row that sees this tile's first column, and,
  // with a window, the end of the last rows whose window holds its last
  // column (row + diag - window < n0 + BN - 1).
  const int m_first = p.causal ? max(0, n0 - diag) / BM * BM : 0;
  const int m_end = MASKED && p.window > 0 ? min(p.q_len, n0 + BN - 1 + p.window - diag) : p.q_len;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const int64_t rows_at = static_cast<int64_t>(b * p.num_q_heads + h) * p.q_len;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    for (int m0 = m_first; m0 < m_end; m0 += BM) {
      if (seg_q != nullptr && !tiles_meet(p, b, m0, n0)) continue;  // uniform: a dead tile pair
      __syncthreads();  // the previous pair's Q, dO, P^T and dS^T are no longer read
      load_tile<T, D>(s_q, q + m0 * p.q_sr, p.q_sr, p.q_len - m0);
      load_tile<T, D>(s_do, dout + m0 * p.o_sr, p.o_sr, p.q_len - m0);
      if (tid < BM) {
        const int row = m0 + tid;
        s_lse[tid] = row < p.q_len ? p.lse[rows_at + row] : 0.f;
        s_delta[tid] = row < p.q_len ? p.delta[rows_at + row] : 0.f;
        if constexpr (MASKED) s_qid[tid] = segment_id<MASKED>(seg_q, row, p.q_len);
      }
      __syncthreads();

      // S^T and dP^T: rows are kv positions, columns q positions.
      float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[ROWS], vv[ROWS], qq[COLS], oo[COLS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          kk[i] = s_k[(ty * ROWS + i) * LD + d];
          vv[i] = s_v[(ty * ROWS + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          qq[j] = s_q[(tx + COLS * j) * LD + d];
          oo[j] = s_do[(tx + COLS * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            s[i][j] = fmaf(kk[i], qq[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], oo[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int col = n0 + ty * ROWS + i;
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const int qi = tx + COLS * j;
          float dcap = 1.f;
          const int32_t row_id = MASKED ? s_qid[qi] : 0;
          const float pr =
              visible<MASKED>(p, m0 + qi, col, row_id, col_id[i]) ? recompute_p<MASKED>(p, s[i][j], s_lse[qi], dcap) : 0.f;
          s_p[(ty * ROWS + i) * LDP + qi] = pr;
          s_ds[(ty * ROWS + i) * LDP + qi] = pr * (dp[i][j] - s_delta[qi]) * dcap;
        }
      }
      __syncthreads();  // P^T and dS^T are complete

      // dV += P^T dO and dK += dS^T Q over the q tile's rows.
#pragma unroll 2
      for (int j = 0; j < BM; ++j) {
        float pr[ROWS], ds[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          pr[i] = s_p[(ty * ROWS + i) * LDP + j];
          ds[i] = s_ds[(ty * ROWS + i) * LDP + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float oo = s_do[j * LD + tx + COLS * c];
          const float qq = s_q[j * LD + tx + COLS * c];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            dv[i][c] = fmaf(pr[i], oo, dv[i][c]);
            dk[i][c] = fmaf(ds[i], qq, dk[i][c]);
          }
        }
      }

      if constexpr (FUSED) {
        // This pair's part of dQ for q rows m0 + ty * ROWS + r: sm_scale *
        // sum over the tile's kv rows j of dS^T[j][row] K[j].
        float part[ROWS][DC];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) part[r][c] = 0.f;
#pragma unroll 4
        for (int j = 0; j < BN; ++j) {
          float ds[ROWS], kk[DC];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) ds[r] = s_ds[j * LDP + ty * ROWS + r];
#pragma unroll
          for (int c = 0; c < DC; ++c) kk[c] = s_k[j * LD + tx + COLS * c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int c = 0; c < DC; ++c) part[r][c] = fmaf(ds[r], kk[c], part[r][c]);
        }
        float* dq = static_cast<float*>(p.dq) + rows_at * D;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int row = m0 + ty * ROWS + r;
          if (row >= p.q_len) continue;
#pragma unroll
          for (int c = 0; c < DC; ++c)
            atomicAdd(dq + static_cast<int64_t>(row) * D + tx + COLS * c, part[r][c] * p.sm_scale);
        }
      }
    }
  }

  const int64_t out_at = static_cast<int64_t>(bh) * p.kv_len * D;
  T* dk_out = static_cast<T*>(p.dk) + out_at;
  T* dv_out = static_cast<T*>(p.dv) + out_at;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int col = n0 + ty * ROWS + i;
    if (col >= p.kv_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int64_t at = static_cast<int64_t>(col) * D + tx + COLS * c;
      dk_out[at] = fat::from_float<T>(dk[i][c] * p.sm_scale);
      dv_out[at] = fat::from_float<T>(dv[i][c]);
    }
  }
}

enum class Pass { kDq, kDkv, kFused };

template <Pass PASS>
struct BwdLaunch {
  BwdParams p;
  int64_t batch;
  cudaStream_t stream;

  template <typename T, int D, bool MASKED>
  cudaError_t run() const {
    if constexpr (PASS == Pass::kDq) {
      constexpr size_t smem = dq_smem_bytes<D>();
      cudaError_t err = fat::reserve_smem(flash_bwd_dq_kernel<T, D, MASKED>, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const dim3 grid((p.q_len + BM - 1) / BM, static_cast<unsigned>(batch * p.num_q_heads));
      flash_bwd_dq_kernel<T, D, MASKED><<<grid, THREADS, smem, stream>>>(p);
    } else {
      constexpr bool fused = PASS == Pass::kFused;
      constexpr size_t smem = dkv_smem_bytes<D>();
      cudaError_t err = fat::reserve_smem(flash_bwd_dkv_kernel<T, D, fused, MASKED>, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const dim3 grid((p.kv_len + BN - 1) / BN, static_cast<unsigned>(batch * p.num_kv_heads));
      flash_bwd_dkv_kernel<T, D, fused, MASKED><<<grid, THREADS, smem, stream>>>(p);
    }
    return cudaGetLastError();
  }

  template <typename T, typename P, int D>
  cudaError_t launch() const {
    // Every pass takes this body in fp32 only (bf16 / fp16: flash_bwd_sm90.cu).
    if constexpr (!std::is_same_v<T, float>) {
      return cudaErrorInvalidValue;
    } else {
      if (p.window < 0 || (p.window > 0 && !p.causal)) return cudaErrorInvalidValue;
      if (p.seg_q != nullptr && (p.seg_kv == nullptr || p.q_rng == nullptr || p.kv_rng == nullptr))
        return cudaErrorInvalidValue;
      if (p.window > 0 || p.softcap2 > 0.f || p.seg_q != nullptr) return run<T, D, true>();
      return run<T, D, false>();
    }
  }
};

// The masks of one call: window (0: none), softcap2 (0: none), and the
// segment ids with their tile ranges (all null: none).
struct BwdMasks {
  int32_t window;
  float softcap2;
  const int32_t* seg_q;
  const int32_t* seg_kv;
  const int32_t* q_rng;
  const int32_t* kv_rng;
};

template <Pass PASS>
int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dq, void* dk, void* dv, int64_t batch, int64_t num_q_heads,
        int64_t num_kv_heads, int64_t q_len, int64_t kv_len, int64_t head_dim, const int64_t* st,
        float scale2, float sm_scale, int32_t causal, const BwdMasks& masks, int32_t dtype, void* stream) {
  BwdParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = st[0];
  p.q_sh = st[1];
  p.q_sr = st[2];
  p.k_sb = st[3];
  p.k_sh = st[4];
  p.k_sr = st[5];
  p.v_sb = st[6];
  p.v_sh = st[7];
  p.v_sr = st[8];
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_sr = st[11];
  p.num_q_heads = static_cast<int>(num_q_heads);
  p.num_kv_heads = static_cast<int>(num_kv_heads);
  p.group = static_cast<int>(num_q_heads / num_kv_heads);
  p.q_len = static_cast<int>(q_len);
  p.kv_len = static_cast<int>(kv_len);
  p.causal = causal;
  p.scale2 = scale2;
  p.sm_scale = sm_scale;
  p.window = masks.window;
  p.softcap2 = masks.softcap2;
  p.seg_q = masks.seg_q;
  p.seg_kv = masks.seg_kv;
  p.q_rng = masks.q_rng;
  p.kv_rng = masks.kv_rng;
  if (PASS == Pass::kFused && p.group != 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdLaunch<PASS> launcher{p, batch, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch<false>(dtype, dtype, head_dim, launcher));
}

}  // namespace

// The three entries share their arguments: q [B, Hq, Sq, D], k and v
// [B, Hkv, Skv, D] and dout (dO, q's shape), each with unit stride on D and
// the given batch / head / row strides (in elements, q's, k's, v's, then
// dO's); lse (base-2, -inf replaced by 0) and delta [B, Hq, Sq] fp32
// contiguous; outputs contiguous. scale2 = sm_scale * log2(e). Masks as the
// forward's (csrc/flash_fwd.cu fat_flash_fwd): window (0: none), softcap2
// (0, or cap * log2(e)), seg_q [B, Sq] and seg_kv [B, Skv] int32 contiguous
// with their 64-row tile ranges q_rng and kv_rng, or all four null. Each
// returns a cudaError_t.
#define FAT_BWD_ARGS                                                                              \
  int64_t batch, int64_t num_q_heads, int64_t num_kv_heads, int64_t q_len, int64_t kv_len,        \
      int64_t head_dim, int64_t q_sb, int64_t q_sh, int64_t q_sr, int64_t k_sb, int64_t k_sh,     \
      int64_t k_sr, int64_t v_sb, int64_t v_sh, int64_t v_sr, int64_t o_sb, int64_t o_sh,         \
      int64_t o_sr, float scale2, float sm_scale, int32_t causal, int32_t window, float softcap2, \
      const int32_t *seg_q, const int32_t *seg_kv, const int32_t *q_rng, const int32_t *kv_rng,   \
      int32_t dtype, void *stream
#define FAT_BWD_STRIDES                                                                       \
  const int64_t st[12] = {q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, o_sb, o_sh, o_sr}; \
  const BwdMasks masks{window, softcap2, seg_q, seg_kv, q_rng, kv_rng}
#define FAT_BWD_SHAPE batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim, st

// The tensor-core bodies' call (csrc/flash_bwd_sm90.cu) for K4 or K5 in
// bf16 / fp16: outputs out0, out1, lse and delta rows lse_pitch apart.
#define FAT_BWD_SM90_CALL(out0, out1, splits)                                                       \
  fat::Sm90BwdCall{q,        k,         v,       dout,     lse,      delta,    out0,   out1,      \
                   batch,    num_q_heads, num_kv_heads, q_len, kv_len, head_dim, lse_pitch, st,    \
                   scale2,   sm_scale,  causal,  window,   softcap2, seg_q,    seg_kv, q_rng,     \
                   kv_rng,   splits,    dtype,   static_cast<cudaStream_t>(stream)}

// K4: dq [B, Hq, Sq, D] in q's dtype. lse and delta rows are lse_pitch
// apart: q_len for fp32 (the FMA body), a multiple of 64 padded with 0 for
// bf16 / fp16 (the tensor-core body).
extern "C" int fat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, FAT_BWD_ARGS,
                                int64_t lse_pitch) {
  FAT_BWD_STRIDES;
  if (dtype != fat::kFloat32)
    return static_cast<int>(fat::sm90_bwd_dq(FAT_BWD_SM90_CALL(dq, nullptr, 1)));
  if (lse_pitch != q_len) return static_cast<int>(cudaErrorInvalidValue);
  return run<Pass::kDq>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, FAT_BWD_SHAPE, scale2,
                        sm_scale, causal, masks, dtype, stream);
}

// K5: dk and dv [B, Hkv, Skv, D], summed over each kv head's q heads; lse
// and delta as K4's. In bf16 / fp16 with splits > 1 the group's q heads are
// split over that many blocks, which write fp32 partials into workspace
// [2, B, Hkv, splits, Skv, D] for fat_flash_bwd_dkv_sum; fp32 takes 1 split.
extern "C" int fat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 FAT_BWD_ARGS, int64_t lse_pitch, int32_t splits, float* workspace) {
  FAT_BWD_STRIDES;
  if (dtype != fat::kFloat32) {
    if (splits > 1) return static_cast<int>(fat::sm90_bwd_dkv(FAT_BWD_SM90_CALL(workspace, nullptr, splits)));
    return static_cast<int>(fat::sm90_bwd_dkv(FAT_BWD_SM90_CALL(dk, dv, 1)));
  }
  if (lse_pitch != q_len || splits != 1) return static_cast<int>(cudaErrorInvalidValue);
  return run<Pass::kDkv>(q, k, v, dout, lse, delta, nullptr, dk, dv, FAT_BWD_SHAPE, scale2,
                         sm_scale, causal, masks, dtype, stream);
}

// K3 (Hq == Hkv): dq_acc [B, Hq, Sq, D] fp32, zeroed by the caller, gets dq
// added in (fp32 atomics here, bulk reduces on the tensor-core body), in a
// run-dependent order; dk and dv as K5's; lse and delta as K4's.
extern "C" int fat_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, float* dq_acc, void* dk,
                                   void* dv, FAT_BWD_ARGS, int64_t lse_pitch) {
  FAT_BWD_STRIDES;
  if (dtype != fat::kFloat32) {
    fat::Sm90BwdCall call = FAT_BWD_SM90_CALL(dk, dv, 1);
    call.dq_acc = dq_acc;
    return static_cast<int>(fat::sm90_bwd_fused(call));
  }
  if (lse_pitch != q_len) return static_cast<int>(cudaErrorInvalidValue);
  return run<Pass::kFused>(q, k, v, dout, lse, delta, dq_acc, dk, dv, FAT_BWD_SHAPE, scale2,
                           sm_scale, causal, masks, dtype, stream);
}
