// K3, K4 and K5: the attention backward (causal or not, MHA or GQA, bf16 /
// fp16 / fp32), for Hopper.
//
// Replaces the JAX package's three Pallas backward kernels, reached from
// ops/attention_bwd.py:flash_attention_bwd (:978):
//   K4  ops/attention_bwd.py:65   _bwd_dq_kernel     -> flash_bwd_dq_kernel
//   K5  ops/attention_bwd.py:317  _bwd_dkv_kernel    -> flash_bwd_dkv_kernel<FUSED = false>
//   K3  ops/attention_bwd.py:594  _bwd_fused_kernel  -> flash_bwd_dkv_kernel<FUSED = true>
// Same function, the flash-attention-2 recurrence in fp32 with P recomputed
// from the forward's base-2 LSE (the caller has replaced an LSE of -inf by 0
// and computed delta = rowsum(dO * O) in fp32):
//   P = exp2(S * scale2 - lse),  S = Q K^T,  scale2 = sm_scale * log2(e)
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta)
//   dQ = sm_scale * dS K;  dK = sm_scale * dS^T Q
// under the forward's end-aligned causal mask (row i sees columns j <= i +
// kv_len - q_len); a masked or out-of-range pair has P = 0. The kv head of q
// head h is h / group. What the TPU kernels do to fit Mosaic (head blocks,
// sub-tiles, the diagonal pipeline, the chunked whole-KV accumulators) is
// not carried over.
//
// What bounds them on this card: every (q, kv) pair the mask leaves costs
// 3 (K4), 4 (K5) or 5 (K3) products of 2 * D FLOPs against O((q_len +
// kv_len) * D) bytes, so at training lengths arithmetic bounds all three.
// This first version does that arithmetic as fp32 FMAs over shared-memory
// tiles, not on the tensor cores, so it runs far below the card's bf16
// rate; wgmma with TMA-fed tiles is later work.
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
};

// K4: Q, dO, K, V tiles and one score tile (dS).
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * LDP);
}

// K5 / K3: K, V, Q, dO tiles, two score tiles (P^T, dS^T), the q tile's
// lse and delta.
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * LDP + 2 * BM);
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

__device__ __forceinline__ bool visible(const BwdParams& p, int row, int col) {
  return row < p.q_len && col < p.kv_len && (!p.causal || col <= row + p.kv_len - p.q_len);
}

template <typename T, int D>
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

  float lse[ROWS], delta[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = m0 + ty * ROWS + i;
    const int64_t at = static_cast<int64_t>(bh) * p.q_len + row;
    lse[i] = row < p.q_len ? p.lse[at] : 0.f;
    delta[i] = row < p.q_len ? p.delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(m0 + BM, p.q_len) - 1;
  const int n_end = p.causal ? min(p.kv_len, last_row + p.kv_len - p.q_len + 1) : p.kv_len;

  for (int n0 = 0; n0 < n_end; n0 += BN) {
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

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = m0 + ty * ROWS + i;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = n0 + tx + COLS * j;
        const float pr = visible(p, row, col) ? exp2f(fmaf(s[i][j], p.scale2, -lse[i])) : 0.f;
        s_ds[(ty * ROWS + i) * LDP + tx + COLS * j] = pr * (dp[i][j] - delta[i]);
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

template <typename T, int D, bool FUSED>
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

  float dk[ROWS][DC], dv[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // The first q tile holding a row that sees this tile's first column.
  const int m_first = p.causal ? max(0, n0 - diag) / BM * BM : 0;
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const int64_t rows_at = static_cast<int64_t>(b * p.num_q_heads + h) * p.q_len;
    const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    for (int m0 = m_first; m0 < p.q_len; m0 += BM) {
      __syncthreads();  // the previous pair's Q, dO, P^T and dS^T are no longer read
      load_tile<T, D>(s_q, q + m0 * p.q_sr, p.q_sr, p.q_len - m0);
      load_tile<T, D>(s_do, dout + m0 * p.o_sr, p.o_sr, p.q_len - m0);
      if (tid < BM) {
        const int row = m0 + tid;
        s_lse[tid] = row < p.q_len ? p.lse[rows_at + row] : 0.f;
        s_delta[tid] = row < p.q_len ? p.delta[rows_at + row] : 0.f;
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
          const float pr = visible(p, m0 + qi, col) ? exp2f(fmaf(s[i][j], p.scale2, -s_lse[qi])) : 0.f;
          s_p[(ty * ROWS + i) * LDP + qi] = pr;
          s_ds[(ty * ROWS + i) * LDP + qi] = pr * (dp[i][j] - s_delta[qi]);
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

  template <typename T, typename P, int D>
  cudaError_t launch() const {
    if constexpr (PASS == Pass::kDq) {
      constexpr size_t smem = dq_smem_bytes<D>();
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const dim3 grid((p.q_len + BM - 1) / BM, static_cast<unsigned>(batch * p.num_q_heads));
      flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
    } else {
      constexpr bool fused = PASS == Pass::kFused;
      constexpr size_t smem = dkv_smem_bytes<D>();
      cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, fused>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      const dim3 grid((p.kv_len + BN - 1) / BN, static_cast<unsigned>(batch * p.num_kv_heads));
      flash_bwd_dkv_kernel<T, D, fused><<<grid, THREADS, smem, stream>>>(p);
    }
    return cudaGetLastError();
  }
};

template <Pass PASS>
int run(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* delta, void* dq, void* dk, void* dv, int64_t batch, int64_t num_q_heads,
        int64_t num_kv_heads, int64_t q_len, int64_t kv_len, int64_t head_dim, const int64_t* st,
        float scale2, float sm_scale, int32_t causal, int32_t dtype, void* stream) {
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
  if (PASS == Pass::kFused && p.group != 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdLaunch<PASS> launcher{p, batch, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(fat::dispatch<false>(dtype, dtype, head_dim, launcher));
}

}  // namespace

// The three entries share their arguments: q [B, Hq, Sq, D], k and v
// [B, Hkv, Skv, D] and dout (dO, q's shape), each with unit stride on D and
// the given batch / head / row strides (in elements, q's, k's, v's, then
// dO's); lse (base-2, -inf replaced by 0) and delta [B, Hq, Sq] fp32
// contiguous; outputs contiguous. scale2 = sm_scale * log2(e). Each returns
// a cudaError_t.
#define FAT_BWD_ARGS                                                                              \
  int64_t batch, int64_t num_q_heads, int64_t num_kv_heads, int64_t q_len, int64_t kv_len,        \
      int64_t head_dim, int64_t q_sb, int64_t q_sh, int64_t q_sr, int64_t k_sb, int64_t k_sh,     \
      int64_t k_sr, int64_t v_sb, int64_t v_sh, int64_t v_sr, int64_t o_sb, int64_t o_sh,         \
      int64_t o_sr, float scale2, float sm_scale, int32_t causal, int32_t dtype, void *stream
#define FAT_BWD_STRIDES \
  const int64_t st[12] = {q_sb, q_sh, q_sr, k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, o_sb, o_sh, o_sr}
#define FAT_BWD_SHAPE batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim, st

// K4: dq [B, Hq, Sq, D] in q's dtype.
extern "C" int fat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq, FAT_BWD_ARGS) {
  FAT_BWD_STRIDES;
  return run<Pass::kDq>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, FAT_BWD_SHAPE, scale2,
                        sm_scale, causal, dtype, stream);
}

// K5: dk and dv [B, Hkv, Skv, D], summed over each kv head's q heads.
extern "C" int fat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk, void* dv,
                                 FAT_BWD_ARGS) {
  FAT_BWD_STRIDES;
  return run<Pass::kDkv>(q, k, v, dout, lse, delta, nullptr, dk, dv, FAT_BWD_SHAPE, scale2,
                         sm_scale, causal, dtype, stream);
}

// K3 (Hq == Hkv): dq_acc [B, Hq, Sq, D] fp32, zeroed by the caller, gets dq
// by atomic adds; dk and dv as K5's.
extern "C" int fat_flash_bwd_fused(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, float* dq_acc, void* dk,
                                   void* dv, FAT_BWD_ARGS) {
  FAT_BWD_STRIDES;
  return run<Pass::kFused>(q, k, v, dout, lse, delta, dq_acc, dk, dv, FAT_BWD_SHAPE, scale2,
                           sm_scale, causal, dtype, stream);
}
