// S1: sample_tokens as one hand-written kernel, one launch a decode step.
//
// Replaces no Pallas kernel: in the JAX package sample_tokens
// (serving/sampling.py:55-121) runs inside the jitted lax.scan of the decode
// block (serving/decode_loop.py:189-203), where XLA fuses it into a few
// fusions; eager PyTorch issued it as ~565 device operations (a full sort,
// softmax, cumsum, the threefry noise over int64 words and the two logs at
// about 30 operations each). This kernel computes the same function, row by
// row, and reaches device memory only for the logits and the tokens:
//
//  * the greedy pick: argmax of the row, ties (and NaN, as torch.argmax
//    orders it) to the lowest index;
//  * kth, the k-th largest logit (k = top_k clipped to [0, V]; k = 0 the
//    row's minimum), and thresh, the smallest sorted logit whose PRECEDING
//    mass of softmax((sorted - max) / T) is below top_p, the first entry
//    always kept (T = temperature, 1 where it is not > 0). Since a tie group
//    shares one value, thresh is the largest logit v whose mass(>= v)
//    reaches top_p, and the row's minimum when no v does;
//  * argmax(where(logits >= kth & logits >= thresh, logits, -inf) / T + g)
//    with g jax.random's Gumbel noise for (seed, position), and the greedy
//    pick where T is not > 0.
//
// The noise is drawn inline and never stored: fold_in is threefry2x32 of
// key (0, seed) on (0, position), random_bits threefry2x32 of the folded key
// on (0, j) with the two words xor-ed, then the mantissa trick, the clamp to
// the smallest normal float and -log(-log(u)) with the Cephes polynomial
// that XLA's CPU backend evaluates (the port's serving/sampling.py _log):
// each multiply-add XLA fuses is one __fmaf_rn, every other product and sum
// an _rn intrinsic, which nvcc never contracts, and the build has no fast
// math, so the noise is gumbel_noise's bits, which are jax.random's. An
// element the masks drop takes -inf / T + g = -inf whatever g is, so its
// noise is drawn only in the detail mode, which writes the noise of every
// element, each row's greedy pick, kth and thresh (chip_smoke.py holds them
// against the plain version).
//
// The selection: each row is one thread-block cluster of up to MAX_SPLITS
// blocks, the vocab split over them (at most MIN_SLICE elements a block
// below the full split), each block's slice of the logits and of the
// probabilities held in shared memory where they fit (else re-read from
// device memory and recomputed each pass). kth and thresh are radix selects
// over the order-preserving 32-bit keys of the logits, 8 bits a pass, the two
// in the same four passes: a pass builds each block's histogram of the
// candidate keys' next digit (counts for kth, probability mass for thresh),
// the blocks meet at a cluster barrier, and every block sums the cluster's
// histograms through distributed shared memory and picks the digit where
// the rank k - 1 (kth) or the mass top_p (thresh) falls. Masses are sums of
// the fp32 probabilities p = e / S in 62-bit fixed point, and S the sum of
// e = exp(z - z_max) in fixed point rounded once to fp32, so every sum is
// exact and independent of the order the threads add in: the kernel is
// deterministic (two calls and a CUDA graph's replay give the same bits),
// and where the plain version's fp32 cumsum rounds across top_p, thresh can
// differ from the plain version's only at a boundary whose mass lies within
// rounding of top_p. A warp adds its lanes' digits through __match_any_sync
// groups (one shared-memory atomic a group), since the keys of a row of
// logits share few leading digits.
//
// What bounds it on this card: operations, not bytes. 8 rows x 32,000 fp32
// logits are 1.0 MB (0.3 us at 3.35 TB/s); the noise is about 110 integer
// operations of threefry and 60 fp32 operations of the logs an element
// drawn, 45 M operations for 256,000 elements (0.7 us at 67 TFLOP/s, spread
// over 64 multiprocessors by the clusters). The passes are short; each
// costs a cluster barrier, eight a row in all.
#include <cooperative_groups.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int PASSES = 4;                 // 8-bit digits of a 32-bit key
constexpr int MAX_SPLITS = 8;             // blocks a row at most (the portable cluster size)
constexpr int64_t MIN_SLICE = 2048;       // elements a block before a row is split further
constexpr int SMEM_BUDGET = 200 * 1024;   // dynamic shared memory a block at most: its slice at 8 bytes an element
constexpr int MASS_BITS = 62;             // fixed-point bits of a probability (a row's mass stays below 2)
constexpr uint32_t NO_DIGIT = 0x100;

struct SampleParams {
  const float* logits;  // [B, V], rows `ld` apart, unit stride along V
  int64_t ld;
  const float* temperature;   // [B]
  const int32_t* top_k;       // [B]
  const float* top_p;         // [B]
  const int32_t* seeds;       // [B], the bits as uint32
  const int32_t* positions;   // [B], the bits as uint32
  int32_t* tokens;            // [B]
  float* noise;               // [B, V] contiguous, or null; set: the detail mode
  int32_t* greedy;            // [B] (detail)
  float* kth;                 // [B] (detail)
  float* thresh;              // [B] (detail)
  int64_t vocab;
  int64_t slice;              // elements a block
  int cached;                 // the slice's logits and probabilities in shared memory
  int e_bits;                 // fixed-point bits of e: vocab values <= 1 sum below 2^63
};

// ---- the noise: threefry2x32 and the Cephes log, as serving/sampling.py ----

__device__ __forceinline__ uint2 threefry(uint32_t k1, uint32_t k2, uint32_t x1, uint32_t x2) {
  constexpr int ROT[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = __funnelshift_l(x2, x2, ROT[i % 2][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x1, x2);
}

// The constants as the port's _f32 rounds them: the decimal to a double,
// then to the nearest float.
__device__ __forceinline__ float f32(double x) { return static_cast<float>(x); }

__device__ __forceinline__ float tiny() { return __uint_as_float(0x00800000u); }

__device__ __forceinline__ float cephes_log(float x) {
  x = fmaxf(x, tiny());
  const uint32_t bits = __float_as_uint(x);
  float m = __uint_as_float((bits & ~0x7F800000u) | 0x3F000000u);
  float e = static_cast<float>(static_cast<int>((bits >> 23) & 0xFFu) - 126);
  const bool low = m < f32(0.707106781186547524);
  e = __fsub_rn(e, low ? 1.f : 0.f);
  m = __fadd_rn(__fsub_rn(m, 1.f), low ? m : 0.f);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y0 = __fmaf_rn(__fmaf_rn(f32(7.0376836292e-2), m, f32(-1.1514610310e-1)), m, f32(1.1676998740e-1));
  const float y1 = __fmaf_rn(__fmaf_rn(f32(-1.2420140846e-1), m, f32(1.4249322787e-1)), m, f32(-1.6668057665e-1));
  const float y2 = __fmaf_rn(__fmaf_rn(f32(2.0000714765e-1), m, f32(-2.4999993993e-1)), m, f32(3.3333331174e-1));
  y0 = __fmaf_rn(__fmaf_rn(y0, x3, y1), x3, y2);
  const float y = __fmaf_rn(y0, x3, __fmul_rn(e, f32(-2.12194440e-4)));
  m = __fadd_rn(__fmaf_rn(-0.5f, x2, m), y);
  return __fmaf_rn(f32(0.693359375), e, m);
}

// Element j's noise under the row's folded key (k1, k2).
__device__ __forceinline__ float gumbel(uint32_t k1, uint32_t k2, uint32_t j) {
  const uint2 b = threefry(k1, k2, 0u, j);
  const float mantissa = __fsub_rn(__uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u), 1.f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(mantissa, 1.f), tiny()), tiny());
  return -cephes_log(-cephes_log(u));
}

// ---- orders and reductions ----

// torch.argmax's order: NaN above everything, ties to the lower index.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// An order-preserving key of a float (-0 taken as +0, which compares equal).
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

// x * 2^bits rounded to an integer (x in [0, 1]; the scaling is exact).
__device__ __forceinline__ unsigned long long fixed(float x, int bits) {
  return __float2ull_rn(__fmul_rn(x, __int_as_float((127 + bits) << 23)));
}

struct Arg {
  float v;
  int i;
};

__device__ __forceinline__ Arg best_of(Arg a, Arg b) { return better(b.v, b.i, a.v, a.i) ? b : a; }

// Block-wide reductions, every thread taking part, the result on every thread.
__device__ __forceinline__ Arg block_best(Arg a, Arg* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = best_of(a, Arg{__shfl_xor_sync(fat::FULL_MASK, a.v, off), __shfl_xor_sync(fat::FULL_MASK, a.i, off)});
  }
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = a;
  __syncthreads();
  Arg r = part[0];
  for (int w = 1; w < WARPS; ++w) r = best_of(r, part[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_min(float x, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(fat::FULL_MASK, x, off));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
  __syncthreads();
  float r = part[0];
  for (int w = 1; w < WARPS; ++w) r = fminf(r, part[w]);
  __syncthreads();
  return r;
}

template <typename U>
__device__ __forceinline__ U block_sum(U x, U* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(fat::FULL_MASK, x, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
  __syncthreads();
  U r = 0;
  for (int w = 0; w < WARPS; ++w) r += part[w];
  __syncthreads();
  return r;
}

// Inclusive prefix sum over the block's threads in thread order.
template <typename U>
__device__ __forceinline__ U block_scan(U x, U* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const U o = __shfl_up_sync(fat::FULL_MASK, x, off);
    if (lane >= off) x += o;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  U before = 0;
  for (int w = 0; w < warp; ++w) before += part[w];
  __syncthreads();
  return x + before;
}

struct Shared {
  // Read by the cluster's other blocks: each stage has its own slots, so
  // no block rewrites a slot a peer may still read.
  float row_max, row_min;
  int row_arg;
  unsigned long long e_sum;
  Arg pick;
  uint32_t count[PASSES][BINS];
  unsigned long long mass[PASSES][BINS];
  // This block's own.
  Arg part_arg[WARPS];
  float part_f[WARPS];
  uint32_t part_u32[WARPS];
  unsigned long long part_u64[WARPS];
  float max, min, sum;
  int arg;
  uint32_t k_prefix, k_need;              // kth: the key's digits so far, the rank left among the candidates
  uint32_t p_prefix;                      // thresh: the key's digits so far
  unsigned long long p_above;             // and the mass above the candidates
  int p_found;
};

static_assert(sizeof(Shared) + SMEM_BUDGET <= 232448, "a block's shared memory on this card");

// One row per cluster: blockIdx.y the row, blockIdx.x the block's rank.
__global__ void __launch_bounds__(THREADS) sample_kernel(const SampleParams p) {
  __shared__ Shared sh;
  extern __shared__ float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * p.slice;
  const int64_t hi = lo + p.slice < p.vocab ? lo + p.slice : p.vocab;
  const int n = hi > lo ? static_cast<int>(hi - lo) : 0;
  const float* __restrict__ logits = p.logits + row * p.ld + lo;
  float* vals = dyn;              // cached: the slice's logits
  float* probs = dyn + p.slice;   // cached: e, then the probabilities
  const bool detail = p.noise != nullptr;
  const float temp = p.temperature[row];
  const bool full = detail || temp > 0.f;
  const float temp_safe = temp > 0.f ? temp : 1.f;

  // ---- the row's max (the greedy pick) and min ----
  Arg best{-CUDART_INF_F, INT_MAX};
  float mn = CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = __ldg(logits + i);
    if (p.cached) vals[i] = x;
    best = best_of(best, Arg{x, static_cast<int>(lo) + i});
    mn = fminf(mn, x);
  }
  best = block_best(best, sh.part_arg);
  mn = block_min(mn, sh.part_f);
  if (threadIdx.x == 0) {
    sh.row_max = best.v;
    sh.row_arg = best.i;
    sh.row_min = mn;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    Arg b{-CUDART_INF_F, INT_MAX};
    float m = CUDART_INF_F;
    for (int r = 0; r < splits; ++r) {
      const Shared* peer = cluster.map_shared_rank(&sh, r);
      b = best_of(b, Arg{peer->row_max, peer->row_arg});
      m = fminf(m, peer->row_min);
    }
    sh.max = b.v;
    sh.arg = b.i;
    sh.min = m;
    if (!full && blockIdx.x == 0) p.tokens[row] = b.i;
  }
  if (!full) {
    cluster.sync();  // no block leaves while a peer may read its shared memory
    return;
  }
  __syncthreads();
  const float row_max = sh.max, row_min = sh.min;
  const float z0 = __fdiv_rn(row_max, temp_safe);
  auto value = [&](int i) { return p.cached ? vals[i] : __ldg(logits + i); };
  auto e_of = [&](float x) { return expf(__fsub_rn(__fdiv_rn(x, temp_safe), z0)); };

  // ---- S, the softmax's sum ----
  unsigned long long e_sum = 0;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float e = e_of(value(i));
    if (p.cached) probs[i] = e;
    e_sum += fixed(e, p.e_bits);
  }
  e_sum = block_sum(e_sum, sh.part_u64);
  if (threadIdx.x == 0) sh.e_sum = e_sum;
  cluster.sync();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int r = 0; r < splits; ++r) total += cluster.map_shared_rank(&sh, r)->e_sum;
    sh.sum = __fmul_rn(__ull2float_rn(total), __int_as_float((127 - p.e_bits) << 23));
  }
  __syncthreads();
  const float sum = sh.sum;
  if (p.cached) {
    for (int i = threadIdx.x; i < n; i += THREADS) probs[i] = __fdiv_rn(probs[i], sum);
  }
  auto prob = [&](int i, float x) { return p.cached ? probs[i] : __fdiv_rn(e_of(x), sum); };

  // ---- kth and thresh: radix selects over the keys, four passes of 8 bits ----
  const int32_t top_k = p.top_k[row];
  const int64_t k = top_k < 0 ? 0 : (top_k > p.vocab ? p.vocab : top_k);
  const uint32_t k_idx = static_cast<uint32_t>(k > 0 ? k - 1 : p.vocab - 1);  // the descending rank of kth
  const bool do_k = k_idx != 0 && k_idx != p.vocab - 1;  // else kth is the max or the min
  const double tp_scaled = static_cast<double>(p.top_p[row]) * 0x1p62;
  const unsigned long long tp = !(tp_scaled > 0.0) ? 0ull
                                : tp_scaled >= 0x1p63 ? (1ull << 63)
                                                      : static_cast<unsigned long long>(ceil(tp_scaled));
  bool do_p = tp != 0;  // top_p <= 0 keeps the first sorted entry alone: thresh is the max
  if (threadIdx.x == 0) {
    sh.k_prefix = 0;
    sh.k_need = k_idx;
    sh.p_prefix = 0;
    sh.p_above = 0;
    sh.p_found = 1;
  }
  const int lane = threadIdx.x % 32;
  for (int q = 0; q < PASSES && (do_k || do_p); ++q) {
    const int shift = 24 - 8 * q;
    for (int t = threadIdx.x; t < BINS; t += THREADS) {
      sh.count[q][t] = 0;
      sh.mass[q][t] = 0;
    }
    __syncthreads();
    const uint32_t k_prefix = sh.k_prefix, p_prefix = sh.p_prefix;
    // A trip count uniform over the block: every lane reaches the warp collectives.
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + threadIdx.x;
      const bool valid = i < n;
      const float x = valid ? value(i) : 0.f;
      const uint32_t key = key_of(x);
      const uint32_t digit = (key >> shift) & 0xFFu;
      const bool in_k = do_k && valid && (q == 0 || (key >> (shift + 8)) == k_prefix);
      const bool in_p = do_p && valid && (q == 0 || (key >> (shift + 8)) == p_prefix);
      // Lanes of one label share both digits: the group's first lane adds for all of them.
      const uint32_t label = (in_k ? digit : NO_DIGIT) | ((in_p ? digit : NO_DIGIT) << 9);
      const unsigned same = __match_any_sync(fat::FULL_MASK, label);
      const bool lead = lane == __ffs(same) - 1;
      if (in_k && lead) atomicAdd(&sh.count[q][digit], static_cast<uint32_t>(__popc(same)));
      if (do_p) {
        // The group's mass in three 21-bit pieces: 32 of each sum in 32 bits.
        const unsigned long long m = in_p ? fixed(prob(i, x), MASS_BITS) : 0ull;
        constexpr unsigned long long PIECE = (1ull << 21) - 1;
        const unsigned s0 = __reduce_add_sync(same, static_cast<unsigned>(m & PIECE));
        const unsigned s1 = __reduce_add_sync(same, static_cast<unsigned>((m >> 21) & PIECE));
        const unsigned s2 = __reduce_add_sync(same, static_cast<unsigned>(m >> 42));
        if (in_p && lead) {
          atomicAdd(&sh.mass[q][digit], s0 + (static_cast<unsigned long long>(s1) << 21) +
                                            (static_cast<unsigned long long>(s2) << 42));
        }
      }
    }
    cluster.sync();
    // Thread t takes digit 255 - t: the scans run from the largest keys down.
    const int d = BINS - 1 - static_cast<int>(threadIdx.x);
    uint32_t c = 0;
    unsigned long long m = 0;
    if (d >= 0) {
      for (int r = 0; r < splits; ++r) {
        const Shared* peer = cluster.map_shared_rank(&sh, r);
        c += peer->count[q][d];
        m += peer->mass[q][d];
      }
    }
    const uint32_t c_incl = block_scan(c, sh.part_u32);
    const unsigned long long m_incl = block_scan(m, sh.part_u64);
    const uint32_t need = sh.k_need;
    const unsigned long long above = sh.p_above;
    __syncthreads();
    if (d >= 0 && do_k && c_incl - c <= need && need < c_incl) {
      sh.k_prefix = (k_prefix << 8) | static_cast<uint32_t>(d);
      sh.k_need = need - (c_incl - c);
    }
    if (d >= 0 && do_p && above + (m_incl - m) < tp && tp <= above + m_incl) {
      sh.p_prefix = (p_prefix << 8) | static_cast<uint32_t>(d);
      sh.p_above = above + (m_incl - m);
    }
    __syncthreads();
    // No digit reaches top_p in the first pass: the row's whole mass is below it, and every entry is kept.
    if (q == 0 && do_p) {
      const unsigned long long total = block_sum(m, sh.part_u64);
      if (total < tp) {
        do_p = false;
        if (threadIdx.x == 0) sh.p_found = 0;
      }
    }
  }
  __syncthreads();
  const float kth = do_k ? value_of(sh.k_prefix) : (k_idx == 0 ? row_max : row_min);
  const float thresh = tp == 0 ? row_max : (sh.p_found ? value_of(sh.p_prefix) : row_min);

  // ---- argmax(where(keep, logits, -inf) / T + g) ----
  const uint2 key = threefry(0u, static_cast<uint32_t>(p.seeds[row]), 0u, static_cast<uint32_t>(p.positions[row]));
  Arg pick{-CUDART_INF_F, INT_MAX};
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float x = value(i);
    const bool keep = x >= kth && x >= thresh;
    float y = -CUDART_INF_F;
    if (keep || detail) {
      const float g = gumbel(key.x, key.y, static_cast<uint32_t>(lo + i));
      if (detail) p.noise[row * p.vocab + lo + i] = g;
      y = __fadd_rn(__fdiv_rn(keep ? x : -CUDART_INF_F, temp_safe), g);
    }
    pick = best_of(pick, Arg{y, static_cast<int>(lo) + i});
  }
  pick = block_best(pick, sh.part_arg);
  if (threadIdx.x == 0) sh.pick = pick;
  cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    Arg b{-CUDART_INF_F, INT_MAX};
    for (int r = 0; r < splits; ++r) b = best_of(b, cluster.map_shared_rank(&sh, r)->pick);
    p.tokens[row] = temp > 0.f ? b.i : sh.arg;
    if (detail) {
      p.greedy[row] = sh.arg;
      p.kth[row] = kth;
      p.thresh[row] = thresh;
    }
  }
  cluster.sync();  // no block leaves while a peer may read its shared memory
}

int bit_length(int64_t v) {
  int n = 0;
  while (v > 0) {
    ++n;
    v >>= 1;
  }
  return n;
}

}  // namespace

// S1. logits [batch, vocab] fp32 with unit stride along vocab, rows `ld`
// apart; temperature, top_p [batch] fp32; top_k, seeds, positions [batch]
// int32 (seeds and positions taken as their uint32 bits); tokens [batch]
// int32. With noise ([batch, vocab] fp32, contiguous), greedy ([batch]
// int32), kth and thresh ([batch] fp32) all given, the detail mode: every
// row computed in full and those written too. Returns a cudaError_t.
extern "C" int fat_sample(const float* logits, int64_t ld, const float* temperature, const int32_t* top_k,
                          const float* top_p, const int32_t* seeds, const int32_t* positions, int32_t* tokens,
                          float* noise, int32_t* greedy, float* kth, float* thresh, int64_t batch, int64_t vocab,
                          void* stream) {
  if (batch <= 0 || batch > 65535 || vocab <= 0 || vocab >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((noise == nullptr) != (greedy == nullptr) || (noise == nullptr) != (kth == nullptr) ||
      (noise == nullptr) != (thresh == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SampleParams p{logits, ld, temperature, top_k, top_p, seeds, positions, tokens, noise, greedy, kth, thresh, vocab};
  const int splits = static_cast<int>(std::min<int64_t>(MAX_SPLITS, (vocab + MIN_SLICE - 1) / MIN_SLICE));
  p.slice = (vocab + splits - 1) / splits;
  p.cached = p.slice * 8 <= SMEM_BUDGET;
  const int smem = p.cached ? static_cast<int>(p.slice * 8) : 0;
  p.e_bits = 63 - bit_length(vocab);
  cudaError_t err = fat::reserve_smem(sample_kernel, SMEM_BUDGET);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(batch));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sample_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
