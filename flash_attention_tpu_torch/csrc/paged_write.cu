// K9 and K10: append one token's K/V row per slot to the KV pages of L
// layers in one launch, for Hopper; K9q and K10q quantize the rows as they
// write them.
//
// Replaces the JAX package's ops/paged.py:_write_rows_kernel (:130, K9,
// one layer), _write_rows_kernel_quant (:145, K9q) and
// _make_multi_write_kernel (:257, K10, all layers of the deferred decode
// step, and its quantized branch K10q, :280-287). For listed slot i, layer
// l: pos = lengths[slot], and where pos < pages_per_slot * page_size the
// row's kv_heads x head_dim K and V elements go to
//   pool_l[clamp(table[slot, pos / page_size]), h, pos % page_size, :]
// A slot at capacity writes nothing. The same launch writes the new lengths
// tensor: lengths[slot] + 1 for each listed slot that wrote, the old length
// for every other slot, each slot by exactly one thread (an extra block of
// layer 0). `slots` is read as int64 or int32, as the caller holds it. The
// page id is clamped into [0, num_pages): a released slot's table points at
// dump page 0 while its lane still rides in the batched step.
//
// What bounds it on this card: it moves bytes and does no arithmetic; at the
// serving shape (32 layers x 8 slots x 8 heads x 128 bf16, K and V) that is
// 1 MB read and 1 MB written, 0.6 us at 3.35 TB/s, so the launch itself
// (a few us) is the floor, which is why all layers share one launch and the
// lengths are advanced in it: a call is this one launch and the allocation
// of the new lengths (the wrapper converts nothing that is int32 or int64
// already).
//
// Design: one block per (slot, layer), plus the lengths block; each thread
// copies 16-byte words of the row straight into place, so nothing else in
// the page is touched (the TPU kernel read and rewrote 8-row slabs because
// Mosaic wants blocks of whole sublanes). The kernel is type-agnostic: it
// copies bytes.
//
// K9q/K10q (paged_write_quant_kernel): the JAX package quantizes the rows in
// XLA and its kernel writes payload rows and scale lanes; here the kernel
// takes the rows in the model's dtype and quantizes them itself, so the
// quantized rows never pass through device memory. One warp takes one
// (K or V, head) row of one (slot, layer): its absmax by a shuffle
// reduction, the scale absmax / QMAX in fp32 (1 for an all-zero row), then
// each element divided by it (IEEE division: the build has no fast math),
// and for int8 rounded half to even (rintf) and clipped to [-127, 127], for
// fp8 cast with __nv_cvt_float_to_fp8(..., __NV_SATFINITE, ...), which
// rounds to nearest even as torch's cast does; the rows' values never reach
// the saturation. The output is bit-equal to ops/quant.py's quantize_values
// followed by the plain write. The scale is one 4-byte store per (row,
// head) into the [L, num_pages, H, page_size] scale pools.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

// What the two kernels share: the slots, their lengths and table, and the
// new lengths.
struct SlotParams {
  const void* slots;       // [n] int64 or int32
  int slots_int64;
  const int32_t* lengths;  // [num_slots], shared by the layers
  const int32_t* table;    // [num_slots, pages_per_slot], shared by the layers
  int32_t* new_lengths;    // [num_slots], out
  int n, num_slots, page_size, pages_per_slot;

  __device__ __forceinline__ int slot(int i) const {
    return slots_int64 ? static_cast<int>(static_cast<const int64_t*>(slots)[i]) : static_cast<const int32_t*>(slots)[i];
  }
  __device__ __forceinline__ bool has_room(int pos) const { return pos >= 0 && pos < page_size * pages_per_slot; }
};

// Block (n, 0): every slot's new length, by one thread each. Returns true
// for the blocks that do this and nothing else.
__device__ __forceinline__ bool lengths_block(const SlotParams& s) {
  if (static_cast<int>(blockIdx.x) < s.n) return false;
  if (blockIdx.y == 0) {
    for (int j = threadIdx.x; j < s.num_slots; j += THREADS) {
      const int old = s.lengths[j];
      int wrote = 0;
      for (int i = 0; i < s.n; ++i) wrote |= s.slot(i) == j;
      s.new_lengths[j] = old + (wrote && s.has_room(old));
    }
  }
  return true;
}

struct WriteParams {
  SlotParams s;
  const char* k_new;  // [L, n, H, row_bytes], contiguous
  const char* v_new;
  char* k_pool;  // layer 0's [num_pages, H, page_size, row_bytes] pages
  char* v_pool;
  int64_t layer_stride, page_stride, head_stride, row_stride;  // pool strides in bytes
  int num_heads, row_words, num_pages;
};

__global__ void __launch_bounds__(THREADS) paged_write_kernel(const WriteParams p) {
  if (lengths_block(p.s)) return;
  const int i = blockIdx.x, layer = blockIdx.y;
  const int slot = p.s.slot(i);
  const int pos = p.s.lengths[slot];
  if (!p.s.has_room(pos)) return;
  const int page = p.s.table[static_cast<int64_t>(slot) * p.s.pages_per_slot + pos / p.s.page_size];
  const int phys = min(max(page, 0), p.num_pages - 1);
  const int64_t dst0 = layer * p.layer_stride + phys * p.page_stride + (pos % p.s.page_size) * p.row_stride;
  const int64_t src0 = (static_cast<int64_t>(layer) * p.s.n + i) * p.num_heads * p.row_words;
  for (int w = threadIdx.x; w < p.num_heads * p.row_words; w += THREADS) {
    const int h = w / p.row_words, c = w % p.row_words;
    const int64_t dst = dst0 + h * p.head_stride;
    reinterpret_cast<uint4*>(p.k_pool + dst)[c] = reinterpret_cast<const uint4*>(p.k_new)[src0 + w];
    reinterpret_cast<uint4*>(p.v_pool + dst)[c] = reinterpret_cast<const uint4*>(p.v_new)[src0 + w];
  }
}

// The payload code of x, quantized by the row scale `scale`.
template <typename P>
__device__ __forceinline__ P quantize(float x, float scale) {
  const float y = x / scale;
  P out;
  if constexpr (std::is_same_v<P, int8_t>) {
    out = static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
  } else {
    constexpr __nv_fp8_interpretation_t kind =
        std::is_same_v<P, __nv_fp8_e4m3> ? __NV_E4M3 : __NV_E5M2;
    out.__x = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, kind);
  }
  return out;
}

struct QuantWriteParams {
  SlotParams s;
  const void* k_new;  // [L, n, H, D] in the model's dtype, contiguous
  const void* v_new;
  void* k_pool;  // layer 0's [num_pages, H, page_size, D] payload pages
  void* v_pool;
  float* k_scales;  // layer 0's [num_pages, H, page_size] scale pages
  float* v_scales;
  int64_t layer_stride, page_stride, head_stride, row_stride;  // payload strides, in elements
  int64_t s_layer_stride, s_page_stride, s_head_stride;        // scale strides (rows contiguous)
  int num_heads, head_dim, num_pages;
  float qmax;
};

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS) paged_write_quant_kernel(const QuantWriteParams p) {
  if (lengths_block(p.s)) return;
  const int i = blockIdx.x, layer = blockIdx.y;
  const int slot = p.s.slot(i);
  const int pos = p.s.lengths[slot];
  if (!p.s.has_room(pos)) return;
  const int page = p.s.table[static_cast<int64_t>(slot) * p.s.pages_per_slot + pos / p.s.page_size];
  const int phys = min(max(page, 0), p.num_pages - 1);
  const int row = pos % p.s.page_size;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Units: (K or V, head) rows of this (slot, layer), one warp each.
  for (int unit = warp; unit < 2 * p.num_heads; unit += THREADS / 32) {
    const bool is_v = unit >= p.num_heads;
    const int h = unit % p.num_heads;
    const T* src = static_cast<const T*>(is_v ? p.v_new : p.k_new) +
                   ((static_cast<int64_t>(layer) * p.s.n + i) * p.num_heads + h) * p.head_dim;
    float absmax = 0.f;
    for (int e = lane; e < p.head_dim; e += 32) absmax = fmaxf(absmax, fabsf(fat::to_float(src[e])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      absmax = fmaxf(absmax, __shfl_xor_sync(fat::FULL_MASK, absmax, off));
    const float scale = absmax == 0.f ? 1.f : absmax / p.qmax;
    P* dst = static_cast<P*>(is_v ? p.v_pool : p.k_pool) + layer * p.layer_stride +
             phys * p.page_stride + h * p.head_stride + row * p.row_stride;
    for (int e = lane; e < p.head_dim; e += 32) dst[e] = quantize<P>(fat::to_float(src[e]), scale);
    if (lane == 0) {
      float* sc = is_v ? p.v_scales : p.k_scales;
      sc[layer * p.s_layer_stride + phys * p.s_page_stride + h * p.s_head_stride + row] = scale;
    }
  }
}

SlotParams slot_params(const void* slots, int32_t slots_int64, const int32_t* lengths, const int32_t* table,
                       int32_t* new_lengths, int64_t n, int64_t num_slots, int64_t page_size,
                       int64_t pages_per_slot) {
  SlotParams s{};
  s.slots = slots;
  s.slots_int64 = slots_int64;
  s.lengths = lengths;
  s.table = table;
  s.new_lengths = new_lengths;
  s.n = static_cast<int>(n);
  s.num_slots = static_cast<int>(num_slots);
  s.page_size = static_cast<int>(page_size);
  s.pages_per_slot = static_cast<int>(pages_per_slot);
  return s;
}

}  // namespace

// k_new, v_new [L, n, H, D] contiguous; k_pool, v_pool point at layer 0 of
// pools whose layers, pages, heads and rows lie at the given byte strides,
// rows contiguous; slots [n] (int64 when slots_int64, else int32), lengths
// [num_slots] and table [num_slots, pages_per_slot] int32 contiguous;
// new_lengths [num_slots] int32 out. row_bytes, every pointer and every
// stride must be multiples of 16. Returns a cudaError_t.
extern "C" int fat_paged_write(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                               const int32_t* lengths, const int32_t* table, const void* slots,
                               int32_t slots_int64, int32_t* new_lengths, int64_t num_layers, int64_t n,
                               int64_t num_slots, int64_t num_heads, int64_t row_bytes, int64_t num_pages,
                               int64_t page_size, int64_t pages_per_slot, int64_t layer_stride,
                               int64_t page_stride, int64_t head_stride, int64_t row_stride, void* stream) {
  WriteParams p{};
  p.s = slot_params(slots, slots_int64, lengths, table, new_lengths, n, num_slots, page_size, pages_per_slot);
  p.k_new = static_cast<const char*>(k_new);
  p.v_new = static_cast<const char*>(v_new);
  p.k_pool = static_cast<char*>(k_pool);
  p.v_pool = static_cast<char*>(v_pool);
  p.layer_stride = layer_stride;
  p.page_stride = page_stride;
  p.head_stride = head_stride;
  p.row_stride = row_stride;
  p.num_heads = static_cast<int>(num_heads);
  p.row_words = static_cast<int>(row_bytes / 16);
  p.num_pages = static_cast<int>(num_pages);
  const dim3 grid(static_cast<unsigned>(n + 1), static_cast<unsigned>(num_layers));
  paged_write_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K9q/K10q. k_new, v_new [L, n, H, D] contiguous in the model's dtype
// (dtype: float32, float16 or bfloat16); k_pool, v_pool point at layer 0 of
// payload pools (payload: int8, fp8 e4m3 or fp8 e5m2) whose layers, pages,
// heads and rows lie at the given element strides, rows contiguous; k_scales,
// v_scales at layer 0 of [L, num_pages, H, page_size] fp32 scale pools with
// the given layer / page / head strides and contiguous rows; slots, lengths,
// table and new_lengths as in fat_paged_write. Returns a cudaError_t.
extern "C" int fat_paged_write_quant(const void* k_new, const void* v_new, void* k_pool,
                                     void* v_pool, float* k_scales, float* v_scales,
                                     const int32_t* lengths, const int32_t* table, const void* slots,
                                     int32_t slots_int64, int32_t* new_lengths, int64_t num_layers,
                                     int64_t n, int64_t num_slots, int64_t num_heads, int64_t head_dim,
                                     int64_t num_pages, int64_t page_size, int64_t pages_per_slot,
                                     int64_t layer_stride, int64_t page_stride,
                                     int64_t head_stride, int64_t row_stride,
                                     int64_t s_layer_stride, int64_t s_page_stride,
                                     int64_t s_head_stride, int32_t dtype, int32_t payload,
                                     void* stream) {
  QuantWriteParams p{};
  p.s = slot_params(slots, slots_int64, lengths, table, new_lengths, n, num_slots, page_size, pages_per_slot);
  p.k_new = k_new;
  p.v_new = v_new;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.layer_stride = layer_stride;
  p.page_stride = page_stride;
  p.head_stride = head_stride;
  p.row_stride = row_stride;
  p.s_layer_stride = s_layer_stride;
  p.s_page_stride = s_page_stride;
  p.s_head_stride = s_head_stride;
  p.num_heads = static_cast<int>(num_heads);
  p.head_dim = static_cast<int>(head_dim);
  p.num_pages = static_cast<int>(num_pages);
  const dim3 grid(static_cast<unsigned>(n + 1), static_cast<unsigned>(num_layers));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(fat::by_type(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    switch (payload) {
      case fat::kInt8:
        p.qmax = 127.f;
        paged_write_quant_kernel<T, int8_t><<<grid, THREADS, 0, st>>>(p);
        break;
      case fat::kFp8E4M3:
        p.qmax = 448.f;
        paged_write_quant_kernel<T, __nv_fp8_e4m3><<<grid, THREADS, 0, st>>>(p);
        break;
      case fat::kFp8E5M2:
        p.qmax = 57344.f;
        paged_write_quant_kernel<T, __nv_fp8_e5m2><<<grid, THREADS, 0, st>>>(p);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  }));
}
