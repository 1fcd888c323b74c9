// K9 and K10: append one token's K/V row per slot to the KV pages of L
// layers in one launch, for Hopper.
//
// Replaces flash_attention_tpu/ops/paged.py:_write_rows_kernel (:130, K9,
// one layer) and _make_multi_write_kernel (:257, K10, all layers of the
// deferred decode step; its non-quantized branch). For listed slot i, layer
// l: pos = lengths[slot], and where pos < pages_per_slot * page_size the
// row's kv_heads x head_dim K and V elements go to
//   pool_l[clamp(table[slot, pos / page_size]), h, pos % page_size, :]
// A slot at capacity writes nothing; valid[i] records which slots wrote, and
// the caller advances lengths by it. The page id is clamped into
// [0, num_pages): a released slot's table points at dump page 0 while its
// lane still rides in the batched step.
//
// What bounds it on this card: it moves bytes and does no arithmetic; at the
// serving shape (32 layers x 8 slots x 8 heads x 128 bf16, K and V) that is
// 1 MB read and 1 MB written, 0.6 us at 3.35 TB/s, so the launch itself
// (a few us) is the floor, which is why all layers share one launch.
//
// Design: one block per (slot, layer); each thread copies 16-byte words of
// the row straight into place, so nothing else in the page is touched (the
// TPU kernel read and rewrote 8-row slabs because Mosaic wants blocks of
// whole sublanes). The kernel is type-agnostic: it copies bytes.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

struct WriteParams {
  const char* k_new;  // [L, n, H, row_bytes], contiguous
  const char* v_new;
  char* k_pool;  // layer 0's [num_pages, H, page_size, row_bytes] pages
  char* v_pool;
  const int32_t* lengths;  // [num_slots], shared by the layers
  const int32_t* table;    // [num_slots, pages_per_slot], shared by the layers
  const int32_t* slots;    // [n]
  int32_t* valid;          // [n], out
  int64_t layer_stride, page_stride, head_stride, row_stride;  // pool strides in bytes
  int n, num_heads, row_words, num_pages, page_size, pages_per_slot;
};

__global__ void __launch_bounds__(THREADS) paged_write_kernel(const WriteParams p) {
  const int i = blockIdx.x, layer = blockIdx.y;
  const int slot = p.slots[i];
  const int pos = p.lengths[slot];
  const bool ok = pos >= 0 && pos < p.page_size * p.pages_per_slot;
  if (layer == 0 && threadIdx.x == 0) p.valid[i] = ok;
  if (!ok) return;
  const int page = p.table[static_cast<int64_t>(slot) * p.pages_per_slot + pos / p.page_size];
  const int phys = min(max(page, 0), p.num_pages - 1);
  const int64_t dst0 = layer * p.layer_stride + phys * p.page_stride + (pos % p.page_size) * p.row_stride;
  const int64_t src0 = (static_cast<int64_t>(layer) * p.n + i) * p.num_heads * p.row_words;
  for (int w = threadIdx.x; w < p.num_heads * p.row_words; w += THREADS) {
    const int h = w / p.row_words, c = w % p.row_words;
    const int64_t dst = dst0 + h * p.head_stride;
    reinterpret_cast<uint4*>(p.k_pool + dst)[c] = reinterpret_cast<const uint4*>(p.k_new)[src0 + w];
    reinterpret_cast<uint4*>(p.v_pool + dst)[c] = reinterpret_cast<const uint4*>(p.v_new)[src0 + w];
  }
}

}  // namespace

// k_new, v_new [L, n, H, D] contiguous; k_pool, v_pool point at layer 0 of
// pools whose layers, pages, heads and rows lie at the given byte strides,
// rows contiguous; lengths [num_slots], table [num_slots, pages_per_slot]
// and slots [n] int32 contiguous; valid [n] int32 out. row_bytes, every
// pointer and every stride must be multiples of 16. Returns a cudaError_t.
extern "C" int fat_paged_write(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
                               const int32_t* lengths, const int32_t* table, const int32_t* slots,
                               int32_t* valid, int64_t num_layers, int64_t n, int64_t num_heads,
                               int64_t row_bytes, int64_t num_pages, int64_t page_size,
                               int64_t pages_per_slot, int64_t layer_stride, int64_t page_stride,
                               int64_t head_stride, int64_t row_stride, void* stream) {
  WriteParams p{};
  p.k_new = static_cast<const char*>(k_new);
  p.v_new = static_cast<const char*>(v_new);
  p.k_pool = static_cast<char*>(k_pool);
  p.v_pool = static_cast<char*>(v_pool);
  p.lengths = lengths;
  p.table = table;
  p.slots = slots;
  p.valid = valid;
  p.layer_stride = layer_stride;
  p.page_stride = page_stride;
  p.head_stride = head_stride;
  p.row_stride = row_stride;
  p.n = static_cast<int>(n);
  p.num_heads = static_cast<int>(num_heads);
  p.row_words = static_cast<int>(row_bytes / 16);
  p.num_pages = static_cast<int>(num_pages);
  p.page_size = static_cast<int>(page_size);
  p.pages_per_slot = static_cast<int>(pages_per_slot);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(num_layers));
  paged_write_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
