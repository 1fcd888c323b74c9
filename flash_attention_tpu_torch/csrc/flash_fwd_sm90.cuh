// The entry point of csrc/flash_fwd_sm90.cu (K1, K1d, K2 and K8 / K8q on
// tensor cores for bf16 and fp16 queries), called by csrc/flash_fwd.cu's
// fat_flash_fwd and fat_paged_prefill, which dispatch by dtype: fp32 keeps
// that file's FMA body.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fat {

// One call: the operands as fat_flash_fwd and fat_paged_prefill take them.
struct Sm90FwdCall {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // [B, Hq, Sq, D] contiguous
  float* lse;  // [B, Hq, Sq] base-2, or nullptr
  int64_t batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim;
  const int64_t* st;  // q, k, v strides in elements: (batch or page, head, row) each
  float scale2;
  int32_t causal, window;
  float softcap2;
  const int32_t* seg_q;
  const int32_t* seg_kv;
  const int32_t* q_rng;
  const int32_t* kv_rng;
  int32_t q_tile;  // q rows a block: 128 (two warpgroups) or 64 (one)
  int32_t dtype;
  cudaStream_t stream;
  // Dense K / V of kv_batch batch rows: with kv_index (device int32 [batch])
  // query batch b attends row kv_index[b], read by each block from memory
  // (the prefill programs' slot, which changes between replays of one CUDA
  // graph); null: row b of batch rows.
  const int32_t* kv_index;
  int64_t kv_batch;
  // K8: k and v are a layer's page pools [num_pages, Hkv, page_size, D]
  // (st: page / head / row strides), read through the row of the page
  // table `table` [table_rows, table_stride] that the device int32 `slot`
  // names, read by each block from memory; kv_len is the chunk's kv_end and
  // batch is 1. Null for dense K / V.
  const int32_t* table;
  const int32_t* slot;
  int64_t table_rows, table_stride;
  int64_t page_size, num_pages;
  int32_t sinks;    // columns [0, sinks) visible beside the window
  int32_t payload;  // K / V's element code: dtype, or a 1-byte payload (K8q) with row scales
  const float* ks;  // K8q: the row scales [pages, Hkv, rows], unit row stride
  const float* vs;
  const int64_t* sst;  // K8q: the scales' page and head strides, K's then V's
};

cudaError_t sm90_fwd(const Sm90FwdCall& c);

}  // namespace fat
