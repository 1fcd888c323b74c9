// The entry point of csrc/flash_fwd_sm90.cu (K1 and K1d on tensor cores for
// bf16 and fp16), called by csrc/flash_fwd.cu's fat_flash_fwd, which
// dispatches by dtype and band: fp32 and K2 keep that file's FMA body.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fat {

// One K1 / K1d call: the operands as fat_flash_fwd takes them.
struct Sm90FwdCall {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // [B, Hq, Sq, D] contiguous
  float* lse;  // [B, Hq, Sq] base-2, or nullptr
  int64_t batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim;
  const int64_t* st;  // q, k, v strides in elements: (batch, head, row) each
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
};

cudaError_t sm90_fwd(const Sm90FwdCall& c);

}  // namespace fat
