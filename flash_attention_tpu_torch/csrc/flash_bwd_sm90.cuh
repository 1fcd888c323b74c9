// The entry points of csrc/flash_bwd_sm90.cu (K3, K4 and K5 on tensor cores
// for bf16 and fp16), called by csrc/flash_bwd.cu's C entries, which
// dispatch by dtype: fp32 keeps that file's FMA bodies.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fat {

// One K3, K4 or K5 call: the operands as flash_bwd.cu's entries take them.
struct Sm90BwdCall {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, lse_pitch] base-2, -inf replaced by 0; rows past q_len are 0
  const float* delta;  // [B, Hq, lse_pitch]
  void* out0;          // K4: dq; K5, K3: dk, or (K5) with splits > 1 the fp32 workspace
  void* out1;          // K5, K3: dv (unused with splits > 1)
  int64_t batch, num_q_heads, num_kv_heads, q_len, kv_len, head_dim, lse_pitch;
  const int64_t* st;   // q, k, v, dO strides in elements: (batch, head, row) each
  float scale2, sm_scale;
  int32_t causal, window;
  float softcap2;
  const int32_t* seg_q;
  const int32_t* seg_kv;
  const int32_t* q_rng;
  const int32_t* kv_rng;
  int32_t splits;  // K5: blocks a kv tile's GQA group is split over
  int32_t dtype;
  cudaStream_t stream;
  float* dq_acc = nullptr;  // K3: [B, Hq, Sq, D] fp32, zeroed by the caller; dq is added into it
};

cudaError_t sm90_bwd_dq(const Sm90BwdCall& c);
cudaError_t sm90_bwd_dkv(const Sm90BwdCall& c);
cudaError_t sm90_bwd_fused(const Sm90BwdCall& c);

}  // namespace fat
