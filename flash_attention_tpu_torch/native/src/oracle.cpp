// Native fp32 attention oracle.
//
// C++ re-implementation of the reference's CPU oracle `cpu_attention`
// (flash_attention.cu:668-697) with the generalizations our kernels need:
// GQA head grouping, causal diag offset (kv_len - q_len), and per-batch KV
// lengths. Same numerics contract: full fp32 score row, subtracted row max,
// exp/sum, normalized weighted-V sum. Used by tests as a second, JAX-free
// judge of the Pallas kernels (the fp32 einsum oracle being the first).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Shapes: q [B, Hq, Sq, D]; k, v [B, Hkv, Skv, D]; out [B, Hq, Sq, D];
// kv_lengths: nullptr or [B] valid-prefix lengths. All row-major fp32.
void fat_oracle_attention(const float* q, const float* k, const float* v,
                          float* out, int32_t batch, int32_t num_q_heads,
                          int32_t num_kv_heads, int32_t q_len, int32_t kv_len,
                          int32_t head_dim, int32_t causal, float scale,
                          const int32_t* kv_lengths) {
  const int32_t group = num_q_heads / num_kv_heads;
  const int64_t q_head_stride = static_cast<int64_t>(q_len) * head_dim;
  const int64_t kv_head_stride = static_cast<int64_t>(kv_len) * head_dim;
  const int32_t diag_offset = kv_len - q_len;
  std::vector<float> scores(kv_len);

  for (int32_t b = 0; b < batch; ++b) {
    const int32_t valid =
        kv_lengths ? (kv_lengths[b] < kv_len ? kv_lengths[b] : kv_len) : kv_len;
    for (int32_t h = 0; h < num_q_heads; ++h) {
      const float* qh = q + (static_cast<int64_t>(b) * num_q_heads + h) * q_head_stride;
      const int32_t hkv = h / group;
      const float* kh = k + (static_cast<int64_t>(b) * num_kv_heads + hkv) * kv_head_stride;
      const float* vh = v + (static_cast<int64_t>(b) * num_kv_heads + hkv) * kv_head_stride;
      float* oh = out + (static_cast<int64_t>(b) * num_q_heads + h) * q_head_stride;

      for (int32_t i = 0; i < q_len; ++i) {
        const float* qi = qh + static_cast<int64_t>(i) * head_dim;
        int32_t cols = valid;
        if (causal) {
          const int32_t lim = i + diag_offset + 1;  // query i sees keys <= i+off
          if (lim < cols) cols = lim;
        }
        float row_max = -INFINITY;
        for (int32_t j = 0; j < cols; ++j) {
          const float* kj = kh + static_cast<int64_t>(j) * head_dim;
          float dot = 0.0f;
          for (int32_t d = 0; d < head_dim; ++d) dot += qi[d] * kj[d];
          scores[j] = dot * scale;
          if (scores[j] > row_max) row_max = scores[j];
        }
        float denom = 0.0f;
        for (int32_t j = 0; j < cols; ++j) {
          scores[j] = std::exp(scores[j] - row_max);
          denom += scores[j];
        }
        float* oi = oh + static_cast<int64_t>(i) * head_dim;
        const float inv = (denom > 0.0f) ? 1.0f / denom : 0.0f;
        for (int32_t d = 0; d < head_dim; ++d) oi[d] = 0.0f;
        for (int32_t j = 0; j < cols; ++j) {
          const float w = scores[j] * inv;
          const float* vj = vh + static_cast<int64_t>(j) * head_dim;
          for (int32_t d = 0; d < head_dim; ++d) oi[d] += w * vj[d];
        }
      }
    }
  }
}

}  // extern "C"
