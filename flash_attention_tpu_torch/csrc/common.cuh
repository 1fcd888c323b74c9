// Shared numerics of the attention kernels: the contract of
// flash_attention_tpu_torch/ops/common.py (fp32 accumulators, exp2-domain
// softmax with sm_scale * log2(e) folded into one constant, a finite mask
// value, the running row max floored at M_FLOOR) and the element-type
// conversions the kernels are templated over.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace fat {

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float M_FLOOR = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Element types, in the codes the Python wrappers pass.
enum DType : int { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls fn.template launch<T, D>() for the runtime (dtype, head_dim); returns
// cudaErrorInvalidValue for a pair with no instantiation.
template <typename Fn>
cudaError_t dispatch(int dtype, int64_t head_dim, const Fn& fn) {
  auto by_dim = [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    switch (head_dim) {
      case 32: return fn.template launch<T, 32>();
      case 64: return fn.template launch<T, 64>();
      case 128: return fn.template launch<T, 128>();
      default: return cudaErrorInvalidValue;
    }
  };
  switch (dtype) {
    case kFloat32: return by_dim(TypeTag<float>{});
    case kFloat16: return by_dim(TypeTag<__half>{});
    case kBFloat16: return by_dim(TypeTag<__nv_bfloat16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fat
