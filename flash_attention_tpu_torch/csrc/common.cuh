// Shared numerics of the attention kernels: the contract of
// flash_attention_tpu_torch/ops/common.py (fp32 accumulators, exp2-domain
// softmax with sm_scale * log2(e) folded into one constant, a finite mask
// value, the running row max floored at M_FLOOR), the element-type
// conversions the kernels are templated over, and the widening of the
// quantized KV payloads (int8, fp8 e4m3 and e5m2; ops/quant.py), to fp32
// and, exactly, to the packed 16-bit pairs of the tensor-core products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace fat {

// Raise `kernel`'s dynamic shared-memory limit to `bytes`, once per kernel
// instantiation and device: at its first launch, and again only for a larger
// size. cudaFuncSetAttribute is a host call that a CUDA-graph capture in the
// default (global) error mode refuses, so a launch being captured must not
// make it: the eager launch before the capture already has.
template <typename Kernel>
cudaError_t reserve_smem(Kernel* kernel, int bytes) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, int> reserved;  // (kernel, device) -> bytes
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> hold(lock);
  int& have = reserved[{fn, dev}];
  if (have >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;
constexpr float M_FLOOR = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Element types, in the codes the Python wrappers pass (ops/_build.py):
// the query / output types, then the payload types of a quantized cache.
enum DType : int { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2, kInt8 = 3, kFp8E4M3 = 4, kFp8E5M2 = 5 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
// Payload widens are exact: every int8 and every finite fp8 code is a float.
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

// True for the payload types of a quantized cache, whose rows carry a scale.
template <typename P>
inline constexpr bool is_payload =
    std::is_same_v<P, int8_t> || std::is_same_v<P, __nv_fp8_e4m3> || std::is_same_v<P, __nv_fp8_e5m2>;

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

// ---- quantizing a row into a cache payload (ops/quant.py's quantize_values) ----

// A row's scale from its absmax: absmax / QMAX in fp32 (IEEE division: the
// build has no fast math), 1 for an all-zero row.
__device__ __forceinline__ float row_scale(float absmax, float qmax) { return absmax == 0.f ? 1.f : absmax / qmax; }

// The value a payload type maps a row's absmax to: 127 for int8, else the
// fp8 format's largest finite value.
template <typename P>
inline constexpr float payload_qmax = std::is_same_v<P, int8_t> ? 127.f : (std::is_same_v<P, __nv_fp8_e4m3> ? 448.f : 57344.f);

// The payload code of x, quantized by its row's scale: x / scale, for int8
// rounded half to even (rintf) and clipped to [-127, 127], for fp8 cast with
// __nv_cvt_float_to_fp8(..., __NV_SATFINITE, ...), which rounds to nearest
// even as torch's cast does (a row's values never reach the saturation).
template <typename P>
__device__ __forceinline__ P quantize(float x, float scale) {
  const float y = x / scale;
  P out;
  if constexpr (std::is_same_v<P, int8_t>) {
    out = static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
  } else {
    constexpr __nv_fp8_interpretation_t kind = std::is_same_v<P, __nv_fp8_e4m3> ? __NV_E4M3 : __NV_E5M2;
    out.__x = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, kind);
  }
  return out;
}

// ---- packing and widening for the tensor-core products ----

// The pieces K6 / K7 (csrc/decode.cu) and K8q (csrc/flash_fwd_sm90.cu)
// share: fp32 pairs packed as one 32-bit register of M (bf16 or fp16),
// and cache elements widened into such pairs.
template <typename M>
__device__ __forceinline__ uint32_t pack(float a, float b) {
  if constexpr (std::is_same_v<M, __half>) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <typename M>
__device__ __forceinline__ float2 unpack(uint32_t x) {
  if constexpr (std::is_same_v<M, __half>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
}

// (a, b) as a packed M pair, and with SPLIT the rounding's remainder as a
// second pair (a + b's fp32 values to about 16 bits over the two).
template <typename M, bool SPLIT>
__device__ __forceinline__ void pack_split(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack<M>(a, b);
  if constexpr (SPLIT) {
    const float2 h = unpack<M>(hi);
    lo = pack<M>(a - h.x, b - h.y);
  }
}

template <typename P>
__device__ __forceinline__ uint16_t raw16(const P& x) {
  return *reinterpret_cast<const uint16_t*>(&x);
}

// Two cache elements x0, x1 (K: neighbours in a row; V: one column of two
// rows) as an M pair, plus the low pair of an fp32 cache.
template <typename P, typename M>
__device__ __forceinline__ void cache_pair(const P& x0, const P& x1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same_v<P, M>) {
    hi = raw16(x0) | (static_cast<uint32_t>(raw16(x1)) << 16);
  } else if constexpr (std::is_same_v<P, float>) {
    pack_split<M, true>(x0, x1, hi, lo);
  } else if constexpr (std::is_same_v<P, int8_t>) {
    hi = pack<M>(static_cast<float>(x0), static_cast<float>(x1));
  } else {  // fp8: both codes widened at once
    constexpr __nv_fp8_interpretation_t kind = std::is_same_v<P, __nv_fp8_e4m3> ? __NV_E4M3 : __NV_E5M2;
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(x0.__x | (static_cast<uint16_t>(x1.__x) << 8)), kind);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    hi = pack<M>(f.x, f.y);
  }
}

// Codes j and j + 1 of the eight in `raw` (j even) as two exact fp32
// values: int8 through the fp32 2^23 + (code + 128) built from the byte
// (no conversion instruction), fp8 through one paired widen to fp16.
template <typename P>
__device__ __forceinline__ float2 code_pair(uint2 raw, int j) {
  const uint32_t word = j < 4 ? raw.x : raw.y;
  const int k = j % 4;
  if constexpr (std::is_same_v<P, int8_t>) {
    const uint32_t biased = word ^ 0x80808080u;
    return make_float2(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + k)) - 8388736.f,
                       __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7651 + k)) - 8388736.f);
  } else {
    constexpr __nv_fp8_interpretation_t kind = std::is_same_v<P, __nv_fp8_e4m3> ? __NV_E4M3 : __NV_E5M2;
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(word >> (8 * k)), kind));
    return __half22float2(h);
  }
}

// Eight payload codes (one 8-byte load) widened exactly into four packed M
// pairs: 16 bytes of a widened row (every int8 and fp8 code is a bf16 and
// an fp16).
template <typename P, typename M>
__device__ __forceinline__ uint4 widen8(uint2 raw) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = code_pair<P>(raw, 2 * j);
    w[j] = pack<M>(f.x, f.y);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Eight payload codes dequantized as the chunk prefill dequantizes a cache
// (K1q, K1r): each code times the row's scale in fp32, rounded to M; four
// packed M pairs.
template <typename P, typename M>
__device__ __forceinline__ uint4 dequant8(uint2 raw, float scale) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = code_pair<P>(raw, 2 * j);
    w[j] = pack<M>(f.x * scale, f.y * scale);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Packed sequences: whether q tile iq and kv tile ikv of batch row b can hold
// a pair with equal segment ids. q_rng [B, nq, 2] and kv_rng [B, nkv, 2] hold
// each 64-row tile's smallest and largest id (ops/common.segment_tile_ranges);
// tiles whose id ranges are disjoint share no id, so skipping them is exact
// for any ids.
__device__ __forceinline__ bool segment_tiles_meet(const int32_t* q_rng, const int32_t* kv_rng, int b,
                                                   int nq, int nkv, int iq, int ikv) {
  const int32_t* qr = q_rng + 2 * (static_cast<int64_t>(b) * nq + iq);
  const int32_t* kr = kv_rng + 2 * (static_cast<int64_t>(b) * nkv + ikv);
  return qr[0] <= kr[1] && kr[0] <= qr[1];
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls fn(TypeTag<T>{}) for the runtime element type code of a query /
// output type; cudaErrorInvalidValue for any other code.
template <typename Fn>
cudaError_t by_type(int dtype, const Fn& fn) {
  switch (dtype) {
    case kFloat32: return fn(TypeTag<float>{});
    case kFloat16: return fn(TypeTag<__half>{});
    case kBFloat16: return fn(TypeTag<__nv_bfloat16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Calls fn.template launch<T, P, D>() for the runtime (dtype, payload,
// head_dim): P is T itself when payload == dtype (an unquantized cache), else
// the payload type of the code. With QUANT false only P == T is instantiated.
// Returns cudaErrorInvalidValue for a combination with no instantiation.
template <bool QUANT = true, typename Fn>
cudaError_t dispatch(int dtype, int payload, int64_t head_dim, const Fn& fn) {
  return by_type(dtype, [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    auto by_dim = [&](auto ptag) -> cudaError_t {
      using P = typename decltype(ptag)::type;
      switch (head_dim) {
        case 32: return fn.template launch<T, P, 32>();
        case 64: return fn.template launch<T, P, 64>();
        case 128: return fn.template launch<T, P, 128>();
        default: return cudaErrorInvalidValue;
      }
    };
    if (payload == dtype) return by_dim(TypeTag<T>{});
    if constexpr (QUANT) {
      switch (payload) {
        case kInt8: return by_dim(TypeTag<int8_t>{});
        case kFp8E4M3: return by_dim(TypeTag<__nv_fp8_e4m3>{});
        case kFp8E5M2: return by_dim(TypeTag<__nv_fp8_e5m2>{});
        default: break;
      }
    }
    return cudaErrorInvalidValue;
  });
}

}  // namespace fat
