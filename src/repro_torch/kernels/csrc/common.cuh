// Helpers shared by the port's CUDA kernels: dtype conversion to and from
// f32 (fp8 e4m3fn K/V included), four-element loads, a warp sum, and the
// -1e30 "minus infinity" of the online softmax (the reference's NEG_INF, so
// that an empty row ends with exactly m = -1e30, l = 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;

// One float8_e4m3fn value as its byte.  CUDA's own __nv_fp8_e4m3 converts
// from float saturating at 448; the KV cache must round as the reference's
// astype does (ml_dtypes: to nearest even, NaN past the range), so the
// conversions below name their mode.
struct fp8e4m3 {
  uint8_t bits;
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exact: every e4m3 value is a half, and every half a float
template <> __device__ __forceinline__ float to_f32<fp8e4m3>(fp8e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.bits, __NV_E4M3)));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
// round to nearest even; |x| > 464 (448 and half a step), inf and NaN give
// NaN with x's sign, as ml_dtypes' float8_e4m3fn does (no saturation)
template <> __device__ __forceinline__ fp8e4m3 from_f32<fp8e4m3>(float x) {
  const uint8_t b = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
  return fp8e4m3{(b & 0x7f) == 0x7f
                     ? (uint8_t)(__float_as_uint(x) >> 31 ? 0xff : 0x7f)
                     : b};
}

// four consecutive elements as f32; p must be aligned to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro
