// Shared helpers for the hand-written Hopper kernels of hugectr_tpu_torch.
//
// Every kernel computes in float32 and loads/stores float32 or bfloat16.
// The C entry points take a dtype code (kF32 or kBF16) and return
// cudaGetLastError() after their launches; the Python wrappers raise on a
// non-zero status.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hctr {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Loads and stores of kVec consecutive elements as float32 registers.
// kVec == 4 takes one 16-byte (float) or 8-byte (bfloat16) access; the
// wrappers only pick it when the row width and the base pointers allow.
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[i] = p[i];
  }
}

template <int kVec>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[i] = __bfloat162float(p[i]);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = x[i];
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[kVec]) {
  if constexpr (kVec == 4) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = __float2bfloat16(x[i]);
  }
}

}  // namespace hctr
