// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, sizes and a cudaStream_t, launches on that stream, does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// (0 on success). The Python wrappers (gaussianformer_tpu_torch/kernels/)
// check device, dtype, shape and contiguity before calling, and raise when
// the returned code is not 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GF_EXPORT extern "C" __attribute__((visibility("default")))

namespace gf {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Load VEC consecutive elements starting at p (aligned to VEC elements) and
// widen them to float.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = p[i];
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<8>(const float* p, float* out) {
  load_vec<4>(p, out);
  load_vec<4>(p + 4, out + 4);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = __bfloat162float(p[i]);
}
template <>
__device__ __forceinline__ void load_vec<4>(const __nv_bfloat16* p,
                                            float* out) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <>
__device__ __forceinline__ void load_vec<8>(const __nv_bfloat16* p,
                                            float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Store v[0..VEC) at p (aligned to VEC elements), rounded to bf16 for a
// bf16 array.
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i)
      reinterpret_cast<__nv_bfloat162*>(p)[i] =
          __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// The SMs of the current device (read once a process).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace gf
