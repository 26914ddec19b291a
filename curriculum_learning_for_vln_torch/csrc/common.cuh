// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its table or compute dtype as a template parameter
// (float or __nv_bfloat16) and accumulates in f32.  The C entry points
// take a dtype code (DTYPE_F32 / DTYPE_BF16), launch on the stream they
// are given, and return the cudaError_t of the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Elements of T in one 16-byte chunk.
template <typename T>
struct Chunk {
  static constexpr int N = 16 / sizeof(T);
};

// Load one 16-byte chunk of T (16-byte aligned) and widen it to f32.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* out) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  if constexpr (std::is_same<T, float>::value) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      out[2 * i] = v.x;
      out[2 * i + 1] = v.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
