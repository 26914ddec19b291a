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

// Widen one 16-byte chunk of T to f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& u, float* out) {
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

// Load one 16-byte chunk of T (16-byte aligned) and widen it to f32.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* out) {
  widen<T>(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 -> T -> f32: rounds to nearest even in bf16, identity in f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// ---------------------------------------------------------------------------
// Env-dropout masks of the observation kernels (K4-K7).
//
// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants), keyed by a
// per-sample 64-bit seed (low word k0, high word k1).  Element e of a
// sample's [rows, D] block takes word e % 4 of the block at counter
// (e / 4, 0, 0, 0).  ops/philox.py computes the same bits in plain torch.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

enum { DROP_NONE = 0, DROP_EXT = 1, DROP_PRNG = 2, DROP_PRNG_SHARED = 3 };

// Rows per group of the prng_shared mode: rows b with the same b / 8 share
// one keep-mask, drawn from the seed of the group's first row (the JAX
// kernels' G = 8 sample groups, pano_fused.py:128-134, cand_score.py:39-49;
// a short last group is allowed).
constexpr int SHARED_GROUP = 8;

// How a kernel drops the image rows it reads: not at all, by an external
// keep-mask [B, rows, D] (bool), by the Philox draw of a per-sample seed
// [B] (int64), or by that of the group's first seed (prng_shared).  A kept
// element becomes round_to<T>(x / keep), a dropped one 0: the bf16
// rounding of the dropped value before the f32 accumulation that
// pano_fused.py:54-59 and cand_score.py:52-57 do.
struct DropSpec {
  int mode;
  const bool* mask;
  const int64_t* seeds;
  float keep;
  uint32_t thr;  // keep iff bits < thr = min(floor(keep * 2^32), 2^32 - 1)
};

// Elements [e, e + N) of sample b's [rows, D] block (e a multiple of N),
// loaded from p (16-byte aligned), dropped per ``d`` and widened to f32.
template <typename T>
__device__ __forceinline__ void load_dropped(const T* p, int b, size_t block_elems, int e,
                                             const DropSpec& d, float* x) {
  constexpr int N = Chunk<T>::N;
  load_chunk(p, x);
  if (d.mode == DROP_NONE) return;
  bool kept[N];
  if (d.mode == DROP_EXT) {
    const bool* m = d.mask + (size_t)b * block_elems + e;
#pragma unroll
    for (int i = 0; i < N; ++i) kept[i] = m[i];
  } else {
    // prng_shared: every row of a group computes the same bits here (K6
    // and K7 draw them once per group into shared memory; K4 and K5 not yet)
    const int row = d.mode == DROP_PRNG_SHARED ? b - b % SHARED_GROUP : b;
    const uint64_t s = (uint64_t)d.seeds[row];
    const uint32_t k0 = (uint32_t)s, k1 = (uint32_t)(s >> 32);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 r = philox4x32_10(make_uint4((uint32_t)(e / 4 + q), 0u, 0u, 0u), k0, k1);
      kept[4 * q + 0] = r.x < d.thr;
      kept[4 * q + 1] = r.y < d.thr;
      kept[4 * q + 2] = r.z < d.thr;
      kept[4 * q + 3] = r.w < d.thr;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = kept[i] ? round_to<T>(x[i] / d.keep) : 0.f;
}
