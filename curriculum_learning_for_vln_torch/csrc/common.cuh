// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes its table or compute dtype as a template parameter
// (float or __nv_bfloat16) and accumulates in f32.  The C entry points
// take a dtype code (DTYPE_F32 / DTYPE_BF16), launch on the stream they
// are given, and return the cudaError_t of the launch.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched through the runtime)
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
// pano_fused.py:54-59 and cand_score.py:52-57 do.  There a bf16 row is
// divided by keep in bf16, so ``keep`` is the probability rounded to the
// table dtype (ops/cuda/drop.py::divisor); ``thr`` is the probability's.
struct DropSpec {
  int mode;
  const bool* mask;
  const int64_t* seeds;
  float keep;
  uint32_t thr;  // keep iff bits < thr = min(floor(p * 2^32), 2^32 - 1), p the probability
};

// The keep flags of elements [4 e4, 4 e4 + 4) of a sample's block, one
// byte each (0 or 1), as the ext mask holds them.
__device__ __forceinline__ uint32_t philox_keep4(uint32_t e4, uint32_t k0, uint32_t k1,
                                                 uint32_t thr) {
  const uint4 r = philox4x32_10(make_uint4(e4, 0u, 0u, 0u), k0, k1);
  return (uint32_t)(r.x < thr) | (uint32_t)(r.y < thr) << 8 | (uint32_t)(r.z < thr) << 16 |
         (uint32_t)(r.w < thr) << 24;
}

// x / d, correctly rounded, from inv = 1 / d (correctly rounded): one
// multiply and two FMAs in place of a division.  q = x * inv is within an
// ulp of x / d, the residual x - q d is exact in one FMA while it is a
// normal number, and q + r inv is then the correctly rounded quotient
// (Markstein's theorem), so the bits are the IEEE division's for x = 0 and
// every |x| in [2^-100, 2^126] at 0 < d <= 1 (tests/test_torch_pano_plans.py
// holds it there bit for bit; -0 gives +0, which no sum tells apart).
// Below 2^-100 the residual can lose bits and above 2^126 q can overflow;
// a guard for those magnitudes, which no feature value comes near, made
// K6 and K7 20-40% slower on the H100 (scripts/torch_kernel_ab.py against
// a tree with the guard).
__device__ __forceinline__ float div_by(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return fmaf(fmaf(-q, d, x), inv, q);
}

// NW words of T (N = NW * 4 / sizeof(T) elements) dropped by their keep
// flags kw (a byte per element, N / 4 words) and widened to f32:
// round_to<T>(x / keep) where kept, 0 where not.  The flags mask the raw
// bits first (0 / keep is 0), and bf16 pairs are rounded together.
template <typename T, int NW>
__device__ __forceinline__ void dropped_words(const uint32_t* w, const uint32_t* kw, float keep,
                                              float inv, float* x) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < NW; ++e)
      x[e] = div_by((kw[e >> 2] >> (8 * (e & 3))) & 0xffu ? __uint_as_float(w[e]) : 0.f, keep,
                    inv);
  } else {
#pragma unroll
    for (int p = 0; p < NW; ++p) {
      // the pair's two flags, spread to 0x0000FFFF / 0xFFFF0000
      const uint32_t bits =
          w[p] & (__byte_perm(kw[p >> 1], 0u, p & 1 ? 0x4342u : 0x4140u) * 0xFFFFu);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits));
      const __nv_bfloat162 r =
          __floats2bfloat162_rn(div_by(f.x, keep, inv), div_by(f.y, keep, inv));
      const float2 o = __bfloat1622float2(r);
      x[2 * p] = o.x;
      x[2 * p + 1] = o.y;
    }
  }
}

// ---------------------------------------------------------------------------
// cp.async: device memory to shared memory without registers.
// ---------------------------------------------------------------------------

// 4, 8 or 16 bytes; zeros where !full (the source is then not read).
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool full) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(full ? N : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every cp.async of this thread has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The Tensor Memory Accelerator: mbarriers that count the bytes of bulk
// copies, and the tensor-map encoder.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the barrier's phase `phase` to complete; a copy that never
// lands traps after ~2 s rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (!t0)
      t0 = t;
    else if (t - t0 > 2000000000ull)
      __trap();
  }
}

// One TMA box of a 2D or 3D tensor map at the given coordinates into this
// block's shared memory (address dst), its bytes counted on the mbarrier bar.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// cuTensorMapEncodeTiled, fetched through the runtime (no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}
