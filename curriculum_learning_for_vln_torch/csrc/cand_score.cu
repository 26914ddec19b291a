// K6 and K7: candidate scoring for the EnvDrop decoder tail, forward and
// backward.
//
// K6 replaces curriculum_learning_for_vln_tpu/ops/pallas/cand_score.py::
// cand_score_fwd_pallas, K7 its cand_score_bwd_pallas.  With r_j the
// candidate row img[b, j] dropped per the mask mode (common.cuh DropSpec)
// and ang[b, j] its angle features (in the table dtype, as env/env.py
// makes them and cand_score.py:124,162 round them):
//
//   forward   logits[b, j]  = valid[b, j] ? r_j . q[b, :D] + ang[b, j] . q[b, D:] : 0   (j < MC)
//             logits[b, MC] = 0                                         (the STOP slot)
//   backward  d_q[b] = sum_j w_j [ r_j ; ang[b, j] ],   w_j = valid[b, j] ? d_logits[b, j] : 0
//
// q and d_q are f32; the sums accumulate in f32.  Masks are never stored:
// the prng modes draw each element's bits from a seed, and the backward
// regenerates the forward's.
//
// Bound on the H100: device-memory bytes — the candidate rows are read
// once (64 x 16 x 2048 x 2 B = 4.2 MB in bf16 at the path's shapes, 1.3 µs
// at 3.35 TB/s) for 2 FLOP a row element, plus one Philox4x32-10 per 4
// elements in the prng modes.
//
// Forward (K6).  The first design (one block per sample, 64 blocks on 132
// SMs, each warp walking two rows with one dependent 16-byte load per lane
// at a time, and every row of a prng_shared group drawing the group's bits
// again) had little of the 4.2 MB in flight at any time. Now one block per
// (candidate j, group g of 8 samples) — 128 blocks at B = 64 — and warp w
// scores sample 8g + w's candidate j.  Each lane issues all its loads of the
// row (8 x 16 B in bf16, 16 in f32), of q and of the ext mask (4 bytes per 4
// elements) before its first FMA, so the whole 4.2 MB is in flight at once.
// prng_shared: the block draws row j's mask once for its group (D / 4 Philox
// calls, 2 a thread at D = 2048) into shared memory, and after one barrier
// all 8 warps apply it — an eighth of the first design's Philox work; prng:
// each warp draws its own row's.  The mask mode is a template parameter.  A
// kept element is x / keep rounded to the table dtype, and an IEEE division
// per element made the masked modes 2.8x mode none in this design (0.0083
// against 0.0029 ms of device time in bf16 on the H100): each thread divides
// once, for 1 / keep, and per element takes q = x * (1 / keep) with one FMA
// correction, q + (x - q keep) / keep, which is the correctly rounded
// quotient (Markstein's theorem), so the bits are the division's.  Warps
// past B (a short last group) load nothing and write nothing.  The launch
// geometry comes from ops/cuda/cand_score.py:: cand_score_plan.
//
// Backward (K7): one block per sample, every thread owns a 16-byte column
// chunk and walks the 16 candidates in order (no atomics, the same sums
// every run), through common.cuh's load_dropped.
#include "common.cuh"

namespace {

constexpr int FWD_THREADS = 32 * SHARED_GROUP;  // one warp per sample of a group
constexpr int PASS = 2048;  // row elements a warp has in flight at once

__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The keep flags of elements [4 e4, 4 e4 + 4) of a sample's [MC, D] block,
// one byte each (0 or 1), as the ext mask holds them.
__device__ __forceinline__ uint32_t philox_keep4(uint32_t e4, uint32_t k0, uint32_t k1,
                                                 uint32_t thr) {
  const uint4 r = philox4x32_10(make_uint4(e4, 0u, 0u, 0u), k0, k1);
  return (uint32_t)(r.x < thr) | (uint32_t)(r.y < thr) << 8 | (uint32_t)(r.z < thr) << 16 |
         (uint32_t)(r.w < thr) << 24;
}

// x / d, correctly rounded, from inv = 1 / d (correctly rounded): one
// multiply and two FMAs in place of a division.
__device__ __forceinline__ float div_by(float x, float d, float inv) {
  const float q = __fmul_rn(x, inv);
  return fmaf(fmaf(-q, d, x), inv, q);
}

// Chunk v (16 bytes of T) dropped by its keep flags kw (a byte per element,
// N / 4 words) and widened to f32: round_to<T>(x / keep) where kept, 0
// where not.  The flags mask the raw bits first (0 / keep is 0), and bf16
// pairs are rounded together.
template <typename T>
__device__ __forceinline__ void dropped_chunk(const uint4& v, const uint32_t* kw, float keep,
                                              float inv, float* x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = div_by((kw[0] >> (8 * e)) & 0xffu ? __uint_as_float(w[e]) : 0.f, keep, inv);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
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

// Load the N / 4 flag words of one chunk (8 or 4 bytes, aligned).
template <int W>
__device__ __forceinline__ void load_flags(const uint32_t* p, uint32_t* kw) {
  if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    kw[0] = u.x;
    kw[1] = u.y;
  } else {
    kw[0] = *p;
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
cand_score_kernel(const T* __restrict__ img, const T* __restrict__ ang,
                  const bool* __restrict__ valid, const float* __restrict__ q,
                  float* __restrict__ logits, int B, int MC, int D, int A, DropSpec drop) {
  constexpr int N = Chunk<T>::N;      // elements per 16-byte load
  constexpr int CPL = PASS / 32 / N;  // loads per lane per pass: 8 in bf16, 16 in f32
  __shared__ uint32_t keep_s[PASS / 4];  // prng_shared: the group's keep flags of row j
  const int j = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31, b = g * SHARED_GROUP + (threadIdx.x >> 5);
  const bool live = b < B;
  const int bb = live ? b : g * SHARED_GROUP;  // a row that exists, for the addresses
  const size_t off = ((size_t)bb * MC + j) * D;
  const T* row = img + off;
  const float* qb = q + (size_t)bb * (D + A);
  uint32_t k0 = 0, k1 = 0;
  if (MODE == DROP_PRNG || MODE == DROP_PRNG_SHARED) {
    const uint64_t s = (uint64_t)drop.seeds[MODE == DROP_PRNG ? bb : g * SHARED_GROUP];
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const float inv_keep = 1.f / drop.keep;

  float acc = 0.f;
  for (int base = 0; base < D; base += PASS) {
    // every load of the pass before the first FMA
    uint4 v[CPL];
    float4 qv[CPL][N / 4];
    uint32_t kw[CPL][N / 4];  // keep flags of the chunk's elements, a byte each
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = base + (lane + 32 * i) * N;
      v[i] = live && c < D ? __ldg(reinterpret_cast<const uint4*>(row + c))
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = base + (lane + 32 * i) * N;
#pragma unroll
      for (int t = 0; t < N / 4; ++t) {
        qv[i][t] = live && c < D ? __ldg(reinterpret_cast<const float4*>(qb + c) + t)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        kw[i][t] = 0x01010101u;
      }
    }
    if (MODE == DROP_EXT) {
      const uint32_t* m = reinterpret_cast<const uint32_t*>(drop.mask + off + base);
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        if (live && base + (lane + 32 * i) * N < D)
          load_flags<N / 4>(m + (lane + 32 * i) * (N / 4), kw[i]);
    } else if (MODE == DROP_PRNG) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = base + (lane + 32 * i) * N;
#pragma unroll
        for (int t = 0; t < N / 4; ++t)
          if (live && c < D)
            kw[i][t] = philox_keep4((uint32_t)((j * D + c) / 4 + t), k0, k1, drop.thr);
      }
    } else if (MODE == DROP_PRNG_SHARED) {
      if (base > 0) __syncthreads();  // the last pass's flags are read
      const int n4 = min(PASS, D - base) / 4;
      for (int w4 = threadIdx.x; w4 < n4; w4 += FWD_THREADS)
        keep_s[w4] = philox_keep4((uint32_t)((j * D + base) / 4 + w4), k0, k1, drop.thr);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < CPL; ++i) load_flags<N / 4>(keep_s + (lane + 32 * i) * (N / 4), kw[i]);
    }
    if (base == 0 && live)  // the angle features, while the row is in flight
      for (int a = lane; a < A; a += 32)
        acc += to_f32(ang[((size_t)b * MC + j) * A + a]) * qb[D + a];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      float x[N];
      if (MODE == DROP_NONE)
        widen<T>(v[i], x);
      else
        dropped_chunk<T>(v[i], kw[i], drop.keep, inv_keep, x);
#pragma unroll
      for (int e = 0; e < N; ++e) acc += x[e] * component(qv[i][e / 4], e % 4);
    }
  }
  acc = warp_sum(acc);
  if (live && lane == 0) {
    logits[(size_t)b * (MC + 1) + j] = valid[(size_t)b * MC + j] ? acc : 0.f;
    if (j == 0) logits[(size_t)b * (MC + 1) + MC] = 0.f;
  }
}

template <typename T>
__global__ void cand_score_bwd_kernel(const T* __restrict__ img, const T* __restrict__ ang,
                                      const bool* __restrict__ valid,
                                      const float* __restrict__ d_logits, float* __restrict__ d_q,
                                      int MC, int D, int A, DropSpec drop) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float w_s[];  // [MC]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int F = D + A;
  const size_t block_elems = (size_t)MC * D;
  for (int j = tid; j < MC; j += blockDim.x)
    w_s[j] = valid[(size_t)b * MC + j] ? d_logits[(size_t)b * (MC + 1) + j] : 0.f;
  __syncthreads();

  float* o = d_q + (size_t)b * F;
  for (int c = tid * N; c < D; c += blockDim.x * N) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int j = 0; j < MC; ++j) {
      float x[N];
      load_dropped(img + (size_t)b * block_elems + (size_t)j * D + c, b, block_elems, j * D + c,
                   drop, x);
      const float w = w_s[j];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += w * x[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) o[c + i] = acc[i];
  }
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < MC; ++j) acc += w_s[j] * to_f32(ang[((size_t)b * MC + j) * A + a]);
    o[D + a] = acc;
  }
}

constexpr int THREADS = 256;

template <typename T>
cudaError_t launch_fwd(const void* img, const void* ang, const void* valid, const void* q,
                       void* logits, int B, int MC, int D, int A, int groups, DropSpec drop,
                       cudaStream_t stream) {
  if ((size_t)groups * SHARED_GROUP < (size_t)B || (D + A) % 4) return cudaErrorInvalidValue;
  auto kernel = drop.mode == DROP_EXT           ? cand_score_kernel<T, DROP_EXT>
                : drop.mode == DROP_PRNG        ? cand_score_kernel<T, DROP_PRNG>
                : drop.mode == DROP_PRNG_SHARED ? cand_score_kernel<T, DROP_PRNG_SHARED>
                                                : cand_score_kernel<T, DROP_NONE>;
  kernel<<<dim3(MC, groups), FWD_THREADS, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ang), static_cast<const bool*>(valid),
      static_cast<const float*>(q), static_cast<float*>(logits), B, MC, D, A, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* img, const void* ang, const void* valid, const void* d_logits,
                       void* d_q, int B, int MC, int D, int A, DropSpec drop,
                       cudaStream_t stream) {
  const size_t smem = (size_t)MC * sizeof(float);
  cand_score_bwd_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ang), static_cast<const bool*>(valid),
      static_cast<const float*>(d_logits), static_cast<float*>(d_q), MC, D, A, drop);
  return cudaGetLastError();
}

DropSpec drop_spec(int mode, const void* mask, const void* seeds, float keep, unsigned thr) {
  return DropSpec{mode, static_cast<const bool*>(mask), static_cast<const int64_t*>(seeds), keep,
                  thr};
}

}  // namespace

// K6.  img [B, MC, D] and ang [B, MC, A] in the table dtype; valid [B, MC]
// bool; q [B, D + A] f32; mode 0 (none), 1 (mask: bool [B, MC, D]), 2
// (seeds: int64 [B]) or 3 (seeds, one mask per group of 8 rows) with keep =
// 1 - rate and the prng threshold thr; groups = ceil(B / 8), the grid's
// second dimension (cand_score_plan).  Writes logits [B, MC + 1] f32.
// D * sizeof(T) and (D + A) * 4 must be multiples of 16, img, q and the
// mask 16-byte aligned.
extern "C" int cand_score(const void* img, const void* ang, const void* valid, const void* q,
                          void* logits, int B, int MC, int D, int A, int dtype, int mode,
                          const void* mask, const void* seeds, float keep, unsigned thr,
                          int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d = drop_spec(mode, mask, seeds, keep, thr);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(img, ang, valid, q, logits, B, MC, D, A, groups, d, s);
  return launch_fwd<float>(img, ang, valid, q, logits, B, MC, D, A, groups, d, s);
}

// K7.  As K6, with the cotangent d_logits [B, MC + 1] f32 in place of q;
// writes d_q [B, D + A] f32 (the STOP slot's cotangent has no effect).
extern "C" int cand_score_bwd(const void* img, const void* ang, const void* valid,
                              const void* d_logits, void* d_q, int B, int MC, int D, int A,
                              int dtype, int mode, const void* mask, const void* seeds,
                              float keep, unsigned thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d = drop_spec(mode, mask, seeds, keep, thr);
  if (dtype == DTYPE_BF16)
    return launch_bwd<__nv_bfloat16>(img, ang, valid, d_logits, d_q, B, MC, D, A, d, s);
  return launch_bwd<float>(img, ang, valid, d_logits, d_q, B, MC, D, A, d, s);
}
