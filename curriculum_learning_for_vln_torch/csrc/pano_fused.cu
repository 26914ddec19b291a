// K4 and K5: one observation step — panorama gather, env-dropout, visual
// attention over the 36 views and the candidate rows — forward and backward.
//
// K4 replaces curriculum_learning_for_vln_tpu/ops/pallas/pano_fused.py::
// pano_attend_fwd_pallas, K5 its pano_attend_bwd_pallas.  With r_v the
// view row features[node, v] dropped per the mask mode (common.cuh
// DropSpec: none, an external keep-mask, or an in-kernel Philox draw from
// a per-sample seed) and l_v = loc_embed[view, v]:
//
//   forward   s[v] = r_v . tv_img + l_v . tv_ang ;  a = softmax(s)
//             vis  = [ sum_v a[v] r_v ; sum_v a[v] l_v ]
//             cand[j] = features[node, cand_view[j]]   (raw rows, table dtype)
//   backward  d_a[v] = r_v . d_img + l_v . d_ang ;  d_s = a (d_a - sum_v a d_a)
//             d_tv = [ sum_v d_s[v] r_v ; sum_v d_s[v] l_v ]
//
// Both are one kernel with two passes over the sample's rows: a dot per
// view (one warp per view, 16-byte vector loads, f32 accumulation, a warp
// reduction), a transform of the 36 dots in shared memory (the softmax, or
// its VJP with the saved a), then a weighted sum in which every thread
// owns a 16-byte column chunk and walks the views.  One block per sample.
// The mask is never stored: the prng modes regenerate each element's bits
// in both passes, and the backward regenerates the forward's bits from the
// same seed (in prng_shared, the seed of the row's group of 8).  The TPU
// kernels' one-hot MXU matmul for the candidate rows, their G = 8 sample
// tiles and the 36 -> 40 view padding exist for Mosaic's alignment rules
// and DMA pipeline, and are not carried over (prng_shared keeps only the
// groups' meaning: one mask per 8 rows); the
// backward does not emit the candidate rows its Pallas twin re-emits (the
// caller discards them, fused_obs.py:154).
//
// Bound on the H100: device-memory bytes.  Each sample must read its
// V x D feature rows once (bf16 at the path's shapes: 64 x 36 x 2048 x 2 B);
// the arithmetic is ~4 FLOP per element plus, in the prng mode, one
// Philox4x32-10 per 4 elements (~50 integer instructions) in each pass.
// The second pass re-reads the rows from L2 (~9 MB of the 50 MB L2).  One
// block per sample leaves half the SMs idle at B = 64; keeping a bf16
// sample's rows in shared memory (147 KB) and a split over D are the next
// steps.
#include <math.h>

#include "common.cuh"

namespace {

template <typename T, bool BWD>
__global__ void pano_kernel(const int64_t* __restrict__ nodes, const int64_t* __restrict__ views,
                            const int64_t* __restrict__ cand_view,
                            const T* __restrict__ features, const float* __restrict__ loc_embed,
                            const float* __restrict__ vec, const float* __restrict__ alpha_in,
                            float* __restrict__ out, float* __restrict__ alpha_out,
                            T* __restrict__ cand, int V, int D, int A, int MC, DropSpec drop) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  float* vec_s = smem;         // [D + A]: tv (forward) or d_vis (backward)
  float* s_s = smem + D + A;   // [V]: dots, then the weights of the second pass
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int F = D + A;
  const size_t block_elems = (size_t)V * D;
  const T* rows = features + (size_t)nodes[b] * block_elems;
  const float* loc = loc_embed + (size_t)views[b] * V * A;

  for (int i = tid; i < F; i += blockDim.x) vec_s[i] = vec[(size_t)b * F + i];
  __syncthreads();

  // 1. one dot per view, one warp per view
  for (int v = warp; v < V; v += nwarps) {
    float acc = 0.f;
    for (int c = lane * N; c < D; c += 32 * N) {
      float x[N];
      load_dropped(rows + (size_t)v * D + c, b, block_elems, v * D + c, drop, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += x[i] * vec_s[c + i];
    }
    for (int a = lane; a < A; a += 32) acc += loc[v * A + a] * vec_s[D + a];
    acc = warp_sum(acc);
    if (lane == 0) s_s[v] = acc;
  }
  __syncthreads();

  // 2. the weights: softmax (forward) or the softmax VJP (backward)
  if (warp == 0) {
    if (!BWD) {
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, s_s[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int v = lane; v < V; v += 32) {
        const float e = expf(s_s[v] - m);
        s_s[v] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int v = lane; v < V; v += 32) {
        const float a = s_s[v] / sum;
        s_s[v] = a;
        alpha_out[(size_t)b * V + v] = a;
      }
    } else {
      float inner = 0.f;
      for (int v = lane; v < V; v += 32) inner += alpha_in[(size_t)b * V + v] * s_s[v];
      inner = warp_sum(inner);
      for (int v = lane; v < V; v += 32) {
        const float a = alpha_in[(size_t)b * V + v];
        s_s[v] = a * (s_s[v] - inner);
      }
    }
  }
  __syncthreads();

  // 3. weighted sums over the views
  float* o = out + (size_t)b * F;
  for (int c = tid * N; c < D; c += blockDim.x * N) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int v = 0; v < V; ++v) {
      float x[N];
      load_dropped(rows + (size_t)v * D + c, b, block_elems, v * D + c, drop, x);
      const float w = s_s[v];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += w * x[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) o[c + i] = acc[i];
  }
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.f;
    for (int v = 0; v < V; ++v) acc += s_s[v] * loc[v * A + a];
    o[D + a] = acc;
  }

  // 4. forward only: the candidate rows, copied as they are stored
  if (!BWD) {
    const int chunks = D / N;
    for (int idx = tid; idx < MC * chunks; idx += blockDim.x) {
      const int j = idx / chunks, c = (idx % chunks) * N;
      const T* src = rows + (size_t)cand_view[(size_t)b * MC + j] * D + c;
      *reinterpret_cast<uint4*>(cand + ((size_t)b * MC + j) * D + c) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
}

constexpr int THREADS = 256;

template <typename T, bool BWD>
cudaError_t launch(const void* nodes, const void* views, const void* cand_view,
                   const void* features, const void* loc_embed, const void* vec,
                   const void* alpha_in, void* out, void* alpha_out, void* cand, int B, int V,
                   int D, int A, int MC, DropSpec drop, cudaStream_t stream) {
  const size_t smem = (size_t)(D + A + V) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pano_kernel<T, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pano_kernel<T, BWD><<<B, THREADS, smem, stream>>>(
      static_cast<const int64_t*>(nodes), static_cast<const int64_t*>(views),
      static_cast<const int64_t*>(cand_view), static_cast<const T*>(features),
      static_cast<const float*>(loc_embed), static_cast<const float*>(vec),
      static_cast<const float*>(alpha_in), static_cast<float*>(out),
      static_cast<float*>(alpha_out), static_cast<T*>(cand), V, D, A, MC, drop);
  return cudaGetLastError();
}

DropSpec drop_spec(int mode, const void* mask, const void* seeds, float keep, unsigned thr) {
  return DropSpec{mode, static_cast<const bool*>(mask), static_cast<const int64_t*>(seeds), keep,
                  thr};
}

}  // namespace

// K4.  nodes, views [B] and cand_view [B, MC] int64; features [N, V, D] in
// the table dtype; loc_embed [36, V, A] f32; tv [B, D + A] f32; mode 0
// (none), 1 (mask: bool [B, V, D]), 2 (seeds: int64 [B]) or 3 (seeds, one
// mask per group of 8 rows), keep = 1 - rate and thr the keep threshold of
// the prng modes.  Writes vis [B, D + A]
// f32, alpha [B, V] f32 and cand [B, MC, D] in the table dtype.
// D * sizeof(T) must be a multiple of 16.
extern "C" int pano_attend(const void* nodes, const void* views, const void* cand_view,
                           const void* features, const void* loc_embed, const void* tv, void* vis,
                           void* alpha, void* cand, int B, int V, int D, int A, int MC, int dtype,
                           int mode, const void* mask, const void* seeds, float keep,
                           unsigned thr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d = drop_spec(mode, mask, seeds, keep, thr);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, false>(nodes, views, cand_view, features, loc_embed, tv, nullptr,
                                        vis, alpha, cand, B, V, D, A, MC, d, s);
  return launch<float, false>(nodes, views, cand_view, features, loc_embed, tv, nullptr, vis,
                              alpha, cand, B, V, D, A, MC, d, s);
}

// K5.  As K4, with the forward's attention weights alpha [B, V] f32 and
// the cotangent d_vis [B, D + A] f32 in place of tv; writes d_tv
// [B, D + A] f32.  The same mode, mask or seeds and keep as the forward
// give the forward's mask.
extern "C" int pano_attend_bwd(const void* nodes, const void* views, const void* features,
                               const void* loc_embed, const void* alpha, const void* d_vis,
                               void* d_tv, int B, int V, int D, int A, int dtype, int mode,
                               const void* mask, const void* seeds, float keep, unsigned thr,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d = drop_spec(mode, mask, seeds, keep, thr);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16, true>(nodes, views, nullptr, features, loc_embed, d_vis, alpha,
                                       d_tv, nullptr, nullptr, B, V, D, A, 0, d, s);
  return launch<float, true>(nodes, views, nullptr, features, loc_embed, d_vis, alpha, d_tv,
                             nullptr, nullptr, B, V, D, A, 0, d, s);
}
