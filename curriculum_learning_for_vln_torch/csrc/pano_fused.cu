// K4: one observation step — panorama gather, visual attention over the
// 36 views, and extraction of the candidate rows.
//
// Replaces curriculum_learning_for_vln_tpu/ops/pallas/pano_fused.py::
// pano_attend_fwd_pallas in its mask mode "none" (train=False):
//
//   s[v]   = features[node, v] . tv_img + loc_embed[view, v] . tv_ang
//   a      = softmax(s) over the V views
//   vis    = [ sum_v a[v] features[node, v] ; sum_v a[v] loc_embed[view, v] ]
//   cand[j] = features[node, cand_view[j]]            (table dtype, j < MC)
//
// One block per sample.  Warps take views in turn and score each with
// 16-byte vector loads of the feature row (f32 accumulation) and one warp
// reduction; warp 0 takes the softmax in shared memory; then every thread
// owns a 16-byte column chunk of the weighted sum and walks the views;
// the candidate rows are copied with direct indexed 16-byte loads.  The
// TPU kernel's one-hot MXU matmul for the candidate rows and its G=8
// sample grouping exist for Mosaic's alignment rules and its DMA
// pipeline, and are not carried over.
//
// Bound on the H100: device-memory bytes.  Each sample must read its
// V x D feature rows once and write MC x D candidate rows (bf16 at the
// path's shapes: 64 x 36 x 2048 x 2 B read + 64 x 16 x 2048 x 2 B
// written); the arithmetic is ~2 FLOP per byte read.  The weighted sum
// re-reads the rows, which by then sit in L2 (the whole batch's rows are
// ~9 MB of the 50 MB L2); one block per sample leaves half the SMs idle
// at B = 64, which a split over D is the next step against.
#include <math.h>

#include "common.cuh"

namespace {

template <typename T>
__global__ void pano_attend_kernel(const int64_t* __restrict__ nodes,
                                   const int64_t* __restrict__ views,
                                   const int64_t* __restrict__ cand_view,
                                   const T* __restrict__ features,
                                   const float* __restrict__ loc_embed,
                                   const float* __restrict__ tv, float* __restrict__ vis,
                                   float* __restrict__ alpha, T* __restrict__ cand, int V, int D,
                                   int A, int MC) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float smem[];
  float* tv_s = smem;          // [D + A]
  float* s_s = smem + D + A;   // [V] scores, then attention weights
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int F = D + A;
  const T* rows = features + (size_t)nodes[b] * V * D;
  const float* loc = loc_embed + (size_t)views[b] * V * A;

  for (int i = tid; i < F; i += blockDim.x) tv_s[i] = tv[(size_t)b * F + i];
  __syncthreads();

  // 1. scores, one warp per view
  for (int v = warp; v < V; v += nwarps) {
    const T* row = rows + (size_t)v * D;
    float acc = 0.f;
    for (int c = lane * N; c < D; c += 32 * N) {
      float x[N];
      load_chunk(row + c, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += x[i] * tv_s[c + i];
    }
    for (int a = lane; a < A; a += 32) acc += loc[v * A + a] * tv_s[D + a];
    acc = warp_sum(acc);
    if (lane == 0) s_s[v] = acc;
  }
  __syncthreads();

  // 2. softmax over the views
  if (warp == 0) {
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
      alpha[(size_t)b * V + v] = a;
    }
  }
  __syncthreads();

  // 3. attention-weighted sums
  float* out = vis + (size_t)b * F;
  for (int c = tid * N; c < D; c += blockDim.x * N) {
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (int v = 0; v < V; ++v) {
      float x[N];
      load_chunk(rows + (size_t)v * D + c, x);
      const float a = s_s[v];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += a * x[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) out[c + i] = acc[i];
  }
  for (int a = tid; a < A; a += blockDim.x) {
    float acc = 0.f;
    for (int v = 0; v < V; ++v) acc += s_s[v] * loc[v * A + a];
    out[D + a] = acc;
  }

  // 4. candidate rows, copied as they are stored
  const int chunks = D / N;
  for (int idx = tid; idx < MC * chunks; idx += blockDim.x) {
    const int j = idx / chunks, c = (idx % chunks) * N;
    const T* src = rows + (size_t)cand_view[(size_t)b * MC + j] * D + c;
    *reinterpret_cast<uint4*>(cand + ((size_t)b * MC + j) * D + c) =
        __ldg(reinterpret_cast<const uint4*>(src));
  }
}

constexpr int THREADS = 256;

template <typename T>
cudaError_t launch(const void* nodes, const void* views, const void* cand_view,
                   const void* features, const void* loc_embed, const void* tv, void* vis,
                   void* alpha, void* cand, int B, int V, int D, int A, int MC,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(D + A + V) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pano_attend_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pano_attend_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const int64_t*>(nodes), static_cast<const int64_t*>(views),
      static_cast<const int64_t*>(cand_view), static_cast<const T*>(features),
      static_cast<const float*>(loc_embed), static_cast<const float*>(tv),
      static_cast<float*>(vis), static_cast<float*>(alpha), static_cast<T*>(cand), V, D, A, MC);
  return cudaGetLastError();
}

}  // namespace

// nodes, views [B] and cand_view [B, MC] int64; features [N, V, D] in the
// table dtype; loc_embed [36, V, A] f32; tv [B, D + A] f32.  Writes
// vis [B, D + A] f32, alpha [B, V] f32 and cand [B, MC, D] in the table
// dtype.  D * sizeof(T) must be a multiple of 16.
extern "C" int pano_attend(const void* nodes, const void* views, const void* cand_view,
                           const void* features, const void* loc_embed, const void* tv, void* vis,
                           void* alpha, void* cand, int B, int V, int D, int A, int MC, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(nodes, views, cand_view, features, loc_embed, tv, vis, alpha,
                                 cand, B, V, D, A, MC, s);
  return launch<float>(nodes, views, cand_view, features, loc_embed, tv, vis, alpha, cand, B, V,
                       D, A, MC, s);
}
