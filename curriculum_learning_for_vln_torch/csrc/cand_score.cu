// K6: candidate scoring for the EnvDrop decoder tail.
//
// Replaces curriculum_learning_for_vln_tpu/ops/pallas/cand_score.py::
// cand_score_fwd_pallas in its mask mode "none" (train=False):
//
//   logits[b, j]  = valid[b, j] ? img[b, j] . q[b, :D] + ang[b, j] . q[b, D:] : 0   (j < MC)
//   logits[b, MC] = 0                                             (the STOP slot)
//
// img and ang are in the table dtype (the wrapper rounds the angle
// features to it, as cand_score.py:124 does); q is f32; the dots
// accumulate in f32.  One block per sample, one warp per candidate, 16-byte
// vector loads along the feature row and one warp reduction per logit.
//
// Bound on the H100: device-memory bytes — the candidate rows are read
// once (64 x 16 x 2048 x 2 B in bf16 at the path's shapes) for 2 FLOP a
// row element.  At B = 64 the call moves ~4 MB, so launch latency and the
// 64 blocks' ramp-up weigh as much as bandwidth; fusing it into the
// observation kernel's launch is later work.
#include "common.cuh"

namespace {

template <typename T>
__global__ void cand_score_kernel(const T* __restrict__ img, const T* __restrict__ ang,
                                  const bool* __restrict__ valid, const float* __restrict__ q,
                                  float* __restrict__ logits, int MC, int D, int A) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float q_s[];  // [D + A]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int F = D + A;
  for (int i = tid; i < F; i += blockDim.x) q_s[i] = q[(size_t)b * F + i];
  __syncthreads();

  for (int j = warp; j < MC; j += nwarps) {
    const T* row = img + ((size_t)b * MC + j) * D;
    const T* arow = ang + ((size_t)b * MC + j) * A;
    float acc = 0.f;
    for (int c = lane * N; c < D; c += 32 * N) {
      float x[N];
      load_chunk(row + c, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += x[i] * q_s[c + i];
    }
    for (int a = lane; a < A; a += 32) acc += to_f32(arow[a]) * q_s[D + a];
    acc = warp_sum(acc);
    if (lane == 0) logits[(size_t)b * (MC + 1) + j] = valid[(size_t)b * MC + j] ? acc : 0.f;
  }
  if (tid == 0) logits[(size_t)b * (MC + 1) + MC] = 0.f;
}

constexpr int THREADS = 256;

template <typename T>
cudaError_t launch(const void* img, const void* ang, const void* valid, const void* q,
                   void* logits, int B, int MC, int D, int A, cudaStream_t stream) {
  const size_t smem = (size_t)(D + A) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cand_score_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cand_score_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ang), static_cast<const bool*>(valid),
      static_cast<const float*>(q), static_cast<float*>(logits), MC, D, A);
  return cudaGetLastError();
}

}  // namespace

// img [B, MC, D] and ang [B, MC, A] in the table dtype; valid [B, MC]
// bool; q [B, D + A] f32.  Writes logits [B, MC + 1] f32.  D * sizeof(T)
// must be a multiple of 16.
extern "C" int cand_score(const void* img, const void* ang, const void* valid, const void* q,
                          void* logits, int B, int MC, int D, int A, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(img, ang, valid, q, logits, B, MC, D, A, s);
  return launch<float>(img, ang, valid, q, logits, B, MC, D, A, s);
}
