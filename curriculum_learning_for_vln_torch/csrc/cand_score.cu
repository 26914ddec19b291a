// K6 and K7: candidate scoring for the EnvDrop decoder tail, forward and
// backward.
//
// K6 replaces curriculum_learning_for_vln_tpu/ops/pallas/cand_score.py::
// cand_score_fwd_pallas, K7 its cand_score_bwd_pallas.  With r_j the
// candidate row img[b, j] dropped per the mask mode (common.cuh DropSpec)
// and ang[b, j] its angle features (the wrapper rounds them to the table
// dtype, as cand_score.py:124,162 do):
//
//   forward   logits[b, j]  = valid[b, j] ? r_j . q[b, :D] + ang[b, j] . q[b, D:] : 0   (j < MC)
//             logits[b, MC] = 0                                         (the STOP slot)
//   backward  d_q[b] = sum_j w_j [ r_j ; ang[b, j] ],   w_j = valid[b, j] ? d_logits[b, j] : 0
//
// q and d_q are f32; the sums accumulate in f32.  Forward: one block per
// sample, one warp per candidate, 16-byte vector loads along the row and
// one warp reduction per logit.  Backward: one block per sample, every
// thread owns a 16-byte column chunk and walks the 16 candidates in order
// (no atomics, the same sums every run).  Masks are never stored: the
// prng mode draws each element's bits from the sample's seed, the
// backward regenerates the forward's.
//
// Bound on the H100: device-memory bytes — the candidate rows are read
// once (64 x 16 x 2048 x 2 B in bf16 at the path's shapes) for 2 FLOP a
// row element, plus one Philox4x32-10 per 4 elements in the prng mode.
// At B = 64 a call moves ~4 MB, so launch latency and the 64 blocks'
// ramp-up weigh as much as bandwidth.
#include "common.cuh"

namespace {

template <typename T>
__global__ void cand_score_kernel(const T* __restrict__ img, const T* __restrict__ ang,
                                  const bool* __restrict__ valid, const float* __restrict__ q,
                                  float* __restrict__ logits, int MC, int D, int A,
                                  DropSpec drop) {
  constexpr int N = Chunk<T>::N;
  extern __shared__ float q_s[];  // [D + A]
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int F = D + A;
  const size_t block_elems = (size_t)MC * D;
  for (int i = tid; i < F; i += blockDim.x) q_s[i] = q[(size_t)b * F + i];
  __syncthreads();

  for (int j = warp; j < MC; j += nwarps) {
    const T* row = img + (size_t)b * block_elems + (size_t)j * D;
    const T* arow = ang + ((size_t)b * MC + j) * A;
    float acc = 0.f;
    for (int c = lane * N; c < D; c += 32 * N) {
      float x[N];
      load_dropped(row + c, b, block_elems, j * D + c, drop, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += x[i] * q_s[c + i];
    }
    for (int a = lane; a < A; a += 32) acc += to_f32(arow[a]) * q_s[D + a];
    acc = warp_sum(acc);
    if (lane == 0) logits[(size_t)b * (MC + 1) + j] = valid[(size_t)b * MC + j] ? acc : 0.f;
  }
  if (tid == 0) logits[(size_t)b * (MC + 1) + MC] = 0.f;
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
                       void* logits, int B, int MC, int D, int A, DropSpec drop,
                       cudaStream_t stream) {
  const size_t smem = (size_t)(D + A) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(cand_score_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cand_score_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ang), static_cast<const bool*>(valid),
      static_cast<const float*>(q), static_cast<float*>(logits), MC, D, A, drop);
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
// bool; q [B, D + A] f32; mode 0 (none), 1 (mask: bool [B, MC, D]) or 2
// (seeds: int64 [B]) with keep = 1 - rate and the prng threshold thr.
// Writes logits [B, MC + 1] f32.  D * sizeof(T) must be a multiple of 16.
extern "C" int cand_score(const void* img, const void* ang, const void* valid, const void* q,
                          void* logits, int B, int MC, int D, int A, int dtype, int mode,
                          const void* mask, const void* seeds, float keep, unsigned thr,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DropSpec d = drop_spec(mode, mask, seeds, keep, thr);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(img, ang, valid, q, logits, B, MC, D, A, d, s);
  return launch_fwd<float>(img, ang, valid, q, logits, B, MC, D, A, d, s);
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
