// K3: masked LSTM scan over a whole sequence, forward or reverse in time.
//
// Replaces curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
// lstm_scan_pallas.  The TPU kernel walks time as a sequential grid and
// keeps W_ih, W_hh and (h, c) in VMEM for the whole scan.  On the H100 a
// block's shared memory cannot hold both weight matrices, blocks run in no
// order, and a grid-wide barrier per step is costly; but every batch
// row's recurrence is independent.  So one C call makes two launches:
//
// 1. gates_x: a tiled GEMM  gx[b, t] = x[b, t] . W_ih + b  for every valid
//    (b, t) with t < len[b] (tiles of invalid pairs exit at once).  This
//    half of the work has no recurrence, so it runs across the whole card.
// 2. recurrence: clusters of CL = 8 blocks, each cluster owning R = 8
//    batch rows.  Block `rank` of a cluster owns hidden units
//    [rank*U, (rank+1)*U), U = H / 8: it keeps their four gate columns of
//    W_hh (H x 4U, 64 KB in bf16 at H = 256) in shared memory for the
//    whole scan, computes its gates for the R rows from h (f32, in shared
//    memory), updates (h, c) in f32, and writes its slice of the new h
//    into every block of the cluster through distributed shared memory;
//    one cluster barrier a step orders those writes against the next
//    step's reads.  A cluster loops only to the longest length of its rows
//    (steps past it change nothing and output 0).
//
// Bound on the H100: at the path's shapes (B = 64, L = 80, D = H = 256)
// the work is ~2.7 GFLOP at most and ~10 MB of traffic, a few µs at the
// card's peaks; what bounds this design is the serial chain of steps:
// per step one pass over the block's W_hh slice in shared memory, one
// gate update and one cluster barrier.  The GEMM is a plain SIMT tiling;
// tensor cores (wgmma) for it are later work.
//
// Semantics (lstm_scan.py:63-67): step l reads t = L-1-l when reversed;
// a row with t >= len keeps its carry and outputs 0; gate order i, f, g, o;
// f32 accumulation and state.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;        // blocks per cluster: the hidden units are split 8 ways
constexpr int R = 8;         // batch rows per cluster
constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// 1. gx[m, n] = sum_k x[m, k] w[k, n] + bias[n] for the M = B*L rows of x
//    whose step t = m % L is below len[m / L]; N = 4H, K = D.
// ---------------------------------------------------------------------------
constexpr int TM = 64, TN = 64, TK = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gates_x_kernel(const T* __restrict__ x, const int64_t* __restrict__ lengths,
               const T* __restrict__ w, const T* __restrict__ bias, float* __restrict__ gx,
               int M, int N, int K, int L) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  int live = 0;
  if (tid < TM) {
    const int m = m0 + tid;
    live = m < M && (m % L) < lengths[m / L];
  }
  if (!__syncthreads_or(live)) return;

  const int tr = tid / 16, tc = tid % 16;  // this thread's 4 x 4 outputs
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TM * TK; i += THREADS) {
      const int r = i / TK, k = i % TK;
      const int m = m0 + r, kk = k0 + k;
      As[k][r] = (m < M && kk < K) ? to_f32(x[(size_t)m * K + kk]) : 0.f;
    }
    for (int i = tid; i < TK * TN; i += THREADS) {
      const int k = i / TN, c = i % TN;
      const int kk = k0 + k, n = n0 + c;
      Bs[k][c] = (kk < K && n < N) ? to_f32(w[(size_t)kk * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][tr * 4 + i];
        b[i] = Bs[k][tc + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 16 * j;
      if (n < N) gx[(size_t)m * N + n] = acc[i][j] + to_f32(bias[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The recurrence.  Shared memory of a block (U = H / CL, G4 = 4U):
//      w_s   [H][G4]   T    its gate columns of W_hh, local column g*U + u
//      h_s   [2][H][R] f32  h of the cluster's rows, double-buffered
//      gates [R][G4]   f32  h . W_hh for its columns
//      gx_s  [R][G4]   f32  this step's gx for its columns (cp.async)
//      c_s   [R][U]    f32  c of its units
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
recurrence_kernel(const float* __restrict__ gx, const int64_t* __restrict__ lengths,
                  const T* __restrict__ w_hh, float* __restrict__ outs, float* __restrict__ hT,
                  float* __restrict__ cT, int B, int L, int H, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* h_s = reinterpret_cast<float*>(smem_raw + (size_t)H * G4 * sizeof(T));
  float* gates = h_s + 2 * H * R;
  float* gx_s = gates + R * G4;
  float* c_s = gx_s + R * G4;

  int len[R];
  int maxlen = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const int64_t n = row < B ? lengths[row] : 0;
    len[r] = n < L ? (int)n : L;
    maxlen = max(maxlen, len[r]);
  }

  for (int i = tid; i < H * G4; i += THREADS) {
    const int k = i / G4, c = i % G4, g = c / U, u = c % U;
    w_s[i] = w_hh[(size_t)k * H4 + g * H + rank * U + u];
  }
  for (int i = tid; i < H * R; i += THREADS) h_s[i] = 0.f;  // buffer 0
  for (int i = tid; i < R * U; i += THREADS) c_s[i] = 0.f;
  cluster.sync();  // every block of the cluster is running and initialised

  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? maxlen - 1 - l : l;
    const float* h_cur = h_s + (l & 1) * H * R;
    float* h_nxt = h_s + ((l & 1) ^ 1) * H * R;

    // this step's gx slice of every valid row, in flight during the dot products
    const int q4 = U / 4;
    for (int i = tid; i < R * 4 * q4; i += THREADS) {
      const int r = i / (4 * q4), g = (i / q4) % 4, q = i % q4;
      if (t < len[r])
        __pipeline_memcpy_async(gx_s + r * G4 + g * U + 4 * q,
                                gx + ((size_t)(row0 + r) * L + t) * H4 + g * H + rank * U + 4 * q,
                                16);
    }
    __pipeline_commit();

    // gates[r][c] = h[r] . w_s[:, c], two columns by two rows a thread
    for (int i = tid; i < (G4 / 2) * (R / 2); i += THREADS) {
      const int cp = i % (G4 / 2), rp = i / (G4 / 2);
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
      const T* wc = w_s + 2 * cp;
      const float* hr = h_cur + 2 * rp;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float2 wv = load2(wc + (size_t)k * G4);
        const float2 hv = *reinterpret_cast<const float2*>(hr + k * R);
        a00 += hv.x * wv.x;
        a01 += hv.x * wv.y;
        a10 += hv.y * wv.x;
        a11 += hv.y * wv.y;
      }
      gates[(2 * rp) * G4 + 2 * cp] = a00;
      gates[(2 * rp) * G4 + 2 * cp + 1] = a01;
      gates[(2 * rp + 1) * G4 + 2 * cp] = a10;
      gates[(2 * rp + 1) * G4 + 2 * cp + 1] = a11;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // cell update of (row r, unit u); the new h goes to every block of the cluster
    for (int i = tid; i < R * U; i += THREADS) {
      const int r = i / U, u = i % U, k = rank * U + u;
      float h = h_cur[k * R + r];
      float out = 0.f;
      if (t < len[r]) {
        const float* gr = gates + r * G4;
        const float* xr = gx_s + r * G4;
        const float ig = sigmoidf(gr[u] + xr[u]);
        const float fg = sigmoidf(gr[U + u] + xr[U + u]);
        const float gg = tanhf(gr[2 * U + u] + xr[2 * U + u]);
        const float og = sigmoidf(gr[3 * U + u] + xr[3 * U + u]);
        const float c = fg * c_s[i] + ig * gg;
        c_s[i] = c;
        h = og * tanhf(c);
        out = h;
      }
      for (int dst = 0; dst < CL; ++dst) cluster.map_shared_rank(h_nxt, dst)[k * R + r] = h;
      if (row0 + r < B) outs[((size_t)(row0 + r) * L + t) * H + k] = out;
    }
    cluster.sync();
  }

  // steps past the cluster's longest row output 0; the carries are final
  const float* h_fin = h_s + (maxlen & 1) * H * R;
  for (int i = tid; i < R * U; i += THREADS) {
    const int r = i / U, u = i % U, k = rank * U + u, row = row0 + r;
    if (row >= B) continue;
    for (int t = maxlen; t < L; ++t) outs[((size_t)row * L + t) * H + k] = 0.f;
    hT[(size_t)row * H + k] = h_fin[k * R + r];
    cT[(size_t)row * H + k] = c_s[i];
  }
}

template <typename T>
cudaError_t launch(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                   const void* b, void* gx, void* outs, void* hT, void* cT, int B, int L, int D,
                   int H, int reverse, cudaStream_t stream) {
  const int M = B * L, N = 4 * H;
  dim3 ggrid((N + TN - 1) / TN, (M + TM - 1) / TM);
  gates_x_kernel<T><<<ggrid, THREADS, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const int64_t*>(lengths),
      static_cast<const T*>(w_ih), static_cast<const T*>(b), static_cast<float*>(gx), M, N, D, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int U = H / CL, G4 = 4 * U;
  const size_t smem = (size_t)H * G4 * sizeof(T) +
                      (size_t)(2 * H * R + 2 * R * G4 + R * U) * sizeof(float);
  e = cudaFuncSetAttribute(recurrence_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const int clusters = (B + R - 1) / R;
  recurrence_kernel<T><<<clusters * CL, THREADS, smem, stream>>>(
      static_cast<const float*>(gx), static_cast<const int64_t*>(lengths),
      static_cast<const T*>(w_hh), static_cast<float*>(outs), static_cast<float*>(hT),
      static_cast<float*>(cT), B, L, H, reverse);
  return cudaGetLastError();
}

}  // namespace

// xs [B, L, D] and the weights w_ih [D, 4H], w_hh [H, 4H], b [4H] in one
// dtype; lengths [B] int64; gx [B, L, 4H] f32 scratch; outs [B, L, H], hT
// and cT [B, H] f32.  H must be a multiple of 32 (U = H / 8 a multiple of
// 4) with W_hh's slice in shared memory: H <= 256.
extern "C" int lstm_scan(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                         const void* b, void* gx, void* outs, void* hT, void* cT, int B, int L,
                         int D, int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, B, L, D, H,
                                 reverse, s);
  return launch<float>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, B, L, D, H, reverse, s);
}
