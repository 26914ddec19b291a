// K3, K1 and K2: the masked LSTM scan over a whole sequence, forward or
// reverse in time — inference forward, training forward, and backward.
//
// K3 replaces curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
// lstm_scan_pallas, K1 its lstm_scan_train_pallas, K2 its
// lstm_scan_bwd_pallas.  The TPU kernels walk time as a sequential grid and
// keep W_ih, W_hh and the carries in VMEM for the whole scan.  On the H100
// a block's shared memory cannot hold both weight matrices, blocks run in
// no order, and a grid-wide barrier per step is costly; but every batch
// row's recurrence is independent.
//
// Forward (K3, and K1 with residuals): one C call, two launches.
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
//    K1 also writes the carries (h, c) before each step, time-major and
//    indexed by absolute t as _train_kernel does (the carried state at a
//    padded step), and overwrites gx in place with each valid step's full
//    gate pre-activations x . W_ih + b + h . W_hh: the backward reads them
//    instead of recomputing both products.
//
// Backward (K2): one C call, four launches.
// 1. bwd_recurrence: the reverse walk on the same cluster layout.  Block
//    `rank` keeps its gate columns of W_hh transposed in shared memory,
//    carries (dh, dc) of its units in registers, forms da of its columns
//    from the saved pre-activations and c_prev, then its partial
//    dh_prev = da . W_hh^T for all H units; the partials go to the blocks
//    owning the units through distributed shared memory and are summed in
//    rank order after one cluster barrier.  It writes da [B, L, 4H] (zero
//    at invalid steps) and the cluster's column sums of da for db.
// 2. dx_gemm:   d_xs = DA . W_ih^T, zero at invalid steps, in the dtype of xs.
// 3. dw_gemm:   dW_ih = X^T . DA and dW_hh = Hprev^T . DA (one launch, two
//    grids of output tiles); each block owns one output tile and loops over
//    the B*L rows in order, skipping chunks without a valid step.
// 4. db_sum:    db = the sum over clusters of their column sums.
// No atomics anywhere: the gradients are the same from run to run.
//
// Bound on the H100: at the path's shapes (B = 64, L = 80, D = H = 256)
// the forward is ~2.7 GFLOP at most and ~10 MB of traffic, a few µs at the
// card's peaks; the backward ~8 GFLOP and ~50 MB.  What bounds this design
// is the serial chain of steps (per step one pass over the block's W_hh
// slice in shared memory, one cell update and one cluster barrier) and the
// SIMT GEMMs; tensor cores (wgmma) for the GEMMs are later work.
//
// Semantics (lstm_scan.py:63-67, 264-286): step l reads t = L-1-l when
// reversed; a row with t >= len keeps its carry and outputs 0; gate order
// i, f, g, o; f32 accumulation and state; the backward walks the forward's
// steps in the opposite order, with dh_eff = dh + dout, and carries (dh,
// dc) through invalid steps unchanged.
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

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Whether sequence row m = b * L + t is a valid step (t < len[b]).
__device__ __forceinline__ bool step_valid(const int64_t* lengths, int m, int L) {
  return (int64_t)(m % L) < lengths[m / L];
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
    live = m < M && step_valid(lengths, m, L);
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
// 2. The forward recurrence.  Shared memory of a block (U = H / CL, G4 = 4U):
//      w_s   [H][G4]   T    its gate columns of W_hh, local column g*U + u
//      h_s   [2][H][R] f32  h of the cluster's rows, double-buffered
//      gates [R][G4]   f32  h . W_hh for its columns
//      gx_s  [R][G4]   f32  this step's gx for its columns (cp.async)
//      c_s   [R][U]    f32  c of its units
//    With hprev != nullptr (K1) it also writes hprev / cprev [L, B, H] and
//    the full pre-activations into gx.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
recurrence_kernel(float* __restrict__ gx, const int64_t* __restrict__ lengths,
                  const T* __restrict__ w_hh, float* __restrict__ outs, float* __restrict__ hT,
                  float* __restrict__ cT, float* __restrict__ hprev, float* __restrict__ cprev,
                  int B, int L, int H, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H;
  const int tid = threadIdx.x;
  const bool train = hprev != nullptr;

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
      const int r = i / U, u = i % U, k = rank * U + u, row = row0 + r;
      float h = h_cur[k * R + r];
      if (train && row < B) {
        hprev[((size_t)t * B + row) * H + k] = h;
        cprev[((size_t)t * B + row) * H + k] = c_s[i];
      }
      float out = 0.f;
      if (t < len[r]) {
        const float* gr = gates + r * G4;
        const float* xr = gx_s + r * G4;
        const float pi = gr[u] + xr[u], pf = gr[U + u] + xr[U + u];
        const float pg = gr[2 * U + u] + xr[2 * U + u], po = gr[3 * U + u] + xr[3 * U + u];
        const float c = sigmoidf(pf) * c_s[i] + sigmoidf(pi) * tanhf(pg);
        c_s[i] = c;
        h = sigmoidf(po) * tanhf(c);
        out = h;
        if (train) {
          float* gp = gx + ((size_t)row * L + t) * H4 + k;
          gp[0] = pi;
          gp[H] = pf;
          gp[2 * H] = pg;
          gp[3 * H] = po;
        }
      }
      for (int dst = 0; dst < CL; ++dst) cluster.map_shared_rank(h_nxt, dst)[k * R + r] = h;
      if (row < B) outs[((size_t)row * L + t) * H + k] = out;
    }
    cluster.sync();
  }

  // steps past the cluster's longest row output 0; the carries are final.
  // Their residual carries: the final state in the forward direction, the
  // zero initial state in the reverse one (those steps come first there).
  const float* h_fin = h_s + (maxlen & 1) * H * R;
  for (int i = tid; i < R * U; i += THREADS) {
    const int r = i / U, u = i % U, k = rank * U + u, row = row0 + r;
    if (row >= B) continue;
    const float hf = h_fin[k * R + r], cf = c_s[i];
    for (int t = maxlen; t < L; ++t) {
      outs[((size_t)row * L + t) * H + k] = 0.f;
      if (train) {
        hprev[((size_t)t * B + row) * H + k] = reverse ? 0.f : hf;
        cprev[((size_t)t * B + row) * H + k] = reverse ? 0.f : cf;
      }
    }
    hT[(size_t)row * H + k] = hf;
    cT[(size_t)row * H + k] = cf;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* b, void* gx, void* outs, void* hT, void* cT, void* hprev,
                       void* cprev, int B, int L, int D, int H, int reverse,
                       cudaStream_t stream) {
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
      static_cast<float*>(gx), static_cast<const int64_t*>(lengths), static_cast<const T*>(w_hh),
      static_cast<float*>(outs), static_cast<float*>(hT), static_cast<float*>(cT),
      static_cast<float*>(hprev), static_cast<float*>(cprev), B, L, H, reverse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2.1 The backward recurrence.  Shared memory of a block:
//      wT_s   [G4][H]        T    its gate columns of W_hh, transposed
//      da_s   [G4][R]        f32  this step's da of its columns (then db sums)
//      part_s [2][CL][R][U]  f32  partial dh_prev of its units from each
//                                 block of the cluster, double-buffered
//    Thread i < R*U owns (row r = i / U, unit u = i % U) and carries its
//    (dh, dc) and its four columns' sums of da in registers.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
bwd_recurrence_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                      const float* __restrict__ d_out, const float* __restrict__ dhT,
                      const float* __restrict__ dcT, const int64_t* __restrict__ lengths,
                      const T* __restrict__ w_hh, float* __restrict__ da,
                      float* __restrict__ db_part, int B, int L, int H, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wT_s = reinterpret_cast<T*>(smem_raw);
  float* da_s = reinterpret_cast<float*>(smem_raw + (size_t)G4 * H * sizeof(T));
  float* part_s = da_s + G4 * R;

  int maxlen = 0;
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const int64_t n = row < B ? lengths[row] : 0;
    maxlen = max(maxlen, (int)(n < L ? n : L));
  }

  for (int i = tid; i < H * G4; i += THREADS) {
    const int k = i / G4, c = i % G4, g = c / U, u = c % U;
    wT_s[(size_t)c * H + k] = w_hh[(size_t)k * H4 + g * H + rank * U + u];
  }

  const bool owner = tid < R * U;
  const int r = tid / U, u = tid % U, k = rank * U + u, row = row0 + r;
  int my_len = 0;
  float dh = 0.f, dc = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner && row < B) {
    const int64_t n = lengths[row];
    my_len = (int)(n < L ? n : L);
    dh = dhT[(size_t)row * H + k];
    dc = dcT[(size_t)row * H + k];
  }
  cluster.sync();  // every block of the cluster is running and initialised

  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? l : maxlen - 1 - l;  // the forward's steps, backwards
    float* part = part_s + (l & 1) * CL * R * U;

    if (owner) {
      float d4[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < my_len) {
        const float* gp = gates + ((size_t)row * L + t) * H4 + k;
        const float ig = sigmoidf(gp[0]), fg = sigmoidf(gp[H]);
        const float gg = tanhf(gp[2 * H]), og = sigmoidf(gp[3 * H]);
        const float cp = cprev[((size_t)t * B + row) * H + k];
        const float tc = tanhf(fg * cp + ig * gg);
        const float dh_eff = dh + d_out[((size_t)row * L + t) * H + k];
        const float dct = dc + dh_eff * og * (1.f - tc * tc);
        d4[0] = dct * gg * ig * (1.f - ig);
        d4[1] = dct * cp * fg * (1.f - fg);
        d4[2] = dct * ig * (1.f - gg * gg);
        d4[3] = dh_eff * tc * og * (1.f - og);
        dc = dct * fg;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        da_s[(g * U + u) * R + r] = d4[g];
        db[g] += d4[g];
      }
      if (row < B) {
        float* dp = da + ((size_t)row * L + t) * H4 + k;
#pragma unroll
        for (int g = 0; g < 4; ++g) dp[g * H] = d4[g];
      }
    }
    __syncthreads();

    // partial dh_prev[r][k'] = sum_c da_s[c][r] wT_s[c][k'], two units by
    // four rows a thread, sent to the block that owns unit k'
    for (int i = tid; i < H; i += THREADS) {
      const int kp = i % (H / 2), rh = i / (H / 2);
      float acc[2][4] = {};
      for (int c = 0; c < G4; ++c) {
        const float2 w = load2(wT_s + (size_t)c * H + 2 * kp);
        const float4 d = *reinterpret_cast<const float4*>(da_s + c * R + 4 * rh);
        acc[0][0] += w.x * d.x;
        acc[0][1] += w.x * d.y;
        acc[0][2] += w.x * d.z;
        acc[0][3] += w.x * d.w;
        acc[1][0] += w.y * d.x;
        acc[1][1] += w.y * d.y;
        acc[1][2] += w.y * d.z;
        acc[1][3] += w.y * d.w;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = 2 * kp + j;
        float* remote = cluster.map_shared_rank(part, kk / U);
#pragma unroll
        for (int q = 0; q < 4; ++q) remote[(rank * R + 4 * rh + q) * U + kk % U] = acc[j][q];
      }
    }
    cluster.sync();

    if (owner && t < my_len) {
      float s = 0.f;
      for (int src = 0; src < CL; ++src) s += part[(src * R + r) * U + u];
      dh = s;
    }
  }

  // this cluster's column sums of da, for db
  if (owner) {
#pragma unroll
    for (int g = 0; g < 4; ++g) da_s[(g * U + u) * R + r] = db[g];
  }
  __syncthreads();
  for (int c = tid; c < G4; c += THREADS) {
    float s = 0.f;
    for (int r2 = 0; r2 < R; ++r2) s += da_s[c * R + r2];
    db_part[(size_t)(blockIdx.x / CL) * H4 + (c / U) * H + rank * U + c % U] = s;
  }
}

// ---------------------------------------------------------------------------
// K2.2 d_xs[m, n] = valid(m) ? sum_k da[m, k] w_ih[n, k] : 0, in T
//      (m < M = B*L, n < N = D, k < K = 4H).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_gemm_kernel(const float* __restrict__ da, const T* __restrict__ w,
               const int64_t* __restrict__ lengths, T* __restrict__ dx, int M, int N, int K,
               int L) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tr = tid / 16, tc = tid % 16;

  int live = 0;
  if (tid < TM) {
    const int m = m0 + tid;
    live = m < M && step_valid(lengths, m, L);
  }
  float acc[4][4] = {};
  if (__syncthreads_or(live)) {
    for (int k0 = 0; k0 < K; k0 += TK) {
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int r = i / TK, k = i % TK;
        const int m = m0 + r, kk = k0 + k;
        As[k][r] = (m < M && kk < K) ? da[(size_t)m * K + kk] : 0.f;
      }
      for (int i = tid; i < TN * TK; i += THREADS) {
        const int c = i / TK, k = i % TK;
        const int n = n0 + c, kk = k0 + k;
        Bs[k][c] = (n < N && kk < K) ? to_f32(w[(size_t)n * K + kk]) : 0.f;
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
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr * 4 + i;
    if (m >= M) continue;
    const bool v = step_valid(lengths, m, L);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 16 * j;
      if (n < N) store_as(dx + (size_t)m * N + n, v ? acc[i][j] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// K2.3 dW[i, j] = sum over valid m of a(m, i) da[m, j], j < J = 4H.
//      blockIdx.z = 0: a = xs [B, L, D] (T), dW = dW_ih [D, 4H];
//      blockIdx.z = 1: a = hprev [L, B, H] (f32, time-major), dW = dW_hh [H, 4H].
//      Each block loops over the M = B*L rows in chunks of TK, in order.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_gemm_kernel(const T* __restrict__ xs, const float* __restrict__ hprev,
               const float* __restrict__ da, const int64_t* __restrict__ lengths,
               float* __restrict__ dw_ih, float* __restrict__ dw_hh, int B, int L, int D, int H) {
  __shared__ float As[TK][TM + 4];
  __shared__ float Bs[TK][TN + 4];
  __shared__ int vm_s[TK];
  const bool hh = blockIdx.z == 1;
  const int I = hh ? H : D, J = 4 * H, M = B * L;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  if (i0 >= I) return;  // the dW_hh grid is shorter when H < D
  float* dw = hh ? dw_hh : dw_ih;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  float acc[4][4] = {};
  for (int m0 = 0; m0 < M; m0 += TK) {
    int v = 0;
    if (tid < TK) {
      const int m = m0 + tid;
      v = m < M && step_valid(lengths, m, L);
      vm_s[tid] = v;
    }
    if (!__syncthreads_or(v)) continue;
    for (int idx = tid; idx < TK * TM; idx += THREADS) {
      const int mm = idx / TM, ii = idx % TM;
      const int m = m0 + mm, i = i0 + ii;
      float a = 0.f;
      if (vm_s[mm] && i < I)
        a = hh ? hprev[((size_t)(m % L) * B + m / L) * H + i] : to_f32(xs[(size_t)m * D + i]);
      As[mm][ii] = a;
    }
    for (int idx = tid; idx < TK * TN; idx += THREADS) {
      const int mm = idx / TN, jj = idx % TN;
      const int m = m0 + mm, j = j0 + jj;
      Bs[mm][jj] = (vm_s[mm] && j < J) ? da[(size_t)m * J + j] : 0.f;
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
    const int ii = i0 + tr * 4 + i;
    if (ii >= I) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tc + 16 * j;
      if (jj < J) dw[(size_t)ii * J + jj] = acc[i][j];
    }
  }
}

// K2.4 db[j] = sum over the clusters (in order) of their column sums.
__global__ void db_sum_kernel(const float* __restrict__ db_part, float* __restrict__ db,
                              int clusters, int J) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  float s = 0.f;
  for (int q = 0; q < clusters; ++q) s += db_part[(size_t)q * J + j];
  db[j] = s;
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* gates, const void* hprev, const void* cprev,
                       const void* d_out, const void* dhT, const void* dcT, void* da,
                       void* db_part, void* d_xs, void* dw_ih, void* dw_hh, void* db, int B,
                       int L, int D, int H, int reverse, cudaStream_t stream) {
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H, M = B * L;
  const int clusters = (B + R - 1) / R;
  const size_t smem = (size_t)G4 * H * sizeof(T) + (size_t)(G4 * R + 2 * CL * R * U) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(bwd_recurrence_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  bwd_recurrence_kernel<T><<<clusters * CL, THREADS, smem, stream>>>(
      static_cast<const float*>(gates), static_cast<const float*>(cprev),
      static_cast<const float*>(d_out), static_cast<const float*>(dhT),
      static_cast<const float*>(dcT), static_cast<const int64_t*>(lengths),
      static_cast<const T*>(w_hh), static_cast<float*>(da), static_cast<float*>(db_part), B, L, H,
      reverse);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  dim3 xgrid((D + TN - 1) / TN, (M + TM - 1) / TM);
  dx_gemm_kernel<T><<<xgrid, THREADS, 0, stream>>>(
      static_cast<const float*>(da), static_cast<const T*>(w_ih),
      static_cast<const int64_t*>(lengths), static_cast<T*>(d_xs), M, D, H4, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  dim3 wgrid((H4 + TN - 1) / TN, (max(D, H) + TM - 1) / TM, 2);
  dw_gemm_kernel<T><<<wgrid, THREADS, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(hprev), static_cast<const float*>(da),
      static_cast<const int64_t*>(lengths), static_cast<float*>(dw_ih),
      static_cast<float*>(dw_hh), B, L, D, H);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  db_sum_kernel<<<(H4 + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(db_part),
                                                      static_cast<float*>(db), clusters, H4);
  return cudaGetLastError();
}

}  // namespace

// K3.  xs [B, L, D] and the weights w_ih [D, 4H], w_hh [H, 4H], b [4H] in
// one dtype; lengths [B] int64; gx [B, L, 4H] f32 scratch; outs [B, L, H],
// hT and cT [B, H] f32.  H must be a multiple of 32 (U = H / 8 a multiple
// of 4) with W_hh's slice in shared memory: H <= 256.
extern "C" int lstm_scan(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                         const void* b, void* gx, void* outs, void* hT, void* cT, int B, int L,
                         int D, int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, nullptr,
                                     nullptr, B, L, D, H, reverse, s);
  return launch_fwd<float>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, nullptr, nullptr, B, L,
                           D, H, reverse, s);
}

// K1.  As K3, and also writes hprev and cprev [L, B, H] f32 (the carries
// before each step, by absolute t) and leaves in gx [B, L, 4H] the gate
// pre-activations of every valid step.
extern "C" int lstm_scan_train(const void* xs, const void* lengths, const void* w_ih,
                               const void* w_hh, const void* b, void* gx, void* outs, void* hT,
                               void* cT, void* hprev, void* cprev, int B, int L, int D, int H,
                               int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, hprev, cprev,
                                     B, L, D, H, reverse, s);
  return launch_fwd<float>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, hprev, cprev, B, L, D,
                           H, reverse, s);
}

// K2.  From K1's residuals (gates = its gx, hprev, cprev) and the
// cotangents d_out [B, L, H], dhT and dcT [B, H] (f32): d_xs [B, L, D] in
// the dtype of xs, dw_ih [D, 4H], dw_hh [H, 4H] and db [4H] f32.  da
// [B, L, 4H] and db_part [ceil(B / 8), 4H] are f32 scratch.
extern "C" int lstm_scan_bwd(const void* xs, const void* lengths, const void* w_ih,
                             const void* w_hh, const void* gates, const void* hprev,
                             const void* cprev, const void* d_out, const void* dhT,
                             const void* dcT, void* da, void* db_part, void* d_xs, void* dw_ih,
                             void* dw_hh, void* db, int B, int L, int D, int H, int reverse,
                             int dtype, void* stream) {
  if (H % 32 != 0 || H > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_bwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT,
                                     dcT, da, db_part, d_xs, dw_ih, dw_hh, db, B, L, D, H,
                                     reverse, s);
  return launch_bwd<float>(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT, da,
                           db_part, d_xs, dw_ih, dw_hh, db, B, L, D, H, reverse, s);
}
