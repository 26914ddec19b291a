// K8: one fused LSTM cell.
//
// Replaces curriculum_learning_for_vln_tpu/ops/pallas/lstm.py::
// lstm_cell_pallas.  With x [B, Din], h and c [B, H], W_ih [Din, 4H],
// W_hh [H, 4H] and b [4H] (the JAX layout: gate-major columns i, f, g, o):
//
//   gates = x . W_ih + h . W_hh + b          (f32 accumulation)
//   c'    = sigmoid(f) c + sigmoid(i) tanh(g)
//   h'    = sigmoid(o) tanh(c')
//
// One block per tile of TH = 8 hidden units and BT = 32 batch rows.  It
// walks K = Din + H in chunks of KT = 32: the [BT, KT] slice of [x | h]
// and the [KT, 4 x TH] slice of [W_ih ; W_hh] (the tile's columns of all
// four gates) go to shared memory, and each thread accumulates TH gate
// pre-activations of one row and one gate in f32 registers, while its
// loads of the next chunk are in flight.  The gates
// meet in shared memory, and each (row, unit) pair applies the
// nonlinearities and writes its h' and c'.  No [B, 4H] gate tensor ever
// reaches device memory, which is what the Pallas kernel fuses too.
//
// Bound on the H100 at the decoder's shape (B = 64, Din = 2240, H = 512):
// the weights are read once (22.5 MB in f32, 11.3 MB in bf16); the f32
// FMAs (0.72 GFLOP) run on the SIMT units, not the tensor cores, so in f32
// the 67 TFLOP/s of the SIMT units bound it as much as the bytes do.  At
// 64 x 2 = 128 blocks each block streams its 352 KB slab of W through
// shared memory with two barriers per chunk and one chunk of loads in
// flight: a simple kernel, far from that bound; wgmma on bf16 tiles, a
// cp.async ring and more blocks per SM are the way to it.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TH = 8;    // hidden units per block (the FMA loop below unrolls 8)
constexpr int BT = 32;   // batch rows per block
constexpr int KT = 32;   // reduction chunk
constexpr int THREADS = BT * 4;  // one thread per (row, gate)

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Per thread: its share of one chunk of [x | h] and of [W_ih ; W_hh], held
// in T until the chunk is stored (a widening right after the load would
// wait for it, and no load would be in flight during the FMAs).
constexpr int A_PER = BT * KT / THREADS, W_PER = KT * 4 * TH / THREADS;

template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, const T* __restrict__ h,
                                          const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                                          int k0, int r0, int j0, int B, int Din, int H,
                                          T* a_reg, T* w_reg) {
  const int K = Din + H;
#pragma unroll
  for (int q = 0; q < A_PER; ++q) {
    const int i = threadIdx.x + q * THREADS, k = k0 + i % KT, row = r0 + i / KT;
    T v = T(0.f);
    if (row < B && k < K) v = k < Din ? x[(size_t)row * Din + k] : h[(size_t)row * H + (k - Din)];
    a_reg[q] = v;
  }
#pragma unroll
  for (int q = 0; q < W_PER; ++q) {
    const int i = threadIdx.x + q * THREADS, col = i % (4 * TH), k = k0 + i / (4 * TH);
    T v = T(0.f);
    if (k < K) {
      const T* w = k < Din ? w_ih + (size_t)k * 4 * H : w_hh + (size_t)(k - Din) * 4 * H;
      v = w[(col / TH) * H + j0 + col % TH];
    }
    w_reg[q] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ c,
                 const T* __restrict__ w_ih, const T* __restrict__ w_hh,
                 const T* __restrict__ bias, T* __restrict__ h_out, T* __restrict__ c_out,
                 int B, int Din, int H) {
  __shared__ float a_s[BT][KT + 1];                  // [x | h] chunk (padded: no bank conflicts)
  __shared__ __align__(16) float w_s[KT][4 * TH];    // gate columns of the tile
  __shared__ float g_s[BT][4 * TH + 1];              // the tile's gate pre-activations
  const int j0 = blockIdx.x * TH, r0 = blockIdx.y * BT;
  const int tid = threadIdx.x, r = tid >> 2, gate = tid & 3;
  const int K = Din + H;
  float acc[TH];
#pragma unroll
  for (int u = 0; u < TH; ++u) acc[u] = 0.f;

  // the next chunk's loads are in flight while this chunk's FMAs run
  T a_reg[A_PER], w_reg[W_PER];
  load_tile(x, h, w_ih, w_hh, 0, r0, j0, B, Din, H, a_reg, w_reg);
  for (int k0 = 0; k0 < K; k0 += KT) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int i = tid + q * THREADS;
      a_s[i / KT][i % KT] = to_f32(a_reg[q]);
    }
#pragma unroll
    for (int q = 0; q < W_PER; ++q) {
      const int i = tid + q * THREADS;
      w_s[i / (4 * TH)][i % (4 * TH)] = to_f32(w_reg[q]);
    }
    __syncthreads();
    if (k0 + KT < K) load_tile(x, h, w_ih, w_hh, k0 + KT, r0, j0, B, Din, H, a_reg, w_reg);
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float a = a_s[r][kk];
      const float4* wv = reinterpret_cast<const float4*>(&w_s[kk][gate * TH]);
      const float4 w0 = wv[0], w1 = wv[1];
      acc[0] += a * w0.x; acc[1] += a * w0.y; acc[2] += a * w0.z; acc[3] += a * w0.w;
      acc[4] += a * w1.x; acc[5] += a * w1.y; acc[6] += a * w1.z; acc[7] += a * w1.w;
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < TH; ++u) g_s[r][gate * TH + u] = acc[u] + to_f32(bias[gate * H + j0 + u]);
  __syncthreads();

  for (int i = tid; i < BT * TH; i += THREADS) {
    const int rr = i / TH, u = i % TH, row = r0 + rr;
    if (row >= B) continue;
    const float ig = sigmoid(g_s[rr][u]), fg = sigmoid(g_s[rr][TH + u]);
    const float gg = tanhf(g_s[rr][2 * TH + u]), og = sigmoid(g_s[rr][3 * TH + u]);
    const size_t o = (size_t)row * H + j0 + u;
    const float cn = fg * to_f32(c[o]) + ig * gg;
    store_as(c_out + o, cn);
    store_as(h_out + o, og * tanhf(cn));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const void* c, const void* w_ih,
                   const void* w_hh, const void* b, void* h_out, void* c_out, int B, int Din,
                   int H, cudaStream_t stream) {
  const dim3 grid(H / TH, (B + BT - 1) / BT);
  lstm_cell_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h), static_cast<const T*>(c),
      static_cast<const T*>(w_ih), static_cast<const T*>(w_hh), static_cast<const T*>(b),
      static_cast<T*>(h_out), static_cast<T*>(c_out), B, Din, H);
  return cudaGetLastError();
}

}  // namespace

// K8.  x [B, Din], h and c [B, H], w_ih [Din, 4H], w_hh [H, 4H], b [4H],
// all in the dtype (DTYPE_F32 or DTYPE_BF16); writes h_out and c_out
// [B, H] in that dtype.  H must be a multiple of 8.
extern "C" int lstm_cell(const void* x, const void* h, const void* c, const void* w_ih,
                         const void* w_hh, const void* b, void* h_out, void* c_out, int B,
                         int Din, int H, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, h, c, w_ih, w_hh, b, h_out, c_out, B, Din, H, s);
  return launch<float>(x, h, c, w_ih, w_hh, b, h_out, c_out, B, Din, H, s);
}
