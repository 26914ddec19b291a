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
// Bound on the H100 at the decoder's shape (B = 64, Din = 2240, H = 512,
// so K = Din + H = 2752 and N = 4H = 2048): the weights, read once, are
// 11.3 MB in bf16 (3.4 µs at 3.35 TB/s) and 22.5 MB in f32; the product is
// 0.72 GFLOP, under 1 µs on the bf16 tensor cores but 10.8 µs at the SIMT
// units' 67 TFLOP/s, so f32 is bound by its operations.  What kept the
// first design (one block per 8 units x 32 rows, K walked in 86 chunks of
// 32 rows with two barriers each) 40x above the bound was that each block
// had one 2 KB chunk of loads in flight, and its two row tiles read every
// weight twice.
//
// This design:
// - Grid (S, H / 16, ceil(B / 64)).  A CTA owns one 64-row M tile (every row
//   of the decoder's batch, so the weights are read once) and one N tile:
//   the four gate columns of 16 hidden units. K is split S ways over a
//   cluster of S CTAs (S = 4 at the decoder's shape: 128 CTAs, one wave on
//   132 SMs).
// - Loads by the Tensor Memory Accelerator.  K is walked in boxes of 128
//   bytes of K (64 rows in bf16, 32 in f32): first the boxes of x / W_ih,
//   then those of h / W_hh, so no box straddles the x/h boundary, and the
//   copy zero-fills rows past B, past Din and past H.  A CTA takes a run of
//   consecutive boxes.  Each stage is five TMA copies: a [64 rows x box]
//   tile of x or h and, per gate, the box's rows of the CTA's 16 columns of
//   W_ih or W_hh ({16 units, box rows}: the JAX layout as it is), 16 KB in
//   all, completed on an mbarrier; a ring of 4 stages keeps 64 KB a CTA in
//   flight.  A design that issued every 16-byte cp.async of a CTA's K slice
//   up front (the whole slice, 204 KB, in shared memory) ran at 0.038 ms of
//   device time in bf16 on the H100: its threads spent most of it issuing
//   copies, and at one CTA an SM its 32 clusters did not fit in one wave. A
//   TMA stage is a few instructions, and 81 KB a CTA leaves room for two
//   CTAs on an SM.
// - Product: bf16 on the tensor cores, mma.sync m16n8k16 with ldmatrix
//   (.trans for the K-major weights) from swizzled tiles (the [x | h] tile
//   128-byte, the weight tiles 32-byte), so the eight rows of an ldmatrix
//   phase hit distinct banks.  Warp w owns rows 16w..16w+15 and all 64
//   columns, so each thread's accumulators hold all four gates of its (row,
//   unit) pairs.  f32 keeps full f32 on the SIMT units (TF32 would break its
//   1e-4 tolerance): the same grid and loads, unswizzled, each thread 8 rows
//   x 1 unit x 4 gates.
// - Split-K reduction and epilogue: pair p of a thread's 8 (row, unit) pairs
//   belongs to CTA p % S of the cluster.  Each CTA stores its four gate
//   partials of every pair straight into the owner's receive buffer through
//   distributed shared memory (stores do not wait; loads of remote partials
//   did), one cluster barrier, and each CTA sums its pairs' S partials from
//   its own shared memory in rank order (the sums repeat bit for bit), adds
//   b, applies the nonlinearities with c (both loaded before the product)
//   and writes h' and c'.  No [B, 4H] gate tensor reaches device memory.
// The launch geometry (S, boxes a CTA, shared-memory bytes) comes from
// ops/cuda/lstm_cell.py::lstm_cell_plan.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TH = 16;            // hidden units per N tile
constexpr int BM = 64;            // batch rows per M tile
constexpr int THREADS = 128;      // 4 warps, 16 rows each
constexpr int ACC = 32;           // accumulators a thread: 8 (row, unit) pairs x 4 gates
constexpr int STAGES = 4;         // ring of TMA stages
constexpr int BOX_BYTES = 128;    // K bytes of one box (64 rows in bf16, 32 in f32)
constexpr int A_BYTES = BM * BOX_BYTES;        // [64 rows x box] of x or h
constexpr int W_BYTES = A_BYTES / 4;           // [box rows x 16 units] of W, a gate
constexpr int STAGE_BYTES = A_BYTES + 4 * W_BYTES;
constexpr int MAX_CLUSTER = 8;
// the ring, the receive buffer of the split-K partials ([8 pairs][THREADS]
// float4), and 1 KB to align the ring
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * THREADS * 16 + 1024;

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `st` of the CTA's run of boxes [b0, b0 + n): its five TMA copies
// into ring slot st % STAGES, completing on that slot's barrier.
__device__ __forceinline__ void issue_stage(int st, int b0, int nbx, int kc, int m0, int n0,
                                            int H, unsigned ring, const uint64_t* full,
                                            const CUtensorMap* mx, const CUtensorMap* mh,
                                            const CUtensorMap* mw_ih, const CUtensorMap* mw_hh) {
  const int bi = b0 + st, slot = st % STAGES;
  const unsigned buf = ring + slot * STAGE_BYTES, bar = smem_u32(&full[slot]);
  const bool in_x = bi < nbx;
  const int k = (in_x ? bi : bi - nbx) * kc;
  mbar_expect_tx(bar, STAGE_BYTES);
  tma_2d(buf, in_x ? mx : mh, k, m0, bar);
#pragma unroll
  for (int g = 0; g < 4; ++g)
    tma_2d(buf + A_BYTES + g * W_BYTES, in_x ? mw_ih : mw_hh, g * H + n0, k, bar);
}

// acc += the stage's [x | h] rows . W rows.
// bf16: acc[(n8 tile) * 4 + fragment register], n8 tile 2 gate + half;
// f32: acc[row * 4 + gate].
template <typename T>
__device__ __forceinline__ void stage_product(unsigned buf, const unsigned char* buf_ptr,
                                              float* acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kBf16<T>) {
    // the [x | h] tile has 128-byte rows, 128-byte swizzled: 16-byte chunk
    // c of row r lies at chunk c ^ (r % 8)
    const int ar = warp * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, buf + ar * 128 + (((kk * 2 + (lane >> 4)) ^ (ar & 7)) << 4));
      // a gate's weight tile has 32-byte rows, 32-byte swizzled: chunk c of
      // row r lies at chunk c ^ (r / 4 % 2)
      const int wr = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const unsigned wa = buf + A_BYTES + wr * 32 + (((lane >> 4) ^ ((wr >> 2) & 1)) << 4);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t b[4];
        ldsm_x4_trans(b, wa + g * W_BYTES);
        mma_bf16(acc + (2 * g) * 4, a, b[0], b[1]);
        mma_bf16(acc + (2 * g + 1) * 4, a, b[2], b[3]);
      }
    }
  } else {
    // A [64 rows][32 k], W [4 gates][32 k][16 units], unswizzled; rows
    // 16 warp + 8 (lane / 16) + i, unit lane % 16
    const float* a_s =
        reinterpret_cast<const float*>(buf_ptr) + (warp * 16 + (lane >> 4) * 8) * 32;
    const float* w_s = reinterpret_cast<const float*>(buf_ptr + A_BYTES) + (lane & 15);
#pragma unroll 2
    for (int k = 0; k < 32; k += 4) {
      float wv[4][4];  // [k][gate]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[kk][g] = w_s[g * (W_BYTES / 4) + (k + kk) * TH];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + i * 32 + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = acc[i * 4 + g];
          s = fmaf(av.x, wv[0][g], s);
          s = fmaf(av.y, wv[1][g], s);
          s = fmaf(av.z, wv[2][g], s);
          s = fmaf(av.w, wv[3][g], s);
          acc[i * 4 + g] = s;
        }
      }
    }
  }
}

// The thread's (row, unit) pair p in 0..7: its row in the M tile and unit
// in the N tile (pair_of), and its four gate accumulators i, f, g, o
// (gates_of).
template <typename T>
__device__ __forceinline__ void pair_of(int p, int* row, int* unit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if constexpr (kBf16<T>) {
    const int half = p >> 2, r = p & 3;  // n8 tile 2 gate + half, fragment register r
    *row = warp * 16 + (lane >> 2) + (r >> 1) * 8;
    *unit = half * 8 + (lane & 3) * 2 + (r & 1);
  } else {
    *row = warp * 16 + (lane >> 4) * 8 + p;
    *unit = lane & 15;
  }
}
template <typename T>
__device__ __forceinline__ float4 gates_of(const float* acc, int p) {
  if constexpr (kBf16<T>) {
    const int a = (p >> 2) * 4 + (p & 3);
    return make_float4(acc[a], acc[a + 8], acc[a + 16], acc[a + 24]);
  } else {
    return make_float4(acc[p * 4], acc[p * 4 + 1], acc[p * 4 + 2], acc[p * 4 + 3]);
  }
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) { return 2.f * sigmoid_fast(2.f * x) - 1.f; }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// S = the cluster size, the K split: each thread finishes NP = 8 / S of
// its (row, unit) pairs, p = rank + k S.
template <typename T, int S>
__global__ void __launch_bounds__(THREADS)
lstm_cell_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_w_ih,
                 const __grid_constant__ CUtensorMap map_w_hh, const T* __restrict__ c,
                 const T* __restrict__ bias, T* __restrict__ h_out, T* __restrict__ c_out, int B,
                 int Din, int H, int per) {
  constexpr int NP = 8 / S;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // the ring, 1024-byte aligned for the 128-byte swizzle
  const unsigned raw = smem_u32(smem_raw), pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* ring_ptr = smem_raw + pad;
  const unsigned ring = raw + pad;
  constexpr int KC = BOX_BYTES / (int)sizeof(T);  // K rows a box
  const int nbx = (Din + KC - 1) / KC, nb = nbx + (H + KC - 1) / KC;
  const int b0 = rank * per, nst = max(0, min(nb, b0 + per) - b0);
  const int m0 = blockIdx.z * BM, n0 = blockIdx.y * TH;

  // this CTA has started: with the wait before the split-K stores, no CTA
  // writes into another that has not
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < min(nst, STAGES))  // the first stages, one lane each
    issue_stage(threadIdx.x, b0, nbx, KC, m0, n0, H, ring, full, &map_x, &map_h, &map_w_ih,
                &map_w_hh);

  // the epilogue's c and b, loaded while the product runs (widened only
  // when used, so no warp waits for them here)
  T c_old[NP], b_old[NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    int r, u;
    pair_of<T>(rank + k * S, &r, &u);
    const int j = n0 + u;
    c_old[k] = m0 + r < B ? c[(size_t)(m0 + r) * H + j] : T(0.f);
#pragma unroll
    for (int g = 0; g < 4; ++g) b_old[k][g] = bias[g * H + j];
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int st = 0; st < nst; ++st) {
    const int slot = st % STAGES;
    mbar_wait(smem_u32(&full[slot]), (st / STAGES) & 1);
    stage_product<T>(ring + slot * STAGE_BYTES, ring_ptr + slot * STAGE_BYTES, acc);
    __syncthreads();  // the slot is read: it may be refilled
    if (threadIdx.x == 0 && st + STAGES < nst) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_stage(st + STAGES, b0, nbx, KC, m0, n0, H, ring, full, &map_x, &map_h, &map_w_ih,
                  &map_w_hh);
    }
  }

  // split-K: pair p of every thread belongs to CTA p % S of the cluster;
  // each CTA stores its four gate partials of p into that CTA's receive
  // buffer, recv[rank][p / S][thread], through distributed shared memory
  float4* recv = reinterpret_cast<float4*>(ring_ptr + STAGES * STAGE_BYTES);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float4* dst = cluster.map_shared_rank(recv, p % S);
    dst[(rank * NP + p / S) * THREADS + threadIdx.x] = gates_of<T>(acc, p);
  }
  cluster.sync();  // every partial has landed; no CTA reads another's memory after this
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    int r, u;
    pair_of<T>(rank + k * S, &r, &u);
    const int row = m0 + r, j = n0 + u;
    float4 sum = recv[k * THREADS + threadIdx.x];  // rank 0's, then the others in rank order
#pragma unroll
    for (int src = 1; src < S; ++src) {
      const float4 v = recv[(src * NP + k) * THREADS + threadIdx.x];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float ig = sigmoid_fast(sum.x + to_f32(b_old[k][0]));
    const float fg = sigmoid_fast(sum.y + to_f32(b_old[k][1]));
    const float gg = tanh_fast(sum.z + to_f32(b_old[k][2]));
    const float og = sigmoid_fast(sum.w + to_f32(b_old[k][3]));
    const float cn = fg * to_f32(c_old[k]) + ig * gg;
    if (row < B) {
      const size_t o = (size_t)row * H + j;
      store_as(c_out + o, cn);
      store_as(h_out + o, og * tanh_fast(cn));
    }
  }
}

// [rows, cols] row-major, boxes of {KC, BM}: the x or h operand.
template <typename T>
bool encode_rows(EncodeTiled enc, CUtensorMap* m, const void* p, int cols, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {BOX_BYTES / sizeof(T), BM}, one[2] = {1, 1};
  return enc(m, kBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(p), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kBf16<T> ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// W [rows, 4H] row-major, boxes of {TH, KC}: one gate's columns of a box.
template <typename T>
bool encode_weights(EncodeTiled enc, CUtensorMap* m, const void* p, int rows, int H) {
  const cuuint64_t dims[2] = {(cuuint64_t)4 * H, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)4 * H * sizeof(T)};
  const cuuint32_t box[2] = {TH, BOX_BYTES / sizeof(T)}, one[2] = {1, 1};
  return enc(m, kBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(p), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             kBf16<T> ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* x, const void* h, const void* c, const void* w_ih,
                   const void* w_hh, const void* b, void* h_out, void* c_out, int B, int Din,
                   int H, int splits, int per, int smem, cudaStream_t stream) {
  constexpr int KC = BOX_BYTES / (int)sizeof(T);
  const int nb = (Din + KC - 1) / KC + (H + KC - 1) / KC;
  if ((splits & (splits - 1)) || splits < 1 || splits > MAX_CLUSTER ||
      (size_t)splits * per < (size_t)nb || H % TH ||
      Din % 8 || smem < SMEM_BYTES)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap mx, mh, mw_ih, mw_hh;
  if (!encode_rows<T>(enc, &mx, x, Din, B) || !encode_rows<T>(enc, &mh, h, H, B) ||
      !encode_weights<T>(enc, &mw_ih, w_ih, Din, H) || !encode_weights<T>(enc, &mw_hh, w_hh, H, H))
    return cudaErrorInvalidValue;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 const T*, const T*, T*, T*, int, int, int, int) =
      splits == 1   ? lstm_cell_kernel<T, 1>
      : splits == 2 ? lstm_cell_kernel<T, 2>
      : splits == 4 ? lstm_cell_kernel<T, 4>
                    : lstm_cell_kernel<T, 8>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H / TH, (B + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, mx, mh, mw_ih, mw_hh,
                            static_cast<const T*>(c), static_cast<const T*>(b),
                            static_cast<T*>(h_out), static_cast<T*>(c_out), B, Din, H, per);
}

}  // namespace

// K8.  x [B, Din], h and c [B, H], w_ih [Din, 4H], w_hh [H, 4H], b [4H],
// all in the dtype (DTYPE_F32 or DTYPE_BF16), 16-byte aligned; writes
// h_out and c_out [B, H] in that dtype.  H a multiple of 16, Din of 8;
// splits (the cluster size: 1, 2, 4 or 8), the boxes a CTA takes (splits *
// per >= the boxes of x and h) and the dynamic shared-memory bytes as
// lstm_cell_plan gives them.
extern "C" int lstm_cell(const void* x, const void* h, const void* c, const void* w_ih,
                         const void* w_hh, const void* b, void* h_out, void* c_out, int B,
                         int Din, int H, int splits, int per, int smem, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, h, c, w_ih, w_hh, b, h_out, c_out, B, Din, H, splits, per,
                                 smem, s);
  return launch<float>(x, h, c, w_ih, w_hh, b, h_out, c_out, B, Din, H, splits, per, smem, s);
}
