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
// The mask is never stored: the prng modes draw each element's bits from
// the sample's seed (in prng_shared, the seed of row b - b % 8), and the
// backward draws the forward's again.  The TPU kernels' one-hot MXU matmul
// for the candidate rows and their 36 -> 40 view padding exist for Mosaic's
// alignment rules and are not carried over; the backward does not emit the
// candidate rows its Pallas twin re-emits (the caller discards them,
// fused_obs.py:154).
//
// Bound on the H100: device-memory bytes.  Each sample's V x D rows are
// read once and K4's candidate rows written once (bf16 at the path's
// shapes, B = 64, V = 36, D = 2048, MC = 16: 9.4 MB and 4.2 MB, 4.5 us at
// 3.35 TB/s for K4, 3.3 us for K5), for ~4 FLOP an element, plus one
// Philox4x32-10 (~100 integer instructions) per 4 elements in mode prng:
// 1.18 M calls a launch at B = 64, that mode's floor; prng_shared draws
// each group's mask once a block.
//
// The first design (one block of 256 threads per sample; a dot pass and a
// weighted-sum pass over the rows, each element loaded, dropped by an IEEE
// division and, in the prng modes, drawn from Philox in both passes) took,
// in bf16 device ms on the H100 (PERF.md, PR 6): K4 0.1041 in prng_shared,
// 0.1050 prng, 0.0996 ext, 0.0353 none; K5 0.1012, 0.1004, 0.0954,
// 0.0320: 23-31x the bound.  What held it back, and what this design does
// about each:
//
// 1. A division per element, twice.  Now each element is dropped once, in
//    shared memory, by div_by (a reciprocal and one FMA correction: the
//    division's bits), and rounded to T there; round_to<T>(x / keep) is a
//    value of T, so the store loses nothing and no later pass divides.
// 2. Philox drawn in both passes, and by each of the 8 rows of a
//    prng_shared group.  Now a block draws each element's flags once, while
//    its rows are in flight: in prng_shared once for all its samples (a
//    block's samples never straddle a group of 8), in prng once a sample.
// 3. 64 blocks at B = 64 on 132 SMs.  Now the grid is (slice of D, group of
//    G samples): a cluster of S = 8 blocks along D covers one group (256
//    image and 16 angle columns a block), G from ops/cuda/pano_fused.py::
//    pano_plan.  G = 4 (128 blocks of 126 KB in bf16, one an SM) left the
//    card room for fewer than its 16 clusters at once (cudaOccupancyMax-
//    ActiveClusters), so one ran as a second wave; the plan takes the G
//    whose grid needs the fewest waves, G = 2 in bf16 (256 blocks of
//    64 KB, up to three an SM).
// 4. The rows read twice, one dependent 16-byte load a lane at a time.  Now
//    thread 0 puts every load of the block in flight before any arithmetic:
//    per sample one TMA box of its rows' slice ({box, cols / box, V} of a 3D
//    view of the table, landing as [V][cols]), one of its ext flags and one
//    of its angle rows, and bulk copies of its query slice, all counted on
//    one mbarrier; the rows stay in shared memory for both passes.  (16-byte
//    cp.async copies, 4,608 a block, took longer to issue than to land.)
//
// Scores across the cluster: tpr threads a (sample, view) row form the
// block's partial dot over its columns (rows rotated so that a 16-byte
// load phase hits distinct banks) and store it, through distributed shared
// memory, into every rank's receive buffer; after one cluster barrier each
// block sums the S partials of a score in rank order 0..S-1 from its own
// shared memory.  So every block holds the same bits of every score, takes
// the softmax (or its VJP with the saved alpha) itself, and the weights its
// slice uses are the other slices' too; rank 0 writes alpha.  No block
// reads another's memory after the barrier, so none waits at its end.  Then
// each lane owns four columns of one sample over half the views, the halves
// meeting in one shuffle: every output element is written once, with no
// atomics, so every run gives the same bits.  K4 copies the candidate rows
// from shared memory before anything is dropped, and a barrier separates
// that read from the in-place drop.  The mask mode is a template parameter.
#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 288;        // 9 warps: 8 threads a (sample, view) row at G = 1, 4 at G = 2
constexpr int NWARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 3;       // blocks an SM holds by their registers (launch bounds)
constexpr int MAX_SPLIT = 8;        // the largest portable cluster
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use on the H100
constexpr int SM_SMEM = 233472;     // shared memory of an SM
constexpr int BLOCK_RESERVE = 1024; // the runtime's shared memory of each block
constexpr int SMS = 132;
constexpr int MAX_BOX = 256;        // the longest side of a TMA box
constexpr int ROWS_OUTER = 1 << 30; // rows of the feature table's tensor map (node * V + view)

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// Offsets (bytes) of a block's shared-memory regions, each 128-byte aligned,
// and the per-sample strides of the first three: rows [G][V][cols] T; flags
// [G][V][cols] bytes (the ext mask, or the prng flags, [1][V][cols] in
// prng_shared); angle rows [G][V][4 aq] f32; the query slice [G][cols + 4
// aq] f32; every rank's partial scores [S][G][V] f32; the weights and K5's
// alpha, each [G][V] f32; and K4's candidate views [G][MC] int32.  The
// total has 128 bytes to align the base.  ops/cuda/pano_fused.py::
// pano_smem computes the same.
struct Layout {
  int rs, fs, ls, flags, loc, vec, recv, wts, alpha, cv, total;
};

__host__ __device__ inline Layout layout(int S, int G, int V, int cols, int aq, int MC, int elem) {
  Layout l;
  l.rs = align128(V * cols * elem);
  l.fs = align128(V * cols);
  l.ls = align128(V * aq * 16);
  l.flags = G * l.rs;
  l.loc = l.flags + G * l.fs;
  l.vec = l.loc + G * l.ls;
  l.recv = l.vec + align128(G * (cols + 4 * aq) * 4);
  l.wts = l.recv + align128(S * G * V * 4);
  l.alpha = l.wts + align128(G * V * 4);
  l.cv = l.alpha + align128(G * V * 4);
  l.total = l.cv + align128(G * MC * 4) + 128;
  return l;
}

// The launch geometry (ops/cuda/pano_fused.py::pano_plan).  S: the largest
// of 8, 4, 2, 1 that divides the row's 16-byte chunks.  G: of 8, 4, 2, 1
// (those whose shared memory fits), the one whose grid takes the fewest
// waves of clusters, and of those the smallest; an SM is taken to hold
// min(MIN_BLOCKS, what its shared memory holds) blocks, and the card 90% of
// the clusters those would make (cudaOccupancyMaxActiveClusters read 91-94%
// at the path's shapes).  Returns false where no G fits.
struct Plan {
  int S, G, groups, cols, aq, smem;
};

bool make_plan(int B, int V, int D, int A, int MC, int elem, Plan* p) {
  const int N = 16 / elem;
  if (B < 1 || V < 1 || D < N || D % N || A % 4 || MC < 0) return false;
  const int chunks = D / N;
  int S = MAX_SPLIT;
  while (chunks % S) S /= 2;
  const int cols = chunks / S * N, aq = (A / 4 + S - 1) / S;
  bool found = false;
  long best_waves = 0;
  for (int G = 1; G <= SHARED_GROUP; G *= 2) {
    const int smem = layout(S, G, V, cols, aq, MC, elem).total;
    if (smem > SMEM_LIMIT) break;
    const long per_sm = std::min<long>(MIN_BLOCKS, SM_SMEM / (smem + BLOCK_RESERVE));
    const long clusters = std::max<long>(1, SMS * per_sm / S * 9 / 10);
    const long groups = (B + G - 1) / G, waves = (groups + clusters - 1) / clusters;
    if (!found || waves < best_waves) {
      *p = Plan{S, G, (int)groups, cols, aq, smem};
      best_waves = waves;
      found = true;
    }
  }
  return found;
}

// The box width (elements) of a row slice's TMA copy: the widest divisor of
// cols of at most MAX_BOX elements that is a multiple of `unit` (16 bytes).
int box_width(int cols, int unit) {
  int w = std::min(cols, MAX_BOX) / unit * unit;
  while (cols % w) w -= unit;
  return w;
}

// A 3D tensor map over a [rows, D] row-major table seen as {w, D / w, rows}:
// a box {w, cols / w, V} lands in shared memory as the [V][cols] slice.
bool encode_slices(EncodeTiled enc, CUtensorMap* m, CUtensorMapDataType type, int elem,
                   const void* p, int D, int rows, int w, int cols, int V) {
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)(D / w), (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)w * elem, (cuuint64_t)D * elem};
  const cuuint32_t box[3] = {(cuuint32_t)w, (cuuint32_t)(cols / w), (cuuint32_t)V};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(m, type, 3, const_cast<void*>(p), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory to this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One 16-byte chunk of f32 values that are values of T, stored as T.
template <typename T>
__device__ __forceinline__ uint4 narrow(const float* x) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * p], x[2 * p + 1]);
      w[p] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Four consecutive elements of T in shared memory, widened to f32.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}

// Grid (S, groups), clusters of S blocks along x: block (rank, y) owns
// samples b0 = y G .. b0 + G - 1 (those < B), image columns [rank cols,
// (rank + 1) cols) and angle columns [4 rank aq, 4 (rank + 1) aq) of [0, A).
// row_mid and mask_mid: the boxes' middle extent (cols / box width) in the
// rows' and the ext mask's tensor maps; mask_mid = 0 stages the ext mask
// by cp.async (slices of under 16 flags).
template <typename T, bool BWD, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pano_kernel(const __grid_constant__ CUtensorMap rows_map,
            const __grid_constant__ CUtensorMap mask_map,
            const __grid_constant__ CUtensorMap loc_map, const int64_t* __restrict__ nodes,
            const int64_t* __restrict__ views, const int64_t* __restrict__ cand_view,
            const float* __restrict__ vec, const float* __restrict__ alpha_in,
            float* __restrict__ out, float* __restrict__ alpha_out, T* __restrict__ cand, int B,
            int V, int D, int A, int MC, int G, int cols, int aq, int row_mid, int mask_mid,
            DropSpec drop) {
  constexpr int N = Chunk<T>::N;  // elements a 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t landed;  // the bytes of the block's loads
  cg::cluster_group cluster = cg::this_cluster();
  // this block has started: with the wait before step 4's stores, no block
  // writes into another that has not
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int S = gridDim.x, rank = blockIdx.x, b0 = blockIdx.y * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = D + A, c0 = rank * cols, a0 = 4 * rank * aq;
  const int na = max(0, min(A - a0, 4 * aq));  // this block's angle columns (0 allowed)
  const int cpr = cols / N, vw = cols + 4 * aq;
  const int live = min(G, B - b0), nrows = live * V;  // the samples and rows that exist
  const bool mask_tma = MODE == DROP_EXT && mask_mid > 0;
  const Layout L = layout(S, G, V, cols, aq, BWD ? 0 : MC, sizeof(T));
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  unsigned char* rows_s = smem;
  unsigned char* flag_s = smem + L.flags;
  float* loc_s = reinterpret_cast<float*>(smem + L.loc);
  float* vec_s = reinterpret_cast<float*>(smem + L.vec);
  float* recv_s = reinterpret_cast<float*>(smem + L.recv);  // [S][G * V]
  float* wts_s = reinterpret_cast<float*>(smem + L.wts);
  float* alpha_s = reinterpret_cast<float*>(smem + L.alpha);
  int* cv_s = reinterpret_cast<int*>(smem + L.cv);
  const uint32_t bar = smem_u32(&landed);

  // 0.-1. thread 0: the barrier that counts the loads' bytes, then every
  //    load of the block in flight before any arithmetic: per sample one TMA
  //    box each of its rows' slice, its ext flags and its angle rows, and
  //    two bulk copies of its query slice (samples past B are not loaded:
  //    nothing of theirs is written out)
  if (tid == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint32_t per_sample = V * cols * sizeof(T) + (mask_tma ? V * cols : 0) +
                                (na ? V * aq * 16 : 0) + (cols + na) * 4;
    mbar_expect_tx(bar, live * per_sample);
    for (int g = 0; g < live; ++g) {
      const float* row = vec + (size_t)(b0 + g) * F;
      bulk_load(vec_s + g * vw, row + c0, cols * 4, bar);
      if (na) bulk_load(vec_s + g * vw + cols, row + D + a0, na * 4, bar);
      if (mask_tma)
        tma_3d(smem_u32(flag_s + g * L.fs), &mask_map, 0, rank * mask_mid, (b0 + g) * V, bar);
    }
    for (int g = 0; g < live; ++g) {
      tma_3d(smem_u32(rows_s + g * L.rs), &rows_map, 0, rank * row_mid, (int)nodes[b0 + g] * V,
             bar);
      if (na) tma_2d(smem_u32(loc_s + g * L.ls / 4), &loc_map, a0, (int)views[b0 + g] * V, bar);
    }
  }
  if (!BWD)
    for (int i = tid; i < live * MC; i += THREADS) cv_s[i] = (int)cand_view[(size_t)b0 * MC + i];
  if (MODE == DROP_EXT && !mask_tma)  // slices of under 16 flags: 8 or 4 bytes a copy
    for (int r = warp; r < nrows; r += NWARPS) {
      const int g = r / V, v = r - g * V;
      for (int k = lane; k < cpr; k += 32)
        cp_async_n<N>(flag_s + g * L.fs + v * cols + k * N,
                      drop.mask + ((size_t)(b0 + g) * V + v) * D + c0 + k * N, true);
    }
  if (BWD)
    for (int i = tid; i < nrows; i += THREADS)
      cp_async_n<4>(alpha_s + i, alpha_in + (size_t)b0 * V + i, true);

  // 2. the prng flags while the bytes are in flight: one draw per element
  //    of the slice, for all G samples in prng_shared and per sample in
  //    prng; the counter is the element's index in the sample's whole [V,
  //    D] block
  if (MODE == DROP_PRNG || MODE == DROP_PRNG_SHARED) {
    const int masks = MODE == DROP_PRNG ? live : 1, q4 = cols / 4;
    for (int r = warp; r < masks * V; r += NWARPS) {
      const int g = r / V, v = r - g * V;
      const uint64_t s =
          (uint64_t)drop.seeds[MODE == DROP_PRNG ? b0 + g : b0 - b0 % SHARED_GROUP];
      const uint32_t e4 = (uint32_t)(((size_t)v * D + c0) / 4);
      uint32_t* f = reinterpret_cast<uint32_t*>(flag_s + g * L.fs + v * cols);
      for (int q = lane; q < q4; q += 32)
        f[q] = philox_keep4(e4 + q, (uint32_t)s, (uint32_t)(s >> 32), drop.thr);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);

  // 3. K4: the candidate rows, raw, from shared memory (a 16-byte chunk a
  //    thread at a time), before anything is dropped
  if (!BWD) {
    for (int i = tid; i < live * MC * cpr; i += THREADS) {
      const int gj = i / cpr, k = i - gj * cpr, g = gj / MC;
      *reinterpret_cast<uint4*>(cand + ((size_t)b0 * MC + gj) * D + c0 + k * N) =
          *reinterpret_cast<const uint4*>(rows_s + g * L.rs +
                                          (cv_s[gj] * cols + k * N) * sizeof(T));
    }
    if (MODE != DROP_NONE) __syncthreads();  // the raw rows are read: drop them in place
  }

  // 4. the block's partial scores: tpr threads a (sample, view) row, each
  //    over every tpr-th chunk (rows rotated so that the 8 threads of a
  //    16-byte load phase hit distinct banks), summed over the tpr threads
  //    in shuffles and sent to every rank of the cluster.  Each element is
  //    dropped once, here, and stored back as T.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  int tpr = 32;
  while (tpr > 1 && nrows * tpr > THREADS) tpr >>= 1;
  const int pass = THREADS / tpr, part = tid & (tpr - 1), spread = tpr < 8 ? 8 / tpr : 1;
  const float keep = drop.keep, inv_keep = 1.f / drop.keep;
  for (int r0 = 0; r0 < nrows; r0 += pass) {
    const int r = r0 + tid / tpr;
    float acc = 0.f;
    if (r < nrows) {
      const int g = r / V, v = r - g * V;
      T* row = reinterpret_cast<T*>(rows_s + g * L.rs) + v * cols;
      const float* q = vec_s + g * vw;
      const unsigned char* fl = flag_s + (MODE == DROP_PRNG_SHARED ? 0 : g * L.fs) + v * cols;
      const int rot = (r % spread) * tpr % cpr;
      for (int i = part; i < cpr; i += tpr) {
        const int k = i + rot < cpr ? i + rot : i + rot - cpr;
        const uint4 u = *reinterpret_cast<const uint4*>(row + k * N);
        float x[N];
        if (MODE == DROP_NONE) {
          widen<T>(u, x);
        } else {
          uint32_t kw[N / 4];
#pragma unroll
          for (int t = 0; t < N / 4; ++t)
            kw[t] = reinterpret_cast<const uint32_t*>(fl + k * N)[t];
          dropped_words<T, 4>(reinterpret_cast<const uint32_t*>(&u), kw, keep, inv_keep, x);
          *reinterpret_cast<uint4*>(row + k * N) = narrow<T>(x);
        }
#pragma unroll
        for (int e = 0; e < N; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(q + k * N + e);
          acc += x[e] * qq.x;
          acc += x[e + 1] * qq.y;
          acc += x[e + 2] * qq.z;
          acc += x[e + 3] * qq.w;
        }
      }
      const float* lr = loc_s + g * L.ls / 4 + v * 4 * aq;
      for (int a = part; a < na; a += tpr) acc += lr[a] * q[cols + a];
    }
    for (int o = tpr / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (part == 0 && r < nrows)
      for (int dst = 0; dst < S; ++dst)
        cluster.map_shared_rank(recv_s, dst)[rank * G * V + r] = acc;
  }

  // 5. the scores, every rank's partials summed in rank order, and the
  //    weights, a warp a sample: softmax (K4) or its VJP (K5)
  cluster.sync();  // every partial has landed; no block touches another after this
  if (warp < live) {
    const int b = b0 + warp;
    float* s = wts_s + warp * V;
    for (int v = lane; v < V; v += 32) {
      float sum = 0.f;
      for (int src = 0; src < S; ++src) sum += recv_s[src * G * V + warp * V + v];
      s[v] = sum;
    }
    __syncwarp();
    if (!BWD) {
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, s[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int v = lane; v < V; v += 32) {
        const float e = expf(s[v] - m);
        s[v] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int v = lane; v < V; v += 32) {
        const float a = s[v] / sum;
        s[v] = a;
        if (rank == 0) alpha_out[(size_t)b * V + v] = a;
      }
    } else {
      const float* al = alpha_s + warp * V;
      float inner = 0.f;
      for (int v = lane; v < V; v += 32) inner += al[v] * s[v];
      inner = warp_sum(inner);
      for (int v = lane; v < V; v += 32) s[v] = al[v] * (s[v] - inner);
    }
  }
  __syncthreads();

  // 6. the weighted sums: lane l of a warp owns column quad l % 16 of the
  //    warp's 16 (image or angle columns of one sample) over half l / 16 of
  //    the views; the halves meet in one shuffle, so every output element
  //    is the same sum in the same order, written once
  const int per = cols / 4 + na / 4, half = (V + 1) / 2;
  for (int i0 = warp * 16; i0 < live * per; i0 += NWARPS * 16) {
    const int i = i0 + (lane & 15), h = lane >> 4;
    const bool mine = i < live * per;
    const int g = mine ? i / per : 0, k = i - g * per;
    const float* w = wts_s + g * V;
    const int v0 = h * half, v1 = min(V, v0 + half);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine && k < cols / 4) {
      const T* col = reinterpret_cast<const T*>(rows_s + g * L.rs) + 4 * k;
      for (int v = v0; v < v1; ++v) fma4(acc, w[v], load4(col + v * cols));
    } else if (mine) {
      const float* col = loc_s + g * L.ls / 4 + 4 * (k - cols / 4);
      for (int v = v0; v < v1; ++v)
        fma4(acc, w[v], *reinterpret_cast<const float4*>(col + v * 4 * aq));
    }
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 16);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 16);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, 16);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, 16);
    if (mine && h == 0) {
      float* o = out + (size_t)(b0 + g) * F;
      *reinterpret_cast<float4*>(k < cols / 4 ? o + c0 + 4 * k : o + D + a0 + 4 * (k - cols / 4)) =
          acc;
    }
  }
}

template <typename T, bool BWD>
using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap, const int64_t*,
                          const int64_t*, const int64_t*, const float*, const float*, float*,
                          float*, T*, int, int, int, int, int, int, int, int, int, int, DropSpec);

template <typename T, bool BWD>
KernelFn<T, BWD> kernel_for(int mode) {
  return mode == DROP_EXT           ? pano_kernel<T, BWD, DROP_EXT>
         : mode == DROP_PRNG        ? pano_kernel<T, BWD, DROP_PRNG>
         : mode == DROP_PRNG_SHARED ? pano_kernel<T, BWD, DROP_PRNG_SHARED>
                                    : pano_kernel<T, BWD, DROP_NONE>;
}

// The launch configuration of a plan: grid (S, groups), clusters of S.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void configure(const Plan& p, cudaStream_t stream, Config* c) {
  c->cfg = {};
  c->cfg.gridDim = dim3(p.S, p.groups);
  c->cfg.blockDim = dim3(THREADS);
  c->cfg.dynamicSmemBytes = p.smem;
  c->cfg.stream = stream;
  c->attr[0].id = cudaLaunchAttributeClusterDimension;
  c->attr[0].val.clusterDim.x = p.S;
  c->attr[0].val.clusterDim.y = 1;
  c->attr[0].val.clusterDim.z = 1;
  c->cfg.attrs = c->attr;
  c->cfg.numAttrs = 1;
}

template <typename T, bool BWD>
cudaError_t launch(const void* nodes, const void* views, const void* cand_view,
                   const void* features, const void* loc_embed, const void* vec,
                   const void* alpha_in, void* out, void* alpha_out, void* cand, int B, int V,
                   int D, int A, int MC, DropSpec drop, cudaStream_t stream) {
  constexpr int elem = sizeof(T), N = Chunk<T>::N;
  Plan p;
  if (!make_plan(B, V, D, A, BWD ? 0 : MC, elem, &p)) return cudaErrorInvalidValue;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  const CUtensorMapDataType type = std::is_same<T, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int w = box_width(p.cols, N), wm = p.cols % 16 ? 0 : box_width(p.cols, 16);
  CUtensorMap rows_map, mask_map, loc_map;
  if (!encode_slices(enc, &rows_map, type, elem, features, D, ROWS_OUTER, w, p.cols, V))
    return cudaErrorInvalidValue;
  mask_map = rows_map;  // unused unless the ext mask goes by TMA
  const bool mask_tma = drop.mode == DROP_EXT && wm > 0;
  if (mask_tma && !encode_slices(enc, &mask_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, drop.mask, D,
                                 B * V, wm, p.cols, V))
    return cudaErrorInvalidValue;
  // loc_embed [views, V, A] f32 as [rows, A], boxes {4 aq, V}; the rows past
  // the table are never asked for
  const cuuint64_t ldims[2] = {(cuuint64_t)A, (cuuint64_t)ROWS_OUTER};
  const cuuint64_t lstrides[1] = {(cuuint64_t)A * 4};
  const cuuint32_t lbox[2] = {(cuuint32_t)(4 * p.aq), (cuuint32_t)V}, one[2] = {1, 1};
  if (enc(&loc_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(loc_embed), ldims,
          lstrides, lbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const KernelFn<T, BWD> kernel = kernel_for<T, BWD>(drop.mode);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  Config c;
  configure(p, stream, &c);
  return cudaLaunchKernelEx(
      &c.cfg, kernel, rows_map, mask_map, loc_map, static_cast<const int64_t*>(nodes),
      static_cast<const int64_t*>(views), static_cast<const int64_t*>(cand_view),
      static_cast<const float*>(vec), static_cast<const float*>(alpha_in),
      static_cast<float*>(out), static_cast<float*>(alpha_out), static_cast<T*>(cand), B, V, D,
      A, MC, p.G, p.cols, p.aq, p.cols / w, mask_tma ? p.cols / wm : 0, drop);
}

DropSpec drop_spec(int mode, const void* mask, const void* seeds, float keep, unsigned thr) {
  return DropSpec{mode, static_cast<const bool*>(mask), static_cast<const int64_t*>(seeds), keep,
                  thr};
}

}  // namespace

// K4.  nodes, views [B] and cand_view [B, MC] int64; features [N, V, D] in
// the table dtype; loc_embed [36, V, A] f32; tv [B, D + A] f32; mode 0
// (none), 1 (mask: bool [B, V, D]), 2 (seeds: int64 [B]) or 3 (seeds, one
// mask per group of 8 rows), keep = 1 - rate in the table dtype and thr
// the keep threshold of the prng modes.  Writes vis [B, D + A] f32, alpha
// [B, V] f32 and cand [B, MC, D] in the table dtype.  D * sizeof(T) and A
// * 4 must be multiples of 16, every array 16-byte aligned.
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

// The plan K4 (MC > 0) or K5 (MC = 0) launches with: out[0..5] = S, G,
// groups, cols, aq, shared-memory bytes, and out[6] the clusters of that
// launch the card can hold at once (cudaOccupancyMaxActiveClusters).
// Returns cudaErrorInvalidValue where no plan fits.
extern "C" int pano_plan_query(int B, int V, int D, int A, int MC, int dtype, int* out) {
  Plan p;
  const int elem = dtype == DTYPE_BF16 ? 2 : 4;
  if (!make_plan(B, V, D, A, MC, elem, &p)) return cudaErrorInvalidValue;
  cudaError_t e;
  int clusters = 0;
  Config c;
  configure(p, nullptr, &c);
  if (dtype == DTYPE_BF16) {
    const auto k = kernel_for<__nv_bfloat16, false>(DROP_EXT);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, k, &c.cfg);
  } else {
    const auto k = kernel_for<float, false>(DROP_EXT);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, k, &c.cfg);
  }
  const int vals[7] = {p.S, p.G, p.groups, p.cols, p.aq, p.smem, clusters};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return e;
}
