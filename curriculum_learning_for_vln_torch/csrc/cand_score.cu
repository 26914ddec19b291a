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
//                                                       (j = 0..MC-1 in order)
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
// Backward (K7).  The first design (one block per sample, 64 blocks; each
// thread walking the 16 candidate rows of a 16-byte column chunk one
// dependent load at a time through common.cuh's load_dropped, with its IEEE
// division per element and every row of a prng_shared group drawing the
// group's bits again) took 0.0083 ms of device time in mode none and
// 0.0225-0.0232 in the masked modes at the path's shapes in bf16 on the
// H100, against 0.0045 for torch.einsum('bk,bkd->bd').  Now K6's layout:
// one block per (slice of 128 image columns, group g of 8 samples) — 16 x
// 8 = 128 blocks at D = 2048, B = 64, one wave — and warp w sums sample 8g
// + w's rows; lane l owns image columns 4l..4l+3 of the slice, and lanes l
// < ang_quads also four angle columns (the 128 angle columns spread over
// the 16 slices, 2 lanes a slice: a 17th slice of blocks made a second
// wave).  Every lane puts all 16 of its candidate rows (8 bytes a row in
// bf16, 16 in f32), angle rows and ext flag words in flight at once with
// cp.async into its own shared-memory slots: held in registers instead,
// the compiler interleaved the loads with their FMAs in some modes, a few
// in flight at a time (mode none 0.0062 ms, slower than prng_shared).
// The weights w_j load in one round trip (valid and d_logits together).
// prng_shared: the block draws its slice's keep flags of the 16 rows once
// (512 Philox calls, 2 a thread) into shared memory, and after one barrier
// all 8 warps apply them; prng: each lane draws its own (one call a row),
// while its rows are in flight.  A kept element is x / keep by K6's
// reciprocal and FMA correction (div_by), so the bits are the division's.
// Each element's sum runs over j = 0..MC-1 in order in one thread, with no
// atomics: the same bits every run.  The mask mode is a template
// parameter; warps past B and lanes past the row's end copy zeros and
// write nothing.  The launch geometry is ops/cuda/cand_score.py::
// cand_score_bwd_plan's.
#include "common.cuh"

namespace {

constexpr int FWD_THREADS = 32 * SHARED_GROUP;  // one warp per sample of a group
constexpr int PASS = 2048;  // row elements a warp has in flight at once
constexpr int BWD_THREADS = 32 * SHARED_GROUP;  // K7: one warp per sample of a group
constexpr int BWD_COLS = 128;  // K7: columns of a block's slice, 4 a lane
constexpr int ROWS = 16;       // K7: candidate rows a lane has in flight at once
constexpr int GROUP_ROWS = 4;  // K7: rows of one cp.async group

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

// NW words of T (N = NW * 4 / sizeof(T) elements) dropped by their keep
// flags kw (a byte per element, N / 4 words) and widened to f32:
// round_to<T>(x / keep) where kept, 0 where not.  The flags mask the raw
// bits first (0 / keep is 0), and bf16 pairs are rounded together.
template <typename T, int NW>
__device__ __forceinline__ void dropped_words(const uint32_t* w, const uint32_t* kw, float keep,
                                              float inv, float* x) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int e = 0; e < NW; ++e)
      x[e] = div_by((kw[e >> 2] >> (8 * (e & 3))) & 0xffu ? __uint_as_float(w[e]) : 0.f, keep,
                    inv);
  } else {
#pragma unroll
    for (int p = 0; p < NW; ++p) {
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

// NW words of T widened to f32.
template <typename T, int NW>
__device__ __forceinline__ void widen_words(const uint32_t* w, float* x) {
#pragma unroll
  for (int p = 0; p < NW; ++p) {
    if constexpr (std::is_same<T, float>::value) {
      x[p] = __uint_as_float(w[p]);
    } else {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[p]));
      x[2 * p] = f.x;
      x[2 * p + 1] = f.y;
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
        dropped_words<T, 4>(reinterpret_cast<const uint32_t*>(&v[i]), kw[i], drop.keep,
                            inv_keep, x);
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

// Four elements of T: 8 bytes in bf16, 16 in f32 (K7's load per lane and row).
template <typename T>
struct Quad {
  using type = uint2;
};
template <>
struct Quad<float> {
  using type = uint4;
};

// 4, 8 or 16 bytes from device to shared memory without registers
// (cp.async); zeros where !full (the source is then not read).
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool full) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(full ? N : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (0..3) of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_groups(int n) {
  if (n >= 3)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// K7's shared memory: every lane's 16 rows of image columns [ROWS][8][32],
// of angle columns [ROWS][8][ang_quads], and ext flags [ROWS][8][32].
template <typename T>
size_t bwd_smem(int ang_quads) {
  return (size_t)ROWS * SHARED_GROUP * (32 + ang_quads) * sizeof(typename Quad<T>::type) +
         (size_t)ROWS * BWD_THREADS * 4;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(BWD_THREADS)
cand_score_bwd_kernel(const T* __restrict__ img, const T* __restrict__ ang,
                      const bool* __restrict__ valid, const float* __restrict__ d_logits,
                      float* __restrict__ d_q, int B, int MC, int D, int A, int ang_quads,
                      DropSpec drop) {
  using Q = typename Quad<T>::type;
  constexpr int NW = sizeof(Q) / 4;  // data words per load
  __shared__ uint32_t keep_s[ROWS * 32];  // prng_shared: the group's flags of 16 rows x 128 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Q* rows_s = reinterpret_cast<Q*>(smem_raw);
  Q* ang_s = rows_s + ROWS * BWD_THREADS;
  uint32_t* flag_s = reinterpret_cast<uint32_t*>(ang_s + ROWS * SHARED_GROUP * ang_quads);
  const int g = blockIdx.y, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = g * SHARED_GROUP + w;
  const bool live = b < B;
  const int bb = live ? b : g * SHARED_GROUP;  // a sample that exists, for the addresses
  // this lane's four image columns, and its four angle columns (lanes < ang_quads)
  const int c = blockIdx.x * BWD_COLS + 4 * lane;
  const int a = (blockIdx.x * ang_quads + lane) * 4;
  const bool col = live && c < D, acol = live && lane < ang_quads && a < A;
  const T* irow = img + (size_t)bb * MC * D + min(c, D - 4);
  const T* arow = ang + (size_t)bb * MC * A + min(a, A - 4);
  uint32_t k0 = 0, k1 = 0;
  if (MODE == DROP_PRNG || MODE == DROP_PRNG_SHARED) {
    const uint64_t s = (uint64_t)drop.seeds[MODE == DROP_PRNG ? bb : g * SHARED_GROUP];
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }
  const float inv_keep = 1.f / drop.keep;

  float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < MC; j0 += ROWS) {
    // every row of the lane (and its ext flags) in flight at once through
    // cp.async, each into the lane's own slots: no register holds them and
    // no compiler schedule serialises them.  Four groups of 4 rows, so that
    // a group's masks and FMAs run while the later groups' copies land.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool in = j0 + r < MC;
      const int j = min(j0 + r, MC - 1);
      cp_async_n<sizeof(Q)>(rows_s + r * BWD_THREADS + threadIdx.x, irow + (size_t)j * D,
                            col && in);
      if (lane < ang_quads)
        cp_async_n<sizeof(Q)>(ang_s + (r * SHARED_GROUP + w) * ang_quads + lane,
                              arow + (size_t)j * A, acol && in);
      if (MODE == DROP_EXT)
        cp_async_n<4>(flag_s + r * BWD_THREADS + threadIdx.x,
                      drop.mask + ((size_t)bb * MC + j) * D + min(c, D - 4), col && in);
      if (r % GROUP_ROWS == GROUP_ROWS - 1) cp_async_commit();
    }
    // the weights of rows j0.. in lanes 0..15: both loads at once (one
    // round trip), and first used at the first FMA, so that the Philox
    // draws below do not wait for them
    bool ok = false;
    float dl = 0.f;
    if (lane < ROWS && j0 + lane < MC) {
      ok = valid[(size_t)bb * MC + j0 + lane];
      dl = __ldg(d_logits + (size_t)bb * (MC + 1) + j0 + lane);
    }
    if (MODE == DROP_PRNG_SHARED) {
      if (j0 > 0) __syncthreads();  // the last rows' flags are read
      for (int i = threadIdx.x; i < ROWS * 32; i += BWD_THREADS) {
        const int r = i / 32, cc = blockIdx.x * BWD_COLS + 4 * (i % 32);
        if (j0 + r < MC && cc < D)
          keep_s[i] = philox_keep4((uint32_t)(((j0 + r) * D + cc) / 4), k0, k1, drop.thr);
      }
      __syncthreads();  // the group's flags are drawn
    }
    // d_q[c..c+3] += w_j x_j, j in order
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += GROUP_ROWS) {
      uint32_t kw[GROUP_ROWS];
#pragma unroll
      for (int i = 0; i < GROUP_ROWS; ++i) {
        const int r = r0 + i;
        if (MODE == DROP_PRNG)
          kw[i] = col && j0 + r < MC
                      ? philox_keep4((uint32_t)(((j0 + r) * D + c) / 4), k0, k1, drop.thr)
                      : 0u;
      }
      cp_async_wait_groups((ROWS - r0) / GROUP_ROWS - 1);  // this group's copies (its own)
#pragma unroll
      for (int i = 0; i < GROUP_ROWS; ++i) {
        const int r = r0 + i;
        if (MODE == DROP_PRNG_SHARED) kw[i] = keep_s[r * 32 + lane];
        if (MODE == DROP_EXT) kw[i] = flag_s[r * BWD_THREADS + threadIdx.x];
        const float wj = __shfl_sync(0xffffffffu, ok ? dl : 0.f, r);
        const Q v = rows_s[r * BWD_THREADS + threadIdx.x];
        float x[4], y[4] = {0.f, 0.f, 0.f, 0.f};
        if (MODE == DROP_NONE)
          widen_words<T, NW>(reinterpret_cast<const uint32_t*>(&v), x);
        else
          dropped_words<T, NW>(reinterpret_cast<const uint32_t*>(&v), &kw[i], drop.keep,
                               inv_keep, x);
        if (lane < ang_quads) {
          const Q u = ang_s[(r * SHARED_GROUP + w) * ang_quads + lane];
          widen_words<T, NW>(reinterpret_cast<const uint32_t*>(&u), y);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] += wj * x[e];
          acc_a[e] += wj * y[e];
        }
      }
    }
  }
  float* o = d_q + (size_t)b * (D + A);
  if (col) *reinterpret_cast<float4*>(o + c) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (acol)
    *reinterpret_cast<float4*>(o + D + a) = make_float4(acc_a[0], acc_a[1], acc_a[2], acc_a[3]);
}

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
  // ops/cuda/cand_score.py::cand_score_bwd_plan: the angle columns spread
  // over the image slices, ang_quads quads of 4 a slice
  const int slices = (D + BWD_COLS - 1) / BWD_COLS;
  const int ang_quads = (A / 4 + slices - 1) / slices;
  if (D % 4 || A % 4 || ang_quads > 32) return cudaErrorInvalidValue;
  const dim3 grid(slices, (B + SHARED_GROUP - 1) / SHARED_GROUP);
  auto kernel = drop.mode == DROP_EXT           ? cand_score_bwd_kernel<T, DROP_EXT>
                : drop.mode == DROP_PRNG        ? cand_score_bwd_kernel<T, DROP_PRNG>
                : drop.mode == DROP_PRNG_SHARED ? cand_score_bwd_kernel<T, DROP_PRNG_SHARED>
                                                : cand_score_bwd_kernel<T, DROP_NONE>;
  const size_t smem = bwd_smem<T>(ang_quads);
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(ang), static_cast<const bool*>(valid),
      static_cast<const float*>(d_logits), static_cast<float*>(d_q), B, MC, D, A, ang_quads,
      drop);
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
