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
// Forward (K3, and K1 with residuals): one C call, two launches
// (ops/cuda/lstm_scan.py::lstm_scan_fwd_plan gives their geometry).
// 1. gates_x: gx = x . W_ih + b at the valid steps only (numbered on the
//    device, as K2's GEMMs do), on the tensor cores through a 3-stage
//    cp.async ring: bf16 operands on mma.sync m16n8k16 (exact products,
//    f32 sums, as JAX's f32-accumulated bf16 dot); f32 on m16n8k8 in TF32
//    with both operands split.  This half of the work has no recurrence,
//    so it runs across the whole card.
// 2. recurrence: clusters of CL = 8 blocks, each cluster owning R = 8
//    batch rows.  Block `rank` owns hidden units [rank*U, (rank+1)*U), U =
//    H / 8, and their G4 = 4U gate columns of W_hh.  The step's product is
//    taken transposed, gates^T[c][r] = sum_k W_hh[k][c] h[r][k] (M = G4, N =
//    R, K = H), on mma.sync m16n8k8 in TF32: warp w holds the A fragments
//    of one m-tile, 16 columns = the four gates of units 4w..4w+3, in
//    registers for the whole walk; h (f32) is split into TF32 halves, a
//    bf16 W_hh is exact in TF32 (two MMAs a product; f32 splits W_hh too:
//    three, its low halves read from shared memory).  The warp then owns
//    the 32 cells of those units and R rows, one a lane: it gathers each
//    cell's four gates through a warp-private tile, adds gx (brought in by
//    cp.async two steps ahead: it does not depend on the carries), and
//    updates (h, c) in f32 registers.  No block barrier and no cluster
//    barrier a step: each warp sends its units' new h to every block of the
//    cluster by st.async, counted on the receiver's mbarrier, and a warp
//    waits only for the H * R * 4 bytes of the next h.  A cluster loops
//    only to the longest length of its rows (steps past it change nothing
//    and output 0).
//    K1 also writes the carries (h, c) before each step, time-major and
//    indexed by absolute t as _train_kernel does (the carried state at a
//    padded step), and overwrites gx in place with each valid step's full
//    gate pre-activations x . W_ih + b + h . W_hh: the backward reads them
//    instead of recomputing both products.
//
// Backward (K2): one C call, three launches.  The first design (a
// transposed W_hh slice in shared memory and a SIMT loop of 128 dependent
// shared-memory loads a thread for the step's product; then SIMT GEMMs
// that walked all B*L padded rows in 16-row chunks, and a bias sum) took
// 0.658 ms of device time at the 11-20-token mix and 1.522 ms at 17-80
// tokens in bf16 on the H100, against 0.220 and 0.752 ms for
// torch.autograd.grad through cuDNN's packed nn.LSTM: dw_gemm 0.340 /
// 0.812 ms, dx_gemm 0.173 / 0.177, the walk 0.143 / 0.530 (6.5 µs a step).
// 1. bwd_recurrence: the reverse walk on the forward's cluster layout
//    (6.5 µs a step before, 2.4 µs now at 17-80 tokens).  Block `rank`
//    holds its G4 = 4U gate columns of W_hh as tensor-core A fragments,
//    each warp its own in registers for the whole walk; thread (r, u)
//    carries (dh, dc) of its row and unit and forms da of its four columns
//    from the saved pre-activations and c_prev, which cp.async brings two
//    steps ahead (they do not depend on the carries).  The step's partial
//    dh_prev = da . W_hh^T over the block's columns runs on the tensor
//    cores (mma.sync m16n8k8 in split TF32, below): M = the H units, N =
//    the R = 8 rows, K = G4.  More independent SIMT accumulators would not
//    have cut the 262,144 FMAs a block a step that the SIMT loop issued;
//    the tensor cores take them in 64 MMAs a warp (96 in f32), issued term
//    by term so that back-to-back MMAs never wait on each other.  Each
//    partial goes to the block owning its unit by st.async, which counts
//    its bytes on that block's mbarrier; the owner waits for the bytes of
//    all 8 blocks (a wait that never completes traps after ~2 s) and sums
//    them in rank order.  No cluster barrier a step: a block waits only for
//    the data it reads, and stores its da and starts its loads while the
//    partials travel.  It writes da [B, L, 4H] at valid steps only, and
//    the cluster's column sums of da.
// 2. dx_gemm: d_xs = DA . W_ih^T at the valid steps, in the dtype of xs, and
//    0 at the padded steps (the grid's later blocks).
// 3. dw_gemm: dW_ih = X^T . DA, dW_hh = Hprev^T . DA and db.  Each output
//    tile is reduced by a cluster of 8 blocks, one a contiguous eighth of
//    the valid steps (512 blocks, two at a time an SM); the eighths'
//    partial tiles are summed in rank order through distributed shared
//    memory.  db sums the recurrence's cluster column sums in order.
// The GEMMs visit only the valid steps: they number them row by row (row
// b's valid steps are the contiguous run t < len[b]), every block taking
// the rows' starts from lengths on the device, so no host synchronisation
// reads them.  K2's stream their operands through a 3-stage cp.async ring
// into mma.sync m16n8k8 in TF32.  A plain TF32 product (~1e-3 relative)
// fails the backward's tolerances, so an f32 operand is split into two
// TF32 halves and a product takes three MMAs; a bf16 operand is exact in
// TF32 and takes two.  da is f32 in both dtypes, and is split everywhere:
// d_xs = da . W_ih^T in bf16 takes two MMAs, and rounds to bf16 once
// (scripts/torch_tf32_error.py measures the error of plain and split
// TF32).  No atomics anywhere: the gradients are the same from run to run.
//
// Bound on the H100: at the path's shapes (B = 64, L = 80, D = H = 256)
// the forward is ~5.4 GFLOP at most (2 x 5,120 steps x (D + H) x 4H) and
// ~10 MB of traffic without K1's residuals, a few µs at the card's peaks;
// the backward ~11 GFLOP and ~50 MB.  What bounds these designs is the
// serial chain of steps: per step one product over the block's W_hh
// slice, one cell update and one exchange within the cluster, on 64 of
// the card's 132 SMs at B = 64.  Both walks keep W_hh in registers and
// exchange by st.async; their input GEMMs visit the valid steps only.
//
// Semantics (lstm_scan.py:63-67, 264-286): step l reads t = L-1-l when
// reversed; a row with t >= len keeps its carry and outputs 0; gate order
// i, f, g, o; f32 accumulation and state; the backward walks the forward's
// steps in the opposite order, with dh_eff = dh + dout, and carries (dh,
// dc) through invalid steps unchanged.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;        // blocks per cluster: the hidden units are split 8 ways
constexpr int R = 8;         // batch rows per cluster
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Tensor cores in f32 accuracy: mma.sync m16n8k8 in TF32 with split operands.
// A TF32 operand keeps 10 of f32's 23 mantissa bits (the tensor core reads a
// register's upper 19 bits), a relative error of ~1e-3 a product, which the
// scans' f32 tolerances do not allow.  So an f32 operand x is split into
// hi = x with its low 13 mantissa bits cleared and lo = the same of x - hi
// (x = hi + lo up to ~2^-21 |x|), and a product takes three MMAs, lo.hi +
// hi.lo + hi.hi, into one f32 accumulator (lo.lo, ~2^-20, is left out).  A
// bf16 operand is exact in TF32 and is not split: its products take two.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_bits(float x) { return __float_as_uint(x) & 0xffffe000u; }

// The TF32 halves of x: hi, and lo (0 where the operand is not split).
template <bool SPLIT>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = SPLIT ? tf32_bits(x - __uint_as_float(hi)) : 0u;
}

// d += a . b on one tile: A 16 x 8 row-major, B 8 x 8 column-major, f32 D.
// Fragments (g = lane / 4, q = lane % 4): a = A[g][q], A[g+8][q], A[g][q+4],
// A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1], D[g+8][2q],
// D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory without registers (cp.async);
// zeros where !full (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The valid steps, in order: valid step v < starts[B] is step t = v -
// starts[b] of row b, where starts[b] = sum over b' < b of len[b'] (len
// clamped to [0, L]); the padded steps likewise, with b * L - starts[b].
// Every block computes starts in shared memory from lengths on the device:
// no host synchronisation reads them.
// ---------------------------------------------------------------------------
__device__ void valid_starts(const int64_t* __restrict__ lengths, int B, int L, int* starts) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      int n = 0;
      if (b < B) {
        const int64_t x = lengths[b];
        n = x < 0 ? 0 : x > L ? L : (int)x;
      }
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (b < B) starts[b] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) starts[B] = carry;
  }
  __syncthreads();
}

// The row b of valid (or, with pad, padded) step v: the b with s(b) <= v <
// s(b + 1), s(b) = starts[b] (pad: b * L - starts[b]).
__device__ __forceinline__ int row_of(const int* starts, int B, int L, int v, bool pad) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if ((pad ? mid * L - starts[mid] : starts[mid]) <= v)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The sequence row m = b * L + t of valid step v.
__device__ __forceinline__ int valid_row(const int* starts, int B, int L, int v) {
  const int b = row_of(starts, B, L, v, false);
  return b * L + v - starts[b];
}

// Shared-memory ints for starts [B + 1], rounded up to 16 bytes.
__host__ __device__ __forceinline__ int starts_ints(int B) { return (B + 4) & ~3; }

// The step's exchange: each block's partials land in the owning block's
// shared memory through st.async, which counts their bytes on that block's
// mbarrier; the owner waits for the bytes of all CL blocks.  No cluster
// barrier a step: a block waits only for the data it reads.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// The address of this block's shared-memory address p in block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(p), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the barrier's phase `phase` to complete, acquiring the cluster's
// writes counted on it; a step whose partials never land traps after ~2 s
// rather than hanging the card.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (!t0)
      t0 = t;
    else if (t - t0 > 2000000000ull)
      __trap();
  }
}

// 16 bytes (four f32) into block-shared memory of the cluster (st.async),
// counted on the receiver's mbarrier.
__device__ __forceinline__ void st_async4(uint32_t addr, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

// d += a . b on one tile of bf16 operands: A 16 x 16 row-major, B 16 x 8
// column-major, f32 D.  Fragments (g = lane / 4, q = lane % 4), two bf16 a
// register, the lower index in the low half: a = A[g][2q..], A[g+8][2q..],
// A[g][2q+8..], A[g+8][2q+8..]; b = B[2q..][g], B[2q+8..][g]; d as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[j]
// is matrix j's fragment, lane l holding rows 2(l % 4), 2(l % 4) + 1 of
// column l / 4 — from rows of B[k][n], a col-major mma B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// ---------------------------------------------------------------------------
// Forward 1. gates_x: gx[m, n] = sum_k x[m, k] W_ih[k, n] + b[n] at every
//    valid step m (N = 4H, K = D); the padded steps are not written (the
//    recurrence reads none, and K1's gate residual is read at valid steps
//    only).  Block (n tile, y) takes columns [n0, n0 + GX_TN) of valid
//    steps [y' GX_TM, +GX_TM) for y' = y, y + Y, ... below the valid steps'
//    count, which it computes from lengths on the device (no host
//    synchronisation reads them): Y = min(B * L / GX_TM, GX_YMAX) tiles,
//    the path's valid steps in one to three rounds, without the waves of
//    blocks that find no valid step that a grid sized for B * L launches.
//    K streams through a ring of GX_STAGES cp.async stages of 128 bytes a
//    row (x as [m][k], W_ih as its own [k][n] rows); four warps of 32 x 32
//    outputs.  bf16: mma.sync m16n8k16 on the bf16 operands, x's
//    fragments by 32-bit loads, W_ih's by ldmatrix.trans; f32: m16n8k8 in
//    TF32, both operands split, three MMAs a product issued term by term.
//    Row strides are padded so that every fragment load is conflict-free.
// ---------------------------------------------------------------------------
constexpr int GX_TM = 64, GX_TN = 64, GX_STAGES = 3, GX_THREADS = 128, GX_YMAX = 32;
constexpr int GX_BS = GX_TN + 8;  // row stride (elements) of a W_ih stage

template <typename T>
__host__ __device__ constexpr int gx_kc() {  // elements of a stage's 128-byte rows
  return 128 / sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int gx_as() {  // row stride (elements) of an x stage
  return gx_kc<T>() + (sizeof(T) == 4 ? 4 : 8);
}

template <typename T>
size_t gx_smem(int B) {
  return (size_t)(starts_ints(B) + GX_TM) * 4 +
         (size_t)GX_STAGES * (GX_TM * gx_as<T>() + gx_kc<T>() * GX_BS) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(GX_THREADS)
gates_x_kernel(const T* __restrict__ x, const int64_t* __restrict__ lengths,
               const T* __restrict__ w, const T* __restrict__ bias, float* __restrict__ gx, int B,
               int L, int D, int N) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int KC = gx_kc<T>(), AS = gx_as<T>(), EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* starts = reinterpret_cast<int*>(smem_raw);
  int* rows = starts + starts_ints(B);
  T* a_s = reinterpret_cast<T*>(rows + GX_TM);
  T* b_s = a_s + GX_STAGES * GX_TM * AS;
  const int tid = threadIdx.x;
  valid_starts(lengths, B, L, starts);
  const int Mv = starts[B];
  for (int v0 = blockIdx.y * GX_TM; v0 < Mv; v0 += gridDim.y * GX_TM) {
    __syncthreads();  // the previous tile's rows and stages are read by all
    if (tid < GX_TM) rows[tid] = v0 + tid < Mv ? valid_row(starts, B, L, v0 + tid) : -1;
    __syncthreads();
    const int n0 = blockIdx.x * GX_TN;

    auto load_stage = [&](int st, int k0) {
      T* as = a_s + st * GX_TM * AS;
      for (int i = tid; i < GX_TM * (KC / EPC); i += GX_THREADS) {
        const int r = i / (KC / EPC), kk = k0 + (i % (KC / EPC)) * EPC, m = rows[r];
        const bool ok = m >= 0 && kk < D;
        cp_async16(as + r * AS + kk - k0, x + (ok ? (size_t)m * D + kk : 0), ok);
      }
      T* bs = b_s + st * KC * GX_BS;
      for (int i = tid; i < KC * (GX_TN / EPC); i += GX_THREADS) {
        const int r = i / (GX_TN / EPC), c = (i % (GX_TN / EPC)) * EPC, kk = k0 + r;
        cp_async16(bs + r * GX_BS + c, w + (kk < D ? (size_t)kk * N + n0 + c : 0), kk < D);
      }
    };

    const int nk = (D + KC - 1) / KC;
#pragma unroll
    for (int st = 0; st < GX_STAGES - 1; ++st) {  // the ring's first stages
      if (st < nk) load_stage(st, st * KC);
      cp_async_commit();
    }

    const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
    const int wm = warp >> 1, wn = warp & 1;  // 32 rows x 32 columns a warp
    float acc[2][4][4] = {};
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<GX_STAGES - 2>();
      __syncthreads();  // stage kc has landed; stage kc - 1 is read by all
      const int kn = kc + GX_STAGES - 1;
      if (kn < nk) load_stage(kn % GX_STAGES, kn * KC);
      cp_async_commit();
      const T* as = a_s + (kc % GX_STAGES) * GX_TM * AS + wm * 32 * AS;
      const T* bs = b_s + (kc % GX_STAGES) * KC * GX_BS + wn * 32;
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8) {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* ap = as + (mt * 16 + g8) * AS + kk + q4;
            tf32_split<true>(ap[0], ah[mt][0], al[mt][0]);
            tf32_split<true>(ap[8 * AS], ah[mt][1], al[mt][1]);
            tf32_split<true>(ap[4], ah[mt][2], al[mt][2]);
            tf32_split<true>(ap[8 * AS + 4], ah[mt][3], al[mt][3]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float* bp = bs + (kk + q4) * GX_BS + nt * 8 + g8;
            tf32_split<true>(bp[0], bh[nt][0], bl[nt][0]);
            tf32_split<true>(bp[4 * GX_BS], bh[nt][1], bl[nt][1]);
          }
          // term by term: back-to-back MMAs never feed each other
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t a[2][4], b[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const T* ap = as + (mt * 16 + g8) * AS + kk + 2 * q4;
            a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * AS);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * AS + 8);
          }
          // matrices (k 0-7, n tile j), (k 8-15, j), (k 0-7, j + 1), (k 8-15, j + 1)
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * GX_BS +
                                     (j + (lane >> 4)) * 8);
            b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = rows[wm * 32 + mt * 16 + g8 + 8 * h];
        if (m < 0) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * q4;
          *reinterpret_cast<float2*>(gx + (size_t)m * N + n) =
              make_float2(acc[mt][nt][2 * h] + to_f32(bias[n]),
                          acc[mt][nt][2 * h + 1] + to_f32(bias[n + 1]));
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Forward 2. The recurrence.  Block `rank` of a cluster holds the gate
//    columns of units [rank U, (rank + 1) U) (U = H / CL, G4 = 4U, KS = H / 8
//    k-steps, MT = G4 / 16 m-tiles, one a warp; warps past MT idle).  The
//    m-tile of warp w has row 4u + g for gate g of unit rank U + 4w + u, so
//    a warp holds all four gates of its four units.  Shared memory:
//      wf_s  [MT][KS][32][4] f32  its gate columns of W_hh as mma A fragments
//                                 of A[c][k'] = W_hh[k', col c] (bf16 weights
//                                 widened: TF32 values), the warps' registers'
//                                 source; in f32 then their low TF32 halves
//      h_s   [2][H][R]       f32  h of the cluster's rows, double-buffered:
//                                 step l reads half l & 1, and every block's
//                                 warps st.async their units' new h into
//                                 half (l + 1) & 1, counted on full[(l+1) & 1]
//      gx_s  [3][WARPS][4][R][4] f32  gx of a warp's 4 gates x R rows x 4
//                                 units for this step and the next two
//      gt_s  [WARPS][R][GT_S] f32 a warp's h . W_hh, row-major: a lane reads
//                                 its cell's four gates as one float4
//      hc_s  [2][R][U]       f32  the final (h, c), for coalesced stores
//      full  [2]             mbarrier  the bytes of each half of h_s
//    Lane l of an active warp w owns the cell of row l % 8 and unit rank U
//    + 4w + l / 8, and carries its (h, c) in registers.
//    With hprev != nullptr (K1) it also writes hprev / cprev [L, B, H] and
//    the full pre-activations into gx.
// ---------------------------------------------------------------------------
constexpr int FQ = 4;        // k-steps whose MMAs a warp issues together (KS % FQ == 0)
constexpr int FKS_MAX = 32;  // k-steps of the step's product at H = 256 (H / 8)
constexpr int GT_S = 20;     // row stride of a gate tile: conflict-free stores and float4 loads

__host__ __device__ constexpr size_t fwd_rec_smem(int H) {
  return (size_t)(H / 2) * H * 4 + (size_t)2 * H * R * 4 + (size_t)3 * WARPS * 4 * R * 4 * 4 +
         (size_t)WARPS * R * GT_S * 4 + (size_t)2 * R * (H / CL) * 4 + 2 * 8;
}

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
recurrence_kernel(float* __restrict__ gx, const int64_t* __restrict__ lengths,
                  const T* __restrict__ w_hh, float* __restrict__ outs, float* __restrict__ hT,
                  float* __restrict__ cT, float* __restrict__ hprev, float* __restrict__ cprev,
                  int B, int L, int H, int reverse) {
  constexpr bool F32 = std::is_same<T, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H, KS = H / 8, MT = G4 / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const bool train = hprev != nullptr, active = warp < MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wf_s = reinterpret_cast<float*>(smem_raw);
  float* h_s = wf_s + (size_t)G4 * H;
  float* gx_s = h_s + 2 * H * R;
  float* gt_s = gx_s + 3 * WARPS * 4 * R * 4;
  float* hc_s = gt_s + WARPS * R * GT_S;
  uint64_t* full = reinterpret_cast<uint64_t*>(hc_s + 2 * R * U);
  const uint32_t step_bytes = H * R * 4;  // the h a block receives a step

  auto row_len = [&](int row) {
    const int64_t n = row < B ? lengths[row] : 0;
    return n < 0 ? 0 : n > L ? L : (int)n;
  };
  int maxlen = 0;
  for (int r = 0; r < R; ++r) maxlen = max(maxlen, row_len(row0 + r));
  // this lane's cell (row cr, unit k) and the gx chunk it brings in each
  // step (row fr, gate fg, the warp's four units: 16 bytes)
  const int cr = lane & 7, cu = lane >> 3, k = rank * U + 4 * warp + cu, crow = row0 + cr;
  const int fr = lane >> 2, fg = lane & 3;
  const int clen = row_len(crow), flen = row_len(row0 + fr);

  // gx of step l does not depend on the carries: cp.async brings it two
  // steps ahead, while the steps before run (valid rows only)
  auto fetch = [&](int l) {
    const int t = reverse ? maxlen - 1 - l : l;
    if (active && l < maxlen && t < flen)
      cp_async16(gx_s + (((l % 3) * WARPS + warp) * 4 + fg) * R * 4 + fr * 4,
                 gx + ((size_t)(row0 + fr) * L + t) * H4 + fg * H + rank * U + 4 * warp, true);
    cp_async_commit();
  };
  fetch(0);
  fetch(1);

  // W_hh's columns of this block into fragment order: column (g, u) is row
  // 4 (u % 4) + g of m-tile u / 4.  Lane l of a warp loads four units (one
  // 8- or 16-byte load) at k' = 8 ks + l % 8, gate l / 8, so that a warp's
  // stores fall into 16 banks (walking along the units put them into 2)
  {
    using V = typename std::conditional<F32, float4, uint2>::type;
    const int quads = U / 4, kin = lane & 7, g = lane >> 3;
#pragma unroll 8
    for (int j = warp; j < KS * quads; j += WARPS) {
      const int ks = j / quads, uq = j % quads;
      const V v = *reinterpret_cast<const V*>(w_hh + (size_t)(ks * 8 + kin) * H4 + g * H +
                                              rank * U + 4 * uq);
      const T* e4 = reinterpret_cast<const T*>(&v);
      float* slot = wf_s + ((size_t)(uq * KS + ks) * 32 + (kin & 3)) * 4 + 2 * (kin >> 2);
#pragma unroll
      for (int u = 0; u < 4; ++u) slot[((4 * u + g) & 7) * 16 + u / 2] = to_f32(e4[u]);
    }
  }
  for (int i = tid; i < H * R; i += THREADS) h_s[i] = 0.f;  // h before the first step
  // step l >= 1 reads the h that every block sent at step l - 1, into half
  // l & 1; a half is armed for the next h it receives before that can come
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(smem_u32(&full[b]));
    if (1 < maxlen) mbar_expect_tx(smem_u32(&full[1]), step_bytes);  // step 1's h
    if (2 < maxlen) mbar_expect_tx(smem_u32(&full[0]), step_bytes);  // step 2's h
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block of the cluster is running and initialised

  // this warp's A fragments stay in registers for the whole walk (the TF32
  // high halves; in f32 the low halves replace the weights in shared
  // memory, each thread its own slots)
  uint32_t wa[FKS_MAX][4];
#pragma unroll
  for (int ks = 0; ks < FKS_MAX; ++ks) {
    float* wp = wf_s + (((size_t)min(warp, MT - 1) * KS + min(ks, KS - 1)) * 32 + lane) * 4;
    const float4 v = *reinterpret_cast<const float4*>(wp);
    const float w4[4] = {v.x, v.y, v.z, v.w};
    uint32_t lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_split<F32>(w4[e], wa[ks][e], lo[e]);
    if (F32 && active && ks < KS)
      *reinterpret_cast<uint4*>(wp) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  float h = 0.f, c = 0.f;  // this lane's cell
  for (int l = 0; active && l < maxlen; ++l) {
    const int t = reverse ? maxlen - 1 - l : l;
    const float* h_cur = h_s + (l & 1) * H * R;
    if (l > 0) {
      mbar_wait_cluster(smem_u32(&full[l & 1]), ((l - 1) >> 1) & 1);
      // arm the half for step l + 2's h: it cannot come before every warp
      // of the cluster has read this one (see the send below)
      if (tid == 0 && l + 2 < maxlen) mbar_expect_tx(smem_u32(&full[l & 1]), step_bytes);
    }
    cp_async_wait<1>();  // this step's gx chunks have landed; the next step's may not have
    fetch(l + 2);        // into the slot read at step l - 1 (past the walk: an empty group)
    __syncwarp();        // the warp's chunks are visible to all its lanes

    // gates^T[c][r] = sum_k' W_hh[k', col c] h[r][k'] for the warp's 16
    // columns on the tensor cores: A = its W_hh fragments, B = h (split into
    // TF32 halves), FQ k-steps' fragments loaded, then their MMAs issued
    // term by term so that back-to-back MMAs never feed each other
    float acc[FQ][4] = {};
    if (l > 0) {  // h is 0 before the first step
#pragma unroll
      for (int ks0 = 0; ks0 < FKS_MAX; ks0 += FQ) {
        if (ks0 >= KS) break;
        uint32_t bh[FQ][2], bl[FQ][2], al[FQ][4];
#pragma unroll
        for (int kq = 0; kq < FQ; ++kq) {
          const int ks = ks0 + kq;
          tf32_split<true>(h_cur[(ks * 8 + q4) * R + g8], bh[kq][0], bl[kq][0]);
          tf32_split<true>(h_cur[(ks * 8 + q4 + 4) * R + g8], bh[kq][1], bl[kq][1]);
          if constexpr (F32) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                wf_s + (((size_t)warp * KS + ks) * 32 + lane) * 4);
            al[kq][0] = v.x, al[kq][1] = v.y, al[kq][2] = v.z, al[kq][3] = v.w;
          }
        }
        if constexpr (F32) {
#pragma unroll
          for (int kq = 0; kq < FQ; ++kq) mma_tf32(acc[kq], al[kq], bh[kq][0], bh[kq][1]);
        }
#pragma unroll
        for (int kq = 0; kq < FQ; ++kq) mma_tf32(acc[kq], wa[ks0 + kq], bl[kq][0], bl[kq][1]);
#pragma unroll
        for (int kq = 0; kq < FQ; ++kq) mma_tf32(acc[kq], wa[ks0 + kq], bh[kq][0], bh[kq][1]);
      }
    }
    // D[c][r]: (g8, 2 q4), (g8, 2 q4 + 1), (g8 + 8, 2 q4), (g8 + 8, 2 q4 + 1)
    float* gt = gt_s + warp * R * GT_S;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = acc[0][e];
#pragma unroll
      for (int kq = 1; kq < FQ; ++kq) sum += acc[kq][e];
      gt[(2 * q4 + (e & 1)) * GT_S + g8 + 8 * (e >> 1)] = sum;
    }
    __syncwarp();
    const float4 p = *reinterpret_cast<const float4*>(gt + cr * GT_S + 4 * cu);  // i, f, g, o
    const float* xg = gx_s + (((l % 3) * WARPS + warp) * 4) * R * 4 + cr * 4 + cu;

    const bool on = crow < B;
    if (train && on) {
      hprev[((size_t)t * B + crow) * H + k] = h;
      cprev[((size_t)t * B + crow) * H + k] = c;
    }
    float out = 0.f;
    if (t < clen) {
      const float pi = p.x + xg[0], pf = p.y + xg[R * 4];
      const float pg = p.z + xg[2 * R * 4], po = p.w + xg[3 * R * 4];
      c = sigmoidf(pf) * c + sigmoidf(pi) * tanhf(pg);
      h = sigmoidf(po) * tanhf(c);
      out = h;
      if (train) {
        float* gp = gx + ((size_t)crow * L + t) * H4 + k;
        gp[0] = pi;
        gp[H] = pf;
        gp[2 * H] = pg;
        gp[3 * H] = po;
      }
    }
    if (on) outs[((size_t)crow * L + t) * H + k] = out;

    // The new h of the warp's 4 units x R rows (carries at invalid rows) to
    // every block of the cluster: 16 bytes (rows 4j..4j+3 of one unit) a
    // store, two stores a lane.  A warp sends only after its own reads of
    // h_cur (its B fragments above; the carry is in registers), so a block
    // has all of step l + 1's h only once every warp of the cluster is done
    // reading step l's, and only then can any block send step l + 2's h
    // into that half.  Nothing reads the last step's h.
    if (l + 1 < maxlen) {
      const int su = (lane & 7) >> 1, sq = lane & 1;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __shfl_sync(0xffffffffu, h, su * 8 + sq * 4 + e);
      const int nxt = (l + 1) & 1;
      const uint32_t dst = smem_u32(h_s + nxt * H * R + (rank * U + 4 * warp + su) * R + sq * 4);
      const uint32_t bar = smem_u32(&full[nxt]);
      for (int d = lane >> 3; d < CL; d += 4)
        st_async4(cluster_addr(dst, d), v, cluster_addr(bar, d));
    }
  }
  // No cluster barrier at the end: the last st.async into a block (the
  // h of its last step) is awaited by that block before it leaves.

  if (active) {
    hc_s[cr * U + 4 * warp + cu] = h;
    hc_s[R * U + cr * U + 4 * warp + cu] = c;
  }
  __syncthreads();
  // steps past the cluster's longest row output 0; the carries are final.
  // Their residual carries: the final state in the forward direction, the
  // zero initial state in the reverse one (those steps come first there).
  for (int i = tid; i < R * U; i += THREADS) {
    const int row = row0 + i / U, kk = rank * U + i % U;
    if (row >= B) continue;
    const float hf = hc_s[i], cf = hc_s[R * U + i];
    hT[(size_t)row * H + kk] = hf;
    cT[(size_t)row * H + kk] = cf;
    for (int t = maxlen; t < L; ++t) {
      outs[((size_t)row * L + t) * H + kk] = 0.f;
      if (train) {
        hprev[((size_t)t * B + row) * H + kk] = reverse ? 0.f : hf;
        cprev[((size_t)t * B + row) * H + kk] = reverse ? 0.f : cf;
      }
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* b, void* gx, void* outs, void* hT, void* cT, void* hprev,
                       void* cprev, int B, int L, int D, int H, int reverse,
                       cudaStream_t stream) {
  // ops/cuda/lstm_scan.py::lstm_scan_fwd_plan
  const int N = 4 * H;
  const size_t gsm = gx_smem<T>(B);
  cudaError_t e = cudaFuncSetAttribute(gates_x_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsm);
  if (e != cudaSuccess) return e;
  dim3 ggrid(N / GX_TN, min((B * L + GX_TM - 1) / GX_TM, GX_YMAX));
  gates_x_kernel<T><<<ggrid, GX_THREADS, gsm, stream>>>(
      static_cast<const T*>(xs), static_cast<const int64_t*>(lengths),
      static_cast<const T*>(w_ih), static_cast<const T*>(b), static_cast<float*>(gx), B, L, D, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t smem = fwd_rec_smem(H);
  if ((e = cudaFuncSetAttribute(recurrence_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
  const int clusters = (B + R - 1) / R;
  recurrence_kernel<T><<<clusters * CL, THREADS, smem, stream>>>(
      static_cast<float*>(gx), static_cast<const int64_t*>(lengths), static_cast<const T*>(w_hh),
      static_cast<float*>(outs), static_cast<float*>(hT), static_cast<float*>(cT),
      static_cast<float*>(hprev), static_cast<float*>(cprev), B, L, H, reverse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2.1 The backward recurrence.  Shared memory of a block (U = H / CL units,
// G4 = 4U columns, KS = G4 / 8 k-steps, MT = H / 16 m-tiles):
//      wf_s   [MT][KS][32][4] f32  its gate columns of W_hh as mma A
//                                  fragments of A[k'][c] = W_hh[k', col c]
//                                  (bf16 weights widened: TF32 values), the
//                                  warps' registers' source; in f32 then
//                                  their low TF32 halves
//      dah_s, dal_s [2][G4][R] u32 this step's da of its columns, split into
//                                  TF32 halves, double-buffered (then db sums)
//      part_s [2][CL][U][R]   f32  partial dh_prev of its units from each
//                                  block of the cluster, double-buffered
//      nx_s   [3][6][THREADS] f32  gates, c_prev, d_out of this step and the
//                                  next two
//      full   [2]             mbarrier  the bytes of each half of part_s
//    Thread tid < R*U owns (row r = tid % R, unit u = tid / R) and carries
//    its (dh, dc) and its four columns' sums of da in registers.
// ---------------------------------------------------------------------------
constexpr int KQ = 4;       // k-steps whose MMAs a warp issues together
constexpr int KS_MAX = 16;  // k-steps of the step's product at H = 256 (G4 / 8)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__host__ __device__ constexpr size_t rec_smem(int H) {
  return (size_t)H * (H / 2) * 4 + (size_t)(4 * (H / 2) * R + 2 * CL * R * (H / CL)) * 4 +
         (size_t)3 * 6 * THREADS * 4 + 2 * 8;
}

template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
bwd_recurrence_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                      const float* __restrict__ d_out, const float* __restrict__ dhT,
                      const float* __restrict__ dcT, const int64_t* __restrict__ lengths,
                      const T* __restrict__ w_hh, float* __restrict__ da,
                      float* __restrict__ db_part, int B, int L, int H, int reverse) {
  constexpr bool F32 = std::is_same<T, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H, KS = G4 / 8, MT = H / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wf_s = reinterpret_cast<float*>(smem_raw);
  uint32_t* dah_s = reinterpret_cast<uint32_t*>(wf_s + (size_t)G4 * H);  // [2][G4][R]
  uint32_t* dal_s = dah_s + 2 * G4 * R;
  float* part_s = reinterpret_cast<float*>(dal_s + 2 * G4 * R);
  float* nx_s = part_s + 2 * CL * U * R;
  uint64_t* full = reinterpret_cast<uint64_t*>(nx_s + 3 * 6 * THREADS);  // [2]: part_s's halves
  const uint32_t step_bytes = CL * U * R * 4;  // the partials a block receives a step

  int maxlen = 0;
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const int64_t n = row < B ? lengths[row] : 0;
    maxlen = max(maxlen, (int)(n < L ? n : L));
  }

  // W_hh's columns of this block, read in rows of consecutive units
  for (int i = tid; i < H * G4; i += THREADS) {
    const int kp = i / G4, c = i % G4, g = c / U, u = c % U;
    const int gm = kp & 15, kc = c & 7;
    const int slot = (((kp >> 4) * KS + (c >> 3)) * 32 + (gm & 7) * 4 + (kc & 3)) * 4 +
                     (gm >> 3) + 2 * (kc >> 2);
    wf_s[slot] = to_f32(w_hh[(size_t)kp * H4 + g * H + rank * U + u]);
  }

  const bool owner = tid < R * U;
  const int r = tid % R, u = tid / R, k = rank * U + u, row = row0 + r;
  int my_len = 0;
  float dh = 0.f, dc = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner && row < B) {
    const int64_t n = lengths[row];
    my_len = (int)(n < L ? n : L);
    dh = dhT[(size_t)row * H + k];
    dc = dcT[(size_t)row * H + k];
  }
  // gates (4), c_prev and d_out of step t do not depend on the carries:
  // cp.async brings them two steps ahead, while the steps before run
  auto fetch = [&](int t, int buf) {
    if (owner && t >= 0 && t < my_len && t < L) {
      const float* gp = gates + ((size_t)row * L + t) * H4 + k;
      float* d = nx_s + buf * 6 * THREADS + tid;
#pragma unroll
      for (int g = 0; g < 4; ++g) cp_async4(d + g * THREADS, gp + g * H);
      cp_async4(d + 4 * THREADS, cprev + ((size_t)t * B + row) * H + k);
      cp_async4(d + 5 * THREADS, d_out + ((size_t)row * L + t) * H + k);
    }
    cp_async_commit();
  };
  fetch(reverse ? 0 : maxlen - 1, 0);
  fetch(reverse ? 1 : maxlen - 2, 1);
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&full[b]));
      mbar_expect_tx(smem_u32(&full[b]), step_bytes);  // steps 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block of the cluster is running and initialised

  // this warp's A fragments stay in registers for the whole walk (the TF32
  // high halves; in f32 the low halves replace the weights in shared
  // memory, each thread its own slots): W_hh does not change, and reading
  // it again every step cost more shared-memory bandwidth than the MMAs
  const int mpw = (MT + 7) / 8;  // m-tiles a warp: 2 at H = 256
  uint32_t wa[2][KS_MAX][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ks = 0; ks < KS_MAX; ++ks) {
      float* wp = wf_s + (((size_t)min(warp * mpw + i, MT - 1) * KS + min(ks, KS - 1)) * 32 +
                          lane) * 4;
      const float4 v = *reinterpret_cast<const float4*>(wp);
      const float w4[4] = {v.x, v.y, v.z, v.w};
      uint32_t lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32_split<F32>(w4[e], wa[i][ks][e], lo[e]);
      if (F32 && i < mpw && warp * mpw + i < MT && ks < KS)
        *reinterpret_cast<uint4*>(wp) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }

  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? l : maxlen - 1 - l;  // the forward's steps, backwards
    float* part = part_s + (l & 1) * CL * U * R;
    uint32_t* dah = dah_s + (l & 1) * G4 * R;
    uint32_t* dal = dal_s + (l & 1) * G4 * R;

    float d4[4] = {0.f, 0.f, 0.f, 0.f};
    cp_async_wait<1>();  // this step's group has landed; the next one may not have
    if (owner) {
      const float* nx = nx_s + (l % 3) * 6 * THREADS + tid;
      if (t < my_len) {
        const float ig = sigmoidf(nx[0]), fg = sigmoidf(nx[THREADS]);
        const float gg = tanhf(nx[2 * THREADS]), og = sigmoidf(nx[3 * THREADS]);
        const float cp = nx[4 * THREADS];
        const float tc = tanhf(fg * cp + ig * gg);
        const float dh_eff = dh + nx[5 * THREADS];
        const float dct = dc + dh_eff * og * (1.f - tc * tc);
        d4[0] = dct * gg * ig * (1.f - ig);
        d4[1] = dct * cp * fg * (1.f - fg);
        d4[2] = dct * ig * (1.f - gg * gg);
        d4[3] = dh_eff * tc * og * (1.f - og);
        dc = dct * fg;
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        tf32_split<true>(d4[g], dah[(g * U + u) * R + r], dal[(g * U + u) * R + r]);
        db[g] += d4[g];
      }
    }
    __syncthreads();

    // partial dh_prev[r][k'] = sum_c W_hh[k', c] da[r][c] on the tensor
    // cores: M = the H units k' (warp w takes m-tiles w * mpw ..), N = the
    // R = 8 rows, K = the block's G4 columns.  A warp loads the fragments of
    // KQ k-steps, then issues their MMAs term by term, so that back-to-back
    // MMAs never feed each other.
    float acc[2][KQ][4] = {};
#pragma unroll
    for (int ks0 = 0; ks0 < KS_MAX; ks0 += KQ) {
      if (ks0 >= KS) break;
      uint32_t bh[KQ][2], bl[KQ][2], al[2][KQ][4];
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        const int ks = min(ks0 + kq, KS - 1);  // a k-step past KS is loaded, never used
        bh[kq][0] = dah[(ks * 8 + q4) * R + g8];
        bh[kq][1] = dah[(ks * 8 + q4 + 4) * R + g8];
        bl[kq][0] = dal[(ks * 8 + q4) * R + g8];
        bl[kq][1] = dal[(ks * 8 + q4 + 4) * R + g8];
        if (F32) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                wf_s + (((size_t)min(warp * mpw + i, MT - 1) * KS + ks) * 32 + lane) * 4);
            al[i][kq][0] = v.x, al[i][kq][1] = v.y, al[i][kq][2] = v.z, al[i][kq][3] = v.w;
          }
        }
      }
      bool on[2][KQ];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq)
          on[i][kq] = i < mpw && warp * mpw + i < MT && ks0 + kq < KS;
      if (F32) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int kq = 0; kq < KQ; ++kq)
            if (on[i][kq]) mma_tf32(acc[i][kq], al[i][kq], bh[kq][0], bh[kq][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq)
          if (on[i][kq]) mma_tf32(acc[i][kq], wa[i][ks0 + kq], bl[kq][0], bl[kq][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq)
          if (on[i][kq]) mma_tf32(acc[i][kq], wa[i][ks0 + kq], bh[kq][0], bh[kq][1]);
    }
    // each partial to the block that owns its unit, in fixed order
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = warp * mpw + i;
      if (i >= mpw || mt >= MT) continue;
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = acc[i][0][e];
#pragma unroll
        for (int q = 1; q < KQ; ++q) s[e] += acc[i][q][e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g8 + 8 * h;
        st_async2(cluster_addr(smem_u32(part + (rank * U + kk % U) * R + 2 * q4), kk / U),
                  s[2 * h], s[2 * h + 1], cluster_addr(smem_u32(&full[l & 1]), kk / U));
      }
    }
    // while the partials travel: this step's da to device memory (valid
    // steps only: the GEMMs read no other) and the next step's loads
    if (owner && t < my_len) {
      float* dp = da + ((size_t)row * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g * H] = d4[g];
    }
    fetch(reverse ? l + 2 : maxlen - 3 - l, (l + 2) % 3);  // past the walk: an empty group

    if (owner) {
      mbar_wait_cluster(smem_u32(&full[l & 1]), (l >> 1) & 1);
      if (t < my_len) {
        float s = 0.f;
        for (int src = 0; src < CL; ++src) s += part[(src * U + u) * R + r];
        dh = s;
      }
      // the half is read: arm it for step l + 2, whose partials cannot come
      // before this block has sent its own of step l + 1
      if (tid == 0 && l + 2 < maxlen) mbar_expect_tx(smem_u32(&full[l & 1]), step_bytes);
    }
  }
  cluster.sync();  // every block is done with every other's shared memory

  // this cluster's column sums of da, for db
  float* db_s = reinterpret_cast<float*>(dah_s);
  if (owner) {
#pragma unroll
    for (int g = 0; g < 4; ++g) db_s[(g * U + u) * R + r] = db[g];
  }
  __syncthreads();
  for (int c = tid; c < G4; c += THREADS) {
    float s = 0.f;
    for (int r2 = 0; r2 < R; ++r2) s += db_s[c * R + r2];
    db_part[(size_t)(blockIdx.x / CL) * H4 + (c / U) * H + rank * U + c % U] = s;
  }
}

// ---------------------------------------------------------------------------
// K2.2 d_xs[m] = da[m] . W_ih^T for every valid step m (in the dtype of xs),
//      0 at every padded step.  Block (n tile, y): y < ceil(Mv / DX_TM) takes
//      valid steps [y * DX_TM, +DX_TM) and columns [n0, n0 + DX_TN); later y
//      write the zeros of the padded steps, DX_TM at a time.  K = 4H streams
//      through a ring of DX_STAGES cp.async stages of DX_KC columns; four
//      warps of 16 rows x 32 columns each run m16n8k8 TF32 MMAs.  da (f32)
//      is split in both dtypes, as the reference's f32 product needs: three
//      MMAs a product in f32 (W_ih split too), two in bf16 (W_ih exact in
//      TF32); d_xs is rounded to bf16 once, from the f32 sums.
// ---------------------------------------------------------------------------
constexpr int DX_TM = 32, DX_TN = 64, DX_KC = 32, DX_STAGES = 3, DX_THREADS = 128;
constexpr int DX_AS = DX_KC + 4;  // f32 row stride of a da stage: conflict-free fragments

template <typename T>
__host__ __device__ constexpr int dx_ws() {  // row stride (elements) of a W_ih stage
  return DX_KC + (sizeof(T) == 4 ? 4 : 8);
}

template <typename T>
size_t dx_smem(int B) {
  return (size_t)(starts_ints(B) + DX_TM) * 4 +
         (size_t)DX_STAGES * (DX_TM * DX_AS * 4 + DX_TN * dx_ws<T>() * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(DX_THREADS)
dx_gemm_kernel(const float* __restrict__ da, const T* __restrict__ w,
               const int64_t* __restrict__ lengths, T* __restrict__ dx, int B, int L, int D,
               int K) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int WS = dx_ws<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* starts = reinterpret_cast<int*>(smem_raw);
  int* rows = starts + starts_ints(B);
  float* a_s = reinterpret_cast<float*>(rows + DX_TM);
  T* w_s = reinterpret_cast<T*>(a_s + DX_STAGES * DX_TM * DX_AS);
  const int tid = threadIdx.x;
  valid_starts(lengths, B, L, starts);
  const int Mv = starts[B], vt = (Mv + DX_TM - 1) / DX_TM;
  const int n0 = blockIdx.x * DX_TN;

  if ((int)blockIdx.y >= vt) {  // zeros at padded steps
    const int p0 = (blockIdx.y - vt) * DX_TM;
    if (p0 >= B * L - Mv) return;
    if (tid < DX_TM) {
      const int v = p0 + tid;
      int m = -1;
      if (v < B * L - Mv) {
        const int b = row_of(starts, B, L, v, true);
        m = b * L + (starts[b + 1] - starts[b]) + v - (b * L - starts[b]);
      }
      rows[tid] = m;
    }
    __syncthreads();
    for (int i = tid; i < DX_TM * DX_TN; i += DX_THREADS) {
      const int m = rows[i / DX_TN], n = n0 + i % DX_TN;
      if (m >= 0 && n < D) store_as(dx + (size_t)m * D + n, 0.f);
    }
    return;
  }

  if (tid < DX_TM) {
    const int v = blockIdx.y * DX_TM + tid;
    rows[tid] = v < Mv ? valid_row(starts, B, L, v) : -1;
  }
  __syncthreads();

  auto load_stage = [&](int st, int k0) {
    float* as = a_s + st * DX_TM * DX_AS;
    for (int i = tid; i < DX_TM * (DX_KC / 4); i += DX_THREADS) {
      const int r = i / (DX_KC / 4), q = i % (DX_KC / 4), m = rows[r];
      cp_async16(as + r * DX_AS + 4 * q, da + (size_t)max(m, 0) * K + k0 + 4 * q, m >= 0);
    }
    constexpr int EPC = 16 / sizeof(T), WC = DX_KC / EPC;  // elements, chunks of a row
    T* ws = w_s + st * DX_TN * WS;
    for (int i = tid; i < DX_TN * WC; i += DX_THREADS) {
      const int r = i / WC, q = i % WC, n = n0 + r;
      cp_async16(ws + r * WS + EPC * q, w + (size_t)min(n, D - 1) * K + k0 + EPC * q, n < D);
    }
  };

  const int nk = K / DX_KC;
#pragma unroll
  for (int st = 0; st < DX_STAGES - 1; ++st) {  // the ring's first stages
    if (st < nk) load_stage(st, st * DX_KC);
    cp_async_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 16 rows x 32 columns a warp
  float acc[4][4] = {};
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<DX_STAGES - 2>();
    __syncthreads();  // stage kc has landed; stage kc - 1 is read by all
    const int kn = kc + DX_STAGES - 1;
    if (kn < nk) load_stage(kn % DX_STAGES, kn * DX_KC);
    cp_async_commit();
    const float* as = a_s + (kc % DX_STAGES) * DX_TM * DX_AS + wm * 16 * DX_AS;
    const T* ws = w_s + (kc % DX_STAGES) * DX_TN * WS + wn * 32 * WS;
#pragma unroll
    for (int kk = 0; kk < DX_KC; kk += 8) {
      uint32_t ah[4], al[4];
      tf32_split<true>(as[g8 * DX_AS + kk + q4], ah[0], al[0]);
      tf32_split<true>(as[(g8 + 8) * DX_AS + kk + q4], ah[1], al[1]);
      tf32_split<true>(as[g8 * DX_AS + kk + q4 + 4], ah[2], al[2]);
      tf32_split<true>(as[(g8 + 8) * DX_AS + kk + q4 + 4], ah[3], al[3]);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        tf32_split<F32>(to_f32(ws[(nt * 8 + g8) * WS + kk + q4]), bh[nt][0], bl[nt][0]);
        tf32_split<F32>(to_f32(ws[(nt * 8 + g8) * WS + kk + q4 + 4]), bh[nt][1], bl[nt][1]);
      }
      // term by term: back-to-back MMAs never feed each other
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], al, bh[nt][0], bh[nt][1]);
      if (F32) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], ah, bl[nt][0], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], ah, bh[nt][0], bh[nt][1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = rows[wm * 16 + g8 + 8 * h];
    if (m < 0) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + 2 * q4;
      if (n >= D) continue;
      T* p = dx + (size_t)m * D + n;
      if constexpr (F32) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2.3 dW[i, j] = sum over valid steps m of a(m, i) da[m, j], j < J = 4H, and
//      db.  blockIdx.z = mat * DW_SPLITS + split: mat 0 takes a = xs [B, L, D]
//      (T) into dW_ih [D, 4H], mat 1 a = hprev [L, B, H] (f32, time-major)
//      into dW_hh [H, 4H].  The DW_SPLITS blocks of one output tile (DW_TI x
//      DW_TJ) form a cluster; split s reduces valid steps [s Mv / S, (s + 1)
//      Mv / S) in order, DW_KC at a time through a ring of cp.async stages,
//      with eight warps of 32 x 32 outputs on m16n8k8 TF32 MMAs (da always
//      split, a split in f32).  Then each block puts its partial tile in
//      shared memory, and after one cluster barrier block s sums rows [s
//      DW_TI / S, ..) of the tile over the cluster's blocks in rank order:
//      no atomics, the same sums every run.  The cluster of tile (j, 0) of
//      dW_hh also writes db[j..] as the sum over the recurrence's clusters,
//      in order, of their column sums.
// ---------------------------------------------------------------------------
constexpr int DW_TI = 64, DW_TJ = 128, DW_KC = 32, DW_STAGES = 3, DW_THREADS = 256;
constexpr int DW_SPLITS = 8;
constexpr int DW_AS = DW_TI + 8;  // row stride (elements) of an a stage
constexpr int DW_BS = DW_TJ + 8;  // of a da stage
constexpr int DW_RS = DW_TJ + 4;  // of the partial tile
constexpr int DW_STAGE_BYTES = DW_KC * (DW_AS + DW_BS) * 4;

size_t dw_smem(int B) {
  constexpr size_t ring = (size_t)DW_STAGES * DW_STAGE_BYTES, tile = (size_t)DW_TI * DW_RS * 4;
  return (size_t)starts_ints(B) * 4 + (ring > tile ? ring : tile);
}

// One split of one tile: the partial dW tile of a (TA: T for xs, f32 for
// hprev) in acc, as mma D fragments of the warp's 2 x 4 tiles.
template <typename TA>
__device__ __forceinline__ void dw_tile(const TA* __restrict__ a, const float* __restrict__ da,
                                        const int* starts, unsigned char* stages, int B, int L,
                                        int I, int J, int i0, int j0, bool time_major, int v0,
                                        int v1, float (&acc)[2][4][4]) {
  constexpr bool F32 = std::is_same<TA, float>::value;
  constexpr int EPC = 16 / sizeof(TA);  // elements of a 16-byte chunk of a
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;  // 32 x 32 outputs a warp
  const int rr = tid / 8, sub = tid % 8;    // the stage row and the chunks this thread loads

  auto load_stage = [&](int st, int v) {
    TA* as = reinterpret_cast<TA*>(stages + st * DW_STAGE_BYTES);
    float* bs = reinterpret_cast<float*>(stages + st * DW_STAGE_BYTES + DW_KC * DW_AS * 4);
    const int vv = v + rr;
    const bool ok = vv < v1;
    int b = 0, t = 0;
    if (ok) {
      b = row_of(starts, B, L, vv, false);
      t = vv - starts[b];
    }
    const size_t m = (size_t)b * L + t;
    const TA* ap = a + (time_major ? ((size_t)t * B + b) * I : m * I) + i0;
    // the 8 threads of a row take neighbouring chunks: conflict-free stores
#pragma unroll
    for (int c = sub; c < DW_TI / EPC; c += 8)
      cp_async16(as + rr * DW_AS + c * EPC, ap + (ok && i0 + c * EPC < I ? c * EPC : 0),
                 ok && i0 + c * EPC < I);
    const float* bp = da + m * J + j0;
#pragma unroll
    for (int c = sub; c < DW_TJ / 4; c += 8) cp_async16(bs + rr * DW_BS + 4 * c, bp + 4 * c, ok);
  };

  const int nk = (v1 - v0 + DW_KC - 1) / DW_KC;
#pragma unroll
  for (int st = 0; st < DW_STAGES - 1; ++st) {  // the ring's first stages
    if (st < nk) load_stage(st, v0 + st * DW_KC);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // stage kc has landed; stage kc - 1 is read by all
    const int kn = kc + DW_STAGES - 1;
    if (kn < nk) load_stage(kn % DW_STAGES, v0 + kn * DW_KC);
    cp_async_commit();
    const unsigned char* st = stages + (kc % DW_STAGES) * DW_STAGE_BYTES;
    const TA* as = reinterpret_cast<const TA*>(st) + wi * 32;
    const float* bs = reinterpret_cast<const float*>(st + DW_KC * DW_AS * 4) + wj * 32;
#pragma unroll
    for (int kk = 0; kk < DW_KC; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        tf32_split<true>(bs[(kk + q4) * DW_BS + nt * 8 + g8], bh[nt][0], bl[nt][0]);
        tf32_split<true>(bs[(kk + q4 + 4) * DW_BS + nt * 8 + g8], bh[nt][1], bl[nt][1]);
      }
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const TA* ap = as + mt * 16 + g8;
        tf32_split<F32>(to_f32(ap[(kk + q4) * DW_AS]), ah[mt][0], al[mt][0]);
        tf32_split<F32>(to_f32(ap[(kk + q4) * DW_AS + 8]), ah[mt][1], al[mt][1]);
        tf32_split<F32>(to_f32(ap[(kk + q4 + 4) * DW_AS]), ah[mt][2], al[mt][2]);
        tf32_split<F32>(to_f32(ap[(kk + q4 + 4) * DW_AS + 8]), ah[mt][3], al[mt][3]);
      }
      // term by term: back-to-back MMAs never feed each other
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (F32) mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is read: the caller reuses the memory
}

template <typename T>
__global__ void __cluster_dims__(1, 1, DW_SPLITS) __launch_bounds__(DW_THREADS, 2)
dw_gemm_kernel(const T* __restrict__ xs, const float* __restrict__ hprev,
               const float* __restrict__ da, const int64_t* __restrict__ lengths,
               const float* __restrict__ db_part, float* __restrict__ dw_ih,
               float* __restrict__ dw_hh, float* __restrict__ db, int B, int L, int D, int H,
               int clusters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const bool hh = blockIdx.z >= DW_SPLITS;
  const int I = hh ? H : D, J = 4 * H;
  const int i0 = blockIdx.y * DW_TI, j0 = blockIdx.x * DW_TJ;
  if (i0 >= I) return;  // the whole cluster: the dW_hh grid is shorter when H < D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* starts = reinterpret_cast<int*>(smem_raw);
  unsigned char* stages = smem_raw + starts_ints(B) * 4;
  valid_starts(lengths, B, L, starts);
  const int Mv = starts[B];
  const int v0 = (int)((long long)Mv * split / DW_SPLITS);
  const int v1 = (int)((long long)Mv * (split + 1) / DW_SPLITS);

  float acc[2][4][4] = {};
  if (hh)
    dw_tile<float>(hprev, da, starts, stages, B, L, I, J, i0, j0, true, v0, v1, acc);
  else
    dw_tile<T>(xs, da, starts, stages, B, L, I, J, i0, j0, false, v0, v1, acc);

  // the partial tile into shared memory, then the cluster's sum in rank order
  float* red = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(red + (wi * 32 + mt * 16 + g8 + 8 * h) * DW_RS + wj * 32 +
                                   nt * 8 + 2 * q4) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster.sync();
  constexpr int ROWS_EACH = DW_TI / DW_SPLITS;
  float* dw = hh ? dw_hh : dw_ih;
  for (int e = tid; e < ROWS_EACH * DW_TJ / 4; e += DW_THREADS) {
    const int ri = split * ROWS_EACH + e / (DW_TJ / 4), c = 4 * (e % (DW_TJ / 4));
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) + ri * DW_RS + c);
#pragma unroll
    for (int q = 1; q < DW_SPLITS; ++q) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + ri * DW_RS + c);
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    if (i0 + ri < I) *reinterpret_cast<float4*>(dw + (size_t)(i0 + ri) * J + j0 + c) = s;
  }
  if (hh && blockIdx.y == 0 && split == 0) {
    for (int j = tid; j < DW_TJ; j += DW_THREADS) {
      float s = 0.f;
      for (int q = 0; q < clusters; ++q) s += db_part[(size_t)q * J + j0 + j];
      db[j0 + j] = s;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* gates, const void* hprev, const void* cprev,
                       const void* d_out, const void* dhT, const void* dcT, void* da,
                       void* db_part, void* d_xs, void* dw_ih, void* dw_hh, void* db, int B,
                       int L, int D, int H, int reverse, cudaStream_t stream) {
  const int H4 = 4 * H;
  const int clusters = (B + R - 1) / R;
  const size_t smem = rec_smem(H);
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

  // ops/cuda/lstm_scan.py::lstm_scan_bwd_plan
  const size_t xsm = dx_smem<T>(B);
  if ((e = cudaFuncSetAttribute(dx_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)xsm)) != cudaSuccess)
    return e;
  dim3 xgrid((D + DX_TN - 1) / DX_TN, (B * L + DX_TM - 1) / DX_TM + 1);
  dx_gemm_kernel<T><<<xgrid, DX_THREADS, xsm, stream>>>(
      static_cast<const float*>(da), static_cast<const T*>(w_ih),
      static_cast<const int64_t*>(lengths), static_cast<T*>(d_xs), B, L, D, H4);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t wsm = dw_smem(B);
  if ((e = cudaFuncSetAttribute(dw_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)wsm)) != cudaSuccess)
    return e;
  dim3 wgrid(H4 / DW_TJ, (max(D, H) + DW_TI - 1) / DW_TI, 2 * DW_SPLITS);
  dw_gemm_kernel<T><<<wgrid, DW_THREADS, wsm, stream>>>(
      static_cast<const T*>(xs), static_cast<const float*>(hprev), static_cast<const float*>(da),
      static_cast<const int64_t*>(lengths), static_cast<const float*>(db_part),
      static_cast<float*>(dw_ih), static_cast<float*>(dw_hh), static_cast<float*>(db), B, L, D,
      H, clusters);
  return cudaGetLastError();
}

}  // namespace

// K3.  xs [B, L, D] and the weights w_ih [D, 4H], w_hh [H, 4H], b [4H] in
// one dtype; lengths [B] int64; gx [B, L, 4H] f32 scratch; outs [B, L, H],
// hT and cT [B, H] f32.  H must be a multiple of 32 (U = H / 8 a multiple
// of 4, whole m-tiles of four units) with a block's W_hh fragments in its
// registers: H <= 256.  xs rows must be whole 16-byte chunks.
extern "C" int lstm_scan(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                         const void* b, void* gx, void* outs, void* hT, void* cT, int B, int L,
                         int D, int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 256 || (D * (dtype == DTYPE_BF16 ? 2 : 4)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
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
  if (H % 32 != 0 || H > 256 || (D * (dtype == DTYPE_BF16 ? 2 : 4)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
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
