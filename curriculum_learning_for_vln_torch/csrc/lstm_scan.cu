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
//    device, as K2's GEMMs do), on the tensor cores: bf16 operands on
//    wgmma (gx_wgmma_kernel below: W_ih by TMA, x's rows gathered by
//    valid step; exact products, f32 sums, as JAX's f32-accumulated bf16
//    dot); f32 through a 3-stage cp.async ring on mma.sync m16n8k8 in TF32
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
// Backward (K2): one C call, three launches (f32) or four (bf16: the walk,
// then K2.0-K2.3 below, the GEMMs on wgmma fed by TMA).  The first design (a
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
// 2. dx_gemm (f32): d_xs = DA . W_ih^T at the valid steps, and 0 at the
//    padded steps (the grid's later blocks).
// 3. dw_gemm (f32): dW_ih = X^T . DA, dW_hh = Hprev^T . DA and db.  Each output
//    tile is reduced by a cluster of 8 blocks, one a contiguous eighth of
//    the valid steps (512 blocks, two at a time an SM); the eighths'
//    partial tiles are summed in rank order through distributed shared
//    memory.  db sums the recurrence's cluster column sums in order.
// The GEMMs visit only the valid steps: they number them row by row (row
// b's valid steps are the contiguous run t < len[b]), every block taking
// the rows' starts from lengths on the device, so no host synchronisation
// reads them.  In f32 K2's stream their operands through a 3-stage cp.async
// ring into mma.sync m16n8k8 in TF32.  A plain TF32 product (~1e-3
// relative) fails the backward's tolerances, so an f32 operand is split
// into two TF32 halves and a product takes three MMAs (scripts/
// torch_tf32_error.py measures the error of plain and split TF32).  In bf16
// the pack launch numbers the valid steps alike and packs the operands by
// them, da (f32) as three bf16 terms, and the GEMMs run on wgmma (K2.0-K2.3
// below); d_xs rounds to bf16 once.  No atomics anywhere: the gradients
// are the same from run to run.
//
// Bound on the H100: at the path's shapes (B = 64, L = 80, D = H = 256)
// the forward is ~5.4 GFLOP at most (2 x 5,120 steps x (D + H) x 4H) and
// ~10 MB of traffic without K1's residuals, a few µs at the card's peaks;
// the backward ~11 GFLOP and ~50 MB.  What bounds these designs is the
// serial chain of steps: per step one product over the block's W_hh
// slice, one cell update and one exchange within the cluster, on 64 of
// the card's 132 SMs at B = 64.  Both walks keep W_hh in registers and
// exchange by st.async; their input GEMMs visit the valid steps only.
// Above H = 256 (the Self-Monitor's encoder, H = 512) a block's eighth no
// longer fits.  Both bf16 walks at H = 512 (the resident walks below: the
// forward's for K3 and K1, the backward's for K2) take clusters of 16
// blocks, each holding its sixteenth in registers; the other wide walks
// (f32, other H) stream their eighth from L2 every step, so a step costs
// the time to bring 256 KB (bf16) or 512 KB (f32) into each of the 64
// blocks, several times a step of the walks above.
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

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); r[j] is matrix
// j's fragment, lane l holding columns 2(l % 4), 2(l % 4) + 1 of row l / 4
// — from rows of A[m][k] a row-major mma A fragment, from rows of B^T[n][k]
// a col-major B fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, transposed: lane l holding rows 2(l % 4), 2(l % 4) + 1 of
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
//    only).  The bf16 route runs it on wgmma (gx_wgmma_kernel below); in
//    f32 block (n tile, y) takes columns [n0, n0 + GX_TN) of valid steps
//    [y' GX_TM, +GX_TM) for y' = y, y + Y, ... below the valid steps'
//    count, which it computes from lengths on the device (no host
//    synchronisation reads them): Y = min(B * L / GX_TM, GX_YMAX) tiles,
//    the path's valid steps in one to three rounds, without the waves of
//    blocks that find no valid step that a grid sized for B * L launches.
//    K streams through a ring of GX_STAGES cp.async stages of 128 bytes a
//    row (x as [m][k], W_ih as its own [k][n] rows); four warps of 32 x 32
//    outputs on m16n8k8 in TF32, both operands split, three MMAs a
//    product issued term by term.  Row strides are padded so that every
//    fragment load is conflict-free.
// ---------------------------------------------------------------------------
constexpr int GX_TM = 64, GX_TN = 64, GX_STAGES = 3, GX_THREADS = 128, GX_YMAX = 32;
constexpr int GX_BS = GX_TN + 8;  // row stride (floats) of a W_ih stage
constexpr int GX_KC = 32;         // floats of a stage's 128-byte rows
constexpr int GX_AS = GX_KC + 4;  // row stride (floats) of an x stage

size_t gx_smem(int B) {
  return (size_t)(starts_ints(B) + GX_TM) * 4 +
         (size_t)GX_STAGES * (GX_TM * GX_AS + GX_KC * GX_BS) * sizeof(float);
}

__global__ void __launch_bounds__(GX_THREADS)
gates_x_kernel(const float* __restrict__ x, const int64_t* __restrict__ lengths,
               const float* __restrict__ w, const float* __restrict__ bias,
               float* __restrict__ gx, int B, int L, int D, int N) {
  constexpr int KC = GX_KC, AS = GX_AS, EPC = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* starts = reinterpret_cast<int*>(smem_raw);
  int* rows = starts + starts_ints(B);
  float* a_s = reinterpret_cast<float*>(rows + GX_TM);
  float* b_s = a_s + GX_STAGES * GX_TM * AS;
  const int tid = threadIdx.x;
  valid_starts(lengths, B, L, starts);
  const int Mv = starts[B];
  for (int v0 = blockIdx.y * GX_TM; v0 < Mv; v0 += gridDim.y * GX_TM) {
    __syncthreads();  // the previous tile's rows and stages are read by all
    if (tid < GX_TM) rows[tid] = v0 + tid < Mv ? valid_row(starts, B, L, v0 + tid) : -1;
    __syncthreads();
    const int n0 = blockIdx.x * GX_TN;

    auto load_stage = [&](int st, int k0) {
      float* as = a_s + st * GX_TM * AS;
      for (int i = tid; i < GX_TM * (KC / EPC); i += GX_THREADS) {
        const int r = i / (KC / EPC), kk = k0 + (i % (KC / EPC)) * EPC, m = rows[r];
        const bool ok = m >= 0 && kk < D;
        cp_async16(as + r * AS + kk - k0, x + (ok ? (size_t)m * D + kk : 0), ok);
      }
      float* bs = b_s + st * KC * GX_BS;
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
      const float* as = a_s + (kc % GX_STAGES) * GX_TM * AS + wm * 32 * AS;
      const float* bs = b_s + (kc % GX_STAGES) * KC * GX_BS + wn * 32;
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
              make_float2(acc[mt][nt][2 * h] + bias[n], acc[mt][nt][2 * h + 1] + bias[n + 1]);
        }
      }
  }
}

// Forward 1 on the bf16 route (gx_wgmma_kernel), defined with K2's wgmma
// GEMMs below.
cudaError_t launch_gx_wgmma(const __nv_bfloat16* xs, const int64_t* lengths,
                            const __nv_bfloat16* w_ih, const __nv_bfloat16* bias, float* gx, int B,
                            int L, int D, int N, cudaStream_t stream);

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

// ---------------------------------------------------------------------------
// The wide walks, for 256 < H <= 512 (the Self-Monitor's encoder: H = 512;
//    in bf16 there the resident walks below take their place).
//    A block's eighth of W_hh is then 256 gate columns x 512 rows: 512 KB in
//    f32, 256 KB in bf16, more than its shared memory and, as fragments, far
//    more than its registers.  So the wide walks keep the cluster-of-8
//    layout, the split-TF32 products and the st.async exchange of the
//    walks above, and stream the block's slice from device memory every
//    step (it stays in the 50 MB L2: all of W_hh is 4 MB in f32).
//    pack_whh_kernel first lays W_hh out in the walks' fragment order, so
//    that each lane's fragment of a k-step is one 16-byte (f32) or 8-byte
//    (bf16) load; each warp then streams its own fragments through a ring
//    of WSTAGES groups in shared memory by cp.async, WSTAGES - 1 groups in
//    flight while it multiplies one, and reads back only what it copied
//    (no barrier for the ring).  The fragments' order does not depend on the
//    step, so the ring runs on across steps: the first groups of step l + 1
//    are in flight while step l ends and its h travels.  Blocks of WT = 512
//    threads: in the forward one warp an m-tile (16 gate columns, as above),
//    in the backward one thread a (row, unit) cell and two m-tiles a warp.
//    The per-step inputs that do not depend on the carries (gx; the saved
//    gates, c_prev and d_out) are loaded into registers a step ahead.
// ---------------------------------------------------------------------------
constexpr int WT = 512;      // threads of a wide walk's block
constexpr int WW = WT / 32;  // its warps
constexpr int WFQ = 4;       // k-steps of a forward group (one m-tile)
constexpr int WBQ = 2;       // k-steps of a backward group (two m-tiles)
constexpr int WSTAGES = 4;   // groups in a warp's ring

// W_hh in the wide walks' fragment order: element e of lane l's A fragment of
// k-step ks of m-tile mt of block `rank` at (((rank MT + mt) KS + ks) 32 + l)
// 4 + e.  Forward (bwd = 0): A[c][k'] = W_hh[k'][column c], MT = U / 4 tiles
// whose row 4u + g is gate g of unit rank U + 4 mt + u (recurrence_kernel's
// order), KS = H / 8.  Backward: A[k'][c] = W_hh[k'][column c] over the
// block's G4 columns, gate-major (bwd_recurrence_kernel's), MT = H / 16, KS
// = G4 / 8.
template <typename T>
__global__ void __launch_bounds__(256)
pack_whh_kernel(const T* __restrict__ w, T* __restrict__ out, int H, int bwd) {
  const int U = H / CL, H4 = 4 * H;
  const int MT = bwd ? H / 16 : U / 4, KS = bwd ? U / 2 : H / 8;
  const int n = CL * MT * KS * 32;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int lane = i & 31, f = i >> 5, ks = f % KS, mt = (f / KS) % MT, rank = f / KS / MT;
    const int g8 = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = g8 + 8 * (e & 1), kk = ks * 8 + q4 + 4 * (e >> 1);  // A[m][kk] of the tile
      const int row = bwd ? mt * 16 + m : kk;
      const int col = bwd ? (kk / U) * H + rank * U + kk % U
                          : (m & 3) * H + rank * U + 4 * mt + (m >> 2);
      out[(size_t)i * 4 + e] = w[(size_t)row * H4 + col];
    }
  }
}

template <typename T>
cudaError_t pack_whh(const void* w_hh, void* wpack, int H, int bwd, cudaStream_t stream) {
  const int n = H * H;  // fragments: CL MT KS 32, either way
  pack_whh_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(static_cast<const T*>(w_hh),
                                                          static_cast<T*>(wpack), H, bwd);
  return cudaGetLastError();
}

// A packed fragment (4 elements of T) as TF32 halves: f32 split, bf16 exact.
template <typename T>
__device__ __forceinline__ void load_frag(const unsigned char* p, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    tf32_split<true>(v.x, hi[0], lo[0]);
    tf32_split<true>(v.y, hi[1], lo[1]);
    tf32_split<true>(v.z, hi[2], lo[2]);
    tf32_split<true>(v.w, hi[3], lo[3]);
  } else {  // element e's bf16 bits are the high half of its f32 bits
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    hi[0] = v.x << 16, hi[1] = v.x & 0xffff0000u, hi[2] = v.y << 16, hi[3] = v.y & 0xffff0000u;
    lo[0] = lo[1] = lo[2] = lo[3] = 0u;
  }
}

__host__ __device__ constexpr size_t wide_fwd_smem(int H, int elem) {
  return (size_t)WW * WSTAGES * WFQ * 32 * 4 * elem + (size_t)2 * H * R * 4 +
         (size_t)WW * R * GT_S * 4 + (size_t)2 * R * (H / CL) * 4 + 2 * 8;
}

// Forward 2, wide.  recurrence_kernel's layout and arithmetic (warp w the
// m-tile of units rank U + 4w .. + 3, lane l the cell of row l % 8 and unit
// rank U + 4w + l / 8), its W_hh fragments streamed from wpack.  Shared
// memory: the warps' rings [WW][WSTAGES][WFQ][32] fragments, h_s [2][H][R],
// gt_s [WW][R][GT_S], hc_s [2][R][U], full [2].
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(WT)
recurrence_wide_kernel(float* __restrict__ gx, const int64_t* __restrict__ lengths,
                       const T* __restrict__ wpack, float* __restrict__ outs,
                       float* __restrict__ hT, float* __restrict__ cT, float* __restrict__ hprev,
                       float* __restrict__ cprev, int B, int L, int H, int reverse) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int FB = 4 * sizeof(T);  // bytes of a lane's fragment
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, H4 = 4 * H, KS = H / 8, NG = KS / WFQ, MT = U / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const bool train = hprev != nullptr, active = warp < MT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wring = smem_raw + (size_t)warp * WSTAGES * WFQ * 32 * FB;
  float* h_s = reinterpret_cast<float*>(smem_raw + (size_t)WW * WSTAGES * WFQ * 32 * FB);
  float* gt_s = h_s + 2 * H * R;
  float* hc_s = gt_s + WW * R * GT_S;
  uint64_t* full = reinterpret_cast<uint64_t*>(hc_s + 2 * R * U);
  const uint32_t step_bytes = H * R * 4;

  auto row_len = [&](int row) {
    const int64_t n = row < B ? lengths[row] : 0;
    return n < 0 ? 0 : n > L ? L : (int)n;
  };
  int maxlen = 0;
  for (int r = 0; r < R; ++r) maxlen = max(maxlen, row_len(row0 + r));
  const int cr = lane & 7, cu = lane >> 3, k = rank * U + 4 * warp + cu, crow = row0 + cr;
  const int clen = row_len(crow);

  // group j: k-steps (j % NG) WFQ .. of this warp's m-tile, into ring slot j % WSTAGES
  const T* wp = wpack + (size_t)(rank * MT + min(warp, MT - 1)) * KS * 32 * 4;
  auto load_group = [&](int j) {
    if (active) {
      const int ks0 = (j % NG) * WFQ;
      unsigned char* dst = wring + (size_t)(j % WSTAGES) * WFQ * 32 * FB;
#pragma unroll
      for (int kq = 0; kq < WFQ; ++kq)
        cp_async_n<FB>(dst + (kq * 32 + lane) * FB, wp + ((size_t)(ks0 + kq) * 32 + lane) * 4,
                       true);
    }
    cp_async_commit();
  };
  // gx of this lane's cell at step l (valid steps only)
  auto gx_at = [&](int l, float (&v)[4]) {
    const int t = reverse ? maxlen - 1 - l : l;
    if (active && l < maxlen && t < clen) {
      const float* p = gx + ((size_t)crow * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = p[g * H];
    }
  };

  for (int i = tid; i < H * R; i += WT) h_s[i] = 0.f;  // h before the first step
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(smem_u32(&full[b]));
    if (1 < maxlen) mbar_expect_tx(smem_u32(&full[1]), step_bytes);  // step 1's h
    if (2 < maxlen) mbar_expect_tx(smem_u32(&full[0]), step_bytes);  // step 2's h
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = 0; j < WSTAGES - 1; ++j) load_group(j);
  cluster.sync();  // every block of the cluster is running and initialised

  float h = 0.f, c = 0.f, xg[4] = {0.f, 0.f, 0.f, 0.f};
  gx_at(0, xg);
  for (int l = 0; active && l < maxlen; ++l) {
    const int t = reverse ? maxlen - 1 - l : l;
    const float* h_cur = h_s + (l & 1) * H * R;
    float xn[4] = {0.f, 0.f, 0.f, 0.f};
    gx_at(l + 1, xn);  // the next step's, in flight during this one
    if (l > 0) {
      mbar_wait_cluster(smem_u32(&full[l & 1]), ((l - 1) >> 1) & 1);
      if (tid == 0 && l + 2 < maxlen) mbar_expect_tx(smem_u32(&full[l & 1]), step_bytes);
    }

    // gates^T = W_hh^T h for the warp's 16 columns, as recurrence_kernel
    // takes it (h is 0 at the first step: its products are 0)
    float acc[WFQ][4] = {};
    for (int gi = 0; gi < NG; ++gi) {
      const int j = l * NG + gi;
      cp_async_wait<WSTAGES - 2>();  // group j has landed (this lane's copies)
      load_group(j + WSTAGES - 1);   // into the slot read at group j - 1
      const unsigned char* src = wring + (size_t)(j % WSTAGES) * WFQ * 32 * FB;
      uint32_t ah[WFQ][4], al[WFQ][4], bh[WFQ][2], bl[WFQ][2];
#pragma unroll
      for (int kq = 0; kq < WFQ; ++kq) {
        const int ks = gi * WFQ + kq;
        load_frag<T>(src + (kq * 32 + lane) * FB, ah[kq], al[kq]);
        tf32_split<true>(h_cur[(ks * 8 + q4) * R + g8], bh[kq][0], bl[kq][0]);
        tf32_split<true>(h_cur[(ks * 8 + q4 + 4) * R + g8], bh[kq][1], bl[kq][1]);
      }
      if constexpr (F32) {
#pragma unroll
        for (int kq = 0; kq < WFQ; ++kq) mma_tf32(acc[kq], al[kq], bh[kq][0], bh[kq][1]);
      }
#pragma unroll
      for (int kq = 0; kq < WFQ; ++kq) mma_tf32(acc[kq], ah[kq], bl[kq][0], bl[kq][1]);
#pragma unroll
      for (int kq = 0; kq < WFQ; ++kq) mma_tf32(acc[kq], ah[kq], bh[kq][0], bh[kq][1]);
    }
    float* gt = gt_s + warp * R * GT_S;
    __syncwarp();  // every lane has read the previous step's gate tile
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = acc[0][e];
#pragma unroll
      for (int kq = 1; kq < WFQ; ++kq) sum += acc[kq][e];
      gt[(2 * q4 + (e & 1)) * GT_S + g8 + 8 * (e >> 1)] = sum;
    }
    __syncwarp();
    const float4 p = *reinterpret_cast<const float4*>(gt + cr * GT_S + 4 * cu);  // i, f, g, o

    const bool on = crow < B;
    if (train && on) {
      hprev[((size_t)t * B + crow) * H + k] = h;
      cprev[((size_t)t * B + crow) * H + k] = c;
    }
    float out = 0.f;
    if (t < clen) {
      const float pi = p.x + xg[0], pf = p.y + xg[1], pg = p.z + xg[2], po = p.w + xg[3];
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

    // the new h to every block of the cluster, as recurrence_kernel sends it
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
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = xn[g];
  }
  cp_async_wait<0>();  // the groups the ring ran ahead

  if (active) {
    hc_s[cr * U + 4 * warp + cu] = h;
    hc_s[R * U + cr * U + 4 * warp + cu] = c;
  }
  __syncthreads();
  for (int i = tid; i < R * U; i += WT) {
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

// ---------------------------------------------------------------------------
// Forward 2, resident: the wide walk in bf16 at H = 512 (the Self-Monitor's
//    encoder), with no byte of W_hh read from L2 inside the step loop.  The
//    streaming walk above brings each block's 256 KB eighth of W_hh (bf16)
//    from L2 every step: 8.5 us a step at B = 64 on the H100.  Here a
//    cluster has RCL = 16 blocks (a non-portable size, launched with
//    cudaLaunchKernelEx), so block `rank` owns U = H / 16 units, G4 = 4U
//    gate columns x H rows of W_hh: 128 KB, 64 registers a thread at RT =
//    512 threads, loaded once a launch (W_hh [H, 4H] staged through shared
//    memory, then ldmatrix.trans into mma.sync A fragments of A[c][k'] =
//    W_hh[k'][column c], the block's columns gate-major: c = g U + u).
//    Rows: a cluster takes R <= 16 batch rows, R = ceil(B / the clusters the
//    card holds at once), so that the launch is one wave (res_rows): the
//    H100 (132 SMs, one block an SM) holds 7 clusters of 16, so B = 64 runs
//    as 7 clusters of 10 rows.  The rows fall into NT = ceil(R / 8) groups,
//    one n-tile of 8 each, which walk a step in turn.
//    A group's step: its product gates^T[c][r] = sum_k' W_hh[k'][c] h[r][k']
//    on mma.sync m16n8k16 in bf16: the weights exact, h (f32) as three bf16
//    terms h1 + h2 + h3 (h within 2^-24 |h|: as accurate as f32), three MMAs
//    a 16-k step, exact products summed in f32.  Warp w = (mg, kg) = (w /
//    RKG, w % RKG) holds MPW m-tiles (16 columns each) of m-group mg over
//    KPW 16-k steps of k-group kg, loads its B fragments of h (f32) and
//    splits each value there (so each value is split by the RMG = 2 warps
//    that multiply it, where the streaming walk split it in all 16), and
//    stores its partial tile to part[kg].  One block barrier; then the warp
//    that owns a row sums each of its U cells' gates over the RKG partials
//    in k-group order, adds gx, updates (h, c) in f32 registers (lane u:
//    unit rank U + u) and sends the new h (f32), 4 units a 16-byte st.async,
//    to every block of the cluster, counted on the receiver's mbarrier of
//    the group, half and k-group the units fall in (a wait that never
//    completes traps after ~2 s).  No cluster barrier a step.
//    What bounds the step: the product on the tensor cores (1,536 MMAs a
//    block a step at two row groups, on mma.sync, not wgmma) and the
//    exchange (every block receives R H 4 bytes a step over the SMs'
//    shared-memory network, whose rate is far below shared memory's); while
//    one group's h travels, the other group multiplies.  Sending h as its
//    three bf16 terms (split once, by its owner) moved 6 bytes a value and
//    was slower than splitting where it is read; so was a TMA bulk copy or
//    a TMA multicast through L2 in place of st.async (PERF.md).
//    Shared memory: the staged slice w_s [H][WS] (prologue only), then in
//    its place each group's h as received hf_s [NT][2][8][HF] f32
//    (double-buffered as in recurrence_kernel) and partial tiles part_s
//    [2][RKG][8][PS] f32, a group's step taking buffer (l NT + g) & 1: the
//    warps that write a buffer have passed the barrier of the group step
//    in between, so its cells are done reading it (at NT = 1 nothing else
//    orders the step l + 1 products after the step l cells, since the h
//    that starts them comes from other blocks); the mbarriers full
//    [NT][2][RKG] at the end.
// ---------------------------------------------------------------------------
constexpr int RCL = 16;      // blocks per cluster of the resident walk (non-portable)
constexpr int RT = 512;      // its threads
constexpr int RW = RT / 32;  // its warps
constexpr int RKG = 8;       // k-groups (warps sharing an m-group); RW / RKG m-groups
constexpr int RMG = RW / RKG;

template <int H>
struct Res {
  static constexpr int U = H / RCL, G4 = 4 * U, MT = G4 / 16, KS = H / 16;
  static constexpr int MPW = MT / RMG, KPW = KS / RKG;  // a warp's m-tiles and 16-k steps
  static constexpr int WS = G4 + 8;  // row stride (elements) of the staged slice
  static constexpr int HF = H + 8;   // row stride (floats) of h as received
  static constexpr int PS = G4 + 4;  // row stride (floats) of a partial tile
  static_assert(U == 32 && MT % RMG == 0 && KS % RKG == 0, "a lane a unit; whole m-tiles, k-steps");
};

template <int H>
__host__ __device__ constexpr size_t res_smem(int NT) {
  using P = Res<H>;
  const size_t stage = (size_t)H * P::WS * 2;
  const size_t walk = (size_t)NT * 2 * 8 * P::HF * 4 + (size_t)2 * RKG * 8 * P::PS * 4;
  return (stage > walk ? stage : walk) + (size_t)NT * 2 * RKG * 8;
}

// The block's slice of W_hh [H, 4H] (bf16) into shared memory, both
// resident walks' prologue: w_s[k'][g U + u] = W_hh[k'][g H + rank U + u],
// row stride WS, by 16-byte chunks (a chunk stays in one gate).
template <int H>
__device__ __forceinline__ void stage_res_slice(const __nv_bfloat16* __restrict__ w_hh,
                                                __nv_bfloat16* w_s, int rank) {
  using P = Res<H>;
  constexpr int CPR = P::G4 / 8;
  for (int i = threadIdx.x; i < H * CPR; i += RT) {
    const int kk = i / CPR, c = (i % CPR) * 8, g = c / P::U, u = c % P::U;
    *reinterpret_cast<uint4*>(w_s + kk * P::WS + c) =
        *reinterpret_cast<const uint4*>(w_hh + (size_t)kk * 4 * H + g * H + rank * P::U + u);
  }
  __syncthreads();
}

// A pair of f32 as three pairs of bf16 terms (the low element in the low
// half), each the rounding of what the terms before leave (x - t1 and
// x - t1 - t2 are exact in f32).
__device__ __forceinline__ void split3_bf16x2(float x, float y, uint32_t (&t)[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    t[a] = *reinterpret_cast<const uint32_t*>(&v);
    const float2 f = __bfloat1622float2(v);
    x -= f.x;
    y -= f.y;
  }
}

template <int H, int NT>
__global__ void __launch_bounds__(RT, 1)
recurrence_res_kernel(float* __restrict__ gx, const int64_t* __restrict__ lengths,
                      const __nv_bfloat16* __restrict__ w_hh, float* __restrict__ outs,
                      float* __restrict__ hT, float* __restrict__ cT, float* __restrict__ hprev,
                      float* __restrict__ cprev, int B, int L, int RR, int reverse) {
  using P = Res<H>;
  constexpr int U = P::U, MPW = P::MPW, KPW = P::KPW;
  constexpr int WS = P::WS, HF = P::HF, PS = P::PS, H4 = 4 * H;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / RCL) * RR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const int mg = warp / RKG, kg = warp % RKG;
  const bool train = hprev != nullptr;
  // the rows' groups: RG rows each (the last may have fewer), one n-tile each
  const int RG = (RR + NT - 1) / NT;
  auto group_rows = [&](int g) { return max(0, min(RG, RR - g * RG)); };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // the prologue's
  float* hf_s = reinterpret_cast<float*>(smem_raw);                 // [NT][2][8][HF]
  float* part_s = hf_s + NT * 2 * 8 * HF;                           // [2][RKG][8][PS]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + res_smem<H>(NT) -
                                               (size_t)NT * 2 * RKG * 8);  // [NT][2][RKG]

  auto row_len = [&](int row) {
    const int64_t n = row < B ? lengths[row] : 0;
    return n < 0 ? 0 : n > L ? L : (int)n;
  };
  int maxlen = 0;
  for (int r = 0; r < RR; ++r) maxlen = max(maxlen, row_len(row0 + r));
  // warp w < RR owns row row0 + w (group w / RG, n-tile row w % RG), lane
  // u the cell of unit rank U + u
  const bool cell = warp < RR;
  const int crow = row0 + warp, k = rank * U + lane, grp = warp / RG, ctr = warp % RG;
  const int clen = cell ? row_len(crow) : 0;
  // gx of this lane's cell at step l (valid steps only)
  auto gx_at = [&](int l, float (&v)[4]) {
    const int t = reverse ? maxlen - 1 - l : l;
    if (l < maxlen && t < clen) {
      const float* p = gx + ((size_t)crow * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = p[g * H];
    }
  };

  stage_res_slice<H>(w_hh, w_s, rank);
  // this warp's A fragments, in registers for the whole walk: matrices (k'
  // 0-7, c 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) of each 16 x 16 tile
  uint32_t wa[MPW][KPW][4];
#pragma unroll
  for (int mt = 0; mt < MPW; ++mt)
#pragma unroll
    for (int ks = 0; ks < KPW; ++ks)
      ldmatrix_x4_trans(wa[mt][ks], w_s + ((kg * KPW + ks) * 16 + ((lane >> 4) & 1) * 8 +
                                           (lane & 7)) * WS +
                                        (mg * MPW + mt) * 16 + ((lane >> 3) & 1) * 8);
  // group g's step l >= 1 reads the h its rows' warps sent at step l - 1,
  // into half l & 1, each k-group's units counted on its own barrier
  // full[g][l & 1][kg] (the bytes of the group's rows of the KPW 16 units
  // that the two blocks owning them send); a barrier is armed for the next
  // h it receives before that can come
  auto group_bytes = [&](int g) { return (uint32_t)group_rows(g) * KPW * 16 * 4; };
  if (tid == 0) {
    for (int b = 0; b < NT * 2 * RKG; ++b) mbar_init(smem_u32(&full[b]));
    for (int g = 0; g < NT; ++g)
      for (int q = 0; q < RKG; ++q) {
        if (1 < maxlen) mbar_expect_tx(smem_u32(&full[(g * 2 + 1) * RKG + q]), group_bytes(g));
        if (2 < maxlen) mbar_expect_tx(smem_u32(&full[(g * 2) * RKG + q]), group_bytes(g));
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block of the cluster is running, initialised and done reading its
  // staged slice, over which h and the partials now land
  cluster.sync();

  // the walk, a group at a time: one group's h travels while the other's
  // product runs
  float h = 0.f, c = 0.f, xg[4] = {0.f, 0.f, 0.f, 0.f};
  if (cell) gx_at(0, xg);
  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? maxlen - 1 - l : l;
    float xn[4] = {0.f, 0.f, 0.f, 0.f};
    if (cell) gx_at(l + 1, xn);  // the next step's, in flight during this one
#pragma unroll
    for (int g = 0; g < NT; ++g) {  // NT = ceil(RR / 8): no group is empty
      float* part = part_s + (size_t)((l * NT + g) & 1) * RKG * 8 * PS;
      if (l > 0) {  // h is 0 at the first step: its products are 0
        // this warp's k-slice of the group's h has landed; the first
        // m-group's warp arms its barrier for step l + 2 (which cannot come
        // before every block has passed this group's barrier below)
        const uint32_t bar = smem_u32(&full[(g * 2 + (l & 1)) * RKG + kg]);
        mbar_wait_cluster(bar, ((l - 1) >> 1) & 1);
        if (mg == 0 && lane == 0 && l + 2 < maxlen) mbar_expect_tx(bar, group_bytes(g));
        const float* hf = hf_s + (size_t)(g * 2 + (l & 1)) * 8 * HF + g8 * HF;
        float acc[MPW][4] = {};
#pragma unroll
        for (int ks = 0; ks < KPW; ++ks) {
          // B fragment: h[row g8][k' 2 q4, + 1] and [k' 2 q4 + 8, + 1], each
          // value split here into its three bf16 terms.  Rows of the n-tile
          // past the group's read stale values, whose products land only in
          // their own columns of D, which no cell reads.
          const float* hp = hf + (kg * KPW + ks) * 16 + 2 * q4;
          const float2 lo = *reinterpret_cast<const float2*>(hp);
          const float2 hi = *reinterpret_cast<const float2*>(hp + 8);
          uint32_t b0[3], b1[3];
          split3_bf16x2(lo.x, lo.y, b0);
          split3_bf16x2(hi.x, hi.y, b1);
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int mt = 0; mt < MPW; ++mt) mma_bf16(acc[mt], wa[mt][ks], b0[a], b1[a]);
        }
        // D[c][r]: (g8, 2 q4), (g8, 2 q4 + 1), (g8 + 8, 2 q4), (g8 + 8, 2 q4 + 1)
        float* pp = part + ((size_t)kg * 8 + 2 * q4) * PS + mg * MPW * 16 + g8;
#pragma unroll
        for (int mt = 0; mt < MPW; ++mt) {
          pp[mt * 16] = acc[mt][0];
          pp[PS + mt * 16] = acc[mt][1];
          pp[mt * 16 + 8] = acc[mt][2];
          pp[PS + mt * 16 + 8] = acc[mt][3];
        }
      }
      __syncthreads();  // every k-group's partials of the group are in part

      if (warp < RR && grp == g) {
        float pre[4];
        const float* pp = part + (size_t)ctr * PS + lane;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          float s = 0.f;
          if (l > 0) {
            s = pp[gt * U];
#pragma unroll
            for (int q = 1; q < RKG; ++q) s += pp[(size_t)q * 8 * PS + gt * U];
          }
          pre[gt] = s + xg[gt];
        }
        const bool on = crow < B;
        if (train && on) {
          hprev[((size_t)t * B + crow) * H + k] = h;
          cprev[((size_t)t * B + crow) * H + k] = c;
        }
        float out = 0.f;
        if (t < clen) {
          c = sigmoidf(pre[1]) * c + sigmoidf(pre[0]) * tanhf(pre[2]);
          h = sigmoidf(pre[3]) * tanhf(c);
          out = h;
          if (train) {
            float* gp = gx + ((size_t)crow * L + t) * H4 + k;
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) gp[gt * H] = pre[gt];
          }
        }
        if (on) outs[((size_t)crow * L + t) * H + k] = out;

        // the new h of the row's U units (carries at invalid rows) to every
        // block of the cluster: lane l gathers chunk j = l % 8 (units
        // 4j..4j+3) and sends it to blocks l / 8 + 4m, counted on the
        // barrier of the k-group its units fall in.  A block has all of
        // the group's step l + 1 h only once every block has passed the
        // group's barrier above, i.e. is done reading its step l h;
        // nothing reads the last step's h.
        if (l + 1 < maxlen) {
          const int j = lane & 7;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = __shfl_sync(0xffffffffu, h, 4 * j + e);
          const int half = g * 2 + ((l + 1) & 1);
          const uint32_t dst = smem_u32(hf_s + ((size_t)half * 8 + ctr) * HF + rank * U + 4 * j);
          const uint32_t bar = smem_u32(&full[half * RKG + rank / 2]);
#pragma unroll
          for (int m = 0; m < RCL / 4; ++m) {
            const int d = (lane >> 3) + 4 * m;
            st_async4(cluster_addr(dst, d), v, cluster_addr(bar, d));
          }
        }
      }
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) xg[gt] = xn[gt];
  }
  // No cluster barrier at the end: the last st.async into a block (the h
  // of its last step) is awaited by that block before it leaves.

  // steps past the cluster's longest row output 0; the carries are final
  // (their residual carries: the final state forward, the zero initial
  // state in reverse, where those steps come first)
  if (cell && crow < B) {
    hT[(size_t)crow * H + k] = h;
    cT[(size_t)crow * H + k] = c;
    for (int t = maxlen; t < L; ++t) {
      outs[((size_t)crow * L + t) * H + k] = 0.f;
      if (train) {
        hprev[((size_t)t * B + crow) * H + k] = reverse ? 0.f : h;
        cprev[((size_t)t * B + crow) * H + k] = reverse ? 0.f : c;
      }
    }
  }
}

// A resident walk's kernel `kern` (either direction) and its launch
// configuration for clusters of RCL blocks of RT threads with `smem` bytes
// (grid: `clusters` of them).
inline cudaError_t res_config(const void* kern, size_t smem, int clusters, cudaStream_t stream,
                              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * RCL);
  cfg->blockDim = dim3(RT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = RCL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// The clusters of a resident walk's kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters), asked once a process: *cached < 0
// until then.
inline cudaError_t res_at_once(const void* kern, size_t smem, int* cached, int* n) {
  if (*cached < 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = res_config(kern, smem, 1, nullptr, &cfg, &attr);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(cached, kern, &cfg);
    if (e != cudaSuccess) {
      *cached = -1;
      return e;
    }
  }
  *n = *cached;
  return cudaSuccess;
}

// A resident walk's rows a cluster: B spread over the clusters the card
// holds at once, at most 16 (ops/cuda/lstm_scan.py::res_rows).
inline int res_rows_of(int B, int at_once) {
  const int n = max(at_once, 1);
  return min((B + n - 1) / n, 16);
}

// The forward's (NT n-tiles), and its rows from its count at NT = 1.
template <int H, int NT>
cudaError_t res_clusters_at_once(int* n) {
  static int cached = -1;
  return res_at_once((const void*)recurrence_res_kernel<H, NT>, res_smem<H>(NT), &cached, n);
}
template <int H>
cudaError_t res_rows(int B, int* rows, int* at_once) {
  const cudaError_t e = res_clusters_at_once<H, 1>(at_once);
  *rows = res_rows_of(B, *at_once);
  return e;
}

template <int H, int NT>
cudaError_t launch_res(float* gx, const int64_t* lengths, const __nv_bfloat16* w_hh, float* outs,
                       float* hT, float* cT, float* hprev, float* cprev, int B, int L, int rows,
                       int reverse, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = res_config((const void*)recurrence_res_kernel<H, NT>, res_smem<H>(NT),
                             (B + rows - 1) / rows, stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, recurrence_res_kernel<H, NT>, gx, lengths, w_hh, outs, hT, cT,
                            hprev, cprev, B, L, rows, reverse);
}

template <int H>
cudaError_t launch_res(float* gx, const int64_t* lengths, const __nv_bfloat16* w_hh, float* outs,
                       float* hT, float* cT, float* hprev, float* cprev, int B, int L,
                       int reverse, cudaStream_t stream) {
  int rows, at_once;
  const cudaError_t e = res_rows<H>(B, &rows, &at_once);
  if (e != cudaSuccess) return e;
  return (rows <= 8 ? launch_res<H, 1> : launch_res<H, 2>)(
      gx, lengths, w_hh, outs, hT, cT, hprev, cprev, B, L, rows, reverse, stream);
}

template <typename T>
cudaError_t launch_fwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* b, void* gx, void* outs, void* hT, void* cT, void* hprev,
                       void* cprev, void* wpack, int B, int L, int D, int H, int reverse,
                       cudaStream_t stream) {
  // ops/cuda/lstm_scan.py::lstm_scan_fwd_plan: bf16 on wgmma, f32 on split-TF32 mma.sync
  const int N = 4 * H;
  cudaError_t e;
  if constexpr (std::is_same<T, float>::value) {
    const size_t gsm = gx_smem(B);
    if ((e = cudaFuncSetAttribute(gates_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)gsm)) != cudaSuccess)
      return e;
    dim3 ggrid(N / GX_TN, min((B * L + GX_TM - 1) / GX_TM, GX_YMAX));
    gates_x_kernel<<<ggrid, GX_THREADS, gsm, stream>>>(
        static_cast<const float*>(xs), static_cast<const int64_t*>(lengths),
        static_cast<const float*>(w_ih), static_cast<const float*>(b), static_cast<float*>(gx), B,
        L, D, N);
    e = cudaGetLastError();
  } else {
    e = launch_gx_wgmma(static_cast<const T*>(xs), static_cast<const int64_t*>(lengths),
                        static_cast<const T*>(w_ih), static_cast<const T*>(b),
                        static_cast<float*>(gx), B, L, D, N, stream);
  }
  if (e != cudaSuccess) return e;

  const int clusters = (B + R - 1) / R;
  if (H > 256) {
    if constexpr (!std::is_same<T, float>::value) {  // bf16 at H = 512: W_hh resident
      if (H == 512)
        return launch_res<512>(
            static_cast<float*>(gx), static_cast<const int64_t*>(lengths),
            static_cast<const T*>(w_hh),
            static_cast<float*>(outs), static_cast<float*>(hT), static_cast<float*>(cT),
            static_cast<float*>(hprev), static_cast<float*>(cprev), B, L, reverse, stream);
    }
    if ((e = pack_whh<T>(w_hh, wpack, H, 0, stream)) != cudaSuccess) return e;
    const size_t wsm = wide_fwd_smem(H, sizeof(T));
    if ((e = cudaFuncSetAttribute(recurrence_wide_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsm)) !=
        cudaSuccess)
      return e;
    recurrence_wide_kernel<T><<<clusters * CL, WT, wsm, stream>>>(
        static_cast<float*>(gx), static_cast<const int64_t*>(lengths),
        static_cast<const T*>(wpack), static_cast<float*>(outs), static_cast<float*>(hT),
        static_cast<float*>(cT), static_cast<float*>(hprev), static_cast<float*>(cprev), B, L, H,
        reverse);
    return cudaGetLastError();
  }
  const size_t smem = fwd_rec_smem(H);
  if ((e = cudaFuncSetAttribute(recurrence_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return e;
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
// K2.2 (f32; bf16 takes dx_wgmma_kernel below) d_xs[m] = da[m] . W_ih^T
//      for every valid step m, 0 at every padded step.  Block (n tile, y):
//      y < ceil(Mv / DX_TM) takes valid steps [y * DX_TM, +DX_TM) and
//      columns [n0, n0 + DX_TN); later y write the zeros of the padded
//      steps, DX_TM at a time.  K = 4H streams through a ring of DX_STAGES
//      cp.async stages of DX_KC columns; four warps of 16 rows x 32 columns
//      each run m16n8k8 TF32 MMAs, three a product: da and W_ih split.
// ---------------------------------------------------------------------------
constexpr int DX_TM = 32, DX_TN = 64, DX_KC = 32, DX_STAGES = 3, DX_THREADS = 128;
constexpr int DX_AS = DX_KC + 4;  // row stride of a da or W_ih stage: conflict-free fragments

size_t dx_smem(int B) {
  return (size_t)(starts_ints(B) + DX_TM) * 4 + (size_t)DX_STAGES * (DX_TM + DX_TN) * DX_AS * 4;
}

__global__ void __launch_bounds__(DX_THREADS)
dx_gemm_kernel(const float* __restrict__ da, const float* __restrict__ w,
               const int64_t* __restrict__ lengths, float* __restrict__ dx, int B, int L, int D,
               int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* starts = reinterpret_cast<int*>(smem_raw);
  int* rows = starts + starts_ints(B);
  float* a_s = reinterpret_cast<float*>(rows + DX_TM);
  float* w_s = a_s + DX_STAGES * DX_TM * DX_AS;
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
      if (m >= 0 && n < D) dx[(size_t)m * D + n] = 0.f;
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
    float* ws = w_s + st * DX_TN * DX_AS;
    for (int i = tid; i < DX_TN * (DX_KC / 4); i += DX_THREADS) {
      const int r = i / (DX_KC / 4), q = i % (DX_KC / 4), n = n0 + r;
      cp_async16(ws + r * DX_AS + 4 * q, w + (size_t)min(n, D - 1) * K + k0 + 4 * q, n < D);
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
    const float* ws = w_s + (kc % DX_STAGES) * DX_TN * DX_AS + wn * 32 * DX_AS;
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
        tf32_split<true>(ws[(nt * 8 + g8) * DX_AS + kk + q4], bh[nt][0], bl[nt][0]);
        tf32_split<true>(ws[(nt * 8 + g8) * DX_AS + kk + q4 + 4], bh[nt][1], bl[nt][1]);
      }
      // term by term: back-to-back MMAs never feed each other
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], ah, bl[nt][0], bl[nt][1]);
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
      *reinterpret_cast<float2*>(dx + (size_t)m * D + n) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2.3 (f32; bf16 takes dw_wgmma_kernel below) dW[i, j] = sum over valid
//      steps m of a(m, i) da[m, j], j < J = 4H, and db.  blockIdx.z = mat *
//      DW_SPLITS + split: mat 0 takes a = xs [B, L, D] into dW_ih [D, 4H],
//      mat 1 a = hprev [L, B, H] (time-major) into dW_hh [H, 4H].  The
//      DW_SPLITS blocks of one output tile (DW_TI x DW_TJ) form a cluster;
//      split s reduces valid steps [s Mv / S, (s + 1) Mv / S) in order,
//      DW_KC at a time through a ring of cp.async stages, with eight warps
//      of 32 x 32 outputs on m16n8k8 TF32 MMAs (both operands split).  Then
//      each block puts its partial tile in shared memory, and after one
//      cluster barrier block s sums rows [s DW_TI / S, ..) of the tile over
//      the cluster's blocks in rank order: no atomics, the same sums every
//      run.  The cluster of tile (j, 0) of dW_hh also writes db[j..] as the
//      sum over the recurrence's clusters, in order, of their column sums.
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

// One split of one tile: the partial dW tile of a (xs or hprev) in acc,
// as mma D fragments of the warp's 2 x 4 tiles.
__device__ __forceinline__ void dw_tile(const float* __restrict__ a, const float* __restrict__ da,
                                        const int* starts, unsigned char* stages, int B, int L,
                                        int I, int J, int i0, int j0, bool time_major, int v0,
                                        int v1, float (&acc)[2][4][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  const int wi = warp >> 2, wj = warp & 3;  // 32 x 32 outputs a warp
  const int rr = tid / 8, sub = tid % 8;    // the stage row and the chunks this thread loads

  auto load_stage = [&](int st, int v) {
    float* as = reinterpret_cast<float*>(stages + st * DW_STAGE_BYTES);
    float* bs = reinterpret_cast<float*>(stages + st * DW_STAGE_BYTES + DW_KC * DW_AS * 4);
    const int vv = v + rr;
    const bool ok = vv < v1;
    int b = 0, t = 0;
    if (ok) {
      b = row_of(starts, B, L, vv, false);
      t = vv - starts[b];
    }
    const size_t m = (size_t)b * L + t;
    const float* ap = a + (time_major ? ((size_t)t * B + b) * I : m * I) + i0;
    // the 8 threads of a row take neighbouring chunks: conflict-free stores
#pragma unroll
    for (int c = sub; c < DW_TI / 4; c += 8)
      cp_async16(as + rr * DW_AS + c * 4, ap + (ok && i0 + c * 4 < I ? c * 4 : 0),
                 ok && i0 + c * 4 < I);
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
    const float* as = reinterpret_cast<const float*>(st) + wi * 32;
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
        const float* ap = as + mt * 16 + g8;
        tf32_split<true>(ap[(kk + q4) * DW_AS], ah[mt][0], al[mt][0]);
        tf32_split<true>(ap[(kk + q4) * DW_AS + 8], ah[mt][1], al[mt][1]);
        tf32_split<true>(ap[(kk + q4 + 4) * DW_AS], ah[mt][2], al[mt][2]);
        tf32_split<true>(ap[(kk + q4 + 4) * DW_AS + 8], ah[mt][3], al[mt][3]);
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
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is read: the caller reuses the memory
}

__global__ void __cluster_dims__(1, 1, DW_SPLITS) __launch_bounds__(DW_THREADS, 2)
dw_gemm_kernel(const float* __restrict__ xs, const float* __restrict__ hprev,
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
    dw_tile(hprev, da, starts, stages, B, L, I, J, i0, j0, true, v0, v1, acc);
  else
    dw_tile(xs, da, starts, stages, B, L, I, J, i0, j0, false, v0, v1, acc);

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

__host__ __device__ constexpr size_t wide_bwd_smem(int H, int elem) {
  return (size_t)WW * WSTAGES * WBQ * 2 * 32 * 4 * elem +
         (size_t)(4 * (H / 2) * R + 2 * CL * R * (H / CL)) * 4 + 2 * 8;
}

// K2.1, wide.  bwd_recurrence_kernel's layout and arithmetic (thread tid
// < R U owns row tid % R and unit tid / R; warp w the m-tiles 2w, 2w + 1 of
// the H units), its W_hh fragments streamed from wpack.  Shared memory: the
// warps' rings [WW][WSTAGES][WBQ x 2][32] fragments, dah_s and dal_s
// [2][G4][R], part_s [2][CL][U][R], full [2].
template <typename T>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(WT)
bwd_recurrence_wide_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                           const float* __restrict__ d_out, const float* __restrict__ dhT,
                           const float* __restrict__ dcT, const int64_t* __restrict__ lengths,
                           const T* __restrict__ wpack, float* __restrict__ da,
                           float* __restrict__ db_part, int B, int L, int H, int reverse) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int FB = 4 * sizeof(T);  // bytes of a lane's fragment
  constexpr int MPW = 2;             // m-tiles a warp
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / CL) * R;
  const int U = H / CL, G4 = 4 * U, H4 = 4 * H, KS = G4 / 8, NG = KS / WBQ, MT = H / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wring = smem_raw + (size_t)warp * WSTAGES * WBQ * MPW * 32 * FB;
  uint32_t* dah_s =
      reinterpret_cast<uint32_t*>(smem_raw + (size_t)WW * WSTAGES * WBQ * MPW * 32 * FB);
  uint32_t* dal_s = dah_s + 2 * G4 * R;
  float* part_s = reinterpret_cast<float*>(dal_s + 2 * G4 * R);
  uint64_t* full = reinterpret_cast<uint64_t*>(part_s + 2 * CL * U * R);
  const uint32_t step_bytes = CL * U * R * 4;

  int maxlen = 0;
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const int64_t n = row < B ? lengths[row] : 0;
    maxlen = max(maxlen, (int)(n < L ? n : L));
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
  // the saved gates (4), c_prev and d_out of step t, in registers a step ahead
  auto inputs_at = [&](int t, float (&v)[6]) {
    if (owner && t >= 0 && t < my_len) {
      const float* gp = gates + ((size_t)row * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = gp[g * H];
      v[4] = cprev[((size_t)t * B + row) * H + k];
      v[5] = d_out[((size_t)row * L + t) * H + k];
    }
  };
  // group j: k-steps (j % NG) WBQ .. of this warp's two m-tiles
  const T* wp = wpack + (size_t)rank * MT * KS * 32 * 4;
  auto load_group = [&](int j) {
    const int ks0 = (j % NG) * WBQ;
    unsigned char* dst = wring + (size_t)(j % WSTAGES) * WBQ * MPW * 32 * FB;
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      const int mt = warp * MPW + i;
      if (mt >= MT) continue;
#pragma unroll
      for (int kq = 0; kq < WBQ; ++kq)
        cp_async_n<FB>(dst + ((i * WBQ + kq) * 32 + lane) * FB,
                       wp + (((size_t)mt * KS + ks0 + kq) * 32 + lane) * 4, true);
    }
    cp_async_commit();
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&full[b]));
      mbar_expect_tx(smem_u32(&full[b]), step_bytes);  // steps 0 and 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = 0; j < WSTAGES - 1; ++j) load_group(j);
  cluster.sync();  // every block of the cluster is running and initialised

  float nx[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  inputs_at(reverse ? 0 : maxlen - 1, nx);
  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? l : maxlen - 1 - l;  // the forward's steps, backwards
    float* part = part_s + (l & 1) * CL * U * R;
    uint32_t* dah = dah_s + (l & 1) * G4 * R;
    uint32_t* dal = dal_s + (l & 1) * G4 * R;
    float nn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    inputs_at(reverse ? l + 1 : maxlen - 2 - l, nn);  // the next step's

    float d4[4] = {0.f, 0.f, 0.f, 0.f};
    if (owner) {
      if (t < my_len) {
        const float ig = sigmoidf(nx[0]), fg = sigmoidf(nx[1]);
        const float gg = tanhf(nx[2]), og = sigmoidf(nx[3]);
        const float cp = nx[4];
        const float tc = tanhf(fg * cp + ig * gg);
        const float dh_eff = dh + nx[5];
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

    // partial dh_prev = W_hh da over the block's columns, as
    // bwd_recurrence_kernel takes it, WBQ k-steps of both m-tiles a group
    float acc[MPW][WBQ][4] = {};
    for (int gi = 0; gi < NG; ++gi) {
      const int j = l * NG + gi;
      cp_async_wait<WSTAGES - 2>();  // group j has landed (this lane's copies)
      load_group(j + WSTAGES - 1);   // into the slot read at group j - 1
      const unsigned char* src = wring + (size_t)(j % WSTAGES) * WBQ * MPW * 32 * FB;
      uint32_t bh[WBQ][2], bl[WBQ][2], ah[MPW][WBQ][4], al[MPW][WBQ][4];
#pragma unroll
      for (int kq = 0; kq < WBQ; ++kq) {
        const int ks = gi * WBQ + kq;
        bh[kq][0] = dah[(ks * 8 + q4) * R + g8];
        bh[kq][1] = dah[(ks * 8 + q4 + 4) * R + g8];
        bl[kq][0] = dal[(ks * 8 + q4) * R + g8];
        bl[kq][1] = dal[(ks * 8 + q4 + 4) * R + g8];
#pragma unroll
        for (int i = 0; i < MPW; ++i)
          load_frag<T>(src + ((i * WBQ + kq) * 32 + lane) * FB, ah[i][kq], al[i][kq]);
      }
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        if (warp * MPW + i >= MT) continue;
        if constexpr (F32) {
#pragma unroll
          for (int kq = 0; kq < WBQ; ++kq) mma_tf32(acc[i][kq], al[i][kq], bh[kq][0], bh[kq][1]);
        }
#pragma unroll
        for (int kq = 0; kq < WBQ; ++kq) mma_tf32(acc[i][kq], ah[i][kq], bl[kq][0], bl[kq][1]);
#pragma unroll
        for (int kq = 0; kq < WBQ; ++kq) mma_tf32(acc[i][kq], ah[i][kq], bh[kq][0], bh[kq][1]);
      }
    }
    // each partial to the block that owns its unit
#pragma unroll
    for (int i = 0; i < MPW; ++i) {
      const int mt = warp * MPW + i;
      if (mt >= MT) continue;
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = acc[i][0][e];
#pragma unroll
        for (int q = 1; q < WBQ; ++q) s[e] += acc[i][q][e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = mt * 16 + g8 + 8 * h;
        st_async2(cluster_addr(smem_u32(part + (rank * U + kk % U) * R + 2 * q4), kk / U),
                  s[2 * h], s[2 * h + 1], cluster_addr(smem_u32(&full[l & 1]), kk / U));
      }
    }
    if (owner && t < my_len) {
      float* dp = da + ((size_t)row * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g * H] = d4[g];
    }
    if (owner) {
      mbar_wait_cluster(smem_u32(&full[l & 1]), (l >> 1) & 1);
      if (t < my_len) {
        float s = 0.f;
        for (int src = 0; src < CL; ++src) s += part[(src * U + u) * R + r];
        dh = s;
      }
      if (tid == 0 && l + 2 < maxlen) mbar_expect_tx(smem_u32(&full[l & 1]), step_bytes);
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) nx[q] = nn[q];
  }
  cp_async_wait<0>();  // the groups the ring ran ahead
  cluster.sync();      // every block is done with every other's shared memory

  float* db_s = reinterpret_cast<float*>(dah_s);
  if (owner) {
#pragma unroll
    for (int g = 0; g < 4; ++g) db_s[(g * U + u) * R + r] = db[g];
  }
  __syncthreads();
  for (int c = tid; c < G4; c += WT) {
    float s = 0.f;
    for (int r2 = 0; r2 < R; ++r2) s += db_s[c * R + r2];
    db_part[(size_t)(blockIdx.x / CL) * H4 + (c / U) * H + rank * U + c % U] = s;
  }
}

// ---------------------------------------------------------------------------
// K2.1, resident: the backward walk in bf16 at H = 512 (the Self-Monitor's
//    encoder), with no byte of W_hh read from L2 inside the step loop.  The
//    streaming walk above brings each block's 256 KB eighth of W_hh from L2
//    every step: 9.1 us a step at B = 64 on the H100.  Here, as in the
//    forward's resident walk, a cluster has RCL = 16 blocks of RT = 512
//    threads (non-portable, cudaLaunchKernelEx) and block `rank` owns the
//    U = 32 units [rank U, rank U + U) and their G4 = 128 gate columns,
//    gate-major (c = g U + u).  It stages its 128 KB slice of W_hh once
//    through shared memory (stage_res_slice) and keeps it in registers as
//    mma.sync m16n8k16 A fragments of A[k'][c] = W_hh[k'][column c]
//    (ldmatrix without .trans): 64 registers a thread.
//    The step's product, partial dh_prev[r][k'] = sum over the block's c of
//    W_hh[k'][c] da[r][c]: M = the H units k' (32 m-tiles), K = G4 (8
//    16-k steps), N = the rows of a group (one n-tile of 8).  Warp w takes
//    m-tiles 2w, 2w + 1 over all 8 k-steps: its k' = 32 w .. 32 w + 31 are
//    the units of block w, so no partial is reduced inside a block and
//    each warp's 32 x 8 tile goes whole to block w.  da is f32 and is
//    split once, by the cell that forms it, into three bf16 terms
//    (split3_bf16x2: within 2^-24 |da|); the weights are exact in bf16 and
//    the products exact in f32, summed in f32.
//    Exchange: each warp sends its tile by st.async to block w, 16 bytes
//    (4 rows of one unit) a store after one shuffle between lane pairs,
//    counted on block w's mbarrier of (row group, step parity); rows 4-7
//    of a group of at most 4 rows are not sent.  Block w's cells sum the
//    16 tiles of their units in rank order (a wait that never completes
//    traps after ~2 s).  Every block receives 16 x 32 x 8 x 4 = 16 KB a
//    group a step, the forward's volume.
//    Rows: R <= 16 rows a cluster, from this kernel's own count of the
//    clusters the card holds at once (bwd_res_rows), in NT = ceil(R / 8)
//    groups of RG = ceil(R / NT) rows that walk a step in turn: one
//    group's partials travel while the other's cells and product run.
//    Cells: thread tid < NT 8 U owns row tid % 8 of group tid / (8 U) and
//    unit (tid / 8) % U (a warp: 4 units x 8 rows, so that the 16 loads of
//    its partials are conflict-free); it carries (dh, dc) and its four
//    columns' sums of da in registers, and loads the saved gates, c_prev
//    and d_out a step ahead into registers.  The sigmoids and tanhs of da
//    (bwd_recurrence_wide_kernel's arithmetic) do not depend on the
//    carries: a cell reduces them to seven coefficients (coefs_of) while
//    its group's partials travel and the other group's cells run, so that
//    past the wait da is a few FMAs (a trace of the first design put 1,200
//    to 1,400 of a group step's 3,500 to 4,200 cycles there).  A group
//    step: the cells wait for and sum their partials of the step before
//    (dh, at a step that was valid for the cell), form da, store its terms
//    and write da to device memory (valid steps only); one block barrier;
//    every warp multiplies and sends; the cells form the next step's
//    coefficients.  The last step sends nothing (dh_prev of the first step
//    is not an output).
//    Shared memory: the staged slice w_s [H][WS] bf16 (prologue only), then
//    in its place recv_s [NT][2][RCL][U][8] f32 (the partials a group
//    receives, by the sending step's parity), da_s [2][3][8][WS] bf16 (the
//    terms of a group step's da, [term][row][column]), and the mbarriers
//    full [NT][2] at the end; after the walk db's row sums [G4][16] f32
//    in recv_s's place.  The buffers, each read after a barrier by other
//    warps or blocks than those that write it:
//    - da_s: written by the cells at group step s = l NT + g, read by
//      every warp's product after the barrier of s.  Two copies, s & 1:
//      a warp writes copy s & 1 again at s + 2, after it has passed the
//      barrier of s + 1, which every warp reaches only after its product
//      of s.  One copy would race: the warps that are cells of s + 1 can
//      write while other warps still multiply s.
//    - recv_s[g][l & 1]: written by the other blocks' sends of step l,
//      read by this block's cells of group g at step l + 1.  The sends of
//      step l + 2 into it follow, in each sender, its cells of (l + 2, g),
//      which wait for this block's sends of (l + 1, g), which follow this
//      block's barrier of (l + 1, g), after its cells' reads.  Its barrier
//      is armed for step l + 2 by the group's first cell thread after its
//      wait at step l + 1, before that barrier.  One copy would race: the
//      sends of step l + 1 follow only the barrier of step l.
//    - db's row sums: after the walk every partial a block is sent has
//      been awaited by it, so nothing lands in recv_s any more.
//    What bounds a step: the product on the tensor cores (48 MMAs a warp a
//    group step, at mma.sync's rate: ~1,440 of a group step's ~2,700
//    cycles at two groups on the H100), then the partials' sum, the cells
//    and the sends (PERF.md); wgmma is the lever not tried.
// ---------------------------------------------------------------------------
template <int H>
__host__ __device__ constexpr size_t bwd_res_smem(int NT) {
  using P = Res<H>;
  const size_t stage = (size_t)H * P::WS * 2;
  const size_t walk = (size_t)NT * 2 * RCL * P::U * 8 * 4 + (size_t)2 * 3 * 8 * P::WS * 2;
  return (stage > walk ? stage : walk) + (size_t)NT * 2 * 8;
}

template <int H, int NT>
__global__ void __launch_bounds__(RT, 1)
bwd_recurrence_res_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                          const float* __restrict__ d_out, const float* __restrict__ dhT,
                          const float* __restrict__ dcT, const int64_t* __restrict__ lengths,
                          const __nv_bfloat16* __restrict__ w_hh, float* __restrict__ da,
                          float* __restrict__ db_part, int B, int L, int RR, int reverse) {
  using P = Res<H>;
  constexpr int U = P::U, G4 = P::G4, WS = P::WS, H4 = 4 * H;
  constexpr int KS = G4 / 16, MPW = U / 16;  // a warp's 16-k steps and m-tiles
  static_assert(RW == RCL && MPW * 16 * RW == H && KS % 2 == 0, "warp w: block w's units");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / RCL, row0 = cid * RR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, q4 = lane & 3;
  // the rows' groups: RG rows each (the last may have fewer), one n-tile each
  const int RG = (RR + NT - 1) / NT;
  auto group_rows = [&](int g) { return max(0, min(RG, RR - g * RG)); };

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // the prologue's
  float* recv_s = reinterpret_cast<float*>(smem_raw);               // [NT][2][RCL][U][8]
  __nv_bfloat16* da_s = reinterpret_cast<__nv_bfloat16*>(recv_s + NT * 2 * RCL * U * 8);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + bwd_res_smem<H>(NT) -
                                               (size_t)NT * 2 * 8);  // [NT][2]

  auto row_len = [&](int row) {
    const int64_t n = row < B ? lengths[row] : 0;
    return n < 0 ? 0 : n > L ? L : (int)n;
  };
  int maxlen = 0;
  for (int r = 0; r < RR; ++r) maxlen = max(maxlen, row_len(row0 + r));
  // this thread's cell: row cr of group grp (row ri of the cluster), unit cu
  const bool cell = tid < NT * 8 * U;
  const int grp = tid / (8 * U), cr = tid & 7, cu = (tid >> 3) % U;
  const int ri = grp * RG + cr, crow = row0 + ri, k = rank * U + cu;
  const bool mine = cell && cr < group_rows(grp);  // a row of the cluster
  const bool live = mine && crow < B;
  const int clen = live ? row_len(crow) : 0;
  float dh = 0.f, dc = 0.f, db[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    dh = dhT[(size_t)crow * H + k];
    dc = dcT[(size_t)crow * H + k];
  }
  // the saved gates (4), c_prev and d_out of step l, in registers a step ahead
  auto inputs_at = [&](int l, float (&v)[6]) {
    const int t = reverse ? l : maxlen - 1 - l;
    if (l < maxlen && t < clen) {
      const float* gp = gates + ((size_t)crow * L + t) * H4 + k;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = gp[g * H];
      v[4] = cprev[((size_t)t * B + crow) * H + k];
      v[5] = d_out[((size_t)crow * L + t) * H + k];
    }
  };
  // what da needs of them, none of which depends on the carries: dct = dc
  // + dh_eff c[0], da = (dct c[1], dct c[2], dct c[3], dh_eff c[4]), dc' =
  // dct c[5], dh_eff = dh + c[6]
  auto coefs_of = [&](const float (&v)[6], float (&c)[7]) {
    const float ig = sigmoidf(v[0]), fg = sigmoidf(v[1]);
    const float gg = tanhf(v[2]), og = sigmoidf(v[3]);
    const float cp = v[4], tc = tanhf(fg * cp + ig * gg);
    c[0] = og * (1.f - tc * tc);
    c[1] = gg * ig * (1.f - ig);
    c[2] = cp * fg * (1.f - fg);
    c[3] = ig * (1.f - gg * gg);
    c[4] = tc * og * (1.f - og);
    c[5] = fg;
    c[6] = v[5];
  };

  stage_res_slice<H>(w_hh, w_s, rank);
  // this warp's A fragments, in registers for the whole walk: matrices (k'
  // 0-7, c 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) of each 16 x 16 tile
  uint32_t wa[MPW][KS][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(wa[i][ks], w_s + (warp * U + i * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * WS +
                                 ks * 16 + (lane >> 4) * 8);
  // the partials of group g's step l land in recv_s[g][l & 1], counted on
  // full[g][l & 1]: the bytes of the rows that the 16 blocks send
  auto group_bytes = [&](int g) {
    return (uint32_t)RCL * U * (group_rows(g) > 4 ? 8 : 4) * 4;
  };
  if (tid == 0) {
    for (int b = 0; b < NT * 2; ++b) mbar_init(smem_u32(&full[b]));
    for (int g = 0; g < NT; ++g) {
      if (1 < maxlen) mbar_expect_tx(smem_u32(&full[g * 2]), group_bytes(g));      // step 0's
      if (2 < maxlen) mbar_expect_tx(smem_u32(&full[g * 2 + 1]), group_bytes(g));  // step 1's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block of the cluster is running, initialised and done reading its
  // staged slice, over which the partials and da's terms now land
  cluster.sync();

  float cf[7];  // this step's coefficients of da
  {
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    inputs_at(0, v);
    coefs_of(v, cf);
  }
  bool was_valid = false;  // whether the cell's previous step was valid
  for (int l = 0; l < maxlen; ++l) {
    const int t = reverse ? l : maxlen - 1 - l;  // the forward's steps, backwards
    float nn[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    inputs_at(l + 1, nn);  // the next step's, in flight during this one
#pragma unroll
    for (int g = 0; g < NT; ++g) {  // NT = ceil(RR / 8): no group is empty
      __nv_bfloat16* dab = da_s + (size_t)((l * NT + g) & 1) * 3 * 8 * WS;
      if (cell && grp == g) {
        if (l > 0) {
          // the 16 blocks' partials of the step before, summed in rank
          // order; the group's first thread arms the barrier for step l + 1
          const int half = g * 2 + ((l - 1) & 1);
          const uint32_t bar = smem_u32(&full[half]);
          mbar_wait_cluster(bar, ((l - 1) >> 1) & 1);
          if (tid == g * 8 * U && l + 2 < maxlen) mbar_expect_tx(bar, group_bytes(g));
          const float* rp = recv_s + ((size_t)half * RCL * U + cu) * 8 + cr;
          float s = rp[0];
#pragma unroll
          for (int src = 1; src < RCL; ++src) s += rp[src * U * 8];
          if (was_valid) dh = s;
        }
        float d4[4] = {0.f, 0.f, 0.f, 0.f};
        const bool valid = t < clen;
        if (valid) {  // a few FMAs past the wait: the coefficients are ready
          const float dh_eff = dh + cf[6];
          const float dct = dc + dh_eff * cf[0];
          d4[0] = dct * cf[1];
          d4[1] = dct * cf[2];
          d4[2] = dct * cf[3];
          d4[3] = dh_eff * cf[4];
          dc = dct * cf[5];
          float* dp = da + ((size_t)crow * L + t) * H4 + k;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) dp[gt * H] = d4[gt];
        }
        was_valid = valid;
        // da's three bf16 terms, B^T [row][column] (zeros at invalid steps)
#pragma unroll
        for (int gt = 0; gt < 4; gt += 2) {
          uint32_t tt[3];
          split3_bf16x2(d4[gt], d4[gt + 1], tt);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            __nv_bfloat16* p = dab + (a * 8 + cr) * WS + cu;
            p[gt * U] = __ushort_as_bfloat16((unsigned short)(tt[a] & 0xffffu));
            p[(gt + 1) * U] = __ushort_as_bfloat16((unsigned short)(tt[a] >> 16));
          }
        }
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) db[gt] += d4[gt];
      }
      __syncthreads();  // the group's da terms are in dab

      if (l + 1 < maxlen) {
        // partial dh_prev^T[k'][r] over the block's columns: two chains an
        // m-tile (even and odd k-steps), B fragments by ldmatrix, two
        // k-steps of one term at a time
        float acc[MPW][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2)
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            uint32_t b[4];
            ldmatrix_x4(b, dab + (a * 8 + (lane & 7)) * WS + ks * 16 + (lane >> 3) * 8);
#pragma unroll
            for (int i = 0; i < MPW; ++i) {
              mma_bf16(acc[i][0], wa[i][ks], b[0], b[1]);
              mma_bf16(acc[i][1], wa[i][ks + 1], b[2], b[3]);
            }
          }
        // D[k'][r]: (g8, 2 q4), (g8, 2 q4 + 1), (g8 + 8, 2 q4), (g8 + 8,
        // 2 q4 + 1).  Lane pairs swap halves: the even lane sends rows
        // 4 (q4 / 2) .. + 3 of unit g8, the odd one those of unit g8 + 8
        const int half = g * 2 + (l & 1);
        const uint32_t bar = cluster_addr(smem_u32(&full[half]), warp);
        const bool odd = q4 & 1, send = q4 < 2 || group_rows(g) > 4;
#pragma unroll
        for (int i = 0; i < MPW; ++i) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = acc[i][0][e] + acc[i][1][e];
          const float y0 = __shfl_xor_sync(0xffffffffu, odd ? d[0] : d[2], 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, odd ? d[1] : d[3], 1);
          const float v[4] = {odd ? y0 : d[0], odd ? y1 : d[1], odd ? d[2] : y0,
                              odd ? d[3] : y1};
          const int unit = i * 16 + g8 + (odd ? 8 : 0);
          const uint32_t dst =
              smem_u32(recv_s + (((size_t)half * RCL + rank) * U + unit) * 8 + 4 * (q4 >> 1));
          if (send) st_async4(cluster_addr(dst, warp), v, bar);
        }
      }
      // the group's coefficients of the next step, while its partials
      // travel and the other group's cells run
      if (cell && grp == g) coefs_of(nn, cf);
    }
  }
  // No cluster barrier at the end: every partial sent to a block is
  // awaited by that block before it leaves the walk.

  // this cluster's column sums of da over its rows, in order, for db
  float* db_s = recv_s;  // [G4][16]
  if (mine) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) db_s[(gt * U + cu) * 16 + ri] = db[gt];
  }
  __syncthreads();
  for (int c = tid; c < G4; c += RT) {
    float s = 0.f;
    for (int r = 0; r < RR; ++r) s += db_s[c * 16 + r];
    db_part[(size_t)cid * H4 + (c / U) * H + rank * U + c % U] = s;
  }
}

// The backward's clusters at once (NT n-tiles), and its rows from its
// count at NT = 1: its shared memory is not the forward's.
template <int H, int NT>
cudaError_t bwd_res_clusters_at_once(int* n) {
  static int cached = -1;
  return res_at_once((const void*)bwd_recurrence_res_kernel<H, NT>, bwd_res_smem<H>(NT), &cached,
                     n);
}
template <int H>
cudaError_t bwd_res_rows(int B, int* rows, int* at_once) {
  const cudaError_t e = bwd_res_clusters_at_once<H, 1>(at_once);
  *rows = res_rows_of(B, *at_once);
  return e;
}

template <int H, int NT>
cudaError_t launch_bwd_res(const float* gates, const float* cprev, const float* d_out,
                           const float* dhT, const float* dcT, const int64_t* lengths,
                           const __nv_bfloat16* w_hh, float* da, float* db_part, int B, int L,
                           int rows, int reverse, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = res_config((const void*)bwd_recurrence_res_kernel<H, NT>, bwd_res_smem<H>(NT),
                             (B + rows - 1) / rows, stream, &cfg, &attr);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, bwd_recurrence_res_kernel<H, NT>, gates, cprev, d_out, dhT, dcT,
                            lengths, w_hh, da, db_part, B, L, rows, reverse);
}

// ---------------------------------------------------------------------------
// K2.2 and K2.3 on the bf16 route: wgmma GEMMs fed by TMA.
//
// dx_gemm and dw_gemm above took 0.1808 and 0.2398 ms of K2's 0.5269 ms at
// the speaker's first layer (D = 2176, H = 256, 2,240 valid steps; cuDNN's
// backward 0.3853) in bf16 on the H100: about 5% of the card's bf16 rate.
// They run mma.sync in TF32 with da split into two halves (two MMAs a
// product), in small tiles that load and split the same da rows again for
// every column tile, through cp.async rings that every thread issues.  The
// f32 route keeps them; in bf16:
// 0. bwd_pack_kernel packs every GEMM operand by valid step v (numbered as
//    above) into plain 2-D matrices: X [P, D] (bf16, exact), Hprev as three
//    bf16 terms [3][P, H] and da as three [3][P, 4H] (split3_bf16x2: the
//    sum of the terms is within 2^-24 of the f32 value), P = B L rows, of
//    which [0, Mv) hold the valid steps and [Mv, Mv rounded up to WG_DW_K)
//    zeros.  So no TMA box straddles two batch rows, and no padded step is
//    multiplied.  It also writes d_xs's zeros at the padded steps.
// 1. dx_wgmma_kernel: d_xs[v] = sum_k (t3 + t2 + t1)[v][k] W_ih[n][k] on
//    tiles of WG_M valid steps x WG_N columns.  Both operands are K-major
//    (K = 4H): wgmma m64n128k16 reads them from 128-byte-swizzled shared
//    memory as they are, three a k16 step (the smallest term first) into
//    f32 accumulators; the sums are rounded to bf16 once and scattered to
//    the valid step's row of [B, L, D].  Where the tiles are few (D = 256)
//    K is split S ways (dx_splits) and a tile's S blocks sum their partial
//    tiles in rank order through distributed shared memory, as dW's do:
//    without (dx_S1) EnvDrop's and the Self-Monitor's shapes took 14-36%
//    more time; the speaker's second layer in bf16 (on no path: it runs in
//    f32), whose 72 tiles of whole rows split past a wave, 37% less.
// 2. dw_wgmma_kernel: dW_ih[i][j] = sum_v X[v][i] da[v][j] and dW_hh[i][j]
//    = sum_v Hp[v][i] da[v][j] on tiles of WG_M x WG_N outputs, K = the
//    valid steps.  Both operands are MN-major, which bf16 wgmma takes
//    through its transpose bits (TF32 wgmma takes K-major operands only:
//    the reason for bf16 terms rather than TF32 halves).  dW_ih takes the
//    three terms of da; dW_hh the six term products Hp_i da_j with i + j
//    <= 4 (each of the three left out is below 2^-25 of |Hp da|).  The
//    steps are split S ways (dw_splits); a tile's S blocks form a cluster
//    and sum their partial tiles in rank order through distributed shared
//    memory: no atomics, the same sums every run.  db sums the walk's
//    cluster column sums in order.
// Both GEMM kernels run two consumer warpgroups of 64 output rows each and
// one producer warp, whose lane 0 keeps a ring of TMA boxes (64 bf16 wide,
// 128-byte rows) in flight on mbarriers; a consumer warpgroup releases a
// stage once the wgmma group that read it has completed (wgmma.wait_group
// 1), so loads, products and the release of stages overlap.  Both are
// bound by moving their operands from L2 (the three terms triple the da
// operand): dw_wgmma without its products took 68-87% of its time at the
// path shapes on the H100 (scripts/torch_k2_wgmma_variants.py,
// dw_no_products).  So dw_wgmma takes K-tiles of 32 steps and a ring half
// dx_wgmma's, and two of its blocks share an SM, one's loads running under
// the other's products and reduction: with K-tiles of 64 at one block an
// SM (dw_k64) it took 17-41% more time at every path shape.
// Bound: the speaker's useful products are 2 x 2240 x 1024 x 2176 = 10.0
// GFLOP for d_xs and as many for dW_ih (10 us each at the card's 989
// TFLOP/s); the terms make them 30 GFLOP of bf16 wgmma each, with 7 more
// for dW_hh's six products.
// ---------------------------------------------------------------------------
constexpr int WG_M = 128, WG_N = 128;  // a GEMM's output tile
constexpr int WG_THREADS = 288;        // two consumer warpgroups, one producer warp
// K-tiles: dx's of 64 gate columns, dw's of 32 valid steps.  A TMA box is
// 64 bf16 wide (128-byte rows) and a K-tile deep, a slot one operand
// term's 128-row tile (two boxes), a ring 12 slots: 3 stages of 4 (three
// da terms and W_ih; X and three da terms) or 2 of 6 (three Hprev terms
// and three da terms)
constexpr int WG_DX_K = 64, WG_DW_K = 32;
constexpr int WG_DX_BOX = 64 * WG_DX_K * 2, WG_DW_BOX = 64 * WG_DW_K * 2;
constexpr int WG_DX_SLOT = 2 * WG_DX_BOX, WG_DW_SLOT = 2 * WG_DW_BOX;
constexpr int WG_DX_RING = 12 * WG_DX_SLOT, WG_DW_RING = 12 * WG_DW_SLOT;
constexpr int WG_RS = WG_N + 4;  // f32 row stride of dw's partial tile
constexpr int WG_SMS = 132;      // the H100's SMs, which dx_splits and dw_splits fill
constexpr int PACK_WARPS = 8;    // sequence rows a pack block, one a warp

// Dynamic shared memory of a wgmma GEMM block: starts, 4 full and 4 empty
// mbarriers, up to 1 KB to align the ring (the 128-byte swizzle repeats
// every 1024 bytes), the ring.
size_t wg_smem(int B, int ring) { return (size_t)starts_ints(B) * 4 + 64 + 1024 + ring; }

// dx_wgmma's splits of K = 4H: the smallest S in {1, 2, 4, 8} whose tiles
// x S blocks, the tiles counted for B L valid steps, fill 70% of a wave of
// one block an SM, at most 8 and the nk K-tiles; short step counts (11-20
// tokens of 80) leave most of those tiles empty, so a split still fills
// more SMs (ops/cuda/lstm_scan.py::dx_splits).
int dx_splits(int tiles, int nk) {
  int s = 1;
  while (s < 8 && 2 * s <= nk && tiles * s * 10 < 7 * WG_SMS) s *= 2;
  return s;
}

// dw_wgmma's splits of the steps: the smallest S in {1, 2, 4, 8} whose
// tiles x S blocks fill 70% of a wave of two blocks an SM, doubled once
// more where that leaves a second wave under half full; fewer blocks
// leave SMs idle, more pay more reductions (the fastest of the four at
// the path shapes on the H100 but at EnvDrop's 11-20 tokens, where 4 beat
// 8 by 0.003 ms: scripts/torch_k2_wgmma_variants.py;
// ops/cuda/lstm_scan.py::dw_splits).
int dw_splits(int tiles) {
  const int wave = 2 * WG_SMS;
  int s = 1;
  while (s < 8 && tiles * s * 10 < 7 * wave) s *= 2;
  if (s < 8 && tiles * s > wave && 2 * tiles * s <= 3 * wave) s *= 2;
  return s;
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// A wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand
// at shared address addr, with leading and stride byte offsets lbo and sbo.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products that own them.
template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A . B on one m64n128k16 step of bf16 operands, f32 d, each operand
// K-major (T = 0: A as [m][k], B as [n][k]) or MN-major (T = 1: A as
// [k][m], B as [k][n], through wgmma's transpose bits; a 128-column B is
// two swizzle atoms of 64 columns, the descriptor's leading byte offset
// apart).  Warp w of the warpgroup holds rows 16 w + l / 4 (d[4 j],
// d[4 j + 1]) and + 8 (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 (l % 4)
// and + 1, j < 16; d0 holds j < 8 (columns 0-63), d1 the rest.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_128(float (&d0)[32], float (&d1)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// K2.0 (bf16): warp w of block x packs sequence row m = x PACK_WARPS + w.
__global__ void __launch_bounds__(PACK_WARPS * 32)
bwd_pack_kernel(const __nv_bfloat16* __restrict__ xs, const float* __restrict__ hprev,
                const float* __restrict__ da, const int64_t* __restrict__ lengths,
                __nv_bfloat16* __restrict__ xp, __nv_bfloat16* __restrict__ hp,
                __nv_bfloat16* __restrict__ dap, __nv_bfloat16* __restrict__ d_xs, int B, int L,
                int D, int H) {
  extern __shared__ int pack_starts[];
  valid_starts(lengths, B, L, pack_starts);
  const int P = B * L, Mv = pack_starts[B];
  const int Mz = min(P, (Mv + WG_DW_K - 1) / WG_DW_K * WG_DW_K);  // packed rows [Mv, Mz): zeros
  const int lane = threadIdx.x & 31, m = blockIdx.x * PACK_WARPS + (threadIdx.x >> 5);
  if (m >= P) return;
  const int b = m / L, t = m % L, len = pack_starts[b + 1] - pack_starts[b];
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  const bool valid = t < len;
  // the packed row: valid step v, or padded step number q's zero row Mv + q
  const int v = valid ? pack_starts[b] + t : Mv + b * L - pack_starts[b] + t - len;
  if (!valid) {
    uint4* dz = reinterpret_cast<uint4*>(d_xs + (size_t)m * D);
    for (int c = lane; c < D / 8; c += 32) dz[c] = z4;
    if (v >= Mz) return;
  }
  const uint4* xsrc = reinterpret_cast<const uint4*>(xs + (size_t)m * D);
  uint4* xdst = reinterpret_cast<uint4*>(xp + (size_t)v * D);
  for (int c = lane; c < D / 8; c += 32) xdst[c] = valid ? xsrc[c] : z4;
  // a row of n f32 as three bf16 terms, term a at dst + a P n
  auto split_row = [&](const float* src, __nv_bfloat16* dst, int n) {
    for (int c = lane; c < n / 4; c += 32) {
      const float4 f = valid ? reinterpret_cast<const float4*>(src)[c] : make_float4(0, 0, 0, 0);
      uint32_t lo[3], hi[3];
      split3_bf16x2(f.x, f.y, lo);
      split3_bf16x2(f.z, f.w, hi);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        reinterpret_cast<uint2*>(dst + (size_t)a * P * n)[c] = make_uint2(lo[a], hi[a]);
    }
  };
  split_row(hprev + ((size_t)t * B + b) * H, hp + (size_t)v * H, H);
  split_row(da + (size_t)m * 4 * H, dap + (size_t)v * 4 * H, 4 * H);
}

// The shared-memory layout of a wgmma GEMM block: starts, then the full
// [4] and empty [4] mbarriers, then the ring at the next 1024-byte
// boundary (its shared address).
struct WgSmem {
  int* starts;
  uint64_t* bars;
  uint32_t ring;
  unsigned char* ring_ptr;
};
__device__ __forceinline__ WgSmem wg_layout(unsigned char* raw, int B) {
  WgSmem s;
  s.starts = reinterpret_cast<int*>(raw);
  s.bars = reinterpret_cast<uint64_t*>(raw + starts_ints(B) * 4);
  const uint32_t base = smem_u32(raw), head = base + starts_ints(B) * 4 + 64;
  s.ring = (head + 1023u) & ~1023u;
  s.ring_ptr = raw + (s.ring - base);
  return s;
}

// Full barriers (one arrival: the producer's, and the boxes' bytes) and
// empty ones (one arrival a consumer warpgroup) of ST stages.
__device__ __forceinline__ void wg_init_bars(uint64_t* bars, int ST) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init_count(smem_u32(&bars[s]), 1);
      mbar_init_count(smem_u32(&bars[4 + s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A consumer warpgroup's partial tile (64 rows x 128 columns in acc0 and
// acc1, wgmma_128's layout) into the f32 tile red [WG_M][WG_RS].
__device__ __forceinline__ void wg_stage_partial(float* red, const float (&acc0)[32],
                                                 const float (&acc1)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = red + (r0 + 8 * h) * WG_RS + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(p) = make_float2(acc0[4 * j + 2 * h], acc0[4 * j + 2 * h + 1]);
      *reinterpret_cast<float2*>(p + 64) =
          make_float2(acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
    }
}

// Block `split` of a cluster of S sums rows [split M / S, (split + 1) M / S)
// of the cluster's partial tiles red over the blocks in rank order (no
// atomics: the same sums every run), four columns at a time: put(row,
// column, sums).
template <typename Put>
__device__ __forceinline__ void wg_cluster_sum(cg::cluster_group& cluster, float* red, int S,
                                               int split, Put put) {
  const int rows = WG_M / S;
  for (int e = threadIdx.x; e < rows * (WG_N / 4); e += WG_THREADS) {
    const int ri = split * rows + e / (WG_N / 4), c = 4 * (e % (WG_N / 4));
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, 0) + ri * WG_RS + c);
    for (int q = 1; q < S; ++q) {
      const float4 p =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + ri * WG_RS + c);
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    put(ri, c, s);
  }
}

// K2.2 (bf16): block (n tile, m tile, split); the S = gridDim.z splits of
// a tile form a cluster, split z taking K-tiles [nk z / S, nk (z + 1) / S)
// (dx_splits; S = 1 stores from the registers).  m_da: da's terms
// [3][P][4H]; m_w: W_ih [D][4H]; both in boxes of {64, WG_DX_K}.
__global__ void __launch_bounds__(WG_THREADS, 1)
dx_wgmma_kernel(const __grid_constant__ CUtensorMap m_da, const __grid_constant__ CUtensorMap m_w,
                const int64_t* __restrict__ lengths, __nv_bfloat16* __restrict__ d_xs, int B,
                int L, int D, int K) {
  constexpr int ST = 3, SLOTS = 4;  // a stage: da's three terms, then W_ih's tile
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgSmem sm = wg_layout(smem_raw, B);
  valid_starts(lengths, B, L, sm.starts);
  const int Mv = sm.starts[B], m0 = blockIdx.y * WG_M, n0 = blockIdx.x * WG_N;
  if (m0 >= Mv) return;  // the whole cluster: a tile past the valid steps
  wg_init_bars(sm.bars, ST);
  const int split = blockIdx.z, S = gridDim.z, nk = K / WG_DX_K;
  const int kt0 = nk * split / S, n = nk * (split + 1) / S - kt0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  float acc0[32], acc1[32];
  if (warp == 8) {  // the producer
    if (lane == 0) {
      for (int q = 0; q < n; ++q) {
        const int s = q % ST, u = q / ST, k0 = (kt0 + q) * WG_DX_K;
        if (u > 0) mbar_wait(smem_u32(&sm.bars[4 + s]), (u - 1) & 1);
        const uint32_t st = sm.ring + s * SLOTS * WG_DX_SLOT, full = smem_u32(&sm.bars[s]);
        mbar_expect_tx(full, SLOTS * WG_DX_SLOT);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            tma_3d(st + a * WG_DX_SLOT + h * WG_DX_BOX, &m_da, k0, m0 + 64 * h, a, full);
          tma_3d(st + 3 * WG_DX_SLOT + h * WG_DX_BOX, &m_w, k0, n0 + 64 * h, 0, full);
        }
      }
    }
    __syncwarp();  // whole again before the block's barriers
  } else {
    const int wg = warp >> 2;  // rows [64 wg, 64 wg + 64) of the tile
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    for (int q = 0; q < n; ++q) {
      const int s = q % ST;
      mbar_wait(smem_u32(&sm.bars[s]), (q / ST) & 1);
      __syncwarp();  // the wgmma instructions need the whole warp
      const uint32_t st = sm.ring + s * SLOTS * WG_DX_SLOT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_DX_K / 16; ++kk) {  // 32 bytes of K a step in the 128-byte rows
        const uint64_t bd = wg_desc(st + 3 * WG_DX_SLOT + kk * 32, 16, 1024);
#pragma unroll
        for (int a = 2; a >= 0; --a)
          wgmma_128<0, 0>(
              acc0, acc1, wg_desc(st + a * WG_DX_SLOT + wg * WG_DX_BOX + kk * 32, 16, 1024), bd);
      }
      wg_commit();
      wg_wait<1>();  // the stage before this one is read: release it
      if (q > 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&sm.bars[4 + (q - 1) % ST]));
    }
    wg_wait<0>();
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    if (S == 1) {  // round once and store the rows of the valid steps
      const int w4 = warp & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = m0 + wg * 64 + w4 * 16 + (lane >> 2) + 8 * h;
        if (v >= Mv) continue;
        __nv_bfloat16* row = d_xs + (size_t)valid_row(sm.starts, B, L, v) * D;
#pragma unroll
        for (int j = 0; j < WG_N / 8; ++j) {
          const int c = n0 + 8 * j + 2 * (lane & 3);
          const float* d = j < 8 ? acc0 + 4 * j : acc1 + 4 * (j - 8);
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(row + c) =
                __floats2bfloat162_rn(d[2 * h], d[2 * h + 1]);
        }
      }
    }
  }
  if (S == 1) return;
  __syncthreads();  // every product has read the ring: it takes the partial tile
  float* red = reinterpret_cast<float*>(sm.ring_ptr);
  if (threadIdx.x < 256) wg_stage_partial(red, acc0, acc1);  // the consumers'
  cluster.sync();
  wg_cluster_sum(cluster, red, S, split, [&](int ri, int c, float4 s) {
    const int v = m0 + ri;
    if (v >= Mv || n0 + c >= D) return;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
        d_xs + (size_t)valid_row(sm.starts, B, L, v) * D + n0 + c);
    p[0] = __floats2bfloat162_rn(s.x, s.y);
    p[1] = __floats2bfloat162_rn(s.z, s.w);
  });
  cluster.sync();  // no block leaves while another reads its partial
}

// dw's term products p = 0 .. NP - 1, the smallest first, as (A term, da
// term), counted from 0: dW_ih's (X, da_3), (X, da_2), (X, da_1); dW_hh's
// (Hp_i, da_j) with i + j <= 4 counted from 1 (ops/cuda/lstm_scan.py::
// DW_TERM_PRODUCTS).
__host__ __device__ constexpr int dw_term_a(int na, int p) {
  return na == 1 ? 0 : p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0;
}
__host__ __device__ constexpr int dw_term_b(int na, int p) {
  return na == 1 ? 2 - p : p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0;
}

// One dw tile's partial over K-tiles [kt0, kt1) of the steps, producer and
// consumers: A's NA terms (1: X, 3: Hprev) from m_a at rows i0.., da's
// three from m_b at columns j0..; a consumer warpgroup's 64 rows x 128
// columns in acc0 (columns 0-63) and acc1 (64-127).
template <int NA>
__device__ __forceinline__ void dw_partial(const CUtensorMap* m_a, const CUtensorMap* m_b,
                                           const WgSmem& sm, int i0, int j0, int kt0, int kt1,
                                           float (&acc0)[32], float (&acc1)[32]) {
  constexpr int SLOTS = NA + 3, ST = WG_DW_RING / (SLOTS * WG_DW_SLOT), NP = NA == 1 ? 3 : 6;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = kt1 - kt0;
  if (warp == 8) {  // the producer
    if ((tid & 31) == 0) {
      for (int q = 0; q < n; ++q) {
        const int s = q % ST, u = q / ST, v0 = (kt0 + q) * WG_DW_K;
        if (u > 0) mbar_wait(smem_u32(&sm.bars[4 + s]), (u - 1) & 1);
        const uint32_t st = sm.ring + s * SLOTS * WG_DW_SLOT, full = smem_u32(&sm.bars[s]);
        mbar_expect_tx(full, SLOTS * WG_DW_SLOT);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_3d(st + a * WG_DW_SLOT + h * WG_DW_BOX, m_a, i0 + 64 * h, v0, a, full);
#pragma unroll
          for (int a = 0; a < 3; ++a)
            tma_3d(st + (NA + a) * WG_DW_SLOT + h * WG_DW_BOX, m_b, j0 + 64 * h, v0, a, full);
        }
      }
    }
    __syncwarp();  // whole again before the block's barrier
    return;
  }
  const int wg = warp >> 2;
  for (int q = 0; q < n; ++q) {
    const int s = q % ST;
    mbar_wait(smem_u32(&sm.bars[s]), (q / ST) & 1);
    __syncwarp();  // the wgmma instructions need the whole warp
    const uint32_t st = sm.ring + s * SLOTS * WG_DW_SLOT;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WG_DW_K / 16; ++kk) {  // 16 steps = 16 rows of 128 bytes a k16 step
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint64_t ad = wg_desc(st + dw_term_a(NA, p) * WG_DW_SLOT + wg * WG_DW_BOX + kk * 2048,
                                    WG_DW_BOX, 1024);
        const uint32_t b = st + (NA + dw_term_b(NA, p)) * WG_DW_SLOT + kk * 2048;
        wgmma_128<1, 1>(acc0, acc1, ad, wg_desc(b, WG_DW_BOX, 1024));
      }
    }
    wg_commit();
    wg_wait<1>();
    if (q > 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&sm.bars[4 + (q - 1) % ST]));
  }
  wg_wait<0>();
}

// K2.3 (bf16): block (tile, split); the tile's S = gridDim.y splits form a
// cluster.  Tiles [0, TIh TJ) are dW_hh's (i tile = tile / TJ), the rest
// dW_ih's: dW_hh's take twice the products a step, so they go first and
// the last wave holds short blocks; m_x: X [P][D]; m_h: Hprev's terms
// [3][P][H]; m_da: da's terms [3][P][4H]; boxes of {64, WG_DW_K}.
__global__ void __launch_bounds__(WG_THREADS, 2)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap m_x, const __grid_constant__ CUtensorMap m_h,
                const __grid_constant__ CUtensorMap m_da, const int64_t* __restrict__ lengths,
                const float* __restrict__ db_part, float* __restrict__ dw_ih,
                float* __restrict__ dw_hh, float* __restrict__ db, int B, int L, int D, int H,
                int clusters) {
  cg::cluster_group cluster = cg::this_cluster();
  const int J = 4 * H, TJ = J / WG_N, tih = (H + WG_M - 1) / WG_M;
  const bool hh = (int)blockIdx.x < tih * TJ;
  const int tile = hh ? (int)blockIdx.x : (int)blockIdx.x - tih * TJ;
  const int I = hh ? H : D, i0 = (tile / TJ) * WG_M, j0 = (tile % TJ) * WG_N;
  const int split = blockIdx.y, S = gridDim.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgSmem sm = wg_layout(smem_raw, B);
  valid_starts(lengths, B, L, sm.starts);
  const int nkt = (sm.starts[B] + WG_DW_K - 1) / WG_DW_K;
  const int kt0 = nkt * split / S, kt1 = nkt * (split + 1) / S;
  wg_init_bars(sm.bars, hh ? 2 : 3);

  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  wg_fence_acc(acc0);
  wg_fence_acc(acc1);
  if (hh)
    dw_partial<3>(&m_h, &m_da, sm, i0, j0, kt0, kt1, acc0, acc1);
  else
    dw_partial<1>(&m_x, &m_da, sm, i0, j0, kt0, kt1, acc0, acc1);
  wg_fence_acc(acc0);
  wg_fence_acc(acc1);
  __syncthreads();  // every product has read the ring: it takes the partial tile

  float* red = reinterpret_cast<float*>(sm.ring_ptr);
  if (threadIdx.x < 256) wg_stage_partial(red, acc0, acc1);  // the consumers'
  cluster.sync();
  float* dw = hh ? dw_hh : dw_ih;
  wg_cluster_sum(cluster, red, S, split, [&](int ri, int c, float4 s) {
    if (i0 + ri < I) *reinterpret_cast<float4*>(dw + (size_t)(i0 + ri) * J + j0 + c) = s;
  });
  if (hh && i0 == 0 && split == 0) {
    for (int j = threadIdx.x; j < WG_N; j += WG_THREADS) {
      float s = 0.f;
      for (int q = 0; q < clusters; ++q) s += db_part[(size_t)q * J + j0 + j];
      db[j0 + j] = s;
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// A bf16 tensor [terms][rows][cols] (row-major, cols * 2 bytes a multiple
// of 16) as a TMA map of 128-byte-swizzled boxes of {64, box_rows, 1};
// boxes past the rows or columns read zeros.
bool encode_terms(EncodeTiled enc, CUtensorMap* m, const void* p, int cols, int rows, int terms,
                  int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)terms};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, one[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
             one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K2.0, K2.2 and K2.3 on the bf16 route, after the walk has written da and
// db_part (`clusters` rows).  pack: bf16 scratch of P (D + 15 H) elements.
cudaError_t launch_bwd_wgmma(const __nv_bfloat16* xs, const int64_t* lengths,
                             const __nv_bfloat16* w_ih, const float* hprev, const float* da,
                             const float* db_part, __nv_bfloat16* pack, __nv_bfloat16* d_xs,
                             float* dw_ih, float* dw_hh, float* db, int B, int L, int D, int H,
                             int clusters, cudaStream_t stream) {
  const int P = B * L, H4 = 4 * H;
  __nv_bfloat16* xp = pack;
  __nv_bfloat16* hp = xp + (size_t)P * D;
  __nv_bfloat16* dap = hp + (size_t)3 * P * H;
  bwd_pack_kernel<<<(P + PACK_WARPS - 1) / PACK_WARPS, PACK_WARPS * 32, starts_ints(B) * 4,
                    stream>>>(xs, hprev, da, lengths, xp, hp, dap, d_xs, B, L, D, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap m_da, m_w, m_x, m_h, m_da_dw;
  if (!encode_terms(enc, &m_da, dap, H4, P, 3, WG_DX_K) ||
      !encode_terms(enc, &m_w, w_ih, H4, D, 1, WG_DX_K) ||
      !encode_terms(enc, &m_x, xp, D, P, 1, WG_DW_K) ||
      !encode_terms(enc, &m_h, hp, H, P, 3, WG_DW_K) ||
      !encode_terms(enc, &m_da_dw, dap, H4, P, 3, WG_DW_K))
    return cudaErrorInvalidValue;

  const size_t xsm = wg_smem(B, WG_DX_RING);
  if ((e = cudaFuncSetAttribute(dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)xsm)) != cudaSuccess)
    return e;
  const dim3 xgrid((D + WG_N - 1) / WG_N, (P + WG_M - 1) / WG_M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(xgrid.x, xgrid.y, dx_splits(xgrid.x * xgrid.y, H4 / WG_DX_K));
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = xsm;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cfg.gridDim.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, dx_wgmma_kernel, m_da, m_w, lengths, d_xs, B, L, D, H4)) !=
          cudaSuccess ||
      (e = cudaGetLastError()) != cudaSuccess)
    return e;

  const int tiles = ((D + WG_M - 1) / WG_M + (H + WG_M - 1) / WG_M) * (H4 / WG_N);
  const int S = dw_splits(tiles);
  const size_t wsm = wg_smem(B, WG_DW_RING);
  if ((e = cudaFuncSetAttribute(dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)wsm)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(dw_wgmma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return e;
  cfg.gridDim = dim3(tiles, S, 1);
  cfg.dynamicSmemBytes = wsm;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  if ((e = cudaLaunchKernelEx(&cfg, dw_wgmma_kernel, m_x, m_h, m_da_dw, lengths, db_part, dw_ih,
                              dw_hh, db, B, L, D, H, clusters)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Forward 1 on the bf16 route: gates_x on wgmma.
//
// gates_x_kernel's bf16 path (mma.sync m16n8k16 on 64 x 64 tiles through
// a cp.async ring that every thread issued) took 0.0812 of K3's 0.1540 ms
// at the speaker's first layer (D = 2176, H = 256, 2,240 valid steps) on
// the H100, ~123 TFLOP/s; f32 keeps that kernel (in split TF32).  In bf16
// gx_wgmma_kernel computes gx[v] = x[v] . W_ih + b on tiles of WG_M valid
// steps x WG_N gate columns, K = D in K-tiles of 64, through a ring of
// GX_ST stages of x's tile and W_ih's; two consumer warpgroups run wgmma
// m64n128k16 (exact products, f32 sums), one producer warp keeps W_ih's
// TMA boxes in flight on full / empty mbarriers, as dx_wgmma does:
// * W_ih [D][4H] MN-major as it is (bf16 wgmma's transpose bit, no
//   transposed copy); boxes past D read zeros, so the Follower's D = 304
//   costs no more than a last K-tile three quarters full.
// * x K-major, fed one of two ways, chosen on the device from the valid
//   steps' count Mv (no host synchronisation reads the lengths):
//   - every step valid (Mv = B L: the speaker's encoder): x's rows are the
//     valid steps in order, and the producer loads them as TMA boxes of
//     64 rows beside W_ih's;
//   - otherwise each consumer warpgroup gathers its 64 rows' K-tile
//     (valid_row's row of x, 16 bytes a cp.async, four a thread) into the
//     128-byte-swizzled layout wgmma reads, two stages ahead, with zeros
//     past D and past the valid steps; a thread waits for its copies,
//     makes them visible to wgmma's async proxy (fence.proxy.async) and
//     meets its warpgroup at a named barrier before the products read them.
//   The gather multiplies no padded step and needs no launch that packs x
//   by valid step first (a pack launch and TMA boxes of the packed rows
//   took longer at the ragged path shapes on the H100: PERF.md); TMA boxes
//   over all B L rows, padded ones too, took longer at every ragged path
//   shape but the Self-Monitor's, and the gather of full-length rows
//   longer than their TMA boxes (scripts/torch_gx_wgmma_variants.py).
// The sums plus b go from the registers to the valid step's row of gx [B,
// L, 4H] in f32.  Without a split of K a block walks step tiles y, y + Y,
// ... (gx_rows: a round of two blocks an SM, so that a grid sized for B L
// steps does not launch waves of blocks that find no valid step), its
// next tile's loads running under its last tile's stores.  Where the
// tiles are few against K (the beam's rescoring, B L = 480 at D = 2176),
// K is split S ways (gx_splits) and a tile's S blocks sum their partial
// tiles in rank order through distributed shared memory (wg_cluster_sum):
// no atomics, the same sums every run.
// Bound: the speaker's 2 x 2240 x 2176 x 1024 = 9.98 GFLOP are 10 us at
// the card's 989 TFLOP/s; EnvDrop's (D = H = 256) 0.5-1.6 GFLOP and the
// Self-Monitor's 6-25 MB of f32 gx are a few us.
// ---------------------------------------------------------------------------
constexpr int GX_ST = 3;                            // stages of gx_wgmma's ring
constexpr int WG_GX_RING = GX_ST * 2 * WG_DX_SLOT;  // x's tile and W_ih's a stage

// gx_wgmma's splits of K = D: the largest S in {1, 2, 4, 8} whose tiles x
// S blocks, the tiles counted for B L valid steps, fit one block an SM,
// with at least 16 K-tiles a split left to halve: a split's partial-tile
// sum through distributed shared memory costs more than the K-tiles it
// saves on a fuller card (on the H100 the speaker's 144 tiles took about
// 1.6x S = 1's time at S = 4, the beam's 32 about half;
// scripts/torch_gx_wgmma_variants.py; ops/cuda/lstm_scan.py::gx_splits).
int gx_splits(int tiles, int nk) {
  int s = 1;
  while (s < 8 && 16 * s <= nk && 2 * tiles * s <= WG_SMS) s *= 2;
  return s;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier id (1-15; 0 is __syncthreads') of n threads, whole warps:
// the calling warps wait until n threads have arrived.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// gx_wgmma's rows of step tiles: with splits of K, one a step tile (B L
// of them); without, at most a round of two blocks an SM over the column
// tiles, block y taking step tiles y, y + Y, ... below the valid steps
// (ops/cuda/lstm_scan.py::gx_rows).
int gx_rows(int nt, int mt, int S) { return S > 1 ? mt : min(mt, max(1, 2 * WG_SMS / nt)); }

// gx_wgmma's step tiles y, y + Y, ... of a block (column tile n0, K-tiles
// [kt0, kt0 + n)), producer and consumers; x's rows as TMA boxes (DENSE:
// every step valid) or gathered by the consumers.  A stage: x's 128 rows
// (warpgroup wg's 64 at wg WG_DX_BOX), then W_ih's 128 columns.  Without a
// split of K (S = 1) each tile's sums plus b go to gx from the registers;
// with one, the block has one tile, whose partial stays in acc0 / acc1.
template <bool DENSE>
__device__ __forceinline__ void gx_tiles(const CUtensorMap* m_w, const CUtensorMap* m_x,
                                         const __nv_bfloat16* __restrict__ xs, const WgSmem& sm,
                                         const __nv_bfloat16* __restrict__ bias,
                                         float* __restrict__ gx, int B, int L, int D, int N,
                                         int Mv, int n0, int kt0, int n, int S,
                                         float (&acc0)[32], float (&acc1)[32]) {
  constexpr int STAGE = 2 * WG_DX_SLOT;
  const int tiles = (Mv + WG_M - 1) / WG_M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 8) {  // the producer: W_ih's boxes, and x's where dense
    if (lane == 0) {
      int q = 0;  // stages filled, over this block's step tiles
      for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
        for (int i = 0; i < n; ++i, ++q) {
          const int s = q % GX_ST, u = q / GX_ST, k0 = (kt0 + i) * WG_DX_K;
          if (u > 0) mbar_wait(smem_u32(&sm.bars[4 + s]), (u - 1) & 1);
          const uint32_t st = sm.ring + s * STAGE, full = smem_u32(&sm.bars[s]);
          mbar_expect_tx(full, DENSE ? STAGE : WG_DX_SLOT);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tma_3d(st + WG_DX_SLOT + h * WG_DX_BOX, m_w, n0 + 64 * h, k0, 0, full);
            if constexpr (DENSE) tma_3d(st + h * WG_DX_BOX, m_x, k0, t * WG_M + 64 * h, 0, full);
          }
        }
      }
    }
    __syncwarp();  // whole again before the block's barriers
    return;
  }
  const int wg = warp >> 2, j = tid & 127;  // rows [64 wg, 64 wg + 64) of a tile
  const int c = j & 7;  // this thread's chunk of x's rows r = j / 8 + 16 i
  int q = 0;            // stages read, over this block's step tiles
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int m0 = t * WG_M, q0 = q;
    const __nv_bfloat16* src[4];
    auto load_x = [&](int i) {  // K-tile kt0 + i into stage q0 + i's x slot, swizzled
      if (i < n) {
        unsigned char* dst = sm.ring_ptr + ((q0 + i) % GX_ST) * STAGE + wg * WG_DX_BOX;
        const int k = (kt0 + i) * WG_DX_K + 8 * c;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = j / 8 + 16 * a;
          const bool ok = src[a] != nullptr && k < D;
          cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), ok ? src[a] + k : xs, ok);
        }
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    if constexpr (!DENSE) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int v = m0 + 64 * wg + j / 8 + 16 * a;
        src[a] = v < Mv ? xs + (size_t)valid_row(sm.starts, B, L, v) * D : nullptr;
      }
      for (int i = 0; i < GX_ST - 1; ++i) load_x(i);
    }
    for (int i = 0; i < n; ++i, ++q) {
      const int s = q % GX_ST;
      if constexpr (!DENSE) {
        cp_async_wait<GX_ST - 2>();   // this thread's chunks of stage q have landed,
        fence_proxy_async();          // are visible to wgmma's reads,
        named_bar_sync(1 + wg, 128);  // and so are the warpgroup's
      }
      mbar_wait(smem_u32(&sm.bars[s]), (q / GX_ST) & 1);
      __syncwarp();  // the wgmma instructions need the whole warp
      const uint32_t st = sm.ring + s * STAGE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_DX_K / 16; ++kk)  // 16 of K: 32 bytes of x's rows, 16 of W_ih's
        wgmma_128<0, 1>(acc0, acc1, wg_desc(st + wg * WG_DX_BOX + kk * 32, 16, 1024),
                        wg_desc(st + WG_DX_SLOT + kk * 2048, WG_DX_BOX, 1024));
      wg_commit();
      wg_wait<1>();  // the stage before this one is read: release W_ih's, refill x's
      if (q > 0 && j == 0) mbar_arrive(smem_u32(&sm.bars[4 + (q - 1) % GX_ST]));
      if constexpr (!DENSE) load_x(i + GX_ST - 1);
    }
    wg_wait<0>();
    wg_fence_acc(acc0);
    wg_fence_acc(acc1);
    if (S > 1) return;  // one step tile a cluster: its partials are summed by the caller
    // the rows of the valid steps, with b, from the registers
    const int w4 = warp & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = m0 + wg * 64 + w4 * 16 + (lane >> 2) + 8 * h;
      if (v >= Mv) continue;
      float* row = gx + (size_t)valid_row(sm.starts, B, L, v) * N + n0;
#pragma unroll
      for (int jj = 0; jj < WG_N / 8; ++jj) {
        const int col = 8 * jj + 2 * (lane & 3);
        const float* d = jj < 8 ? acc0 + 4 * jj : acc1 + 4 * (jj - 8);
        *reinterpret_cast<float2*>(row + col) = make_float2(
            d[2 * h] + to_f32(bias[n0 + col]), d[2 * h + 1] + to_f32(bias[n0 + col + 1]));
      }
    }
  }
}

// K1/K3.1 (bf16): block (n tile, y, split); the S = gridDim.z splits of a
// step tile form a cluster, split z taking K-tiles [nk z / S, nk (z + 1) /
// S).  m_w: W_ih [D][4H]; m_x: xs [B L][D], read by TMA where every step
// is valid; boxes of {64, 64}.
__global__ void __launch_bounds__(WG_THREADS, 2)
gx_wgmma_kernel(const __grid_constant__ CUtensorMap m_w, const __grid_constant__ CUtensorMap m_x,
                const __nv_bfloat16* __restrict__ xs, const int64_t* __restrict__ lengths,
                const __nv_bfloat16* __restrict__ bias, float* __restrict__ gx, int B, int L,
                int D, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WgSmem sm = wg_layout(smem_raw, B);
  valid_starts(lengths, B, L, sm.starts);
  const int Mv = sm.starts[B], n0 = blockIdx.x * WG_N;
  if ((int)blockIdx.y * WG_M >= Mv) return;  // the whole cluster: no step tile left
  wg_init_bars(sm.bars, GX_ST);
  const int split = blockIdx.z, S = gridDim.z, nk = (D + WG_DX_K - 1) / WG_DX_K;
  const int kt0 = nk * split / S, n = nk * (split + 1) / S - kt0;

  float acc0[32], acc1[32];
  // every step valid: x's rows are the valid steps in order, TMA boxes of
  // 64 rows; otherwise the consumers gather them
  if (Mv == B * L)
    gx_tiles<true>(&m_w, &m_x, xs, sm, bias, gx, B, L, D, N, Mv, n0, kt0, n, S, acc0, acc1);
  else
    gx_tiles<false>(&m_w, &m_x, xs, sm, bias, gx, B, L, D, N, Mv, n0, kt0, n, S, acc0, acc1);
  if (S == 1) return;
  __syncthreads();  // every product has read the ring: it takes the partial tile
  const int m0 = blockIdx.y * WG_M;
  float* red = reinterpret_cast<float*>(sm.ring_ptr);
  if (threadIdx.x < 256) wg_stage_partial(red, acc0, acc1);  // the consumers'
  cluster.sync();
  wg_cluster_sum(cluster, red, S, split, [&](int ri, int col, float4 sum) {
    const int v = m0 + ri;
    if (v >= Mv) return;
    const __nv_bfloat16* bc = bias + n0 + col;
    *reinterpret_cast<float4*>(gx + (size_t)valid_row(sm.starts, B, L, v) * N + n0 + col) =
        make_float4(sum.x + to_f32(bc[0]), sum.y + to_f32(bc[1]), sum.z + to_f32(bc[2]),
                    sum.w + to_f32(bc[3]));
  });
  cluster.sync();  // no block leaves while another reads its partial
}

cudaError_t launch_gx_wgmma(const __nv_bfloat16* xs, const int64_t* lengths,
                            const __nv_bfloat16* w_ih, const __nv_bfloat16* bias, float* gx, int B,
                            int L, int D, int N, cudaStream_t stream) {
  const int P = B * L;
  if (P == 0) return cudaSuccess;
  const EncodeTiled enc = encoder();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap m_w, m_x;
  if (!encode_terms(enc, &m_w, w_ih, N, D, 1, WG_DX_K) ||
      !encode_terms(enc, &m_x, xs, D, P, 1, WG_DX_K))
    return cudaErrorInvalidValue;
  const size_t smem = wg_smem(B, WG_GX_RING);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(gx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(gx_wgmma_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return e;
  const int nt = N / WG_N, mt = (P + WG_M - 1) / WG_M;
  const int S = gx_splits(nt * mt, (D + WG_DX_K - 1) / WG_DX_K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt, gx_rows(nt, mt, S), S);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, gx_wgmma_kernel, m_w, m_x, xs, lengths, bias, gx, B, L, D,
                              N)) != cudaSuccess)
    return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                       const void* gates, const void* hprev, const void* cprev,
                       const void* d_out, const void* dhT, const void* dcT, void* da,
                       void* db_part, void* d_xs, void* dw_ih, void* dw_hh, void* db,
                       void* wpack, void* pack, int B, int L, int D, int H, int reverse,
                       cudaStream_t stream) {
  const int H4 = 4 * H;
  int clusters = (B + R - 1) / R;  // the recurrence's, which db_part has rows for
  cudaError_t e;
  if (std::is_same<T, __nv_bfloat16>::value && H == 512) {  // W_hh resident
    int rows, at_once;
    if ((e = bwd_res_rows<512>(B, &rows, &at_once)) != cudaSuccess) return e;
    clusters = (B + rows - 1) / rows;
    e = (rows <= 8 ? launch_bwd_res<512, 1> : launch_bwd_res<512, 2>)(
        static_cast<const float*>(gates), static_cast<const float*>(cprev),
        static_cast<const float*>(d_out), static_cast<const float*>(dhT),
        static_cast<const float*>(dcT), static_cast<const int64_t*>(lengths),
        static_cast<const __nv_bfloat16*>(w_hh), static_cast<float*>(da),
        static_cast<float*>(db_part), B, L, rows, reverse, stream);
    if (e != cudaSuccess) return e;
  } else if (H > 256) {
    if ((e = pack_whh<T>(w_hh, wpack, H, 1, stream)) != cudaSuccess) return e;
    const size_t wsm = wide_bwd_smem(H, sizeof(T));
    if ((e = cudaFuncSetAttribute(bwd_recurrence_wide_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wsm)) !=
        cudaSuccess)
      return e;
    bwd_recurrence_wide_kernel<T><<<clusters * CL, WT, wsm, stream>>>(
        static_cast<const float*>(gates), static_cast<const float*>(cprev),
        static_cast<const float*>(d_out), static_cast<const float*>(dhT),
        static_cast<const float*>(dcT), static_cast<const int64_t*>(lengths),
        static_cast<const T*>(wpack), static_cast<float*>(da), static_cast<float*>(db_part), B,
        L, H, reverse);
  } else {
    const size_t smem = rec_smem(H);
    if ((e = cudaFuncSetAttribute(bwd_recurrence_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return e;
    bwd_recurrence_kernel<T><<<clusters * CL, THREADS, smem, stream>>>(
        static_cast<const float*>(gates), static_cast<const float*>(cprev),
        static_cast<const float*>(d_out), static_cast<const float*>(dhT),
        static_cast<const float*>(dcT), static_cast<const int64_t*>(lengths),
        static_cast<const T*>(w_hh), static_cast<float*>(da), static_cast<float*>(db_part), B, L,
        H, reverse);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // ops/cuda/lstm_scan.py::lstm_scan_bwd_plan: bf16 on wgmma, f32 on split-TF32 mma.sync
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bwd_wgmma(static_cast<const T*>(xs), static_cast<const int64_t*>(lengths),
                            static_cast<const T*>(w_ih), static_cast<const float*>(hprev),
                            static_cast<const float*>(da), static_cast<const float*>(db_part),
                            static_cast<T*>(pack), static_cast<T*>(d_xs),
                            static_cast<float*>(dw_ih), static_cast<float*>(dw_hh),
                            static_cast<float*>(db), B, L, D, H, clusters, stream);
  } else {
    const size_t xsm = dx_smem(B);
    if ((e = cudaFuncSetAttribute(dx_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)xsm)) != cudaSuccess)
      return e;
    dim3 xgrid((D + DX_TN - 1) / DX_TN, (B * L + DX_TM - 1) / DX_TM + 1);
    dx_gemm_kernel<<<xgrid, DX_THREADS, xsm, stream>>>(
        static_cast<const float*>(da), static_cast<const float*>(w_ih),
        static_cast<const int64_t*>(lengths), static_cast<float*>(d_xs), B, L, D, H4);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    const size_t wsm = dw_smem(B);
    if ((e = cudaFuncSetAttribute(dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)wsm)) != cudaSuccess)
      return e;
    dim3 wgrid(H4 / DW_TJ, (max(D, H) + DW_TI - 1) / DW_TI, 2 * DW_SPLITS);
    dw_gemm_kernel<<<wgrid, DW_THREADS, wsm, stream>>>(
        static_cast<const float*>(xs), static_cast<const float*>(hprev),
        static_cast<const float*>(da), static_cast<const int64_t*>(lengths),
        static_cast<const float*>(db_part), static_cast<float*>(dw_ih),
        static_cast<float*>(dw_hh), static_cast<float*>(db), B, L, D, H, clusters);
    return cudaGetLastError();
  }
}

}  // namespace

// K3.  xs [B, L, D] and the weights w_ih [D, 4H], w_hh [H, 4H], b [4H] in
// one dtype; lengths [B] int64; gx [B, L, 4H] f32 scratch; outs [B, L, H],
// hT and cT [B, H] f32.  H must be a multiple of 32 (U = H / 8 a multiple
// of 4, whole m-tiles of four units) up to 512: up to 256 a block's W_hh
// fragments sit in its registers, and so they do in bf16 at H = 512
// (the resident walk, clusters of 16); otherwise the wide walk streams them
// from wpack [4H * H] (the dtype's scratch; unused by the other walks).  xs
// rows must be whole 16-byte chunks (ops/cuda/lstm_scan.py pads them).
extern "C" int lstm_scan(const void* xs, const void* lengths, const void* w_ih, const void* w_hh,
                         const void* b, void* gx, void* outs, void* hT, void* cT, void* wpack,
                         int B, int L, int D, int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 512 || (D * (dtype == DTYPE_BF16 ? 2 : 4)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, nullptr,
                                     nullptr, wpack, B, L, D, H, reverse, s);
  return launch_fwd<float>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, nullptr, nullptr, wpack,
                           B, L, D, H, reverse, s);
}

// K1.  As K3, and also writes hprev and cprev [L, B, H] f32 (the carries
// before each step, by absolute t) and leaves in gx [B, L, 4H] the gate
// pre-activations of every valid step.
extern "C" int lstm_scan_train(const void* xs, const void* lengths, const void* w_ih,
                               const void* w_hh, const void* b, void* gx, void* outs, void* hT,
                               void* cT, void* hprev, void* cprev, void* wpack, int B, int L,
                               int D, int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 512 || (D * (dtype == DTYPE_BF16 ? 2 : 4)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_fwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, hprev, cprev,
                                     wpack, B, L, D, H, reverse, s);
  return launch_fwd<float>(xs, lengths, w_ih, w_hh, b, gx, outs, hT, cT, hprev, cprev, wpack, B,
                           L, D, H, reverse, s);
}

// K2.  From K1's residuals (gates = its gx, hprev, cprev) and the
// cotangents d_out [B, L, H], dhT and dcT [B, H] (f32): d_xs [B, L, D] in
// the dtype of xs, dw_ih [D, 4H], dw_hh [H, 4H] and db [4H] f32.  da
// [B, L, 4H] and db_part [the walk's clusters, 4H] (f32: ceil(B / 8)
// clusters, or the resident walk's ceil(B / rows), lstm_scan_bwd_plan_query),
// wpack (4H * H of the dtype for the streaming walk, else unused) and pack
// (bf16: B L (D + 15 H) elements of the wgmma GEMMs' operands; f32: unused)
// are scratch.
extern "C" int lstm_scan_bwd(const void* xs, const void* lengths, const void* w_ih,
                             const void* w_hh, const void* gates, const void* hprev,
                             const void* cprev, const void* d_out, const void* dhT,
                             const void* dcT, void* da, void* db_part, void* d_xs, void* dw_ih,
                             void* dw_hh, void* db, void* wpack, void* pack, int B, int L, int D,
                             int H, int reverse, int dtype, void* stream) {
  if (H % 32 != 0 || H > 512 || (D * (dtype == DTYPE_BF16 ? 2 : 4)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_bwd<__nv_bfloat16>(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT,
                                     dcT, da, db_part, d_xs, dw_ih, dw_hh, db, wpack, pack, B, L,
                                     D, H, reverse, s);
  return launch_bwd<float>(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT, da,
                           db_part, d_xs, dw_ih, dw_hh, db, wpack, pack, B, L, D, H, reverse, s);
}

// A walk's plan at (B, H, dtype), as launch_fwd (bwd = 0) or launch_bwd
// (bwd = 1) takes it: out[0..6] = blocks a cluster, batch rows a cluster,
// clusters, threads a block, shared memory bytes a block, the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters) that the plan chose
// the rows from (a resident walk's at one row group), and those of the
// launched walk.
static int plan_query(int B, int H, int dtype, int bwd, int* out) {
  if (H % 32 != 0 || H > 512) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == DTYPE_BF16;
  cudaError_t e = cudaSuccess;
  int cl = CL, rows = R, threads = THREADS, planned = 0, at_once = 0;
  size_t smem;
  if (bf16 && H == 512) {
    e = bwd ? bwd_res_rows<512>(B, &rows, &planned) : res_rows<512>(B, &rows, &planned);
    const int nt = rows <= 8 ? 1 : 2;
    cl = RCL, threads = RT, at_once = planned;
    smem = bwd ? bwd_res_smem<512>(nt) : res_smem<512>(nt);
    if (e == cudaSuccess && nt == 2)  // the launched kernel's own count
      e = bwd ? bwd_res_clusters_at_once<512, 2>(&at_once) : res_clusters_at_once<512, 2>(&at_once);
  } else {
    const void* kern;
    if (H > 256) {
      threads = WT;
      smem = bwd ? wide_bwd_smem(H, bf16 ? 2 : 4) : wide_fwd_smem(H, bf16 ? 2 : 4);
      kern = bwd ? (bf16 ? (const void*)bwd_recurrence_wide_kernel<__nv_bfloat16>
                         : (const void*)bwd_recurrence_wide_kernel<float>)
                 : (bf16 ? (const void*)recurrence_wide_kernel<__nv_bfloat16>
                         : (const void*)recurrence_wide_kernel<float>);
    } else {
      smem = bwd ? rec_smem(H) : fwd_rec_smem(H);
      kern = bwd ? (bf16 ? (const void*)bwd_recurrence_kernel<__nv_bfloat16>
                         : (const void*)bwd_recurrence_kernel<float>)
                 : (bf16 ? (const void*)recurrence_kernel<__nv_bfloat16>
                         : (const void*)recurrence_kernel<float>);
    }
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&at_once, kern, &cfg);
    planned = at_once;
  }
  const int vals[7] = {cl, rows, (B + rows - 1) / rows, threads, (int)smem, planned, at_once};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)e;
}

// The forward walk's plan (K3, K1).
extern "C" int lstm_scan_plan_query(int B, int H, int dtype, int* out) {
  return plan_query(B, H, dtype, 0, out);
}

// The backward walk's plan (K2); its clusters are db_part's rows.
extern "C" int lstm_scan_bwd_plan_query(int B, int H, int dtype, int* out) {
  return plan_query(B, H, dtype, 1, out);
}
