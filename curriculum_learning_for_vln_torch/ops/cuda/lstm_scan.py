"""K3, K1 and K2: the masked LSTM scan — inference forward, training
forward and backward; CUDA kernels and plain twins.

K3 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
lstm_scan_pallas``, K1 its ``lstm_scan_train_pallas``, K2 its
``lstm_scan_bwd_pallas``.  Kernel: ``csrc/lstm_scan.cu`` — the forward is
one C call of two launches: a tensor-core GEMM for x . W_ih + b over the
valid steps only (f32: mma.sync; bf16: wgmma, W_ih by TMA, x's rows by TMA
where every step is valid and else gathered by valid step, ``gx_splits``
ways of K), then the recurrence on clusters of 8 blocks, each warp
holding its W_hh columns as tensor-core fragments in registers and
sending its units' new h to every block by st.async (no barrier a step);
K1 also writes the pre-step carries and keeps the gate pre-activations
as residuals.  K2 is one C call: the reverse-time recurrence on the
same cluster layout (its per-step product on the tensor cores), then
GEMMs for d_xs and for dW_ih, dW_hh and db over the valid steps only, in
a fixed order (no atomics): in f32 two mma.sync launches, in bf16 a
launch that packs the operands by valid step (da and hprev as three
bf16 terms, ``split_bf16x3``) and two wgmma launches fed by TMA
(``lstm_scan_bwd_plan``; ``_wgmma_gemms`` emulates their sums).  Every
mma.sync product with an f32 operand runs in TF32 with that operand
split in two halves, which keeps f32 accuracy; bf16 operands are exact
there.  Up
to H = 256 both walks keep their block's eighth of W_hh in registers (and
the f32 low halves in shared memory).  Both bf16 walks at H = 512 (the
Self-Monitor's encoder; the resident walks) take clusters of 16 blocks,
each holding its sixteenth of W_hh in registers for the whole walk, and
multiply the f32 operand that changes every step (h forward, da
backward) as three bf16 terms (``split_bf16x3``); their rows a cluster
(up to 16) follow from the clusters the card holds at once
(``res_rows``), each walk's own count.  The other walks above H = 256
(512 threads a block: f32, other H) stream their eighth every step, in
the fragment order ``whh_pack_order`` gives, which one more launch
writes into a scratch copy.  Rows of xs that are not whole 16-byte
chunks (the Follower's 300-wide bf16 embeddings) are zero-padded by
``pad_rows``, and d_xs and dW_ih cut back: exact.
``lstm_scan_fwd_plan`` and ``lstm_scan_bwd_plan`` give the launch
geometry, ``valid_steps`` / ``split_bounds`` the order in which the GEMMs
take the valid steps, and ``lstm_scan_fwd_emulated`` /
``lstm_scan_bwd_emulated`` the kernels' arithmetic in plain torch; the
CPU tests check all of them.  All three are bound by their serial chain
of steps, not by bytes or FLOPs (the source says more).

``lstm_scan``, ``lstm_scan_train`` and ``lstm_scan_bwd`` dispatch by
device: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel; there is no fallback between them.  ``launches`` counts K3
calls, ``train_launches`` K1 calls, ``bwd_launches`` K2 calls (each call
counts once, whatever its number of launches).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import build

launches = 0
train_launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

Carry = Tuple[torch.Tensor, torch.Tensor]

# csrc/lstm_scan.cu's geometry: both recurrences' clusters of CL blocks
# own R batch rows each.  Forward (f32): gates_x's tiles of GX_TM valid steps x
# GX_TN gate columns, at most GX_YMAX blocks along the steps, GX_STAGES
# stages of 128-byte rows; the walk's warps each hold FKS_MAX k-steps of
# W_hh fragments (4 registers each) and a gate tile of rows GT_S floats
# apart.  Backward: dx_gemm's tiles of DX_TM steps x DX_TN columns;
# dw_gemm's tiles of DW_TI x DW_TJ outputs, each reduced by a cluster of
# DW_SPLITS blocks over the valid steps, DW_KC steps a stage
CL, R, THREADS = 8, 8, 256
WARPS = THREADS // 32
GX_TM, GX_TN, GX_STAGES, GX_THREADS, GX_YMAX = 64, 64, 3, 128, 32
FKS_MAX, GT_S = 32, 20
DX_TM, DX_TN, DX_KC, DX_STAGES, DX_THREADS = 32, 64, 32, 3, 128
DW_TI, DW_TJ, DW_KC, DW_STAGES, DW_THREADS, DW_SPLITS = 64, 128, 32, 3, 256, 8
# K2's GEMMs on the bf16 route (wgmma fed by TMA): output tiles of WG_M x
# WG_N, WG_THREADS threads a block (two consumer warpgroups, one producer
# warp); d_xs's K-tiles of WG_DX_K gate columns through a ring of
# WG_DX_RING bytes (one block an SM), dW's of WG_DW_K valid steps through
# one of WG_DW_RING (two blocks an SM), its steps split over up to 8
# blocks a tile (``dw_splits``, from the H100's WG_SMS); the pack launch
# takes PACK_WARPS sequence rows a block
WG_M, WG_N, WG_THREADS, WG_SMS = 128, 128, 288, 132
WG_DX_K, WG_DW_K = 64, 32
WG_DX_RING, WG_DW_RING = 12 * 2 * 64 * WG_DX_K * 2, 12 * 2 * 64 * WG_DW_K * 2
PACK_WARPS = 8
# K1/K3's gates_x on the bf16 route (gx_wgmma_kernel): dx_wgmma's output
# tiles, K-tiles of WG_DX_K and threads, through a ring of GX_ST stages of
# x's tile and W_ih's (WG_GX_RING bytes: two blocks an SM)
GX_ST = 3
WG_GX_RING = GX_ST * 2 * 2 * 64 * WG_DX_K * 2
# dW's term products (A term, da term), terms counted from 0 (t1 the
# largest), in the order the kernel sums them (the smallest first): dW_ih
# the three of X and da, dW_hh the six of Hprev's and da's terms with
# i + j <= 4 counted from 1
DW_TERM_PRODUCTS = {1: ((0, 2), (0, 1), (0, 0)),
                    3: ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))}
# The wide walks (256 < H <= 512): WT threads a block, each warp streaming
# its W_hh fragments (packed by pack_whh_kernel into 4H * H elements)
# through a ring of WSTAGES groups, a group WFQ k-steps of one m-tile
# (forward) or WBQ k-steps of two (backward)
WIDE_H, WT, WFQ, WBQ, WSTAGES = 256, 512, 4, 2, 4
WW = WT // 32
# The resident walk (bf16, H = 512): clusters of RES_CL blocks of RES_T
# threads, warp w = (m-group w / RES_KG, k-group w % RES_KG)
RES_CL, RES_T, RES_KG = 16, 512, 8
RES_MG = RES_T // 32 // RES_KG
# cudaOccupancyMaxActiveClusters of the resident walks on an H100 80GB HBM3
# (132 SMs, one block an SM): only the CPU emulation's default; a launch
# takes its card's own count (plan_query, bwd_plan_query)
H100_RES_CLUSTERS = 7
MAX_H = 512
MAX_SMEM = 232448  # shared memory a block can use on the H100


class BwdPlan(NamedTuple):
    """K2's launches.  ``rec_grid`` blocks of the recurrence (clusters of
    ``cluster`` blocks along x, each cluster ``rows`` batch rows) of
    ``rec_threads`` threads with ``rec_smem`` bytes, which stream
    ``w_stream`` bytes of W_hh a step (the streaming wide walk; 0 when
    W_hh sits in registers and shared memory) from a packed copy of
    ``w_pack`` elements; ``w_where`` says where W_hh sits during the walk.
    Each cluster writes one row of db's partial sums (``clusters`` rows).
    ``gemm`` names the input-side GEMMs' route.  "mma.sync" (f32):
    dx_gemm's grid (D tiles, step tiles + 1: blocks past the valid steps'
    tiles write the padded steps' zeros) with ``dx_smem``; dw_gemm's grid
    (4H tiles, max(D, H) tiles, 2 matrices x ``splits``, clusters of
    ``splits`` along z) with ``dw_smem``, ``dw_blocks_per_sm`` of which
    fit an SM.  "wgmma" (bf16): the pack launch's ``pack_grid`` blocks
    (``PACK_WARPS`` sequence rows each) fill ``pack_elems`` bf16 of
    packed operands and d_xs's zeros at the padded steps; dx_wgmma's grid
    (D tiles, B L step tiles: those past the valid steps leave at once,
    ``dx_splits`` splits of K, clusters of them along z) with ``dx_smem``,
    one block an SM; dw_wgmma's grid (the tiles of dW_hh
    then of dW_ih, ``splits``, clusters of ``splits`` along y) with
    ``dw_smem``, ``dw_blocks_per_sm`` = 2 blocks an SM."""
    rec_grid: int
    rec_smem: int
    dx_grid: Tuple[int, int]
    dx_smem: int
    dw_grid: Tuple[int, int, int]
    dw_smem: int
    dw_blocks_per_sm: int
    splits: int
    rec_threads: int
    w_stream: int
    w_pack: int
    cluster: int
    rows: int
    w_where: str
    gemm: str = "mma.sync"
    pack_grid: int = 0
    pack_elems: int = 0

    @property
    def clusters(self) -> int:
        return self.rec_grid // self.cluster


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class FwdPlan(NamedTuple):
    """K3's and K1's launches.  ``gemm`` names gates_x's route.
    "mma.sync" (f32): gates_x's grid (4H tiles, Y step tiles: block y takes
    step tiles y, y + Y, ... below the valid steps' count, which it
    computes on the device, so no host synchronisation reads the lengths)
    of GX_THREADS threads with ``gx_smem`` bytes.  "wgmma" (bf16):
    gx_wgmma's grid (4H / WG_N column tiles, ``gx_rows`` rows of blocks
    over the B L / WG_M step tiles: block y takes tiles y, y + Y, ...
    below the valid steps, ``gx_splits`` splits of K, clusters of them
    along z) of WG_THREADS threads with ``gx_smem`` bytes,
    ``gx_blocks_per_sm`` = 2 blocks an SM.  Then the recurrence's
    ``rec_grid`` blocks (clusters of ``cluster`` blocks along
    x, each cluster ``rows`` batch rows) of ``rec_threads`` threads with
    ``rec_smem``, of whose warps ``rec_warps`` hold ``w_regs`` registers
    a thread of W_hh fragments for the whole walk (up to H = 256: one warp
    a 16-column m-tile of the block's 4H / 8 gate columns; the resident
    walk: every warp), or stream ``w_stream`` bytes of them a step from a
    packed copy of ``w_pack`` elements (the other wide walks).
    ``w_where`` says where W_hh sits during the walk."""
    gx_grid: Tuple[int, ...]
    gx_smem: int
    rec_grid: int
    rec_smem: int
    rec_warps: int
    w_regs: int
    rec_threads: int
    w_stream: int
    w_pack: int
    cluster: int
    rows: int
    w_where: str
    gemm: str = "mma.sync"
    gx_blocks_per_sm: int = 1

    @property
    def clusters(self) -> int:
        return self.rec_grid // self.cluster


def resident(H: int, elem_size: int) -> bool:
    """Whether the walks take their resident versions, both directions:
    bf16 at H = 512, the Self-Monitor's encoder (f32 and the other H above
    256 stream W_hh)."""
    return elem_size == 2 and H == 512


def res_rows(B: int, clusters_at_once: int) -> int:
    """A resident walk's batch rows a cluster: B spread over the clusters
    the card holds at once, at most 16 (two n-tiles of 8), so that the
    launch is one wave wherever 16 rows a cluster can make it one (the
    H100's 7 clusters of 16 blocks take B = 64 as 7 clusters of 10 rows;
    8 rows would leave one of 8 clusters for a second wave).  Fewer rows a
    cluster send fewer bytes a step (h forward, partials of dh backward),
    which bound the step."""
    return min(_ceil_div(B, max(clusters_at_once, 1)), 16)


def res_geometry(H: int):
    """The resident walk's (U units, G4 columns, MT m-tiles, KS 16-k steps
    of a block; MPW m-tiles and KPW 16-k steps of a warp; the row strides
    WS of the staged slice, in elements, HF of h as received and PS of a
    partial tile, in floats)."""
    U = H // RES_CL
    G4, KS = 4 * U, H // 16
    MT = G4 // 16
    return U, G4, MT, KS, MT // RES_MG, KS // RES_KG, G4 + 8, H + 8, G4 + 4


def res_smem(H: int, rows: int) -> int:
    """Shared memory of a resident block of ``rows`` rows in NT groups (one
    n-tile of 8 each: NT = 2 above 8 rows): the staged slice of W_hh [H][WS]
    bf16 (the prologue's), and over it each group's h as received
    [NT][2][8][HF] f32 and two buffers of partial tiles [2][RES_KG][8][PS]
    f32 (a group step's buffer is its parity); an mbarrier for each group,
    half of h and k-group."""
    *_, WS, HF, PS = res_geometry(H)
    nt = _ceil_div(rows, 8)
    return (max(H * WS * 2, nt * 2 * 8 * HF * 4 + 2 * RES_KG * 8 * PS * 4)
            + nt * 2 * RES_KG * 8)


def bwd_res_smem(H: int, rows: int) -> int:
    """Shared memory of a resident backward block of ``rows`` rows in NT
    groups: the staged slice of W_hh [H][WS] bf16 (the prologue's), and
    over it the partials each group receives [NT][2][RES_CL][U][8] f32
    (by the sending step's parity) and two buffers of da's three bf16
    terms [2][3][8][WS] (a group step's buffer is its parity); an
    mbarrier for each group and parity."""
    U, _, _, _, _, _, WS, _, _ = res_geometry(H)
    nt = _ceil_div(rows, 8)
    return max(H * WS * 2, nt * 2 * RES_CL * U * 8 * 4 + 2 * 3 * 8 * WS * 2) + nt * 2 * 8


def lstm_scan_fwd_plan(B: int, L: int, D: int, H: int, elem_size: int,
                       clusters_at_once: Optional[int] = None) -> FwdPlan:
    """``clusters_at_once``: the resident walk's clusters that the card
    holds at once, from which ``res_rows`` chooses (on a card, what
    ``plan_query`` reads); the resident walk needs it, the others ignore it."""
    U = H // CL
    if elem_size == 2:  # gx_wgmma_kernel
        nt, mt = 4 * H // WG_N, _ceil_div(B * L, WG_M)
        gx = dict(gemm="wgmma", gx_blocks_per_sm=2)
        S = gx_splits(nt * mt, _ceil_div(D, WG_DX_K))
        gx_grid = (nt, gx_rows(nt, mt, S), S)
        gx_smem = wg_smem(B, WG_GX_RING)
    else:  # gates_x_kernel: x's and W_ih's stages of 128-byte rows, rows padded
        gx = {}
        starts = ((B + 4) & ~3) * 4  # starts [B + 1] ints, rounded up to 16 bytes
        kc = 32  # floats of a stage's 128-byte rows
        gx_smem = starts + GX_TM * 4 + GX_STAGES * (GX_TM * (kc + 4) + kc * (GX_TN + 8)) * 4
        gx_grid = (4 * H // GX_TN, min(_ceil_div(B * L, GX_TM), GX_YMAX))
    if resident(H, elem_size):
        if clusters_at_once is None:
            raise ValueError("the resident walk's rows follow from the clusters the card holds "
                             "at once (plan_query)")
        rows = res_rows(B, clusters_at_once)
        _, _, _, _, mpw, kpw, *_ = res_geometry(H)
        return FwdPlan(gx_grid, gx_smem, _ceil_div(B, rows) * RES_CL, res_smem(H, rows),
                       RES_T // 32, 4 * mpw * kpw, RES_T, 0, 0, RES_CL, rows, "registers", **gx)
    if H > WIDE_H:
        # the warps' rings; h double-buffered; the gate tiles; the final
        # (h, c); two mbarriers.  A block streams its 4U columns of W_hh
        rec_smem = (WW * WSTAGES * WFQ * 32 * 4 * elem_size
                    + (2 * H * R + WW * R * GT_S + 2 * R * U) * 4 + 16)
        return FwdPlan(gx_grid, gx_smem, _ceil_div(B, R) * CL, rec_smem, 4 * U // 16, 0, WT,
                       4 * U * H * elem_size, 4 * H * H, CL, R, "streamed from L2", **gx)
    # W_hh's columns as f32 fragments; h double-buffered; three steps' gx of
    # every warp; the warps' gate tiles; the final (h, c); two mbarriers
    rec_smem = (4 * U * H + 2 * H * R + 3 * WARPS * 4 * R * 4 + WARPS * R * GT_S
                + 2 * R * U) * 4 + 16
    return FwdPlan(gx_grid, gx_smem, _ceil_div(B, R) * CL, rec_smem, 4 * U // 16, 4 * FKS_MAX,
                   THREADS, 0, 0, CL, R,
                   "registers" if elem_size == 2 else
                   "registers (TF32 high halves) and shared memory (low halves)", **gx)


def plan_query(B: int, H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """(blocks a cluster, rows a cluster, clusters, threads, shared memory,
    the clusters the card holds at once that the rows were chosen from, and
    those of the launched walk) of the forward walk the C entry points
    launch, read from the built library (a card is needed)."""
    return _plan_query("lstm_scan_plan_query", B, H, dtype)


def bwd_plan_query(B: int, H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """``plan_query`` of the backward walk (K2's first launch)."""
    return _plan_query("lstm_scan_bwd_plan_query", B, H, dtype)


def _plan_query(symbol: str, B: int, H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    fn = build.kernel_function("lstm_scan", symbol,
                               [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * 7)()
    build.check_launch(fn(B, H, build.DTYPE_CODES[dtype], out), symbol)
    return tuple(out)


def lstm_scan_bwd_plan(B: int, L: int, D: int, H: int, elem_size: int,
                       clusters_at_once: Optional[int] = None) -> BwdPlan:
    """``clusters_at_once``: the resident backward walk's clusters that the
    card holds at once (on a card, what ``bwd_plan_query`` reads; not the
    forward's count), from which ``res_rows`` chooses; the resident walk
    needs it, the others ignore it."""
    U = H // CL
    starts = ((B + 4) & ~3) * 4  # starts [B + 1] ints, rounded up to 16 bytes
    if resident(H, elem_size):
        if clusters_at_once is None:
            raise ValueError("the resident walk's rows follow from the clusters the card holds "
                             "at once (bwd_plan_query)")
        rows = res_rows(B, clusters_at_once)
        rec = (_ceil_div(B, rows) * RES_CL, bwd_res_smem(H, rows), RES_T, 0, 0, RES_CL, rows,
               "registers")
    elif H > WIDE_H:  # the warps' rings (two m-tiles each); da's halves; the partials
        rec = (_ceil_div(B, R) * CL, WW * WSTAGES * WBQ * 2 * 32 * 4 * elem_size
               + (4 * 4 * U * R + 2 * CL * R * U) * 4 + 16, WT, 4 * U * H * elem_size,
               4 * H * H, CL, R, "streamed from L2")
    else:
        # W_hh's columns as f32 fragments; da's TF32 halves and the partials,
        # double-buffered; three steps' inputs; two mbarriers
        rec = (_ceil_div(B, R) * CL,
               4 * U * H * 4 + (4 * 4 * U * R + 2 * CL * R * U + 3 * 6 * THREADS) * 4 + 16,
               THREADS, 0, 0, CL, R,
               "registers" if elem_size == 2 else
               "registers (TF32 high halves) and shared memory (low halves)")
    rec_grid, rec_smem, *rest = rec
    if elem_size == 2:
        tiles, nx, ny = dw_tiles(D, H), _ceil_div(D, WG_N), _ceil_div(B * L, WG_M)
        return BwdPlan(rec_grid, rec_smem, (nx, ny, dx_splits(nx * ny, 4 * H // WG_DX_K)),
                       wg_smem(B, WG_DX_RING), (tiles, dw_splits(tiles), 1),
                       wg_smem(B, WG_DW_RING), 2, dw_splits(tiles), *rest,
                       gemm="wgmma", pack_grid=_ceil_div(B * L, PACK_WARPS),
                       pack_elems=B * L * (D + 15 * H))
    # f32: da's and W_ih's stages, rows padded by 4 floats
    dx_smem = starts + DX_TM * 4 + DX_STAGES * (DX_TM + DX_TN) * (DX_KC + 4) * 4
    dw_smem = starts + max(DW_STAGES * DW_KC * (DW_TI + 8 + DW_TJ + 8) * 4,
                           DW_TI * (DW_TJ + 4) * 4)
    return BwdPlan(rec_grid, rec_smem,
                   (_ceil_div(D, DX_TN), _ceil_div(B * L, DX_TM) + 1), dx_smem,
                   (4 * H // DW_TJ, _ceil_div(max(D, H), DW_TI), 2 * DW_SPLITS), dw_smem,
                   min(MAX_SMEM // dw_smem, 2048 // DW_THREADS), DW_SPLITS, *rest)


def wg_smem(B: int, ring: int) -> int:
    """Shared memory of a wgmma GEMM block: starts [B + 1] ints (rounded up
    to 16 bytes), 4 full and 4 empty mbarriers, up to 1 KB to align the
    ring to the 128-byte swizzle's 1024-byte period, the ring."""
    return ((B + 4) & ~3) * 4 + 64 + 1024 + ring


def dw_tiles(D: int, H: int) -> int:
    """dw_wgmma's output tiles: dW_hh's [H, 4H] then dW_ih's [D, 4H]."""
    return (_ceil_div(D, WG_M) + _ceil_div(H, WG_M)) * (4 * H // WG_N)


def dx_splits(tiles: int, nk: int, sms: int = WG_SMS) -> int:
    """dx_wgmma's splits of K: the smallest S in {1, 2, 4, 8} whose tiles x
    S blocks (the tiles counted for B L valid steps) fill 70% of a wave of
    one block an SM, at most 8 and the ``nk`` K-tiles.  Short step counts
    leave most of those tiles empty (11-20 tokens of 80), so a split still
    fills more SMs."""
    s = 1
    while s < 8 and 2 * s <= nk and tiles * s * 10 < 7 * sms:
        s *= 2
    return s


def gx_splits(tiles: int, nk: int, sms: int = WG_SMS) -> int:
    """gx_wgmma's splits of K = D: the largest S in {1, 2, 4, 8} whose
    tiles x S blocks (the tiles counted for B L valid steps) fit one block
    an SM, with at least 16 K-tiles a split left to halve: a split's
    partial-tile sum through distributed shared memory costs more than the
    K-tiles it saves on a fuller card (``scripts/torch_gx_wgmma_variants.py``).
    The beam's rescoring (32 tiles of 34 K-tiles) splits 4 ways; the
    speaker's 144 tiles and every D below 16 K-tiles (<= 960), none."""
    s = 1
    while s < 8 and 16 * s <= nk and 2 * tiles * s <= sms:
        s *= 2
    return s


def gx_rows(nt: int, mt: int, S: int, sms: int = WG_SMS) -> int:
    """gx_wgmma's rows of blocks over the ``mt`` step tiles counted for B L
    steps: with splits of K one a step tile; without, at most a round of
    two blocks an SM over the ``nt`` column tiles, block y taking step
    tiles y, y + Y, ... below the valid steps (counted on the device)."""
    return mt if S > 1 else min(mt, max(1, 2 * sms // nt))


def dw_splits(tiles: int, sms: int = WG_SMS) -> int:
    """The smallest S in {1, 2, 4, 8} whose tiles x S blocks fill 70% of a
    wave of two blocks an SM, doubled once more where that leaves a second
    wave under half full: fewer blocks leave SMs idle, more pay more
    reductions (``scripts/torch_k2_wgmma_variants.py``)."""
    wave, s = 2 * sms, 1
    while s < 8 and tiles * s * 10 < 7 * wave:
        s *= 2
    if s < 8 and wave < tiles * s and 2 * tiles * s <= 3 * wave:
        s *= 2
    return s


def wg_split_bounds(Mv: int, splits: int) -> List[Tuple[int, int]]:
    """dw_wgmma's split s reduces the valid steps of K-tiles [n s / S,
    n (s + 1) / S) of the n = ceil(Mv / WG_DW_K) tiles of WG_DW_K steps, in
    order (cut back to Mv); the cluster then sums the splits' partials in
    rank order."""
    n = _ceil_div(Mv, WG_DW_K)
    return [(min(Mv, n * s // splits * WG_DW_K), min(Mv, n * (s + 1) // splits * WG_DW_K))
            for s in range(splits)]


def packed_rows(lengths, L: int) -> List[int]:
    """The packed row that the pack launch fills from sequence row m = b L
    + t, in m's order: valid step v (``valid_steps``' numbering) where t <
    len[b], else Mv + q for padded step number q (row by row), whose row is
    zeroed only below Mv rounded up to dW's K-tile (the rest is never
    read)."""
    lens = [max(0, min(int(n), L)) for n in lengths]
    Mv = sum(lens)
    out, v, q = [], 0, 0
    for n in lens:
        for t in range(L):
            if t < n:
                out.append(v)
                v += 1
            else:
                out.append(Mv + q)
                q += 1
    return out


def wg_tma_boxes(B: int, L: int, D: int, H: int, Mv: int):
    """The TMA boxes (map, (c0, c1, term)) that K2's wgmma launches ask for,
    and each map's dims (cols, rows, terms, box rows): every box is {64,
    box rows, 1} (a box's part past the cols or rows reads zeros).  d_xs's
    maps ("da", "w_ih") take boxes of WG_DX_K rows, dW's ("x", "hprev",
    "da_dw": da's terms again) of WG_DW_K."""
    P, H4 = B * L, 4 * H
    dims = {"da": (H4, P, 3, WG_DX_K), "w_ih": (H4, D, 1, WG_DX_K), "x": (D, P, 1, WG_DW_K),
            "hprev": (H, P, 3, WG_DW_K), "da_dw": (H4, P, 3, WG_DW_K)}
    boxes = []
    for mt in range(_ceil_div(D, WG_N)):
        for st in range(_ceil_div(Mv, WG_M)):
            for kt in range(H4 // WG_DX_K):
                for h in range(2):
                    boxes += [("da", (kt * WG_DX_K, st * WG_M + 64 * h, a)) for a in range(3)]
                    boxes.append(("w_ih", (kt * WG_DX_K, mt * WG_N + 64 * h, 0)))
    S = dw_splits(dw_tiles(D, H))
    for name, I, na in (("hprev", H, 3), ("x", D, 1)):
        for it in range(_ceil_div(I, WG_M)):
            for jt in range(H4 // WG_N):
                for v0, v1 in wg_split_bounds(Mv, S):
                    for v in range(v0, v1, WG_DW_K):
                        for h in range(2):
                            boxes += [(name, (it * WG_M + 64 * h, v, a)) for a in range(na)]
                            boxes += [("da_dw", (jt * WG_N + 64 * h, v, a)) for a in range(3)]
    return dims, boxes


def gx_loads(B: int, L: int, D: int, H: int, Mv: int):
    """What gx_wgmma reads at Mv valid steps, as its plan cuts the grid:
    the TMA maps of W_ih and x ("w_ih" [D][4H], "x" [B L][D]: (cols, rows,
    terms, box rows), every box {64, 64, 1}, its part past the cols or rows
    reading zeros); the boxes (map, c0, c1) of each block (n tile, y,
    split), x's only where Mv = B L; and where Mv < B L the (valid step,
    k) of every 16-byte chunk of x that the consumers gather (v < Mv, k <
    D; the others are zero-filled), one for each (tile, K-tile, row, chunk
    of 8)."""
    P, nk = B * L, _ceil_div(D, WG_DX_K)
    nt, mt = 4 * H // WG_N, _ceil_div(P, WG_M)
    _, Y, S = lstm_scan_fwd_plan(B, L, D, H, 2, clusters_at_once=H100_RES_CLUSTERS).gx_grid
    dims = {"w_ih": (4 * H, D, 1, WG_DX_K), "x": (D, P, 1, WG_DX_K)}
    boxes, chunks = {}, []
    for x in range(nt):
        for y in range(Y):
            for z in range(S):
                got = boxes.setdefault((x, y, z), [])
                for t in range(y, _ceil_div(Mv, WG_M), Y):
                    for kt in range(nk * z // S, nk * (z + 1) // S):
                        for h in range(2):
                            got.append(("w_ih", x * WG_N + 64 * h, kt * WG_DX_K))
                            if Mv == P:
                                got.append(("x", kt * WG_DX_K, t * WG_M + 64 * h))
                        if x == 0 and Mv < P:
                            chunks += [(v, k) for v in range(t * WG_M, min(Mv, (t + 1) * WG_M))
                                       for k in range(kt * WG_DX_K, min(D, (kt + 1) * WG_DX_K), 8)]
    return dims, boxes, chunks


def whh_pack_order(H: int, bwd: bool) -> torch.Tensor:
    """The flat W_hh [H, 4H] index of each element that pack_whh_kernel
    writes, in its order: element e of lane l's A fragment (m16n8k8 TF32:
    e = 0..3 are rows g, g + 8, g, g + 8 and columns q, q, q + 4, q + 4 of
    the tile, g = l / 4, q = l % 4) of k-step ks of m-tile mt of block rank
    at (((rank MT + mt) KS + ks) 32 + l) 4 + e.  Forward: A[c][k'] =
    W_hh[k'][column c], tile row 4u + g the gate g of unit rank U + 4 mt +
    u; backward: A[k'][c] over the block's 4U columns, gate-major."""
    U = H // CL
    MT, KS = (H // 16, U // 2) if bwd else (U // 4, H // 8)
    i = torch.arange(CL * MT * KS * 32)
    lane, f = i % 32, i // 32
    ks, mt, rank = f % KS, (f // KS) % MT, f // KS // MT
    g8, q4 = lane // 4, lane % 4
    out = []
    for e in range(4):
        m, kk = g8 + 8 * (e & 1), ks * 8 + q4 + 4 * (e >> 1)
        if bwd:
            row, col = mt * 16 + m, (kk // U) * H + rank * U + kk % U
        else:
            row, col = kk, (m % 4) * H + rank * U + 4 * mt + m // 4
        out.append(row * 4 * H + col)
    return torch.stack(out, dim=1).reshape(-1)


def valid_steps(lengths, L: int) -> List[Tuple[int, int]]:
    """The valid steps (b, t), t < len[b] (clamped to [0, L]), in the order
    in which K2's GEMMs number them: row by row, t ascending, whatever the
    direction (both walk the same steps)."""
    return [(b, t) for b, n in enumerate(lengths) for t in range(max(0, min(int(n), L)))]


def split_bounds(Mv: int, splits: int) -> List[Tuple[int, int]]:
    """dw_gemm's split s reduces valid steps [s Mv / S, (s + 1) Mv / S), in
    order; the cluster then sums the splits' partials in rank order."""
    return [(Mv * s // splits, Mv * (s + 1) // splits) for s in range(splits)]


def _cell(gates: torch.Tensor, c: torch.Tensor, H: int):
    i, f, g, o = gates.split(H, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_scan_train_plain(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Masked LSTM over xs [B, L, D] (gate order i, f, g, o; f32 state and
    accumulation).  Step l reads t = L-1-l when ``reverse``; rows with
    t >= lengths[b] keep their carry and output 0.  Returns (outs [B, L, H],
    (hT, cT) [B, H], hprev and cprev [L, B, H] — the carries before each
    step, by absolute t — and the gate pre-activations [B, L, 4H]), all
    f32."""
    B, L, _ = xs.shape
    H = w_hh.shape[0]
    acc = build.acc_dtype(xs)
    wih, whh, bias = w_ih.to(acc), w_hh.to(acc), b.to(acc)
    h = xs.new_zeros((B, H), dtype=acc)
    c = torch.zeros_like(h)
    outs = xs.new_zeros((B, L, H), dtype=acc)
    hprev = xs.new_zeros((L, B, H), dtype=acc)
    cprev = torch.zeros_like(hprev)
    gates = xs.new_zeros((B, L, 4 * H), dtype=acc)
    for l in range(L):
        t = L - 1 - l if reverse else l
        hprev[t], cprev[t] = h, c
        gates[:, t] = xs[:, t].to(acc) @ wih + h @ whh + bias
        h_new, c_new = _cell(gates[:, t], c, H)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[:, t] = torch.where(valid, h_new, 0.0)
    return outs, (h, c), hprev, cprev, gates


def lstm_scan_plain(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                    w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False
                    ) -> Tuple[torch.Tensor, Carry]:
    """The inference forward: (outs [B, L, H] f32, (hT, cT) [B, H] f32) of
    ``lstm_scan_train_plain``."""
    outs, carry, _, _, _ = lstm_scan_train_plain(xs, lengths, w_ih, w_hh, b, reverse)
    return outs, carry


def lstm_scan_bwd_plain(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                        w_hh: torch.Tensor, gates: torch.Tensor, hprev: torch.Tensor,
                        cprev: torch.Tensor, d_out: torch.Tensor, dhT: torch.Tensor,
                        dcT: torch.Tensor, reverse: bool = False):
    """Backward of ``lstm_scan_train_plain`` from its residuals and the
    cotangents of (outs, hT, cT).  Walks the forward's steps in the
    opposite order (t = l when ``reverse``, else L-1-l) with dh_eff = dh +
    dout; invalid steps pass (dh, dc) through unchanged (lstm_scan.py:
    264-286).  Returns (d_xs [B, L, D] in the dtype of xs, dW_ih [D, 4H],
    dW_hh [H, 4H], db [4H], all f32)."""
    B, L, _ = xs.shape
    H = w_hh.shape[0]
    acc = build.acc_dtype(xs)
    whh = w_hh.to(acc)
    dh, dc = dhT.to(acc), dcT.to(acc)
    da = xs.new_zeros((B, L, 4 * H), dtype=acc)
    for l in range(L):
        t = l if reverse else L - 1 - l
        valid = (t < lengths)[:, None]
        pi, pf, pg, po = gates[:, t].split(H, dim=-1)
        i, f, g, o = torch.sigmoid(pi), torch.sigmoid(pf), torch.tanh(pg), torch.sigmoid(po)
        cp = cprev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_eff = dh + d_out[:, t].to(acc)
        dct = dc + dh_eff * o * (1.0 - tc * tc)
        da_t = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                          dct * i * (1.0 - g * g), dh_eff * tc * o * (1.0 - o)], dim=-1)
        da_t = torch.where(valid, da_t, 0.0)
        dh = torch.where(valid, da_t @ whh.t(), dh)
        dc = torch.where(valid, dct * f, dc)
        da[:, t] = da_t
    d_xs = (da @ w_ih.to(acc).t()).to(xs.dtype)
    dw_ih = torch.einsum("bld,blg->dg", xs.to(acc), da)
    dw_hh = torch.einsum("lbh,blg->hg", hprev.to(acc), da)
    return d_xs, dw_ih, dw_hh, da.sum(dim=(0, 1))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) with its low 13 mantissa bits cleared: the TF32 value a
    tensor core reads from it."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, split_a: bool, split_b: bool) -> torch.Tensor:
    """a @ b (f32) as K2's MMAs take it: each operand as TF32 halves hi and
    lo = TF32(x - hi) where it is split, the products lo.hi + hi.lo +
    hi.hi (only those of split operands) summed in f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if split_a:
        out = _tf32(a - ah) @ bh + out
    if split_b:
        out = ah @ _tf32(b - bh) + out
    return out


def _block_columns(H: int, blocks: int = CL) -> List[torch.Tensor]:
    """The gate columns of W_hh that block ``rank`` of a cluster of
    ``blocks`` holds (CL, or the resident walks' RES_CL): gate g of units
    [rank U, (rank + 1) U), U = H / blocks, gate-major."""
    U = H // blocks
    return [torch.cat([torch.arange(g * H + r * U, g * H + (r + 1) * U) for g in range(4)])
            for r in range(blocks)]


def split_bf16x3(x: torch.Tensor) -> List[torch.Tensor]:
    """x (f32) as three bf16 terms t1 + t2 + t3, as the resident walk splits
    the h it receives: each the round-to-nearest-even of what the terms before leave
    (x - t1 and x - t1 - t2 are exact in f32), so x - (t1 + t2 + t3) is
    within 2^-24 |x|, or, where the last terms fall below bf16's normal
    range (|x| < 2^-110), within half its subnormal spacing, 2^-134."""
    terms = []
    for _ in range(3):
        t = x.to(torch.bfloat16)
        terms.append(t)
        x = x - t.float()
    return terms


def _res_product(h: torch.Tensor, whh: torch.Tensor) -> torch.Tensor:
    """h . W_hh [B, 4H] as the resident walk sums it: each of the RES_KG
    k-groups' partial, its three bf16 terms of h times the bf16 W_hh
    (exact products, f32 sums), then the partials in k-group order.  The
    blocks' column slices do not enter: a column's sum runs over k only."""
    H = whh.shape[0]
    terms = [t.float() for t in split_bf16x3(h)]
    kw = H // RES_KG
    out = None
    for kg in range(RES_KG):
        ks = slice(kg * kw, (kg + 1) * kw)
        part = terms[0][:, ks] @ whh[ks] + terms[1][:, ks] @ whh[ks] + terms[2][:, ks] @ whh[ks]
        out = part if out is None else out + part
    return out


def _res_bwd_product(da: torch.Tensor, whh: torch.Tensor) -> torch.Tensor:
    """da . W_hh^T [B, H] as the resident backward walk sums it: per block
    of the cluster (its 4H / RES_CL gate columns), the three bf16 terms of
    da times the bf16 W_hh (exact products, f32 sums), then the RES_CL
    partials in rank order."""
    terms = [t.float() for t in split_bf16x3(da)]
    out = None
    for col in _block_columns(whh.shape[0], RES_CL):
        wc = whh[:, col].t()
        part = None
        for t in terms:
            part = t[:, col] @ wc if part is None else part + t[:, col] @ wc
        out = part if out is None else out + part
    return out


def _gx_wgmma(x, wih, rows: int):
    """x . W_ih [rows, 4H] (f32 values of bf16 operands) as gx_wgmma sums
    it: exact products summed in f32 over ``gx_splits``' splits of K = D
    (whole K-tiles of WG_DX_K), the splits in rank order (its tiles
    counted for ``rows`` = B L steps)."""
    D, N = wih.shape
    nk = _ceil_div(D, WG_DX_K)
    S = gx_splits(N // WG_N * _ceil_div(rows, WG_M), nk)
    out = None
    for s in range(S):
        ks = slice(nk * s // S * WG_DX_K, nk * (s + 1) // S * WG_DX_K)
        part = x[:, ks] @ wih[ks]
        out = part if out is None else out + part
    return out


def lstm_scan_fwd_emulated(xs, lengths, w_ih, w_hh, b, reverse: bool = False):
    """K3's and K1's arithmetic in plain torch on the CPU, as
    ``csrc/lstm_scan.cu`` cuts it: gx = x . W_ih + b in the kernel's
    precision (bf16: exact products of the bf16 operands summed in f32
    over the splits of K that ``gx_splits`` gives, ``_gx_wgmma``; f32:
    TF32 with both operands split); the step product h . W_hh per
    block of the cluster (its G4 gate columns) in TF32 with h split into
    two halves and W_hh split in f32 only (bf16 is exact in TF32), or, on
    the resident walk, in bf16 with h as three terms (``_res_product``);
    the cell update in f32.  Returns what ``lstm_scan_train_plain``
    returns (the pre-activations at every step; the kernel writes only the
    valid ones)."""
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = xs.dtype == torch.float32
    res = resident(H, xs.element_size())
    x, wih, whh = xs.float().reshape(B * L, D), w_ih.float(), w_hh.float()
    gx = (_tf32_mm(x, wih, True, True) if f32 else _gx_wgmma(x, wih, B * L)).reshape(
        B, L, 4 * H) + b.float()
    h = torch.zeros((B, H))
    c = torch.zeros_like(h)
    outs = torch.zeros((B, L, H))
    hprev, cprev = torch.zeros((L, B, H)), torch.zeros((L, B, H))
    gates = torch.zeros((B, L, 4 * H))
    cols = _block_columns(H)
    for l in range(L):
        t = L - 1 - l if reverse else l
        hprev[t], cprev[t] = h, c
        if res:
            hw = _res_product(h, whh)
        else:
            hw = torch.zeros((B, 4 * H))
            for col in cols:
                hw[:, col] = _tf32_mm(h, whh[:, col], True, f32)
        gates[:, t] = hw + gx[:, t]
        h_new, c_new = _cell(gates[:, t], c, H)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[:, t] = torch.where(valid, h_new, 0.0)
    return outs, (h, c), hprev, cprev, gates


def _wgmma_gemms(xv, hv, dav, w_ih, rows: int):
    """K2's bf16 GEMMs as the wgmma launches cut them, from the valid
    steps' rows (``valid_steps``' order) of xs [Mv, D], hprev [Mv, H] and
    da [Mv, 4H]: da and hprev as three bf16 terms (``split_bf16x3``), X
    and W_ih exact; every product exact, summed in f32.  d_xs [Mv, D] f32
    = the terms' products with W_ih^T, the smallest term first, over
    ``dx_splits``' splits of K = 4H (whole K-tiles) summed in rank order
    (its tiles counted for ``rows`` = B L steps); dW_ih and dW_hh over
    ``wg_split_bounds``' splits of the steps, each split the
    ``DW_TERM_PRODUCTS`` in order, the splits summed in rank order."""
    D, H = xv.shape[1], hv.shape[1]
    terms = [t.float() for t in split_bf16x3(dav)]
    wih = w_ih.float().t()
    nk = 4 * H // WG_DX_K
    S = dx_splits(_ceil_div(D, WG_N) * _ceil_div(rows, WG_M), nk)
    d_xs = None
    for s in range(S):
        ks = slice(nk * s // S * WG_DX_K, nk * (s + 1) // S * WG_DX_K)
        part = terms[2][:, ks] @ wih[ks] + terms[1][:, ks] @ wih[ks] + terms[0][:, ks] @ wih[ks]
        d_xs = part if d_xs is None else d_xs + part
    bounds = wg_split_bounds(dav.shape[0], dw_splits(dw_tiles(D, H)))
    dws = []
    for a_terms in ([xv.float()], [t.float() for t in split_bf16x3(hv)]):
        dw = None
        for v0, v1 in bounds:
            part = None
            for ia, ib in DW_TERM_PRODUCTS[len(a_terms)]:
                p = a_terms[ia][v0:v1].t() @ terms[ib][v0:v1]
                part = p if part is None else part + p
            dw = part if dw is None else dw + part
        dws.append(dw)
    return d_xs, dws


def lstm_scan_bwd_emulated(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT,
                           reverse: bool = False, split: bool = True,
                           clusters_at_once: Optional[int] = None):
    """K2's arithmetic in plain torch on the CPU, as ``csrc/lstm_scan.cu``
    and its plan cut it: the recurrence's step product da . W_hh^T on the
    tensor cores per block of the cluster (its G4 columns) and summed over
    the blocks in rank order; d_xs = da . W_ih^T; dW_ih, dW_hh as partial
    sums over ``valid_steps``, summed in rank order; db over the
    recurrence's clusters in order.  In f32 the GEMMs take
    ``split_bounds``' splits, and every product there and in the walk is in
    TF32 with the operands the kernel splits split (``split=False``: none,
    plain TF32, for comparison): da always, as f32 operands are; bf16
    operands are exact in TF32 and never split.  In bf16 the GEMMs are the
    wgmma launches' (``_wgmma_gemms``: bf16 terms, whatever ``split``).  On
    the resident walk (``resident``) the step product is
    ``_res_bwd_product`` (16 blocks, da as three bf16 terms, whatever
    ``split``) and db's clusters take ``res_rows(B, clusters_at_once)``
    rows each (default: the H100's ``H100_RES_CLUSTERS``).  Returns what
    ``lstm_scan_bwd`` returns."""
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = xs.dtype == torch.float32
    res = resident(H, xs.element_size())
    if clusters_at_once is None:
        clusters_at_once = H100_RES_CLUSTERS
    rows = res_rows(B, clusters_at_once) if res else R  # db's rows a cluster
    whh = w_hh.float()
    dh, dc = dhT.float(), dcT.float()
    da = torch.zeros((B, L, 4 * H))
    cols = _block_columns(H)
    for l in range(L):
        t = l if reverse else L - 1 - l
        valid = (t < lengths)[:, None]
        pi, pf, pg, po = gates[:, t].split(H, dim=-1)
        i, f, g, o = torch.sigmoid(pi), torch.sigmoid(pf), torch.tanh(pg), torch.sigmoid(po)
        cp = cprev[t]
        tc = torch.tanh(f * cp + i * g)
        dh_eff = dh + d_out[:, t]
        dct = dc + dh_eff * o * (1.0 - tc * tc)
        da_t = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                          dct * i * (1.0 - g * g), dh_eff * tc * o * (1.0 - o)], dim=-1)
        da_t = torch.where(valid, da_t, 0.0)
        if res:
            dh_prev = _res_bwd_product(da_t, whh)
        else:
            dh_prev = torch.zeros_like(dh)
            for c in cols:
                dh_prev = dh_prev + _tf32_mm(da_t[:, c], whh[:, c].t(), split, split and f32)
        dh = torch.where(valid, dh_prev, dh)
        dc = torch.where(valid, dct * f, dc)
        da[:, t] = da_t
    steps = valid_steps(lengths.tolist(), L)
    bs = torch.tensor([b for b, _ in steps], dtype=torch.long)
    ts = torch.tensor([t for _, t in steps], dtype=torch.long)
    dav = da[bs, ts]
    d_xs = torch.zeros((B, L, D))
    if not f32:
        d_xs[bs, ts], dws = _wgmma_gemms(xs[bs, ts], hprev[ts, bs].float(), dav, w_ih, B * L)
    else:
        d_xs[bs, ts] = _tf32_mm(dav, w_ih.float().t(), split, split)
        dws = []
        for a, split_a in ((xs[bs, ts].float(), split), (hprev[ts, bs].float(), split)):
            dw = None
            for v0, v1 in split_bounds(len(steps), DW_SPLITS):
                part = _tf32_mm(a[v0:v1].t(), dav[v0:v1], split_a, split)
                dw = part if dw is None else dw + part
            dws.append(dw)
    db = None
    for q in range(_ceil_div(B, rows)):
        part = da[q * rows:(q + 1) * rows].sum(dim=(0, 1))
        db = part if db is None else db + part
    return d_xs.to(xs.dtype), dws[0], dws[1], db


def _check(name, xs, lengths, w_ih, w_hh, extra=()):
    B, L, D = xs.shape
    H = w_hh.shape[0]
    dtype = xs.dtype
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"{name}: xs dtype must be float32 or bfloat16, got {dtype}")
    for arg, t, shape, dt in (("w_ih", w_ih, (D, 4 * H), dtype), ("w_hh", w_hh, (H, 4 * H), dtype),
                              ("lengths", lengths, (B,), torch.int64), *extra):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if H % 32 or not 32 <= H <= MAX_H:
        raise ValueError(f"{name}: hidden size {H} must be a multiple of 32 up to {MAX_H} "
                         "(whole m-tiles of four units a block of the cluster)")
    ins = (xs, lengths, w_ih, w_hh, *(e[1] for e in extra))
    if any(t.device != xs.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: all inputs must be contiguous and on one CUDA device")
    return B, L, D, H


def pad_rows(xs: torch.Tensor, w_ih: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs [B, L, D] and w_ih [D, 4H] with D zero-padded to whole 16-byte rows,
    which the kernels' loads need (the Follower's 300-wide bf16 embedding
    rows are 600 bytes).  A zero feature adds nothing to any product, so the
    results are exact once d_xs and dW_ih are cut back to D."""
    pad = -xs.shape[-1] % (16 // xs.element_size())
    if not pad:
        return xs, w_ih
    return (torch.nn.functional.pad(xs, (0, pad)).contiguous(),
            torch.nn.functional.pad(w_ih, (0, 0, 0, pad)).contiguous())


def _forward_cuda(name, symbol, argtypes, xs, lengths, w_ih, w_hh, b, reverse, train):
    _check(name, xs, lengths, w_ih, w_hh, (("b", b, (4 * w_hh.shape[0],), xs.dtype),))
    xs, w_ih = pad_rows(xs, w_ih)
    B, L, D = xs.shape
    H = w_hh.shape[0]
    # the resident walk's rows, as the C entry point chooses them on this card
    at_once = plan_query(B, H, xs.dtype)[5] if resident(H, xs.element_size()) else None
    plan = lstm_scan_fwd_plan(B, L, D, H, xs.element_size(), at_once)
    if max(plan.gx_smem, plan.rec_smem) > MAX_SMEM:
        raise ValueError(f"{name}: batch {B} needs more shared memory than a block has")
    f32 = dict(dtype=torch.float32, device=xs.device)
    gx = torch.empty((B, L, 4 * H), **f32)  # x . W_ih + b (K1: the full pre-activations)
    outs = torch.empty((B, L, H), **f32)
    hT, cT = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    residual = (torch.empty((L, B, H), **f32), torch.empty((L, B, H), **f32)) if train else ()
    wpack = torch.empty((plan.w_pack,), dtype=xs.dtype, device=xs.device)  # the wide walk's
    fn = build.kernel_function("lstm_scan", symbol, argtypes)
    err = fn(xs.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
             gx.data_ptr(), outs.data_ptr(), hT.data_ptr(), cT.data_ptr(),
             *(t.data_ptr() for t in residual), wpack.data_ptr(), B, L, D, H, int(reverse),
             build.DTYPE_CODES[xs.dtype], build.stream_handle(xs))
    build.check_launch(err, name)
    return outs, (hT, cT), residual, gx


def lstm_scan_cuda(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                   w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False
                   ) -> Tuple[torch.Tensor, Carry]:
    """``lstm_scan_plain`` as one call of K3 (its two launches count as one)."""
    global launches
    outs, carry, _, _ = _forward_cuda("lstm_scan", "lstm_scan", _ARGTYPES, xs, lengths, w_ih,
                                      w_hh, b, reverse, train=False)
    launches += 1
    return outs, carry


def lstm_scan_train_cuda(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                         w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """``lstm_scan_train_plain`` as one call of K1 (two launches).  Its
    gate pre-activations are those of the valid steps only."""
    global train_launches
    outs, carry, (hprev, cprev), gates = _forward_cuda(
        "lstm_scan_train", "lstm_scan_train", _TRAIN_ARGTYPES, xs, lengths, w_ih, w_hh, b,
        reverse, train=True)
    train_launches += 1
    return outs, carry, hprev, cprev, gates


def lstm_scan_bwd_cuda(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                       w_hh: torch.Tensor, gates: torch.Tensor, hprev: torch.Tensor,
                       cprev: torch.Tensor, d_out: torch.Tensor, dhT: torch.Tensor,
                       dcT: torch.Tensor, reverse: bool = False):
    """``lstm_scan_bwd_plain`` as one call of K2: the walk, then in f32
    the two mma.sync GEMMs, in bf16 the pack and the two wgmma GEMMs."""
    global bwd_launches
    B, L, D0 = xs.shape
    H = w_hh.shape[0]
    f32 = torch.float32
    _check("lstm_scan_bwd", xs, lengths, w_ih, w_hh, (
        ("gates", gates, (B, L, 4 * H), f32), ("hprev", hprev, (L, B, H), f32),
        ("cprev", cprev, (L, B, H), f32), ("d_out", d_out, (B, L, H), f32),
        ("dhT", dhT, (B, H), f32), ("dcT", dcT, (B, H), f32)))
    xs, w_ih = pad_rows(xs, w_ih)
    D = xs.shape[2]
    # the resident walk's rows, as the C entry point chooses them on this card
    at_once = bwd_plan_query(B, H, xs.dtype)[5] if resident(H, xs.element_size()) else None
    plan = lstm_scan_bwd_plan(B, L, D, H, xs.element_size(), at_once)
    if max(plan.rec_smem, plan.dx_smem, plan.dw_smem) > MAX_SMEM:
        raise ValueError(f"lstm_scan_bwd: batch {B} needs more shared memory than a block has")
    dev = dict(dtype=f32, device=xs.device)
    da = torch.empty((B, L, 4 * H), **dev)
    db_part = torch.empty((plan.clusters, 4 * H), **dev)  # a row each cluster of the walk
    d_xs = torch.empty((B, L, D), dtype=xs.dtype, device=xs.device)
    dw_ih, dw_hh = torch.empty((D, 4 * H), **dev), torch.empty((H, 4 * H), **dev)
    db = torch.empty((4 * H,), **dev)
    wpack = torch.empty((plan.w_pack,), dtype=xs.dtype, device=xs.device)  # the wide walk's
    pack = torch.empty((plan.pack_elems,), dtype=xs.dtype, device=xs.device)  # bf16: the GEMMs'
    fn = build.kernel_function("lstm_scan", "lstm_scan_bwd", _BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT,
                                      dcT, da, db_part, d_xs, dw_ih, dw_hh, db, wpack, pack)),
             B, L, D, H, int(reverse), build.DTYPE_CODES[xs.dtype], build.stream_handle(xs))
    build.check_launch(err, "lstm_scan_bwd")
    bwd_launches += 1
    if D != D0:  # cut the padded features back
        d_xs, dw_ih = d_xs[..., :D0].contiguous(), dw_ih[:D0].contiguous()
    return d_xs, dw_ih, dw_hh, db


def _dispatch(name, xs, cuda_fn, plain_fn, *args, **kwargs):
    if xs.device.type == "cuda":
        return cuda_fn(xs, *args, **kwargs)
    if xs.device.type == "cpu":
        return plain_fn(xs, *args, **kwargs)
    raise ValueError(f"{name}: no implementation for device {xs.device}")


def lstm_scan(xs, lengths, w_ih, w_hh, b, reverse: bool = False) -> Tuple[torch.Tensor, Carry]:
    return _dispatch("lstm_scan", xs, lstm_scan_cuda, lstm_scan_plain, lengths, w_ih, w_hh, b,
                     reverse=reverse)


def lstm_scan_train(xs, lengths, w_ih, w_hh, b, reverse: bool = False):
    return _dispatch("lstm_scan_train", xs, lstm_scan_train_cuda, lstm_scan_train_plain,
                     lengths, w_ih, w_hh, b, reverse=reverse)


def lstm_scan_bwd(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT,
                  reverse: bool = False):
    return _dispatch("lstm_scan_bwd", xs, lstm_scan_bwd_cuda, lstm_scan_bwd_plain, lengths,
                     w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT, reverse=reverse)
