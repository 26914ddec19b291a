"""K3, K1 and K2: the masked LSTM scan — inference forward, training
forward and backward; CUDA kernels and plain twins.

K3 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
lstm_scan_pallas``, K1 its ``lstm_scan_train_pallas``, K2 its
``lstm_scan_bwd_pallas``.  Kernel: ``csrc/lstm_scan.cu`` — the forward is
one C call of two launches: a tensor-core GEMM for x . W_ih + b over the
valid steps only, then the recurrence on clusters of 8 blocks, each warp
holding its W_hh columns as tensor-core fragments in registers and
sending its units' new h to every block by st.async (no barrier a step);
K1 also writes the pre-step carries and keeps the gate pre-activations
as residuals.  K2 is one C call of three launches: the reverse-time
recurrence on the same cluster layout (its per-step product on the
tensor cores), then tensor-core GEMMs for d_xs and for dW_ih, dW_hh and
db over the valid steps only, in a fixed order (no atomics).  Every
product with an f32 operand runs in TF32 with that operand split in two
halves, which keeps f32 accuracy; bf16 operands are exact there.
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
from typing import List, NamedTuple, Tuple

import torch

from . import build

launches = 0
train_launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

Carry = Tuple[torch.Tensor, torch.Tensor]

# csrc/lstm_scan.cu's geometry: both recurrences' clusters of CL blocks
# own R batch rows each.  Forward: gates_x's tiles of GX_TM valid steps x
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
MAX_SMEM = 232448  # shared memory a block can use on the H100


class BwdPlan(NamedTuple):
    """K2's launches.  ``rec_grid`` blocks of the recurrence (clusters of
    CL along x) with ``rec_smem`` bytes; dx_gemm's grid (D tiles, step
    tiles + 1: blocks past the valid steps' tiles write the padded steps'
    zeros) with ``dx_smem``; dw_gemm's grid (4H tiles, max(D, H) tiles, 2
    matrices x ``splits``, clusters of ``splits`` along z) with
    ``dw_smem``, ``dw_blocks_per_sm`` of which fit an SM."""
    rec_grid: int
    rec_smem: int
    dx_grid: Tuple[int, int]
    dx_smem: int
    dw_grid: Tuple[int, int, int]
    dw_smem: int
    dw_blocks_per_sm: int
    splits: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class FwdPlan(NamedTuple):
    """K3's and K1's launches.  gates_x's grid (4H tiles, Y step tiles:
    block y takes step tiles y, y + Y, ... below the valid steps' count,
    which it computes on the device, so no host synchronisation reads the
    lengths) of GX_THREADS threads with ``gx_smem`` bytes; the
    recurrence's ``rec_grid`` blocks (clusters of CL along x) of THREADS
    threads with ``rec_smem``, of whose warps the first ``rec_warps`` (one
    a 16-column m-tile of the block's 4H / 8 gate columns) hold
    ``w_regs`` registers a thread of W_hh fragments."""
    gx_grid: Tuple[int, int]
    gx_smem: int
    rec_grid: int
    rec_smem: int
    rec_warps: int
    w_regs: int


def lstm_scan_fwd_plan(B: int, L: int, D: int, H: int, elem_size: int) -> FwdPlan:
    U = H // CL
    starts = ((B + 4) & ~3) * 4  # starts [B + 1] ints, rounded up to 16 bytes
    kc = 128 // elem_size  # elements of a stage's 128-byte rows
    x_stride, w_stride = kc + (4 if elem_size == 4 else 8), GX_TN + 8
    gx_smem = starts + GX_TM * 4 + GX_STAGES * (GX_TM * x_stride + kc * w_stride) * elem_size
    # W_hh's columns as f32 fragments; h double-buffered; three steps' gx of
    # every warp; the warps' gate tiles; the final (h, c); two mbarriers
    rec_smem = (4 * U * H + 2 * H * R + 3 * WARPS * 4 * R * 4 + WARPS * R * GT_S
                + 2 * R * U) * 4 + 16
    return FwdPlan((4 * H // GX_TN, min(_ceil_div(B * L, GX_TM), GX_YMAX)), gx_smem,
                   _ceil_div(B, R) * CL, rec_smem, 4 * U // 16, 4 * FKS_MAX)


def lstm_scan_bwd_plan(B: int, L: int, D: int, H: int, elem_size: int) -> BwdPlan:
    U = H // CL
    starts = ((B + 4) & ~3) * 4  # starts [B + 1] ints, rounded up to 16 bytes
    # W_hh's columns as f32 fragments; da's TF32 halves and the partials,
    # double-buffered; three steps' inputs; two mbarriers
    rec_smem = 4 * U * H * 4 + (4 * 4 * U * R + 2 * CL * R * U + 3 * 6 * THREADS) * 4 + 16
    w_stride = DX_KC + (4 if elem_size == 4 else 8)
    dx_smem = starts + DX_TM * 4 + DX_STAGES * (DX_TM * (DX_KC + 4) * 4
                                                + DX_TN * w_stride * elem_size)
    dw_smem = starts + max(DW_STAGES * DW_KC * (DW_TI + 8 + DW_TJ + 8) * 4,
                           DW_TI * (DW_TJ + 4) * 4)
    return BwdPlan(_ceil_div(B, R) * CL, rec_smem,
                   (_ceil_div(D, DX_TN), _ceil_div(B * L, DX_TM) + 1), dx_smem,
                   (4 * H // DW_TJ, _ceil_div(max(D, H), DW_TI), 2 * DW_SPLITS), dw_smem,
                   min(MAX_SMEM // dw_smem, 2048 // DW_THREADS), DW_SPLITS)


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


def _block_columns(H: int) -> List[torch.Tensor]:
    """The gate columns of W_hh that block ``rank`` of a cluster holds:
    gate g of units [rank U, (rank + 1) U), U = H / CL, gate-major."""
    U = H // CL
    return [torch.cat([torch.arange(g * H + r * U, g * H + (r + 1) * U) for g in range(4)])
            for r in range(CL)]


def lstm_scan_fwd_emulated(xs, lengths, w_ih, w_hh, b, reverse: bool = False):
    """K3's and K1's arithmetic in plain torch on the CPU, as
    ``csrc/lstm_scan.cu`` cuts it: gx = x . W_ih + b in the kernel's
    precision (bf16: exact products of the bf16 operands summed in f32;
    f32: TF32 with both operands split); the step product h . W_hh per
    block of the cluster (its G4 gate columns) in TF32 with h split into
    two halves and W_hh split in f32 only (bf16 is exact in TF32); the
    cell update in f32.  Returns what ``lstm_scan_train_plain`` returns
    (the pre-activations at every step; the kernel writes only the valid
    ones)."""
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = xs.dtype == torch.float32
    x, wih, whh = xs.float().reshape(B * L, D), w_ih.float(), w_hh.float()
    gx = (_tf32_mm(x, wih, True, True) if f32 else x @ wih).reshape(B, L, 4 * H) + b.float()
    h = torch.zeros((B, H))
    c = torch.zeros_like(h)
    outs = torch.zeros((B, L, H))
    hprev, cprev = torch.zeros((L, B, H)), torch.zeros((L, B, H))
    gates = torch.zeros((B, L, 4 * H))
    cols = _block_columns(H)
    for l in range(L):
        t = L - 1 - l if reverse else l
        hprev[t], cprev[t] = h, c
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


def lstm_scan_bwd_emulated(xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT, dcT,
                           reverse: bool = False, split: bool = True):
    """K2's arithmetic in plain torch on the CPU, as ``csrc/lstm_scan.cu``
    and its plan cut it: the recurrence's step product da . W_hh^T on the
    tensor cores per block of the cluster (its G4 columns) and summed over
    the blocks in rank order; d_xs = da . W_ih^T; dW_ih, dW_hh as
    ``split_bounds``' partial sums over ``valid_steps``, summed in rank
    order; db over the recurrence's clusters in order.  Every product is
    in TF32 with the operands the kernel splits split (``split=False``:
    none, plain TF32, for comparison): da always, as f32 operands are;
    bf16 operands are exact in TF32 and never split.  Returns what
    ``lstm_scan_bwd`` returns."""
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = xs.dtype == torch.float32
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
    d_xs[bs, ts] = _tf32_mm(dav, w_ih.float().t(), split, split and f32)
    dws = []
    for a, split_a in ((xs[bs, ts].float(), split and f32), (hprev[ts, bs].float(), split)):
        dw = None
        for v0, v1 in split_bounds(len(steps), DW_SPLITS):
            part = _tf32_mm(a[v0:v1].t(), dav[v0:v1], split_a, split)
            dw = part if dw is None else dw + part
        dws.append(dw)
    db = None
    for q in range(_ceil_div(B, R)):
        part = da[q * R:(q + 1) * R].sum(dim=(0, 1))
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
    if H % 32 or not 32 <= H <= 256:
        raise ValueError(f"{name}: hidden size {H} must be a multiple of 32 up to 256 "
                         "(an eighth of W_hh per block's shared memory)")
    ins = (xs, lengths, w_ih, w_hh, *(e[1] for e in extra))
    if any(t.device != xs.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError(f"{name}: all inputs must be contiguous and on one CUDA device")
    if (D * xs.element_size()) % 16:
        raise ValueError(f"{name}: xs rows must be a multiple of 16 bytes (D={D})")
    return B, L, D, H


def _forward_cuda(name, symbol, argtypes, xs, lengths, w_ih, w_hh, b, reverse, train):
    B, L, D, H = _check(name, xs, lengths, w_ih, w_hh, (("b", b, (4 * w_hh.shape[0],), xs.dtype),))
    plan = lstm_scan_fwd_plan(B, L, D, H, xs.element_size())
    if max(plan.gx_smem, plan.rec_smem) > MAX_SMEM:
        raise ValueError(f"{name}: batch {B} needs more shared memory than a block has")
    f32 = dict(dtype=torch.float32, device=xs.device)
    gx = torch.empty((B, L, 4 * H), **f32)  # x . W_ih + b (K1: the full pre-activations)
    outs = torch.empty((B, L, H), **f32)
    hT, cT = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    residual = (torch.empty((L, B, H), **f32), torch.empty((L, B, H), **f32)) if train else ()
    fn = build.kernel_function("lstm_scan", symbol, argtypes)
    err = fn(xs.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
             gx.data_ptr(), outs.data_ptr(), hT.data_ptr(), cT.data_ptr(),
             *(t.data_ptr() for t in residual), B, L, D, H, int(reverse),
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
    """``lstm_scan_bwd_plain`` as one call of K2 (three launches)."""
    global bwd_launches
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = torch.float32
    B, L, D, H = _check("lstm_scan_bwd", xs, lengths, w_ih, w_hh, (
        ("gates", gates, (B, L, 4 * H), f32), ("hprev", hprev, (L, B, H), f32),
        ("cprev", cprev, (L, B, H), f32), ("d_out", d_out, (B, L, H), f32),
        ("dhT", dhT, (B, H), f32), ("dcT", dcT, (B, H), f32)))
    plan = lstm_scan_bwd_plan(B, L, D, H, xs.element_size())
    if max(plan.rec_smem, plan.dx_smem, plan.dw_smem) > MAX_SMEM:
        raise ValueError(f"lstm_scan_bwd: batch {B} needs more shared memory than a block has")
    dev = dict(dtype=f32, device=xs.device)
    da = torch.empty((B, L, 4 * H), **dev)
    db_part = torch.empty((_ceil_div(B, R), 4 * H), **dev)
    d_xs = torch.empty((B, L, D), dtype=xs.dtype, device=xs.device)
    dw_ih, dw_hh = torch.empty((D, 4 * H), **dev), torch.empty((H, 4 * H), **dev)
    db = torch.empty((4 * H,), **dev)
    fn = build.kernel_function("lstm_scan", "lstm_scan_bwd", _BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out, dhT,
                                      dcT, da, db_part, d_xs, dw_ih, dw_hh, db)),
             B, L, D, H, int(reverse), build.DTYPE_CODES[xs.dtype], build.stream_handle(xs))
    build.check_launch(err, "lstm_scan_bwd")
    bwd_launches += 1
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
