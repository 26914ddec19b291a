"""K8: one fused LSTM cell; CUDA kernel and plain twin.

K8 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/lstm.py::
lstm_cell_pallas``: gates = x . W_ih + h . W_hh + b in f32 (gate order i,
f, g, o; the JAX layout W_ih [Din, 4H], W_hh [H, 4H]), then (h', c').
Kernel: ``csrc/lstm_cell.cu`` — a cluster of S CTAs per tile of 64 batch
rows x 16 hidden units (all four gate columns) splits K = Din + H S ways,
in boxes of 128 bytes of K (x / W_ih boxes first, then h / W_hh); each
CTA streams its run of boxes through a ring of TMA stages (bf16 through
the tensor cores, f32 on the SIMT units), and the cluster sums its
partials in rank order and writes its h' and c' tiles.
``lstm_cell_plan`` gives the launch geometry, which the CPU tests check.

No path runs it: like the JAX package (ops/rnn.py:59-67), the port's
decoder keeps ``ops/rnn.py::lstm_cell`` plain.  ``chip_smoke.py`` holds
it against its plain twin at the decoder cell's shape.

``lstm_cell`` dispatches by device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; there is no fallback between them.
``launches`` counts K8 launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# csrc/lstm_cell.cu's tiles: 16 hidden units (64 gate columns) by 64 batch
# rows a CTA, 128 threads; K in boxes of 128 bytes through a ring of 4
# stages of 16 KB, a 16 KB buffer that receives the cluster's split-K
# partials, and 1 KB to align the ring
TH, BM, THREADS, BOX_BYTES, STAGES, STAGE_BYTES = 16, 64, 128, 128, 4, 16384
SMEM = STAGES * STAGE_BYTES + 8 * THREADS * 16 + 1024
MAX_CLUSTER = 8           # the portable cluster size
SMS = 132                 # the H100's streaming multiprocessors


class CellPlan(NamedTuple):
    """K8's launch: grid (splits, H / TH, M tiles), clusters of ``splits``
    CTAs along x; CTA ``rank`` takes boxes [rank * boxes, (rank + 1) *
    boxes) of the ``box_rows``-row boxes of x (and W_ih), then of h (and
    W_hh); ``smem`` bytes of dynamic shared memory."""
    grid: Tuple[int, int, int]
    splits: int
    boxes: int
    box_rows: int
    smem: int
    threads: int = THREADS


def lstm_cell_plan(B: int, Din: int, H: int, elem_size: int, sms: int = SMS) -> CellPlan:
    """The K split S, a power of two up to ``MAX_CLUSTER``: doubled while
    twice the CTAs still fit in one wave on ``sms`` SMs, and never so far
    that a CTA has no box."""
    kc = BOX_BYTES // elem_size
    nb = _ceil_div(Din, kc) + _ceil_div(H, kc)
    tiles = (H // TH) * _ceil_div(B, BM)
    s = 1
    while s < MAX_CLUSTER and tiles * 2 * s <= sms and (2 * s - 1) * _ceil_div(nb, 2 * s) < nb:
        s *= 2
    return CellPlan((s, H // TH, _ceil_div(B, BM)), s, _ceil_div(nb, s), kc, SMEM)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


Carry = Tuple[torch.Tensor, torch.Tensor]


def lstm_cell_plain(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_ih: torch.Tensor,
                    w_hh: torch.Tensor, b: torch.Tensor) -> Carry:
    """(h' [B, H] in the dtype of h, c' [B, H] in the dtype of c) of the
    LSTM cell; the gates and the state update in f32 (f64 for f64 inputs),
    as lstm.py:31-43 computes them."""
    acc = build.acc_dtype(x)
    gates = x.to(acc) @ w_ih.to(acc) + h.to(acc) @ w_hh.to(acc) + b.to(acc)
    i, f, g, o = gates.split(h.shape[-1], dim=-1)
    c_new = torch.sigmoid(f) * c.to(acc) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def lstm_cell_cuda(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_ih: torch.Tensor,
                   w_hh: torch.Tensor, b: torch.Tensor) -> Carry:
    """``lstm_cell_plain`` as one launch of K8; every input in one dtype
    (float32 or bfloat16), and so are h' and c'."""
    global launches
    B, Din = x.shape
    H = h.shape[-1]
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"lstm_cell: dtype must be float32 or bfloat16, got {x.dtype}")
    for arg, t, shape in (("h", h, (B, H)), ("c", c, (B, H)), ("w_ih", w_ih, (Din, 4 * H)),
                          ("w_hh", w_hh, (H, 4 * H)), ("b", b, (4 * H,))):
        if t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(f"lstm_cell: {arg} must be {x.dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if H % TH:
        raise ValueError(f"lstm_cell: hidden size {H} must be a multiple of {TH}")
    if Din % 8:
        raise ValueError(f"lstm_cell: input size {Din} must be a multiple of 8")
    ins = (x, h, c, w_ih, w_hh, b)
    if (any(t.device != x.device for t in ins) or not all(t.is_contiguous() for t in ins)
            or any(t.data_ptr() % 16 for t in ins)):
        raise ValueError("lstm_cell: all inputs must be contiguous, 16-byte aligned and on one "
                         "CUDA device")
    plan = lstm_cell_plan(B, Din, H, x.element_size())
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    fn = build.kernel_function("lstm_cell", "lstm_cell", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in (*ins, h_out, c_out)), B, Din, H, plan.splits,
             plan.boxes, plan.smem, build.DTYPE_CODES[x.dtype], build.stream_handle(x))
    build.check_launch(err, "lstm_cell")
    launches += 1
    return h_out, c_out


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b: torch.Tensor) -> Carry:
    if x.device.type == "cuda":
        return lstm_cell_cuda(x, h, c, w_ih, w_hh, b)
    if x.device.type == "cpu":
        return lstm_cell_plain(x, h, c, w_ih, w_hh, b)
    raise ValueError(f"lstm_cell: no implementation for device {x.device}")
