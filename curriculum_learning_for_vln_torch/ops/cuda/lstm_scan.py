"""K3: masked LSTM scan (inference forward), CUDA kernel and plain twin.

Replaces ``curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
lstm_scan_pallas``.  Kernel: ``csrc/lstm_scan.cu`` — one C call, two
launches: a tiled GEMM for x . W_ih + b over the valid steps, then the
recurrence on clusters of 8 blocks that keep W_hh in shared memory and
trade h through distributed shared memory.  It is bound by its serial
chain of steps, not by bytes or FLOPs (the source says more).

``lstm_scan`` dispatches by device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel; there is no fallback between them.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def lstm_scan_plain(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                    w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Masked LSTM over xs [B, L, D] (gate order i, f, g, o; f32 state and
    accumulation).  Step l reads t = L-1-l when ``reverse``; rows with
    t >= lengths[b] keep their carry and output 0.  Returns
    (outs [B, L, H] f32, (hT, cT) [B, H] f32)."""
    B, L, _ = xs.shape
    H = w_hh.shape[0]
    wih, whh, bias = w_ih.float(), w_hh.float(), b.float()
    h = xs.new_zeros((B, H), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = xs.new_zeros((B, L, H), dtype=torch.float32)
    for l in range(L):
        t = L - 1 - l if reverse else l
        gates = xs[:, t].float() @ wih + h @ whh + bias
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        valid = (t < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[:, t] = torch.where(valid, h_new, 0.0)
    return outs, (h, c)


def lstm_scan_cuda(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                   w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``lstm_scan_plain`` as one call of the CUDA kernel (its two
    launches count as one)."""
    global launches
    B, L, D = xs.shape
    H = w_hh.shape[0]
    dtype = xs.dtype
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"lstm_scan: xs dtype must be float32 or bfloat16, got {dtype}")
    for name, t, shape in (("w_ih", w_ih, (D, 4 * H)), ("w_hh", w_hh, (H, 4 * H)),
                           ("b", b, (4 * H,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"lstm_scan: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if lengths.dtype != torch.int64 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lstm_scan: lengths must be int64 [{B}]")
    if H % 32 or not 32 <= H <= 256:
        raise ValueError(f"lstm_scan: hidden size {H} must be a multiple of 32 up to 256 "
                         "(an eighth of W_hh per block's shared memory)")
    ins = (xs, lengths, w_ih, w_hh, b)
    if any(t.device != xs.device for t in ins) or not all(t.is_contiguous() for t in ins):
        raise ValueError("lstm_scan: all inputs must be contiguous and on one CUDA device")
    gx = torch.empty((B, L, 4 * H), dtype=torch.float32, device=xs.device)  # x . W_ih + b
    outs = torch.empty((B, L, H), dtype=torch.float32, device=xs.device)
    hT = torch.empty((B, H), dtype=torch.float32, device=xs.device)
    cT = torch.empty_like(hT)
    fn = build.kernel_function("lstm_scan", _ARGTYPES)
    err = fn(xs.data_ptr(), lengths.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
             gx.data_ptr(), outs.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, L, D, H, int(reverse),
             build.DTYPE_CODES[dtype], build.stream_handle(xs))
    build.check_launch(err, "lstm_scan")
    launches += 1
    return outs, (hT, cT)


def lstm_scan(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
              w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    if xs.device.type == "cuda":
        return lstm_scan_cuda(xs, lengths, w_ih, w_hh, b, reverse)
    if xs.device.type == "cpu":
        return lstm_scan_plain(xs, lengths, w_ih, w_hh, b, reverse)
    raise ValueError(f"lstm_scan: no implementation for device {xs.device}")
