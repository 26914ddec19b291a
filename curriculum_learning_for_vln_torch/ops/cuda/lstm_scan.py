"""K3, K1 and K2: the masked LSTM scan — inference forward, training
forward and backward; CUDA kernels and plain twins.

K3 replaces ``curriculum_learning_for_vln_tpu/ops/pallas/lstm_scan.py::
lstm_scan_pallas``, K1 its ``lstm_scan_train_pallas``, K2 its
``lstm_scan_bwd_pallas``.  Kernel: ``csrc/lstm_scan.cu`` — the forward is
one C call of two launches (a tiled GEMM for x . W_ih + b over the valid
steps, then the recurrence on clusters of 8 blocks that keep W_hh in
shared memory and trade h through distributed shared memory); K1 also
writes the pre-step carries and keeps the gate pre-activations as
residuals.  K2 is one C call of four launches: the reverse-time
recurrence on the same cluster layout, then GEMMs for d_xs, dW_ih and
dW_hh and the bias sum, in a fixed order (no atomics).  All three are
bound by their serial chain of steps, not by bytes or FLOPs (the source
says more).

``lstm_scan``, ``lstm_scan_train`` and ``lstm_scan_bwd`` dispatch by
device: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel; there is no fallback between them.  ``launches`` counts K3
calls, ``train_launches`` K1 calls, ``bwd_launches`` K2 calls (each call
counts once, whatever its number of launches).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

launches = 0
train_launches = 0
bwd_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TRAIN_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

Carry = Tuple[torch.Tensor, torch.Tensor]


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
    return B, L, D, H


def _forward_cuda(name, symbol, argtypes, xs, lengths, w_ih, w_hh, b, reverse, train):
    B, L, D, H = _check(name, xs, lengths, w_ih, w_hh, (("b", b, (4 * w_hh.shape[0],), xs.dtype),))
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
    """``lstm_scan_bwd_plain`` as one call of K2 (four launches)."""
    global bwd_launches
    B, L, D = xs.shape
    H = w_hh.shape[0]
    f32 = torch.float32
    B, L, D, H = _check("lstm_scan_bwd", xs, lengths, w_ih, w_hh, (
        ("gates", gates, (B, L, 4 * H), f32), ("hprev", hprev, (L, B, H), f32),
        ("cprev", cprev, (L, B, H), f32), ("d_out", d_out, (B, L, H), f32),
        ("dhT", dhT, (B, H), f32), ("dcT", dcT, (B, H), f32)))
    dev = dict(dtype=f32, device=xs.device)
    da = torch.empty((B, L, 4 * H), **dev)
    db_part = torch.empty(((B + 7) // 8, 4 * H), **dev)
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
