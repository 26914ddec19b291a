"""RNN compute ops.

The port of ``curriculum_learning_for_vln_tpu/ops/rnn.py``.  ``lstm_cell``
(one step) stays plain torch, as the JAX package keeps it plain XLA even
under its Pallas backend (rnn.py:59-67).  ``masked_lstm`` (a whole
packed-semantics sequence) follows the process-wide backend
(``set_backend``, rnn.py:20-30; ``engine.loop.configure_runtime`` sets it
from TPU.USE_PALLAS).  Under "cuda", the default, it runs the LSTM scan
kernels (ops/cuda/lstm_scan.py) on the card and their plain twins on the
CPU:

* with autograd recording (grad mode on and an input that requires grad)
  it is ``MaskedLSTM``, a ``torch.autograd.Function`` with the residual
  contract of rnn.py:99-136 — forward K1 (which saves the pre-step
  carries and the gate pre-activations), backward K2, weight gradients
  cast to the weights' dtype and d_xs in the dtype of xs;
* otherwise (``torch.no_grad()``, or nothing to differentiate) it is the
  inference forward K3.

Under "plain" it is ``masked_lstm_plain``, the counterpart of JAX's
``masked_lstm_xla`` (rnn.py:72-97): a step loop of ``lstm_cell`` with f32
state, differentiated by autograd; no kernel launches.  The JAX package's
VMEM gate (``_fused_fits``) is a TPU budget and is not carried over.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import lstm_scan as _lstm_scan

BACKENDS = ("cuda", "plain")
_BACKEND = "cuda"


def set_backend(name: str) -> None:
    """"cuda" (K1-K3 on a CUDA tensor, their plain twins on a CPU one) or
    "plain" (the autograd step loop everywhere)."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"rnn backend {name!r} is none of {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM cell, torch gate order (i, f, g, o).

    Gates accumulate in f32 whatever the operand dtype, so bf16 compute
    weights never put the recurrent state on a bf16 path (operands are
    widened to f32, as jnp promotion does in the JAX package)."""
    gates = x.float() @ w_ih.float() + h.float() @ w_hh.float() + b.float()
    i, f, g, o = gates.split(h.shape[-1], dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


class MaskedLSTM(torch.autograd.Function):
    """(outs, hT, cT) of the masked LSTM scan, differentiable in xs and the
    weights: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, xs, lengths, w_ih, w_hh, b, reverse):
        outs, (hT, cT), hprev, cprev, gates = _lstm_scan.lstm_scan_train(
            xs, lengths, w_ih, w_hh, b, reverse=reverse)
        ctx.save_for_backward(xs, lengths, w_ih, w_hh, hprev, cprev, gates)
        ctx.reverse = reverse
        ctx.b_dtype = b.dtype
        return outs, hT, cT

    @staticmethod
    def backward(ctx, d_out, dhT, dcT):
        xs, lengths, w_ih, w_hh, hprev, cprev, gates = ctx.saved_tensors
        d_xs, d_wih, d_whh, d_b = _lstm_scan.lstm_scan_bwd(
            xs, lengths, w_ih, w_hh, gates, hprev, cprev, d_out.contiguous(),
            dhT.contiguous(), dcT.contiguous(), reverse=ctx.reverse)
        return (d_xs, None, d_wih.to(w_ih.dtype), d_whh.to(w_hh.dtype), d_b.to(ctx.b_dtype),
                None)


def masked_lstm_plain(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                      w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """The masked LSTM as a loop of ``lstm_cell`` over the L steps (in
    reverse order with ``reverse``), from a zero f32 state: a step past a
    row's length keeps its state and outputs zeros (rnn.py:72-97)."""
    B, L, _ = xs.shape
    H = w_hh.shape[0]
    h = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    outs = [None] * L
    for t in range(L):
        idx = L - 1 - t if reverse else t
        h_new, c_new = lstm_cell(xs[:, idx], h, c, w_ih, w_hh, b)
        valid = (idx < lengths)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs[idx] = torch.where(valid, h_new, 0.0)
    return torch.stack(outs, dim=1), (h, c)


def masked_lstm(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Packed-sequence LSTM over xs [B, L, D]; see models.core.masked_lstm.
    Returns (outs [B, L, H], (hT, cT) [B, H]), all f32."""
    if _BACKEND == "plain":
        return masked_lstm_plain(xs, lengths, w_ih, w_hh, b, reverse=reverse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, w_ih, w_hh, b)):
        outs, hT, cT = MaskedLSTM.apply(xs, lengths, w_ih, w_hh, b, reverse)
        return outs, (hT, cT)
    return _lstm_scan.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
