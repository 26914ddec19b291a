"""RNN compute ops.

The port of ``curriculum_learning_for_vln_tpu/ops/rnn.py``.  ``lstm_cell``
(one step) stays plain torch, as the JAX package keeps it plain XLA even
under its Pallas backend (rnn.py:59-67).  ``masked_lstm`` (a whole
packed-semantics sequence) runs the LSTM scan kernels
(ops/cuda/lstm_scan.py) on the card and their plain twins on the CPU:

* with autograd recording (grad mode on and an input that requires grad)
  it is ``MaskedLSTM``, a ``torch.autograd.Function`` with the residual
  contract of rnn.py:99-136 — forward K1 (which saves the pre-step
  carries and the gate pre-activations), backward K2, weight gradients
  cast to the weights' dtype and d_xs in the dtype of xs;
* otherwise (``torch.no_grad()``, or nothing to differentiate) it is the
  inference forward K3.

The JAX package's VMEM gate (``_fused_fits``) is a TPU budget and is not
carried over.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import lstm_scan as _lstm_scan


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


def masked_lstm(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Packed-sequence LSTM over xs [B, L, D]; see models.core.masked_lstm.
    Returns (outs [B, L, H], (hT, cT) [B, H]), all f32."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, w_ih, w_hh, b)):
        outs, hT, cT = MaskedLSTM.apply(xs, lengths, w_ih, w_hh, b, reverse)
        return outs, (hT, cT)
    return _lstm_scan.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
