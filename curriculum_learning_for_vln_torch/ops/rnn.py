"""RNN compute ops.

The port of ``curriculum_learning_for_vln_tpu/ops/rnn.py``.  ``lstm_cell``
(one step) stays plain torch, as the JAX package keeps it plain XLA even
under its Pallas backend (rnn.py:59-67).  ``masked_lstm`` (a whole
packed-semantics sequence) is kernel K3 (ops/cuda/lstm_scan.py): its
CUDA kernel for tensors on the card, its plain twin on the CPU.  The JAX
package's VMEM gate (``_fused_fits``) is a TPU budget and is not carried
over.
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


def masked_lstm(xs: torch.Tensor, lengths: torch.Tensor, w_ih: torch.Tensor,
                w_hh: torch.Tensor, b: torch.Tensor, reverse: bool = False):
    """Packed-sequence LSTM over xs [B, L, D]; see models.core.masked_lstm."""
    return _lstm_scan.lstm_scan(xs, lengths, w_ih, w_hh, b, reverse=reverse)
