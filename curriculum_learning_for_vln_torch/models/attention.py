"""Attention units: masked softmax and SoftDotAttention.

The port of the parts of ``curriculum_learning_for_vln_tpu/models/
attention.py`` that EnvDrop serving needs (ref: units.py:77-122).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .core import dense, dense_init

NEG_INF = -1e30  # large-finite stand-in for -inf under masked softmax


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1
                   ) -> torch.Tensor:
    """Softmax with a boolean mask (True = suppress), the reference's
    masked_fill(-inf) + softmax."""
    if mask is not None:
        logits = torch.where(mask, NEG_INF, logits)
    return torch.softmax(logits, dim=dim)


def soft_dot_init(gen: torch.Generator, query_dim: int, context_only: bool = False,
                  context_dim: Optional[int] = None, device=None) -> dict:
    ctx_dim = query_dim if context_dim is None else context_dim
    p = {"linear_in": dense_init(gen, query_dim, ctx_dim, bias=False, device=device)}
    if not context_only:
        p["linear_out"] = dense_init(gen, query_dim + ctx_dim, query_dim, bias=False,
                                     device=device)
    return p


def soft_dot(p: dict, h: torch.Tensor, context: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """General dot attention. h: [B, Q]; context: [B, L, C]; mask True=drop.

    Returns (h_tilde or weighted_context, attn): with a "linear_out" param
    the output is tanh(W [weighted; h]) (ref: units.py:120-122), else the
    raw weighted context.  Both context contractions run in the CONTEXT's
    dtype and the softmax in f32 — the JAX package's dtype contract
    (attention.py:51-62), which keeps a bf16 context from being promoted
    to an f32 copy by the f32 query."""
    target = dense(p["linear_in"], h).to(context.dtype)          # [B, C]
    attn = torch.einsum("blc,bc->bl", context, target)
    attn = masked_softmax(attn.float(), mask)
    weighted = torch.einsum("bl,blc->bc", attn.to(context.dtype), context)
    if "linear_out" not in p:
        return weighted, attn
    dtype = torch.promote_types(weighted.dtype, h.dtype)
    h_tilde = torch.tanh(dense(p["linear_out"], torch.cat([weighted.to(dtype), h.to(dtype)], -1)))
    return h_tilde, attn
