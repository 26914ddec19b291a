"""Attention and scoring units.

The port of ``curriculum_learning_for_vln_tpu/models/attention.py`` (ref:
units.py): SoftDotAttention (:77-122), VisualSoftDotAttention (:125-160),
ActionScoring (:163-185), PositionalEncoding (:188-207) and MLPwithBN
(:210-242).  Each unit is an (init, apply) pair over a parameter dict;
the BN running statistics are explicit state, returned by ``mlp_bn``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .core import batchnorm, batchnorm_init, dense, dense_init, dropout

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


# -- VisualSoftDotAttention --------------------------------------------------

def visual_soft_dot_init(gen: torch.Generator, h_dim: int, v_dim: Optional[int] = None,
                         dot_dim: int = 256, device=None) -> dict:
    p = {"linear_in_h": dense_init(gen, h_dim, dot_dim, bias=True, device=device)}
    if v_dim is not None:
        p["linear_in_v"] = dense_init(gen, v_dim, dot_dim, bias=True, device=device)
    return p


def visual_soft_dot(p: dict, h: torch.Tensor, visual_context: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected dot attention over views (ref: units.py:138-160): scores
    of (W_v ctx + b_v) . (W_h h + b_h) (without ``linear_in_v``, of ctx
    itself), the weighted sum over the *unprojected* visual context, all in
    the promoted dtype as jnp computes it (attention.py:78-89)."""
    target = dense(p["linear_in_h"], h)                                   # [B, dot]
    ctx = (dense(p["linear_in_v"], visual_context) if "linear_in_v" in p else visual_context)
    dtype = torch.promote_types(ctx.dtype, target.dtype)
    attn = masked_softmax(torch.einsum("bvd,bd->bv", ctx.to(dtype), target.to(dtype)), mask)
    dtype = torch.promote_types(attn.dtype, visual_context.dtype)
    weighted = torch.einsum("bv,bvd->bd", attn.to(dtype), visual_context.to(dtype))
    return weighted, attn


# -- ActionScoring -----------------------------------------------------------

def action_scoring_init(gen: torch.Generator, action_size: int, hidden_size: int,
                        dot_size: int = 256, device=None) -> dict:
    return {
        "linear_act": dense_init(gen, action_size, dot_size, bias=True, device=device),
        "linear_hid": dense_init(gen, hidden_size, dot_size, bias=True, device=device),
        "linear_out": dense_init(gen, dot_size, 1, bias=True, device=device),
    }


def action_scoring(p: dict, act_cands: torch.Tensor, h_tilde: torch.Tensor) -> torch.Tensor:
    """Bilinear-style candidate scorer (ref: units.py:174-185): act_cands
    [B, K, A], h_tilde [B, H] -> logits [B, K]."""
    target = dense(p["linear_hid"], h_tilde)[:, None, :]     # [B, 1, dot]
    context = dense(p["linear_act"], act_cands)              # [B, K, dot]
    dtype = torch.promote_types(context.dtype, target.dtype)
    return dense(p["linear_out"], context.to(dtype) * target.to(dtype))[..., 0]


# -- PositionalEncoding ------------------------------------------------------

def positional_encoding_table(d_model: int, max_len: int = 80, device=None) -> torch.Tensor:
    """The sinusoid table [max_len, d_model] f32 (sin on even columns, cos
    on odd)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def positional_encoding(pe: torch.Tensor, x: torch.Tensor, train: bool, rate: float = 0.1,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x [B, L, D] + PE, then dropout at ``rate`` (ref: units.py:205-207).
    ``pe`` is a parameter leaf (the JAX tree holds it so), so it is cast
    and trained like any other."""
    dtype = torch.promote_types(x.dtype, pe.dtype)
    y = x.to(dtype) + pe[None, : x.shape[1], :].to(dtype)
    return dropout(y, rate, train, generator)


# -- MLP with BatchNorm ------------------------------------------------------

def mlp_bn_init(gen: torch.Generator, input_size: int, hidden_sizes, out_size: Optional[int] = None,
                use_bn: bool = True, device=None) -> Tuple[dict, dict]:
    """(params, state) of MLPwithBN (ref: units.py:214-238): [BN(in)] ->
    (Linear -> [BN] -> [Dropout] -> ReLU)* -> [Linear(out)]."""
    params = {"layers": []}
    state = {"bns": []}
    if use_bn:
        params["bn_in"], state["bn_in"] = batchnorm_init(input_size, device=device)
    dims = [input_size] + list(hidden_sizes)
    for i in range(len(dims) - 1):
        params["layers"].append(dense_init(gen, dims[i], dims[i + 1], bias=True, device=device))
        if use_bn:
            bp, bs = batchnorm_init(dims[i + 1], device=device)
            state["bns"].append(bs)
            params.setdefault("bn_layers", []).append(bp)
    if out_size is not None:
        params["out"] = dense_init(gen, dims[-1], out_size, bias=True, device=device)
    return params, state


def mlp_bn(params: dict, state: dict, x: torch.Tensor, train: bool, drop_rate: float = 0.5,
           use_bn: bool = True, generator: Optional[torch.Generator] = None):
    """MLPwithBN; returns (y, new_state).  Each layer's dropout draws its
    mask from ``generator`` in layer order (the JAX package's fold_in(rng,
    i))."""
    new_state = {"bns": []}
    if use_bn:
        x, new_state["bn_in"] = batchnorm(params["bn_in"], state["bn_in"], x, train)
    for i, lp in enumerate(params["layers"]):
        x = dense(lp, x)
        if use_bn:
            x, s = batchnorm(params["bn_layers"][i], state["bns"][i], x, train)
            new_state["bns"].append(s)
        if drop_rate > 0:
            x = dropout(x, drop_rate, train, generator)
        x = torch.relu(x)
    if "out" in params:
        x = dense(params["out"], x)
    return x, new_state
