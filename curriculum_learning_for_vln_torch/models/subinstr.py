"""Sub-instruction-aware decoder family (a latent capability path).

The port of ``curriculum_learning_for_vln_tpu/models/subinstr.py``: the
reference's sub-instruction modules, which it ships unused (its agent
factory has them commented out, tasks/R2R-judy/src/agent/__init__.py:
32-42): SoftDotBlockAttention (src/model/units.py:245-283),
SubMonitorDecoder (src/model/policy.py:274-358) and InstrShifting
(policy.py:361-392).  The reference's per-sample loop over instruction
blocks is a masked softmax over each sample's block range.

Functions over parameter dicts of tensors, as ``models/attention.py``.
At train=True each dropout site draws its mask from ``generator``
(``ops/draws.py``), in the order the step runs them: the JAX package's
fold_in indices in ascending order (the decoder: 0 and 1 the BN-MLP's
rows of a_prev and of the candidates, 2 the positional encoding, 3 h1;
the shifting head: 0, 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import (NEG_INF, mlp_bn, mlp_bn_init, positional_encoding,
                        positional_encoding_table, visual_soft_dot, visual_soft_dot_init)
from .core import dense, dense_init, dropout, lstm_cell, lstm_cell_init
from .decoders import _cat


def soft_dot_block_attention_init(gen: torch.Generator, dim: int, device=None) -> dict:
    return {"linear_in": dense_init(gen, dim, dim, bias=False, device=device)}


def soft_dot_block_attention(p: dict, h: torch.Tensor, context: torch.Tensor,
                             sub_seq_lengths: torch.Tensor, selected_block_idx: torch.Tensor,
                             mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention within the selected sub-instruction block only (ref:
    units.py:254-283).  h [B, D], context [B, L, D], sub_seq_lengths
    [B, S] (each block's length), selected_block_idx [B], mask [B, L]
    (True = masked).  Block k spans positions [1 + sum(len[:k]),
    1 + sum(len[:k]) + len[k]): the +1 skips <BOS>.  Returns (the weighted
    context [B, D], the raw masked scores [B, L])."""
    B, L, _ = context.shape
    target = dense(p["linear_in"], h)
    dtype = torch.promote_types(context.dtype, target.dtype)
    attn = torch.einsum("bld,bd->bl", context.to(dtype), target.to(dtype))
    if mask is not None:
        attn = torch.where(mask, NEG_INF, attn)
    cum = torch.cumsum(sub_seq_lengths, dim=1)
    starts = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1) + 1
    sel = selected_block_idx[:, None].long()
    start = starts.gather(1, sel)
    length = sub_seq_lengths.gather(1, sel)
    pos = torch.arange(L, device=context.device)[None, :]
    in_block = (pos >= start) & (pos < start + length)
    block_attn = torch.softmax(torch.where(in_block, attn, NEG_INF), dim=1)
    block_attn = torch.where(in_block, block_attn, 0.0)    # exact zeros outside the block
    weighted = torch.einsum("bl,bld->bd", block_attn, context.to(dtype))
    return weighted, attn


def sub_monitor_decoder_init(gen: torch.Generator, rnn_hidden_size: int, max_enc_len: int,
                             mlp_dims=(128, 1024), action_embed_size: int = 2048 + 128,
                             device=None) -> Tuple[dict, dict]:
    """(params, {"mlp": BN state}) of the SubMonitorDecoder (subinstr.py:
    57-70)."""
    img_hidden = mlp_dims[-1]
    mlp_p, mlp_s = mlp_bn_init(gen, action_embed_size, list(mlp_dims), device=device)
    params = {
        "proj_navigable_mlp": mlp_p,
        "pe": positional_encoding_table(rnn_hidden_size, max_enc_len, device=device),
        "text_attn": soft_dot_block_attention_init(gen, rnn_hidden_size, device=device),
        "visual_attn": visual_soft_dot_init(gen, rnn_hidden_size, None, img_hidden,
                                            device=device),
        "lstm": lstm_cell_init(gen, img_hidden * 2 + rnn_hidden_size, rnn_hidden_size,
                               device=device),
        "action_linear": dense_init(gen, rnn_hidden_size * 2, img_hidden, device=device),
    }
    return params, {"mlp": mlp_s}


def sub_monitor_decoder_step(p: dict, bn_state: dict, a_prev: torch.Tensor,
                             cand_feat: torch.Tensor, cand_mask: torch.Tensor, h: torch.Tensor,
                             c: torch.Tensor, ctx: torch.Tensor, sub_seq_lengths: torch.Tensor,
                             selected_block_idx: torch.Tensor, ctx_mask: Optional[torch.Tensor],
                             train: bool, drop_rate: float = 0.5,
                             generator: Optional[torch.Generator] = None):
    """One SubMonitorDecoder step (ref: policy.py:320-358; subinstr.py:
    73-101): the Self-Monitor's step with text attention restricted to the
    selected sub-instruction block and no progress head.  Returns
    ((logits [B, K], weighted_ctx [B, H]), (h1, c1), {"mlp": new BN
    state}, (ctx_attn, cands_attn))."""
    B, K, A = cand_feat.shape
    proj_prev, bn1 = mlp_bn(p["proj_navigable_mlp"], bn_state["mlp"], a_prev, train,
                            generator=generator)
    proj_cands, bn2 = mlp_bn(p["proj_navigable_mlp"], bn1, cand_feat.reshape(B * K, A), train,
                             generator=generator)
    proj_cands = proj_cands.reshape(B, K, -1)
    proj_cands = proj_cands * (1.0 - cand_mask.to(proj_cands.dtype))[:, :, None]

    pos_ctx = positional_encoding(p["pe"], ctx, train, generator=generator)
    weighted_ctx, ctx_attn = soft_dot_block_attention(
        p["text_attn"], h, pos_ctx, sub_seq_lengths, selected_block_idx, ctx_mask)
    weighted_cands, cands_attn = visual_soft_dot(p["visual_attn"], h, proj_cands, cand_mask)

    h1, c1 = lstm_cell(p["lstm"], _cat(proj_prev, weighted_cands, weighted_ctx), h, c)
    h1_drop = dropout(h1, drop_rate, train, generator, batch_dim=0)
    h_tilde = dense(p["action_linear"], _cat(weighted_ctx, h1_drop))
    dtype = torch.promote_types(proj_cands.dtype, h_tilde.dtype)
    logits = torch.einsum("bkd,bd->bk", proj_cands.to(dtype), h_tilde.to(dtype))
    return (logits, weighted_ctx), (h1, c1), {"mlp": bn2}, (ctx_attn, cands_attn)


def instr_shifting_init(gen: torch.Generator, rnn_hidden_size: int, shift_hidden_size: int,
                        action_emb_size: int, max_subinstr_size: int, device=None) -> dict:
    return {
        "linear0": dense_init(gen, rnn_hidden_size, shift_hidden_size, bias=False,
                              device=device),
        "linear1": dense_init(gen, rnn_hidden_size + shift_hidden_size + action_emb_size,
                              shift_hidden_size, bias=False, device=device),
        "linear2": dense_init(gen, max_subinstr_size, shift_hidden_size, bias=False,
                              device=device),
        "linear3": dense_init(gen, 2 * shift_hidden_size, 1, bias=False, device=device),
    }


def instr_shifting_apply(p: dict, h_t: torch.Tensor, m_t: torch.Tensor, a_t_cur: torch.Tensor,
                         weighted_ctx: torch.Tensor, e_t: torch.Tensor, train: bool,
                         drop_rate: float = 0.5,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The shift probability [B]: is the current sub-instruction about to
    complete? (ref: policy.py:376-392).  The gate sigmoid(W1 ...) *
    tanh(m_t) needs shift_hidden_size == rnn_hidden_size, as the
    reference's does (policy.py:386)."""
    proj_h = dense(p["linear0"], dropout(h_t, drop_rate, train, generator, batch_dim=0))
    h_t_c = torch.sigmoid(dense(p["linear1"], _cat(proj_h, a_t_cur, weighted_ctx))) \
        * torch.tanh(m_t)
    proj_e = dense(p["linear2"], e_t)
    h_t_c = dropout(h_t_c, drop_rate, train, generator, batch_dim=0)
    return torch.sigmoid(dense(p["linear3"], _cat(proj_e, h_t_c)))[..., 0]
