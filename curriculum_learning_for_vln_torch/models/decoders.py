"""EnvDrop decoder and critic.

The port of the EnvDrop and critic parts of
``curriculum_learning_for_vln_tpu/models/decoders.py`` (ref:
policy.py:173-267), in the fused-observation form the serving and the
training paths run: ``envdrop_visual_query`` gives the query of the
observation op (K4, K5), and ``envdrop_decoder_from_vis`` takes its
output through the action embedding, the LSTM cell, text attention and
the candidate scorer (K6, K7).  At train=True each dropout site
(decoders.py:196-244, 299-302) draws its mask from ``generator``, in the
order the step runs them: the JAX package's fold_in indices 3, 0, 4, 5
(1 and 2 are the observation ops' env-dropout).  The Follower and
Self-Monitor decoders are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .attention import soft_dot, soft_dot_init
from .core import dense, dense_init, dropout, lstm_cell, lstm_cell_init


def envdrop_decoder_init(gen: torch.Generator, hidden_size: int, action_embed_size: int = 64,
                         angle_feat_size: int = 128, feature_size: int = 2048 + 128,
                         device=None) -> dict:
    return {
        "act_embed": dense_init(gen, angle_feat_size, action_embed_size, device=device),
        "lstm": lstm_cell_init(gen, action_embed_size + feature_size, hidden_size, device=device),
        "text_attn": soft_dot_init(gen, hidden_size, device=device),
        "visual_attn": soft_dot_init(gen, hidden_size, context_only=True,
                                     context_dim=feature_size, device=device),
        "cand_attn": dense_init(gen, hidden_size, feature_size, bias=False, device=device),
    }


def envdrop_visual_query(p: dict, h_tilde_prev: torch.Tensor, train: bool = False,
                         drop_rate: float = 0.5,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The visual-attention query tv = W_in . dropout(h_tilde_prev) [B, F]."""
    return dense(p["visual_attn"]["linear_in"], dropout(h_tilde_prev, drop_rate, train, generator))


def envdrop_decoder_from_vis(
    p: dict,
    a_t_angle: torch.Tensor,      # [B, 128]
    visual_feat: torch.Tensor,    # [B, F] attention-weighted panorama
    h_tilde_prev: torch.Tensor,   # [B, H]
    c: torch.Tensor,              # [B, H]
    ctx: torch.Tensor,            # [B, L, H]
    ctx_mask: Optional[torch.Tensor],
    cand_scorer: Callable[[torch.Tensor], torch.Tensor],
    train: bool = False,
    drop_rate: float = 0.5,
    generator: Optional[torch.Generator] = None,
):
    """The decoder step after visual attention: action embedding, LSTM
    (recurrent input h_tilde_prev, ref: policy.py:238), text attention,
    and the candidate logits ``cand_scorer(q)`` of the projected query q.
    Returns (logits [B, MC+1], (h1, c1), h_tilde)."""
    act_emb = dropout(torch.tanh(dense(p["act_embed"], a_t_angle)), drop_rate, train, generator)
    x = torch.cat([act_emb.float(), visual_feat.float()], dim=-1)
    h1, c1 = lstm_cell(p["lstm"], x, h_tilde_prev, c)
    h1_drop = dropout(h1, drop_rate, train, generator)
    h_tilde, _alpha = soft_dot(p["text_attn"], h1_drop, ctx, ctx_mask)
    q = dense(p["cand_attn"], dropout(h_tilde, drop_rate, train, generator))
    return cand_scorer(q), (h1, c1), h_tilde


def critic_init(gen: torch.Generator, hidden_size: int, device=None) -> dict:
    return {
        "fc1": dense_init(gen, hidden_size, hidden_size, device=device),
        "fc2": dense_init(gen, hidden_size, 1, device=device),
    }


def critic_apply(p: dict, state: torch.Tensor, train: bool = False, drop_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    x = dropout(torch.relu(dense(p["fc1"], state)), drop_rate, train, generator)
    return dense(p["fc2"], x)[..., 0]
