"""Navigation policy decoders: Follower, Self-Monitor, EnvDrop, critic.

The port of ``curriculum_learning_for_vln_tpu/models/decoders.py`` (ref:
policy.py), each decoder a single step over explicit parameters, carries
and BN statistics:

* Follower (AttnDecoderLSTM, :15-60): ``follower_visual_query`` gives the
  query of the observation op (K4, K5) that reparameterises the projected
  visual attention, ``follower_decoder_from_vis`` takes its output through
  the LSTM cell, text attention and ActionScoring; ``follower_decoder_step``
  is the same step on a gathered panorama (the reference's shape).
* Self-Monitor (MonitorDecoder, :67-166): ``monitor_decoder_step``, the
  BN-MLP candidate projection, positional text attention, candidate
  visual attention, the LSTM cell, the policy logits and the progress
  monitor.
* EnvDrop (:173-246), in the fused-observation form the serving and the
  training paths run: ``envdrop_visual_query`` gives the query of the
  observation op, and ``envdrop_decoder_from_vis`` takes its output
  through the action embedding, the LSTM cell, text attention and the
  candidate scorer (K6, K7); ``envdrop_decoder_step`` (JAX
  decoders.py:255-288) is the unfused step over gathered features that
  back-translation runs, with ``drop_feat_img``; and the critic
  (:249-267).

At train=True each dropout site draws its mask from ``generator``, in the
order the step runs them: the JAX package's fold_in indices in ascending
order (EnvDrop: 3, 0, 4, 5, with 1 and 2 the observation ops'
env-dropout, which the unfused step draws first; Follower: 0, 1;
Self-Monitor: 0 and 1 the BN-MLP's layers in order, 2 the positional
encoding, 3, 4).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .attention import (action_scoring, action_scoring_init, mlp_bn, mlp_bn_init,
                        positional_encoding, positional_encoding_table, soft_dot, soft_dot_init,
                        visual_soft_dot, visual_soft_dot_init)
from .core import dense, dense_init, dropout, lstm_cell, lstm_cell_init


# ---------------------------------------------------------------------------
# Follower (Speaker-Follower, Fried et al. 2018)
# ---------------------------------------------------------------------------

def follower_decoder_init(gen: torch.Generator, hidden_size: int, action_embed_size: int,
                          feature_size: int, device=None) -> dict:
    return {
        "lstm": lstm_cell_init(gen, action_embed_size + feature_size, hidden_size, device=device),
        "text_attn": soft_dot_init(gen, hidden_size, device=device),
        "visual_attn": visual_soft_dot_init(gen, hidden_size, feature_size, device=device),
        "decode_action": action_scoring_init(gen, action_embed_size, hidden_size, device=device),
    }


def follower_visual_query(p: dict, h: torch.Tensor) -> torch.Tensor:
    """The reparameterised visual-attention query of the observation op:
    scores (pano W_v + b_v) . (W_h h + b_h) equal pano . (W_v (W_h h +
    b_h)) up to a per-sample constant (b_v's term), which the softmax
    ignores, so b_v rightly gets a zero gradient (decoders.py:75-83).
    Returns tv [B, F] in the promoted dtype."""
    t = dense(p["visual_attn"]["linear_in_h"], h)                        # [B, dot]
    w = p["visual_attn"]["linear_in_v"]["w"]
    dtype = torch.promote_types(t.dtype, w.dtype)
    return t.to(dtype) @ w.to(dtype).t()


def follower_decoder_from_vis(p: dict, weighted_v: torch.Tensor, a_prev: torch.Tensor,
                              cand_feat: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                              ctx: torch.Tensor, ctx_mask: Optional[torch.Tensor], train: bool,
                              drop_rate: float = 0.5,
                              generator: Optional[torch.Generator] = None):
    """The Follower step after visual attention (decoders.py:48-72):
    dropout of [a_prev; weighted_v], the LSTM cell, dropout of h1, text
    attention and ActionScoring over cand_feat [B, K, A].  Returns (logits
    [B, K], (h1, c1), text attention weights)."""
    dtype = torch.promote_types(a_prev.dtype, weighted_v.dtype)
    visual_ctx = dropout(torch.cat([a_prev.to(dtype), weighted_v.to(dtype)], dim=-1), drop_rate,
                         train, generator, batch_dim=0)
    h1, c1 = lstm_cell(p["lstm"], visual_ctx, h, c)
    h1_drop = dropout(h1, drop_rate, train, generator, batch_dim=0)
    h_tilde, alpha_c = soft_dot(p["text_attn"], h1_drop, ctx, ctx_mask)
    logits = action_scoring(p["decode_action"], cand_feat, h_tilde)
    return logits, (h1, c1), alpha_c


def follower_decoder_step(p: dict, pano_feat: torch.Tensor, a_prev: torch.Tensor,
                          cand_feat: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                          ctx: torch.Tensor, ctx_mask: Optional[torch.Tensor], train: bool,
                          drop_rate: float = 0.5, generator: Optional[torch.Generator] = None):
    """The reference-shaped step over a gathered panorama pano_feat [B, 36,
    F] (decoders.py:86-102): visual attention, then the shared rest."""
    weighted_v, alpha_v = visual_soft_dot(p["visual_attn"], h, pano_feat)
    logits, (h1, c1), alpha_c = follower_decoder_from_vis(
        p, weighted_v, a_prev, cand_feat, h, c, ctx, ctx_mask, train, drop_rate, generator)
    return logits, (h1, c1), (alpha_c, alpha_v)


# ---------------------------------------------------------------------------
# Self-Monitoring (Ma et al. 2019)
# ---------------------------------------------------------------------------

def monitor_decoder_init(gen: torch.Generator, rnn_hidden_size: int, max_enc_len: int,
                         mlp_dims=(128, 1024), action_embed_size: int = 2048 + 128,
                         device=None) -> Tuple[dict, dict]:
    """(params, {"mlp": BN state}) of the MonitorDecoder (decoders.py:
    109-131); ``pe`` is a parameter leaf, as in the JAX tree."""
    img_hidden = mlp_dims[-1]
    mlp_p, mlp_s = mlp_bn_init(gen, action_embed_size, list(mlp_dims), device=device)
    params = {
        "proj_navigable_mlp": mlp_p,
        "pe": positional_encoding_table(rnn_hidden_size, max_enc_len, device=device),
        "text_attn": soft_dot_init(gen, rnn_hidden_size, context_only=True, device=device),
        "visual_attn": visual_soft_dot_init(gen, rnn_hidden_size, None, img_hidden,
                                            device=device),
        "lstm": lstm_cell_init(gen, img_hidden * 2 + rnn_hidden_size, rnn_hidden_size,
                               device=device),
        "action_linear": dense_init(gen, rnn_hidden_size * 2, img_hidden, device=device),
        "monitor_linear": dense_init(gen, rnn_hidden_size + img_hidden, rnn_hidden_size,
                                     device=device),
        "critic": dense_init(gen, max_enc_len + rnn_hidden_size, 1, device=device),
    }
    return params, {"mlp": mlp_s}


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    """jnp.concatenate's promotion: the parts in their common dtype."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.cat([x.to(dtype) for x in xs], dim=-1)


def monitor_decoder_step(p: dict, bn_state: dict, a_prev: torch.Tensor, cand_feat: torch.Tensor,
                         cand_mask: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                         ctx: torch.Tensor, ctx_mask: Optional[torch.Tensor], train: bool,
                         drop_rate: float = 0.5, generator: Optional[torch.Generator] = None):
    """One MonitorDecoder step (decoders.py:134-171).  The shared BN-MLP
    runs on a_prev [B, A], then on the [B K, A] candidate rows (padding
    rows included), its running statistics threaded in that order
    (policy.py:144-149); ctx [B, L, H] with L = max_enc_len.  Returns
    ((logits [B, K], progress [B]), (h1, c1), {"mlp": new BN state},
    (ctx_attn, cands_attn)).  The progress head gates on the *previous* h
    and the new c."""
    B, K, A = cand_feat.shape
    proj_prev, bn1 = mlp_bn(p["proj_navigable_mlp"], bn_state["mlp"], a_prev, train,
                            generator=generator)
    proj_cands, bn2 = mlp_bn(p["proj_navigable_mlp"], bn1, cand_feat.reshape(B * K, A), train,
                             generator=generator)
    proj_cands = proj_cands.reshape(B, K, -1)
    proj_cands = proj_cands * (1.0 - cand_mask.to(proj_cands.dtype))[:, :, None]

    pos_ctx = positional_encoding(p["pe"], ctx, train, generator=generator)
    weighted_ctx, ctx_attn = soft_dot(p["text_attn"], h, pos_ctx, ctx_mask)
    weighted_cands, cands_attn = visual_soft_dot(p["visual_attn"], h, proj_cands, cand_mask)

    h1, c1 = lstm_cell(p["lstm"], _cat(proj_prev, weighted_cands, weighted_ctx), h, c)

    # policy net (ref: policy.py:108-117)
    h1_drop = dropout(h1, drop_rate, train, generator, batch_dim=0)
    h_tilde = dense(p["action_linear"], _cat(weighted_ctx, h1_drop))
    dtype = torch.promote_types(proj_cands.dtype, h_tilde.dtype)
    logits = torch.einsum("bkd,bd->bk", proj_cands.to(dtype), h_tilde.to(dtype))

    # progress monitor (ref: policy.py:119-130): gate on the previous h, new c
    concat_pm = dense(p["monitor_linear"], _cat(h, weighted_cands))
    h_pm = dropout(torch.sigmoid(concat_pm) * torch.tanh(c1), drop_rate, train, generator,
                   batch_dim=0)
    progress = torch.tanh(dense(p["critic"], _cat(ctx_attn, h_pm)))[:, 0]
    return (logits, progress), (h1, c1), {"mlp": bn2}, (ctx_attn, cands_attn)


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
    return dense(p["visual_attn"]["linear_in"],
                 dropout(h_tilde_prev, drop_rate, train, generator, batch_dim=0))


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
    act_emb = dropout(torch.tanh(dense(p["act_embed"], a_t_angle)), drop_rate, train, generator,
                      batch_dim=0)
    x = torch.cat([act_emb.float(), visual_feat.float()], dim=-1)
    h1, c1 = lstm_cell(p["lstm"], x, h_tilde_prev, c)
    h1_drop = dropout(h1, drop_rate, train, generator, batch_dim=0)
    h_tilde, _alpha = soft_dot(p["text_attn"], h1_drop, ctx, ctx_mask)
    q = dense(p["cand_attn"], dropout(h_tilde, drop_rate, train, generator, batch_dim=0))
    return cand_scorer(q), (h1, c1), h_tilde


def drop_feat_img(feat: torch.Tensor, rate: float, train: bool, angle_feat_size: int = 128,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Environmental dropout on the image dims only (decoders.py:247-252,
    ref: policy.py:226-232)."""
    img, ang = feat[..., :-angle_feat_size], feat[..., -angle_feat_size:]
    return torch.cat([dropout(img, rate, train, generator, batch_dim=0), ang], dim=-1)


def envdrop_decoder_step(
    p: dict,
    a_t_angle: torch.Tensor,      # [B, 128]
    pano_feat: torch.Tensor,      # [B, 36, F]
    cand_feat: torch.Tensor,      # [B, MC+1, F]
    h_tilde_prev: torch.Tensor,   # [B, H]
    c: torch.Tensor,              # [B, H]
    ctx: torch.Tensor,            # [B, L, H]
    ctx_mask: Optional[torch.Tensor],
    train: bool = False,
    drop_rate: float = 0.5,
    feat_drop_rate: float = 0.3,
    angle_feat_size: int = 128,
    already_dropfeat: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """EnvDrop's unfused step over gathered features (decoders.py:255-288),
    the one back-translation runs (its shared noise already applied:
    ``already_dropfeat``): env-dropout of the panorama's and the
    candidates' image dims unless already applied, visual attention of
    dropout(h_tilde_prev) over the panorama in the panorama's dtype, then
    ``envdrop_decoder_from_vis`` with the candidate logits cand_feat . q in
    the promoted dtype.  Returns what ``envdrop_decoder_from_vis`` returns."""
    if not already_dropfeat:
        pano_feat = drop_feat_img(pano_feat, feat_drop_rate, train, angle_feat_size, generator)
        cand_feat = drop_feat_img(cand_feat, feat_drop_rate, train, angle_feat_size, generator)
    prev_drop = dropout(h_tilde_prev, drop_rate, train, generator, batch_dim=0)
    visual_feat, _alpha = soft_dot(p["visual_attn"], prev_drop, pano_feat)

    def scorer(q):
        dtype = torch.promote_types(cand_feat.dtype, q.dtype)
        return torch.einsum("bkf,bf->bk", cand_feat.to(dtype), q.to(dtype))

    return envdrop_decoder_from_vis(p, a_t_angle, visual_feat, h_tilde_prev, c, ctx, ctx_mask,
                                    scorer, train, drop_rate, generator)


def critic_init(gen: torch.Generator, hidden_size: int, device=None) -> dict:
    return {
        "fc1": dense_init(gen, hidden_size, hidden_size, device=device),
        "fc2": dense_init(gen, hidden_size, 1, device=device),
    }


def critic_apply(p: dict, state: torch.Tensor, train: bool = False, drop_rate: float = 0.5,
                 generator: Optional[torch.Generator] = None, batch_dim: int = 0) -> torch.Tensor:
    """The critic's value of ``state`` [..., H]; ``batch_dim`` is its batch
    axis (1 for the [T, B, H] stack of a rollout's steps)."""
    x = dropout(torch.relu(dense(p["fc1"], state)), drop_rate, train, generator, batch_dim)
    return dense(p["fc2"], x)[..., 0]
