"""Speaker encoder and decoder.

The port of ``curriculum_learning_for_vln_tpu/models/speaker_model.py``
(ref: units.py:286-390, from airsplay/R2R-EnvDrop):

* the encoder: feature dropout on the image dims -> a bidirectional LSTM
  over the chosen candidates' features at full length (the reference's
  LSTM is not packed: padded steps are processed, units.py:311-341) ->
  attention of each step over its 36 views -> a bidirectional post-LSTM;
* the decoder: word embedding -> an LSTM resumed from (h0, c0) ->
  attention over the encoder's context -> the vocabulary projection.

With a zero initial state an LSTM goes through ``models.core.masked_lstm``
with full lengths, forward and ``reverse=True``: kernel K3 under
``torch.no_grad()``, K1 and K2 (``ops.rnn.MaskedLSTM``) under autograd.
The encoder's first layer runs them at D = the feature size (2176 at
2048-d features), its post-LSTM at D = 2H.  The decoder, which resumes
from a state, stays a plain ``lstm_cell`` step loop, as in the JAX
package (speaker_model.py:42-52).

At train=True the dropout masks are drawn from ``generator`` in the order
of the JAX package's fold_in indices (encoder 0-4, decoder 0-2).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import masked_softmax, soft_dot, soft_dot_init
from .core import (dense, dense_init, dropout, embedding, embedding_init, lstm_cell,
                   lstm_cell_init, masked_lstm)
from .decoders import drop_feat_img


def _full_lengths(xs: torch.Tensor) -> torch.Tensor:
    B, T = xs.shape[:2]
    return torch.full((B,), T, dtype=torch.long, device=xs.device)


def _unmasked_lstm(p: dict, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
                   c0: Optional[torch.Tensor] = None):
    """Full-length LSTM over xs [B, T, D] (speaker_model.py:27-52): from a
    zero state the scan kernels (``masked_lstm`` at full lengths), from a
    caller's (h0, c0) a plain ``lstm_cell`` step loop.  Returns (outs [B, T,
    H], (hT, cT))."""
    if h0 is None and c0 is None:
        return masked_lstm(p, xs, _full_lengths(xs))
    B, T, _ = xs.shape
    H = p["w_hh"].shape[0]
    h = xs.new_zeros((B, H)) if h0 is None else h0
    c = xs.new_zeros((B, H)) if c0 is None else c0
    outs = []
    for t in range(T):
        h, c = lstm_cell(p, xs[:, t], h, c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)


def _bidir_unmasked_lstm(p_fwd: dict, p_bwd: Optional[dict], xs: torch.Tensor) -> torch.Tensor:
    """[forward outs ; reverse outs] at full length (speaker_model.py:55-63)."""
    out_f, _ = _unmasked_lstm(p_fwd, xs)
    if p_bwd is None:
        return out_f
    out_b, _ = masked_lstm(p_bwd, xs, _full_lengths(xs), reverse=True)
    return torch.cat([out_f, out_b], dim=-1)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def speaker_encoder_init(gen: torch.Generator, feature_size: int, hidden_size: int,
                         bidirectional: bool, device=None) -> dict:
    dirs = 2 if bidirectional else 1
    H = hidden_size // dirs
    return {
        "lstm_fwd": lstm_cell_init(gen, feature_size, H, device=device),
        "lstm_bwd": lstm_cell_init(gen, feature_size, H, device=device) if bidirectional else None,
        "attn": soft_dot_init(gen, hidden_size, context_dim=feature_size, device=device),
        "post_fwd": lstm_cell_init(gen, hidden_size, H, device=device),
        "post_bwd": lstm_cell_init(gen, hidden_size, H, device=device) if bidirectional else None,
    }


def speaker_encoder_apply(p: dict, action_embeds: torch.Tensor, features: torch.Tensor,
                          train: bool, drop_rate: float = 0.6, feat_drop_rate: float = 0.3,
                          angle_feat_size: int = 128, already_dropfeat: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """action_embeds [B, T, F] (the chosen candidates' features), features
    [B, T, 36, F] (the panoramas) -> ctx [B, T, H] (speaker_model.py:
    82-116).  The attention's output mixes the f32 LSTM state with the
    panorama's weighted sum and is f32, so the post-LSTM runs in f32 in
    bf16 compute too, as jnp promotion gives."""
    B, T, V, F = features.shape
    x = action_embeds
    if not already_dropfeat:
        x = drop_feat_img(x, feat_drop_rate, train, angle_feat_size, generator)
    ctx = dropout(_bidir_unmasked_lstm(p["lstm_fwd"], p["lstm_bwd"], x), drop_rate, train,
                  generator)
    H = ctx.shape[-1]
    feats = features
    if not already_dropfeat:
        feats = drop_feat_img(feats, feat_drop_rate, train, angle_feat_size, generator)
    x2, _ = soft_dot(p["attn"], ctx.reshape(B * T, H), feats.reshape(B * T, V, F))
    x2 = dropout(x2.reshape(B, T, H), drop_rate, train, generator)
    out = _bidir_unmasked_lstm(p["post_fwd"], p["post_bwd"], x2)
    return dropout(out, drop_rate, train, generator)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def speaker_decoder_init(gen: torch.Generator, vocab_size: int, embedding_size: int,
                         padding_idx: int, hidden_size: int, device=None) -> dict:
    return {
        "embedding": embedding_init(gen, vocab_size, embedding_size, padding_idx, device=device),
        "lstm": lstm_cell_init(gen, embedding_size, hidden_size, device=device),
        "attn": soft_dot_init(gen, hidden_size, device=device),
        "projection": dense_init(gen, hidden_size, vocab_size, device=device),
        "baseline_fc1": dense_init(gen, hidden_size, 128, device=device),
        "baseline_fc2": dense_init(gen, 128, 1, device=device),
    }


def _attend_each_word(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                      ctx_mask: torch.Tensor) -> torch.Tensor:
    """``soft_dot`` of every word's state x [B, L, H] over its sample's
    context ctx [B, T, C] (mask [B, T]), without the [B L, T, C] copy of the
    context that the JAX package broadcasts (speaker_model.py:153-156): the
    same products and sums, the contractions in the context's dtype, the
    softmax in f32."""
    target = dense(p["linear_in"], x).to(ctx.dtype)                      # [B, L, C]
    scores = torch.einsum("btc,blc->blt", ctx, target)
    attn = masked_softmax(scores.float(), ctx_mask[:, None, :])
    weighted = torch.einsum("blt,btc->blc", attn.to(ctx.dtype), ctx)
    dtype = torch.promote_types(weighted.dtype, x.dtype)
    return torch.tanh(dense(p["linear_out"], torch.cat([weighted.to(dtype), x.to(dtype)], -1)))


def speaker_decoder_apply(p: dict, words: torch.Tensor, ctx: torch.Tensor,
                          ctx_mask: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                          train: bool, drop_rate: float = 0.6,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """words [B, L] token ids, ctx [B, T, H], ctx_mask [B, T] (True =
    masked), the state (h0, c0) [B, H] -> (logits [B, L, V], h1, c1)
    (speaker_model.py:134-162)."""
    embeds = dropout(embedding(p["embedding"], words), drop_rate, train, generator)
    x, (h1, c1) = _unmasked_lstm(p["lstm"], embeds, h0, c0)
    x = dropout(x, drop_rate, train, generator)
    x2 = dropout(_attend_each_word(p["attn"], x, ctx, ctx_mask), drop_rate, train, generator)
    return dense(p["projection"], x2), h1, c1
