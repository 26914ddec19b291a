"""Fused observation ops, each a ``torch.autograd.Function``.

The port of ``curriculum_learning_for_vln_tpu/ops/fused_obs.py``:

* ``pano_attend_cands`` — panorama gather + env-dropout + visual
  attention + candidate rows: forward K4, backward K5
  (ops/cuda/pano_fused.py);
* ``cand_attend_logits`` — candidate scoring with env-dropout on the
  image rows and the zero STOP slot: forward K6, backward K7
  (ops/cuda/cand_score.py).

The residual contract is that of fused_obs.py:131-165 and :224-255: only
the query (``tv``, ``q``) carries a gradient — the world tables carry
none — and what is saved is the attention weights [B, 36], the indices,
and the external mask or the prng seeds (``DropSpec``): nothing
image-sized.  The backward regenerates the forward's mask.  Each op runs
its CUDA kernels for tensors on the card and their plain twins on the
CPU; there is no backend switch and no gate that could skip a kernel.
The Self-Monitor's ``cands_only`` short-circuit and the "prng_shared"
mode are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import cand_score as _cand_score
from .cuda import pano_fused as _pano_fused
from .cuda.drop import NO_DROP, DropSpec


class PanoAttend(torch.autograd.Function):
    """(vis, cand_img) of K4, differentiable in tv through K5."""

    @staticmethod
    def forward(ctx, tv, node, view, c_view, features, loc_embed, drop):
        vis, alpha, cand = _pano_fused.pano_attend(node, view, c_view, features, loc_embed, tv,
                                                   drop)
        ctx.save_for_backward(node, view, features, loc_embed, alpha)
        ctx.drop = drop
        ctx.mark_non_differentiable(cand)  # a copy of gradient-free table rows
        return vis, cand

    @staticmethod
    def backward(ctx, g_vis, _g_cand):
        node, view, features, loc_embed, alpha = ctx.saved_tensors
        d_tv = _pano_fused.pano_attend_bwd(node, view, features, loc_embed, alpha,
                                           g_vis.contiguous(), ctx.drop)
        return d_tv, None, None, None, None, None, None


class CandAttend(torch.autograd.Function):
    """Candidate logits of K6, differentiable in q through K7."""

    @staticmethod
    def forward(ctx, q, cand_img, cand_angle, cand_valid, drop):
        ctx.save_for_backward(cand_img, cand_angle, cand_valid)
        ctx.drop = drop
        return _cand_score.cand_score(cand_img, cand_angle, cand_valid, q, drop)

    @staticmethod
    def backward(ctx, g):
        cand_img, cand_angle, cand_valid = ctx.saved_tensors
        d_q = _cand_score.cand_score_bwd(cand_img, cand_angle, cand_valid, g.contiguous(),
                                         ctx.drop)
        return d_q, None, None, None, None


def pano_attend_cands(node: torch.Tensor, view: torch.Tensor, c_view: torch.Tensor,
                      features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor,
                      drop: DropSpec = NO_DROP) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vis [B, F] f32, cand_img [B, MC, D] in the table dtype) for the
    current states, against the visual query tv [B, F] f32, with the
    panorama's image rows dropped per ``drop``."""
    return PanoAttend.apply(tv, node, view, c_view, features, loc_embed, drop)


def cand_attend_logits(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                       cand_valid: torch.Tensor, q: torch.Tensor,
                       drop: DropSpec = NO_DROP) -> torch.Tensor:
    """Candidate logits [B, MC+1] (STOP slot zero) from raw candidate view
    rows + angle features and the projected query q [B, F], with the image
    rows dropped per ``drop``."""
    return CandAttend.apply(q, cand_img, cand_angle, cand_valid, drop)
