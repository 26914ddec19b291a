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
CPU.  The process-wide backend (``set_backend``, fused_obs.py:47-68) does
not reach inside the ops: it tells the agents whether to call them
(``enabled_for``).  Under "plain" (TPU.USE_PALLAS False) the agents take
their unfused decode over gathered features instead, and no observation
kernel launches.
The masks follow the ``DropSpec``'s mode: "none", "ext", "prng" or
"prng_shared" (ops/cuda/drop.py).  ``pano_cands`` is the Self-Monitor's
``cands_only`` use (fused_obs.py:116-128, 140-141): K4 on a zero query
that carries no gradient, so no backward (K5) ever runs for it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import cand_score as _cand_score
from .cuda import pano_fused as _pano_fused
from .cuda.drop import NO_DROP, DropSpec

BACKENDS = ("cuda", "plain")
_BACKEND = "cuda"


def set_backend(name: str) -> None:
    """"cuda" (the agents run these ops: K4-K7 on the card) or "plain" (the
    agents' unfused decode).  The mask mode is the agent's
    (TPU.OBS_MASKS), not the backend's as in the JAX package."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"fused_obs backend {name!r} is none of {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def enabled_for(features: torch.Tensor, compute_dtype: torch.dtype) -> bool:
    """Whether an agent takes the fused observation path: the "cuda"
    backend, over a feature table stored in the compute dtype (the agents
    raise on any other table first: ``agents.common.check_dtype``)."""
    return _BACKEND == "cuda" and features.dtype == compute_dtype


def _drop(ctx, mask, seeds) -> DropSpec:
    """The forward's DropSpec, its tensors back from ``save_for_backward``
    (which frees them after the backward, where an attribute of ctx would
    keep an ext mask alive as long as the op's outputs)."""
    mode, keep = ctx.drop_mode
    return DropSpec(mode, mask=mask, seeds=seeds, keep=keep)


class PanoAttend(torch.autograd.Function):
    """(vis, cand_img) of K4, differentiable in tv through K5."""

    @staticmethod
    def forward(ctx, tv, node, view, c_view, features, loc_embed, drop):
        vis, alpha, cand = _pano_fused.pano_attend(node, view, c_view, features, loc_embed, tv,
                                                   drop)
        ctx.save_for_backward(node, view, features, loc_embed, alpha, drop.mask, drop.seeds)
        ctx.drop_mode = (drop.mode, drop.keep)
        ctx.mark_non_differentiable(cand)  # a copy of gradient-free table rows
        return vis, cand

    @staticmethod
    def backward(ctx, g_vis, _g_cand):
        node, view, features, loc_embed, alpha, mask, seeds = ctx.saved_tensors
        d_tv = _pano_fused.pano_attend_bwd(node, view, features, loc_embed, alpha,
                                           g_vis.contiguous(), _drop(ctx, mask, seeds))
        return d_tv, None, None, None, None, None, None


class CandAttend(torch.autograd.Function):
    """Candidate logits of K6, differentiable in q through K7."""

    @staticmethod
    def forward(ctx, q, cand_img, cand_angle, cand_valid, drop):
        ctx.save_for_backward(cand_img, cand_angle, cand_valid, drop.mask, drop.seeds)
        ctx.drop_mode = (drop.mode, drop.keep)
        return _cand_score.cand_score(cand_img, cand_angle, cand_valid, q, drop)

    @staticmethod
    def backward(ctx, g):
        cand_img, cand_angle, cand_valid, mask, seeds = ctx.saved_tensors
        d_q = _cand_score.cand_score_bwd(cand_img, cand_angle, cand_valid, g.contiguous(),
                                         _drop(ctx, mask, seeds))
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


def pano_cands(node: torch.Tensor, view: torch.Tensor, c_view: torch.Tensor,
               features: torch.Tensor, loc_embed: torch.Tensor) -> torch.Tensor:
    """cand_img [B, MC, D] alone, for a decoder that attends over the
    candidates and not the panorama (the Self-Monitor).  The JAX package
    flags the call ``cands_only`` and returns a zero query cotangent; the
    port's route is a query that carries no gradient: K4 runs once on a
    zero f32 query, nothing in the call requires a gradient, so autograd
    records no backward and K5 never launches.  No env-dropout (the
    Self-Monitor has none)."""
    tv = torch.zeros((node.shape[0], features.shape[-1] + loc_embed.shape[-1]),
                     dtype=torch.float32, device=features.device)
    return PanoAttend.apply(tv, node, view, c_view, features, loc_embed, NO_DROP)[1]
