"""Fused observation ops (forward only).

The port of ``curriculum_learning_for_vln_tpu/ops/fused_obs.py`` for the
serving path (train=False, no env-dropout):

* ``pano_attend_cands`` — panorama gather + visual attention + candidate
  rows, kernel K4 (ops/cuda/pano_fused.py);
* ``cand_attend_logits`` — candidate scoring with the zero STOP slot,
  kernel K6 (ops/cuda/cand_score.py).

Each runs its CUDA kernel for tensors on the card and its plain twin on
the CPU.  There is no backend switch and no gate that could skip a
kernel.  The custom-VJP training path and the dropout mask modes come
with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .cuda import cand_score as _cand_score
from .cuda import pano_fused as _pano_fused


def pano_attend_cands(node: torch.Tensor, view: torch.Tensor, c_view: torch.Tensor,
                      features: torch.Tensor, loc_embed: torch.Tensor, tv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vis [B, F] f32, cand_img [B, MC, D] in the table dtype) for the
    current states, against the visual query tv [B, F] f32."""
    vis, _alpha, cand = _pano_fused.pano_attend(node, view, c_view, features, loc_embed, tv)
    return vis, cand


def cand_attend_logits(cand_img: torch.Tensor, cand_angle: torch.Tensor,
                       cand_valid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Candidate logits [B, MC+1] (STOP slot zero) from raw candidate view
    rows + angle features and the projected query q [B, F]."""
    return _cand_score.cand_score(cand_img, cand_angle, cand_valid, q)
