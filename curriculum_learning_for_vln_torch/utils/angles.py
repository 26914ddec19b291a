"""Panoramic angle features and view-location embeddings.

Formula-parity with the reference (`tasks/R2R-judy/src/utils/misc.py:286-317`)
and with ``curriculum_learning_for_vln_tpu/utils/angles.py``:

* ``make_angle_feat(h, e)`` -> 128-d ``[sin h]*32 + [cos h]*32 + [sin e]*32
  + [cos e]*32`` on torch tensors (used inside the rollout loop).
* ``all_loc_embeddings()`` -> the (36, 36, 128) relative-view embedding
  table in numpy, built once at world compilation and gathered on the
  device by the current viewIndex.
"""
from __future__ import annotations

import math

import numpy as np
import torch

ANGLE_INC = math.pi / 6.0  # 30 degree view increments (ref: misc.py:28)
NUM_VIEWS = 36
ANGLE_FEAT_SIZE = 128


def make_angle_feat_np(heading, elevation, feat_size: int = ANGLE_FEAT_SIZE) -> np.ndarray:
    """Host-side single angle feature (ref: misc.py:286-293)."""
    return np.array(
        [math.sin(heading), math.cos(heading), math.sin(elevation), math.cos(elevation)],
        dtype=np.float32,
    ).repeat(feat_size // 4)


def make_angle_feat(heading: torch.Tensor, elevation: torch.Tensor,
                    feat_size: int = ANGLE_FEAT_SIZE) -> torch.Tensor:
    """Batched angle feature: ``heading``/``elevation`` of any (matching)
    shape S give S + (feat_size,) in the block layout
    [sin h * q, cos h * q, sin e * q, cos e * q], q = feat_size // 4."""
    parts = torch.stack([torch.sin(heading), torch.cos(heading),
                         torch.sin(elevation), torch.cos(elevation)], dim=-1)
    return torch.repeat_interleave(parts, feat_size // 4, dim=-1)


def build_viewpoint_loc_embedding(view_index: int, feat_size: int = ANGLE_FEAT_SIZE) -> np.ndarray:
    """(36, feat_size) relative-position embedding for one current viewIndex
    (ref: misc.py:296-312)."""
    embedding = np.zeros((NUM_VIEWS, feat_size), np.float32)
    for abs_view in range(NUM_VIEWS):
        rel_view = (abs_view - view_index) % 12 + (abs_view // 12) * 12
        rel_heading = (rel_view % 12) * ANGLE_INC
        rel_elevation = (rel_view // 12 - 1) * ANGLE_INC
        embedding[abs_view, :] = make_angle_feat_np(rel_heading, rel_elevation, feat_size)
    return embedding


def all_loc_embeddings(feat_size: int = ANGLE_FEAT_SIZE) -> np.ndarray:
    """(36, 36, feat_size): row v = loc embedding when current viewIndex is v
    (ref: misc.py:316-317)."""
    return np.stack([build_viewpoint_loc_embedding(v, feat_size) for v in range(NUM_VIEWS)])
