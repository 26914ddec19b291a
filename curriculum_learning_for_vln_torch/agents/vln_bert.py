"""VLN-BERT path-instruction compatibility scorer.

The port of ``curriculum_learning_for_vln_tpu/agents/vln_bert.py``: the
two-stream ViLBERT (models/vilbert.py) with the path-selection head (ref:
tasks/R2R-judy/src/agent/vln_bert.py:11-75), and ``path_scorer_inputs``,
the 12-d location vector of each step built from the compiled world:

    [:5]   normalised (x, y, z, geodesic progress, step fraction)
    [5:9]  orientation  [sin h, cos h, sin e, cos e]
    [9:11] next-step orientation [sin h', cos h']
    [11]   integer step index (the sequence-position embedding)

which fills the slots of the VLN image embeddings (vilbert.py:1398-1428).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.vilbert import VilBertConfig, vlnbert_apply, vlnbert_init
from ..utils.angles import ANGLE_INC
from ..world.compiler import CompiledWorld


class VLNBertScorer:
    name = "VLN-BERT"

    def __init__(self, cfg: VilBertConfig, dropout_prob: float = 0.1):
        self.cfg = cfg
        self.dropout_prob = dropout_prob

    def init(self, generator: torch.Generator, device=None) -> Tuple[dict, dict]:
        """Seeded f32 parameters on ``device`` and the (empty) model state."""
        from ..utils.tree import tree_map

        return tree_map(lambda t: t.to(device), vlnbert_init(generator, self.cfg)), {}

    def apply(self, params, instr_tokens, image_features, image_locations,
              attention_mask=None, image_attention_mask=None, train: bool = False,
              compute_heads: bool = True, generator: Optional[torch.Generator] = None,
              tp=None):
        return vlnbert_apply(
            params, self.cfg, instr_tokens, image_features, image_locations,
            attention_mask=attention_mask, image_attention_mask=image_attention_mask,
            train=train, dropout_prob=self.dropout_prob, compute_heads=compute_heads,
            generator=generator, tp=tp)

    @torch.inference_mode()
    def score_paths(self, params, instr_tokens, image_features, image_locations,
                    attention_mask=None, image_attention_mask=None, tp=None) -> torch.Tensor:
        """vil_logit [B] of a batch of (path, instruction) pairs, with the
        LM and region heads left out (compute_heads=False): the difficulty
        score reads vil_logit alone.  With ``tp`` (parallel/
        vilbert_sharding.py) ``params`` are this rank's slices and the
        model group scores the batch together."""
        logit, _, _, _ = self.apply(params, instr_tokens, image_features, image_locations,
                                    attention_mask, image_attention_mask, train=False,
                                    compute_heads=False, tp=tp)
        return logit[:, 0]


def path_scorer_inputs(
    world: CompiledWorld,
    scan: str,
    path_nodes: Sequence[int],       # global node ids along the path
    path_views: Sequence[int],       # view indices at each step
    max_path_len: int,
    feat_dim: int = 2048,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(features [L, D], locations [L, 12], mask [L]) of one path, f32."""
    locs, mask = path_locations(world, path_nodes, path_views, max_path_len)
    feats = np.zeros((max_path_len, feat_dim), np.float32)
    for t in range(int(mask.sum())):
        feats[t] = world.features[int(path_nodes[t]), int(path_views[t])][:feat_dim]
    return feats, locs, mask


def path_locations(world: CompiledWorld, path_nodes: Sequence[int], path_views: Sequence[int],
                   max_path_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(locations [L, 12], mask [L]) of one path, f32: ``path_scorer_inputs``
    without the features, which a caller may gather on the card."""
    L = max_path_len
    locs = np.zeros((L, 12), np.float32)
    mask = np.zeros((L,), np.float32)
    n = min(len(path_nodes), L)
    pos = world.pos
    start = pos[path_nodes[0]]
    extent = max(float(np.ptp(pos[:, 0])), float(np.ptp(pos[:, 1])), 1.0)
    goal_local = world.node_local[path_nodes[-1]]
    total = max(float(world.dist[path_nodes[0], goal_local]), 1e-6)

    for t in range(n):
        g = int(path_nodes[t])
        v = int(path_views[t])
        p = pos[g]
        progress = 1.0 - float(world.dist[g, goal_local]) / total
        locs[t, 0] = (p[0] - start[0]) / extent
        locs[t, 1] = (p[1] - start[1]) / extent
        locs[t, 2] = (p[2] - start[2]) / extent
        locs[t, 3] = progress
        locs[t, 4] = t / max(n - 1, 1)
        h = float(_view_heading(v))
        e = float(_view_elevation(v))
        locs[t, 5:9] = [math.sin(h), math.cos(h), math.sin(e), math.cos(e)]
        if t + 1 < n:
            hn = float(_view_heading(int(path_views[t + 1])))
            locs[t, 9:11] = [math.sin(hn), math.cos(hn)]
        locs[t, 11] = min(t, 31)
        mask[t] = 1.0
    return locs, mask


def _view_heading(view_index):
    """The discretised absolute heading of a view index (radians)."""
    return (view_index % 12) * ANGLE_INC


def _view_elevation(view_index):
    """The discretised absolute elevation of a view index: rows are down,
    level, up."""
    return (view_index // 12 - 1) * ANGLE_INC
