"""Model-free teacher-following agent: the env and metric plumbing's check.

The port of ``curriculum_learning_for_vln_tpu/agents/test_agent.py`` (the
reference's TestAgent, tasks/R2R-judy/src/agent/base.py:484-571), which
``engine.trainer.check_the_code`` runs: it follows the shortest-path
teacher every step, so it scores SR ~1.0 whatever the weights (it has
none), which checks env stepping, teacher actions, trajectory recording
and the evaluation end to end.  No kernel runs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..env.env import EpisodeBatch
from ..world.compiler import WorldTables
from . import common as C


class TestAgent:
    name = "TEST"
    __test__ = False  # not a pytest class

    def __init__(self, episode_len: int = 20):
        self.episode_len = episode_len
        self.compute_dtype = torch.float32

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> Tuple[dict, dict]:
        return {}, {}

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch,
                feedback: int = C.FEEDBACK_TEACHER, train: bool = False,
                episode_len: Optional[int] = None, generator: Optional[torch.Generator] = None,
                model_state: Optional[dict] = None):
        """(None, result, model_state): logits one-hot on the teacher (0
        there, NEG_INF elsewhere), so every feedback mode follows it."""
        B = ep.instr_tokens.shape[0]
        K = world.max_candidates + 1
        slots = torch.arange(K, device=ep.instr_tokens.device)[None, :]
        hidden = torch.zeros((B, 1), device=ep.instr_tokens.device)

        def model_step(mc, meta, state, t):
            tgt = meta.teacher.clamp(0, K - 1)
            logits = torch.where(slots == tgt[:, None], 0.0, C.NEG_INF)
            return logits, mc, hidden, None

        result = C.rollout_scan(world, ep, (), model_step, episode_len or self.episode_len,
                                C.FEEDBACK_TEACHER, generator=generator)
        return None, result, model_state if model_state is not None else {}
