"""Agent factory (ref: tasks/R2R-judy/src/agent/__init__.py:11-54).

The port of ``curriculum_learning_for_vln_tpu/agents/__init__.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..world.compiler import PRECISIONS
from .envdrop import EnvDropAgent
from .follower import FollowerAgent
from .monitor import SelfMonitorAgent
from .test_agent import TestAgent


def build_agent(cfg, vocab_size: int, feat_dim: int = 2048):
    """The agent cfg.MODEL.NAME selects, computing in TPU.PRECISION's dtype
    (the feature table's); EnvDrop with its TPU.OBS_MASKS."""
    name = cfg.MODEL.NAME
    episode_len = cfg.AGENT.MAX_EPISODE_LEN
    dtype = PRECISIONS[cfg.TPU.PRECISION]
    if name == "FOLLOWER":
        return FollowerAgent(cfg.MODEL.FOLLOWER, vocab_size, feat_dim, episode_len,
                             compute_dtype=dtype)
    if name == "SELF-MONITOR":
        return SelfMonitorAgent(cfg.MODEL.MONITOR, cfg.DATA.MAX_ENC_LEN, vocab_size, feat_dim,
                                episode_len, compute_dtype=dtype)
    if name == "ENVDROP":
        return EnvDropAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, vocab_size, feat_dim,
                            episode_len, compute_dtype=dtype, obs_masks=cfg.TPU.OBS_MASKS)
    if name == "TEST":
        return TestAgent(episode_len)
    raise NotImplementedError(f"MODEL.NAME {name!r} is not ported")


def init_agent(agent, generator: torch.Generator, device=None) -> Tuple[dict, dict]:
    """(params, model_state) of any agent: EnvDrop's ``init`` returns its
    parameters alone (it has no model state), the others' both."""
    out = agent.init(generator, device=device)
    return out if isinstance(out, tuple) else (out, {})


__all__ = ["EnvDropAgent", "FollowerAgent", "SelfMonitorAgent", "TestAgent", "build_agent",
           "init_agent"]
