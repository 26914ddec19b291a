"""Agent factory (ref: tasks/R2R-judy/src/agent/__init__.py:11-54).

The port of ``curriculum_learning_for_vln_tpu/agents/__init__.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.glove import load_glove
from ..world.compiler import PRECISIONS
from .envdrop import EnvDropAgent
from .follower import FollowerAgent
from .monitor import SelfMonitorAgent
from .test_agent import TestAgent


def build_agent(cfg, vocab_size: int, feat_dim: int = 2048, vocab=None):
    """The agent cfg.MODEL.NAME selects, computing in TPU.PRECISION's dtype
    (the feature table's); EnvDrop with its TPU.OBS_MASKS and, with
    TPU.FUSED_BPTT, the hand-written rollout backward; the Follower
    with the frozen GloVe table of MODEL.FOLLOWER.GLOVE_PATH, if set
    (``vocab``, the word list, aligns a text-format file; a ``.npy``
    table is aligned already; agents/__init__.py:20-31)."""
    name = cfg.MODEL.NAME
    episode_len = cfg.AGENT.MAX_EPISODE_LEN
    dtype = PRECISIONS[cfg.TPU.PRECISION]
    if name == "FOLLOWER":
        m = cfg.MODEL.FOLLOWER
        glove = load_glove(m.GLOVE_PATH, vocab, dim=m.WORD_EMB_SIZE) if m.GLOVE_PATH else None
        return FollowerAgent(m, vocab_size, feat_dim, episode_len, compute_dtype=dtype,
                             glove=glove)
    if name == "SELF-MONITOR":
        return SelfMonitorAgent(cfg.MODEL.MONITOR, cfg.DATA.MAX_ENC_LEN, vocab_size, feat_dim,
                                episode_len, compute_dtype=dtype)
    if name == "ENVDROP":
        agent = EnvDropAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, vocab_size, feat_dim,
                             episode_len, compute_dtype=dtype, obs_masks=cfg.TPU.OBS_MASKS)
        agent.use_fused_bptt = bool(cfg.TPU.FUSED_BPTT)  # (agents/__init__.py:52-53)
        return agent
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
