"""Inference/serving API: instruction -> trajectory.

The port of ``curriculum_learning_for_vln_tpu/serve.py``.  ``Navigator``
holds a compiled world's tables and an EnvDrop agent's weights on the
device and runs one argmax rollout per micro-batch of requests (padded to
``max_batch`` slots, padding slots born ended).  On the card the rollout
runs the port's CUDA kernels (encoder LSTM scan, observation step,
candidate scoring); there is no backend switch.

    nav = Navigator.from_checkpoint(world, agent, "ckpt/best_val_unseen.ckpt", tok,
                                    max_batch=64, precision="bf16")
    result = nav.navigate("walk past the kitchen and stop by the stairs",
                          scan="17DRP5sb8fy", start_viewpoint="0e92a69a50414253a23043758f111cec",
                          heading=3.75)
    result["trajectory"]  # [(viewpoint, heading, elevation), ...]
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .agents.common import FEEDBACK_ARGMAX, RolloutResult, assemble_trajectories, cast_compute_params
from .convert import load_jax_checkpoint
from .env.env import EpisodeBatch
from .utils.tokenizer import Tokenizer
from .utils.tree import tree_map
from .world.compiler import CompiledWorld, resolve_device


class Navigator:
    """Request-level navigation over a trained EnvDrop agent.

    Runs on CUDA unless ``device`` names another device; raises when CUDA
    is asked for and absent.  ``precision`` ("f32" | "bf16") is the
    feature table's dtype and must equal ``agent.compute_dtype``."""

    def __init__(self, world: CompiledWorld, agent, params: dict, tokenizer: Tokenizer,
                 max_batch: int = 8, precision: str = "f32", device=None):
        self.device = resolve_device(device)
        self.world = world
        self.agent = agent
        self.tok = tokenizer
        self.max_batch = max_batch
        self.tables = world.device_tables(precision, self.device)
        if self.tables.features.dtype != agent.compute_dtype:
            raise ValueError(f"precision {precision!r} gives a {self.tables.features.dtype} "
                             f"feature table but the agent computes in {agent.compute_dtype}")
        self.params = tree_map(lambda t: t.to(self.device),
                               cast_compute_params(params, agent.compute_dtype))

    @classmethod
    def from_checkpoint(cls, world: CompiledWorld, agent, ckpt_path: str,
                        tokenizer: Tokenizer, **kwargs) -> "Navigator":
        """A Navigator over the weights of a JAX package checkpoint."""
        return cls(world, agent, load_jax_checkpoint(ckpt_path)["params"], tokenizer, **kwargs)

    def episodes(self, requests: Sequence[dict]) -> EpisodeBatch:
        """The padded episode batch for a micro-batch of requests."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests exceed the micro-batch limit {self.max_batch}")
        B, L = self.max_batch, self.tok.encoding_length
        tokens = np.zeros((B, L), np.int64)
        lengths = np.ones(B, np.int64)
        start = np.zeros(B, np.int64)
        heading = np.zeros(B, np.float32)
        goal = np.zeros(B, np.int64)
        goal_local = np.zeros(B, np.int64)
        valid = np.zeros(B, bool)
        for i, req in enumerate(requests):
            enc = self.tok.encode_sentence(req["instruction"])
            if enc is None:
                raise ValueError(f"un-encodable instruction: {req['instruction']!r}")
            tokens[i], lengths[i] = enc
            g = self.world.global_id(req["scan"], req["start_viewpoint"])
            start[i] = g
            heading[i] = float(req.get("heading", 0.0))
            tgt = (self.world.global_id(req["scan"], req["goal_viewpoint"])
                   if "goal_viewpoint" in req else g)
            goal[i] = tgt
            goal_local[i] = self.world.node_local[tgt]
            valid[i] = True

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return EpisodeBatch(
            instr_tokens=dev(tokens), instr_len=dev(lengths), start_node=dev(start),
            start_heading=dev(heading), goal=dev(goal), goal_local=dev(goal_local),
            item_idx=torch.arange(B, device=self.device), valid=dev(valid))

    @torch.inference_mode()
    def rollout(self, ep: EpisodeBatch) -> RolloutResult:
        return self.agent.rollout(self.params, self.tables, ep, FEEDBACK_ARGMAX, train=False)[1]

    def navigate_batch(self, requests: Sequence[dict]) -> List[dict]:
        """Each request: {"instruction", "scan", "start_viewpoint",
        "heading" (optional), "goal_viewpoint" (optional, metrics only)}.
        Returns per-request {"trajectory", "instruction"} dicts."""
        ep = self.episodes(requests)
        result = self.rollout(ep)
        data = [{"instr_id": i} for i in range(self.max_batch)]
        by_idx = {o["instr_id"]: o["trajectory"]
                  for o in assemble_trajectories(self.world, ep, result, data)}
        return [{"instruction": req["instruction"], "trajectory": by_idx[i]}
                for i, req in enumerate(requests)]

    def navigate(self, instruction: str, scan: str, start_viewpoint: str,
                 heading: float = 0.0) -> dict:
        return self.navigate_batch([{
            "instruction": instruction, "scan": scan,
            "start_viewpoint": start_viewpoint, "heading": heading,
        }])[0]
