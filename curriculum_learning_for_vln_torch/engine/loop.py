"""The training iteration, the optimizers and the evaluation runner.

The port of ``curriculum_learning_for_vln_tpu/engine/loop.py`` for
EnvDrop.  One iteration is the reference's dual rollout — teacher-forced
IL then sampled A2C on the same minibatch, one optimizer step over the
summed loss (ref: tasks/R2R-judy/src/engine/trainer.py:411-427; JAX
loop.py:97-173) — run eagerly: two rollouts through autograd, one
backward, a clip of the encoder's and the decoder's gradients at 40, one
optimizer step.  SPCL weighting enters as a per-sample weight vector
(``weights``) so the curriculum trainers of the next slice plug in.

Parameters are nested dicts of leaf tensors (``utils/tree.py``).  The
packed-RL and scanned (``SCAN_ITERS``) iterations are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..agents.common import (FEEDBACK_ARGMAX, FEEDBACK_IDS, FEEDBACK_SAMPLE, FEEDBACK_TEACHER,
                             assemble_trajectories)
from ..utils.tree import tree_leaves
from ..world.compiler import WorldTables


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` as the JAX package builds it
    (loop.py:78): nu = decay nu + (1 - decay) g^2 from nu = 0, then
    p -= lr g / sqrt(nu + eps) — eps INSIDE the square root (optax's
    eps_in_sqrt=True), where ``torch.optim.RMSprop`` adds it outside.  A
    parameter without a gradient counts as a zero gradient, as in optax."""

    def __init__(self, params, lr: float, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(g, g, value=1.0 - group["decay"])
                p.sub_(group["lr"] * g * torch.rsqrt(nu + group["eps"]))


def make_optimizer(name: str, lr: float, params: dict) -> torch.optim.Optimizer:
    """adam / rms / sgd with torch-default hyperparameters over the leaves
    of ``params`` (ref: trainer.py:17-21; JAX loop.py:74-81).  Adam's eps
    sits outside the root in both optax and torch."""
    leaves = tree_leaves(params)
    if name == "rms":
        return RMSprop(leaves, lr, decay=0.99, eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(leaves, lr)
    return torch.optim.Adam(leaves, lr, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_submodule_grads(params: dict, keys, max_norm: float) -> Dict[str, torch.Tensor]:
    """Per-submodule global-norm clipping of the ``.grad`` of each leaf, the
    reference's clip_grad_norm(encoder) / clip_grad_norm(decoder) at 40
    (ref: trainer.py:425-426; the critic is NOT clipped), with the norm +
    1e-6 of loop.py:84-94.  Returns each submodule's norm before the clip."""
    norms = {}
    for key in keys:
        grads = [p.grad for p in tree_leaves(params[key]) if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        norms[key] = norm
    return norms


def iteration_loss(agent, feedback: str, tables: WorldTables, params: dict, ep,
                   generator: Optional[torch.Generator], weights: Optional[torch.Tensor] = None,
                   il_len: Optional[int] = None):
    """The objective of one EnvDrop iteration (loop.py:104-146): the
    teacher-forced IL rollout, truncated to ``il_len`` (the batch's bucketed
    episode length, trainer.py:86-105), then with sample feedback the
    sampled A2C rollout at the full horizon, on the same minibatch.
    Returns (total loss, logs)."""
    if agent.name != "ENVDROP":
        raise NotImplementedError(f"the {agent.name} iteration is not ported yet")
    il, _ = agent.rollout(params, tables, ep, FEEDBACK_TEACHER, train=True, train_ml=True,
                          train_rl=False, episode_len=il_len, generator=generator)
    rl = None
    if FEEDBACK_IDS[feedback] == FEEDBACK_SAMPLE:
        rl, _ = agent.rollout(params, tables, ep, FEEDBACK_SAMPLE, train=True, train_ml=False,
                              train_rl=True, generator=generator)
    ml_vec = il.ml_loss_per_sample
    rl_vec = rl.rl_loss_per_sample if rl is not None else torch.zeros_like(ml_vec)
    if weights is None:
        total = il.ml_loss + (rl.rl_loss if rl is not None else 0.0)
    else:
        total = torch.dot(weights, ml_vec + rl_vec)  # (ref: curriculum.py:294-296)
    zero = total.new_zeros(())
    logs = {
        "loss": total,
        "ml_loss": il.ml_loss,
        "rl_loss": rl.rl_loss if rl is not None else zero,
        # SPCL per-item record: ml vector * B (ref: curriculum.py:313)
        "loss_per_sample": ml_vec * ml_vec.shape[0],
        "entropy": rl.entropy_sum if rl is not None else il.entropy_sum,
        "critic_loss": rl.critic_loss_sum if rl is not None else zero,
        "total_actions": rl.total_actions if rl is not None else il.total_actions,
    }
    return total, logs


def one_iter(agent, optimizer: torch.optim.Optimizer, feedback: str, tables: WorldTables,
             params: dict, ep, generator: Optional[torch.Generator],
             weights: Optional[torch.Tensor] = None, il_len: Optional[int] = None) -> dict:
    """One training iteration: ``iteration_loss``, its gradients, the clip
    at 40 of the encoder's and the decoder's, one optimizer step on
    ``params`` (in place).  Returns the detached logs."""
    total, logs = iteration_loss(agent, feedback, tables, params, ep, generator, weights, il_len)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
    optimizer.step()
    return {k: v.detach() for k, v in logs.items()}


def build_eval_rollout(agent) -> Callable:
    """Argmax eval rollout without autograd (the encoder runs K3):
    (tables, params, ep, generator) -> RolloutResult."""

    @torch.no_grad()
    def roll(tables, params, ep, generator=None):
        return agent.rollout(params, tables, ep, FEEDBACK_ARGMAX, train=False,
                             generator=generator)[1]

    return roll


def run_eval(agent, params: dict, tables: WorldTables, henv,
             eval_rollout: Optional[Callable] = None) -> list:
    """Full-split evaluation with exact coverage (replaces the reference's
    loop-until-instr_id-repeats, base.py:63-82)."""
    if eval_rollout is None:
        eval_rollout = build_eval_rollout(agent)
    results = []
    for ep in henv.eval_batches():
        result = eval_rollout(tables, params, ep)
        results += assemble_trajectories(henv.world, ep, result, henv.data)
    return results
