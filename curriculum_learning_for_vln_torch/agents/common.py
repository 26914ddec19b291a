"""Shared rollout machinery.

The port of ``curriculum_learning_for_vln_tpu/agents/common.py``.  The
JAX package runs an episode as one ``lax.scan``; here ``rollout_scan`` is
a Python loop over a fixed ``episode_len`` that calls a model-specific
step function and does the rest itself — observation metadata, action
selection, stop conversion, reward shaping and the per-step records
(per-sample CE against the teacher included).  Ended episodes are frozen
by the env semantics and masked in the records; the early exit once
every episode has ended is not ported yet.

Sample feedback is Gumbel-max, argmax(logits + Gumbel noise), which is
how ``jax.random.categorical`` is defined (common.py:135); the noise comes
from the rollout's generator through ``gumbel_noise``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..env import env as E
from ..env.env import EnvState, EpisodeBatch
from ..models.attention import NEG_INF
from ..models.core import cross_entropy_per_sample
from ..utils.angles import ANGLE_INC
from ..utils.tree import tree_map
from ..world.compiler import WorldTables

FEEDBACK_TEACHER = 0
FEEDBACK_ARGMAX = 1
FEEDBACK_SAMPLE = 2

FEEDBACK_IDS = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX, "sample": FEEDBACK_SAMPLE}


class StepRecord(NamedTuple):
    """Stacked [T, ...] outputs of the rollout loop."""

    node_after: torch.Tensor     # [T, B] node after this step's action
    view_after: torch.Tensor     # [T, B]
    moved: torch.Tensor          # [T, B] bool — a real move happened
    alive_before: torch.Tensor   # [T, B] bool — episode alive when acting
    ce: torch.Tensor             # [T, B] per-sample CE vs teacher (0 where ignored)
    ce_count: torch.Tensor       # [T] number of non-ignored samples
    logits: torch.Tensor         # [T, B, MC+1] masked logits
    log_prob: torch.Tensor       # [T, B] log pi(a_t)
    entropy: torch.Tensor        # [T, B] policy entropy
    hidden: torch.Tensor         # [T, B, H] decoder h_t (critic input)
    reward: torch.Tensor         # [T, B] shaped reward (EnvDrop formula)
    dist_after: torch.Tensor     # [T, B] distance-to-goal after the action
    teacher: torch.Tensor        # [T, B] teacher action index (IGNORE when ended)
    action: torch.Tensor         # [T, B] chosen action index


class RolloutResult(NamedTuple):
    final_state: EnvState
    start_node: torch.Tensor     # [B]
    start_view: torch.Tensor     # [B]
    steps: StepRecord
    model_carry: tuple


def cast_compute_params(params, compute_dtype):
    """Compute copies of the float leaves of a parameter tree (bf16 halves
    the weight bytes every step reads); integer leaves and None stay."""
    return tree_map(lambda t: t.to(compute_dtype) if t.is_floating_point() else t, params)


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u ~ U[tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def select_action(feedback: int, masked_logits: torch.Tensor, teacher: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (action, log_prob, entropy) for the feedback mode
    (ref: follower.py:131-139, envdrop.py:182-195).  The action carries no
    gradient; log_prob and entropy do."""
    logp = torch.log_softmax(masked_logits, dim=-1)
    probs = torch.exp(logp)
    entropy = -torch.sum(probs * torch.where(probs > 0, logp, 0.0), dim=-1)
    if feedback == FEEDBACK_TEACHER:
        action = teacher
    elif feedback == FEEDBACK_ARGMAX:
        action = torch.argmax(masked_logits, dim=-1)  # first maximum, as jnp.argmax
    else:
        noise = gumbel_noise(masked_logits.shape, generator, masked_logits.device)
        action = torch.argmax(masked_logits.detach() + noise, dim=-1)
    a_safe = action.clamp(0, masked_logits.shape[-1] - 1)
    log_prob = logp.gather(1, a_safe[:, None])[:, 0]
    return action, log_prob, entropy


def shaped_reward(is_stop: torch.Tensor, dist_before: torch.Tensor, dist_after: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """EnvDrop reward (ref: envdrop.py:209-212): +-2 terminal success bonus
    on stop, sign of distance progress otherwise, masked to alive."""
    stop_term = (2.0 * (dist_after < 3.0).float() - 1.0) * 2.0
    move_term = torch.sign(dist_before - dist_after)
    return torch.where(is_stop, stop_term, move_term) * alive.float()


# Model step callback:
#   model_step(model_carry, meta, env_state, t) -> (logits, new_carry, hidden)
ModelStepFn = Callable


def rollout_scan(world: WorldTables, ep: EpisodeBatch, model_carry0: tuple,
                 model_step: ModelStepFn, episode_len: int, feedback: int,
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None) -> RolloutResult:
    """Run ``episode_len`` decoder steps over the batch."""
    state = state0 = E.reset(world, ep)
    mc = model_carry0
    records = []
    for t in range(episode_len):
        meta = E.observe_meta(world, state, compute_dtype)
        logits, mc, hidden = model_step(mc, meta, state, t)
        masked = torch.where(meta.cand_mask, NEG_INF, logits)
        action, log_prob, entropy = select_action(feedback, masked, meta.teacher, generator)
        ce = cross_entropy_per_sample(masked, meta.teacher, E.IGNORE_ID)

        alive_before = torch.logical_not(state.ended)
        is_stop = E.action_is_stop(world, state, action)
        new_state = E.step(world, state, action)
        dist_after = world.dist[new_state.node].gather(1, state.goal_local[:, None])[:, 0]
        records.append(StepRecord(
            node_after=new_state.node,
            view_after=new_state.view_idx,
            moved=alive_before & torch.logical_not(is_stop),
            alive_before=alive_before,
            ce=ce,
            ce_count=(meta.teacher != E.IGNORE_ID).sum(),
            logits=masked,
            log_prob=log_prob,
            entropy=entropy,
            hidden=hidden,
            reward=shaped_reward(is_stop, meta.dist, dist_after, alive_before),
            dist_after=dist_after,
            teacher=meta.teacher,
            action=action,
        ))
        state = new_state
    steps = StepRecord(*(torch.stack(field) for field in zip(*records)))
    return RolloutResult(final_state=state, start_node=state0.node, start_view=state0.view_idx,
                         steps=steps, model_carry=mc)


def ml_loss_per_sample(steps: StepRecord) -> torch.Tensor:
    """Per-sample CE summed over time — the SPCL/train_cl loss vector
    (ref: follower.py:104,128)."""
    return steps.ce.sum(dim=0)


def ml_loss_sum(steps: StepRecord) -> torch.Tensor:
    """EnvDrop's summed CE (ref: envdrop.py:179)."""
    return steps.ce.sum()


# ---------------------------------------------------------------------------
# Host-side trajectory assembly
# ---------------------------------------------------------------------------

def assemble_trajectories(world_host, ep: EpisodeBatch, result: RolloutResult, data):
    """Reference-format result dicts from the stacked records
    (ref: evaluator.py:12-18): [(viewpointId, heading_rads, elevation_rads)].
    Only actual moves append entries (ref: common_env.py:108-110)."""
    nodes = result.steps.node_after.cpu().numpy()       # [T, B]
    views = result.steps.view_after.cpu().numpy()
    moved = result.steps.moved.cpu().numpy()
    start_nodes = result.start_node.cpu().numpy()
    start_views = result.start_view.cpu().numpy()
    item_idx = ep.item_idx.cpu().numpy()
    valid = ep.valid.cpu().numpy()

    T, B = nodes.shape
    results = []
    for b in range(B):
        if not valid[b]:
            continue
        item = data[int(item_idx[b])]
        sv = int(start_views[b])
        path = [(world_host.viewpoint_of(int(start_nodes[b])),
                 (sv % 12) * ANGLE_INC, (sv // 12 - 1) * ANGLE_INC)]
        for t in np.flatnonzero(moved[:, b]):
            v = int(views[t, b])
            path.append((world_host.viewpoint_of(int(nodes[t, b])),
                         (v % 12) * ANGLE_INC, (v // 12 - 1) * ANGLE_INC))
        results.append({"instr_id": item["instr_id"], "trajectory": path})
    return results
