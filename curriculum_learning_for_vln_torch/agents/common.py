"""Shared rollout machinery.

The port of ``curriculum_learning_for_vln_tpu/agents/common.py``.  The
JAX package runs an episode as one ``lax.scan``; here ``rollout_scan`` is
a Python loop over a fixed ``episode_len`` that calls a model-specific
step function and does the rest itself — observation metadata, action
selection, stop conversion, reward shaping and the per-step records
(per-sample CE against the teacher and the progress monitor's prediction
included).  Ended episodes are frozen by the env semantics and masked in
the records.

The early exit (``TPU.SCAN_EARLY_EXIT``, common.py:48-69, 244-271; off
by default): the reference breaks its rollout loop once every episode
has ended (ref: follower.py:168).  With the flag on, each step first
asks the card whether any episode is alive (a device-to-host read, until
the answer is no); after that every step is frozen: no model step runs,
and the record is what a live step records for an all-ended batch (the
node sticks, nothing moves, ce 0, the teacher IGNORE, the distance to
the goal unchanged; the other fields 0, the action 0 as in the JAX
package), so the records keep their length T and every loss and update
is the flag-off one.  The model carry stays, so the Self-Monitor's BN
statistics stop accumulating on dead steps, as the reference's do.  A
frozen step makes the random draws of the last live step again and drops
them (ops/draws.py), so the generator ends where the fixed-length loop
leaves it.  ``set_early_exit`` sets the flag (engine/loop.py::
configure_runtime, from the config).

Sample feedback is Gumbel-max, argmax(logits + Gumbel noise), which is
how ``jax.random.categorical`` is defined (common.py:135); the noise comes
from the rollout's generator through ``gumbel_noise``.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..env import env as E
from ..env.env import EnvState, EpisodeBatch
from ..models.attention import NEG_INF
from ..models.core import cross_entropy_per_sample
from ..ops import draws
from ..parallel import mesh as M
from ..utils.angles import ANGLE_INC
from ..utils.profiling import span
from ..utils.tree import tree_map
from ..world.compiler import WorldTables

FEEDBACK_TEACHER = 0
FEEDBACK_ARGMAX = 1
FEEDBACK_SAMPLE = 2

FEEDBACK_IDS = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX, "sample": FEEDBACK_SAMPLE}

_EARLY_EXIT = False  # TPU.SCAN_EARLY_EXIT


def set_early_exit(on: bool) -> None:
    global _EARLY_EXIT
    _EARLY_EXIT = bool(on)


class EarlyExit:
    """The early exit of one rollout loop: ``dead(ended)`` says whether
    every episode has ended (on every rank, in a data-parallel step, so
    that the ranks run the same steps and their collectives pair up, as
    JAX's ``lax.cond`` on the global batch), asking the card until it
    has; ``live()``
    records a live step's draws; ``skip()`` makes them again."""

    def __init__(self):
        self.on, self.is_dead, self.draws = _EARLY_EXIT, False, None

    def dead(self, ended: torch.Tensor) -> bool:
        # frozen steps need a live step's record first
        if self.on and not self.is_dead and self.draws is not None:
            self.is_dead = M.all_true(ended)
        return self.is_dead

    @contextmanager
    def live(self):
        if not self.on:
            yield
            return
        with draws.recording() as log:
            yield
        self.draws = log

    def skip(self) -> None:
        draws.replay(self.draws)


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
    progress: torch.Tensor       # [T, B] progress-monitor prediction (0 if n/a)


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


def check_dtype(world: WorldTables, compute_dtype: torch.dtype) -> None:
    """The observation kernels read the feature table in the agent's compute
    dtype; the JAX package silently drops its fused path on a mismatch."""
    if world.features.dtype != compute_dtype:
        raise ValueError(f"feature table dtype {world.features.dtype} differs from the "
                         f"compute dtype {compute_dtype}")


def chosen_feature(cand_feat: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """a_t_prev: the chosen candidate's feature row of cand_feat [B, K, F]
    (the STOP slot's zeros; an ignored action reads slot 0), as
    common.py:302-307 gathers it."""
    a = action.clamp(0, cand_feat.shape[1] - 1)
    return cand_feat.gather(1, a[:, None, None].expand(-1, 1, cand_feat.shape[2]))[:, 0]


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u ~ U[tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = draws.rand(shape, generator, device, batch_dim=0).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def policy_terms(masked_logits: torch.Tensor, action: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_prob of ``action``, entropy) of the policy over ``masked_logits``
    [B, K] (common.py:126-139); an ignored action reads slot 0."""
    logp = torch.log_softmax(masked_logits, dim=-1)
    probs = torch.exp(logp)
    entropy = -torch.sum(probs * torch.where(probs > 0, logp, 0.0), dim=-1)
    a_safe = action.clamp(0, masked_logits.shape[-1] - 1)
    return logp.gather(1, a_safe[:, None])[:, 0], entropy


def select_action(feedback: int, masked_logits: torch.Tensor, teacher: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (action, log_prob, entropy) for the feedback mode
    (ref: follower.py:131-139, envdrop.py:182-195).  The action carries no
    gradient; log_prob and entropy do."""
    if feedback == FEEDBACK_TEACHER:
        action = teacher
    elif feedback == FEEDBACK_ARGMAX:
        action = torch.argmax(masked_logits, dim=-1)  # first maximum, as jnp.argmax
    else:
        noise = gumbel_noise(masked_logits.shape, generator, masked_logits.device)
        action = torch.argmax(masked_logits.detach() + noise, dim=-1)
    log_prob, entropy = policy_terms(masked_logits, action)
    return action, log_prob, entropy


def shaped_reward(is_stop: torch.Tensor, dist_before: torch.Tensor, dist_after: torch.Tensor,
                  alive: torch.Tensor) -> torch.Tensor:
    """EnvDrop reward (ref: envdrop.py:209-212): +-2 terminal success bonus
    on stop, sign of distance progress otherwise, masked to alive."""
    stop_term = (2.0 * (dist_after < 3.0).float() - 1.0) * 2.0
    move_term = torch.sign(dist_before - dist_after)
    return torch.where(is_stop, stop_term, move_term) * alive.float()


# Model step callback:
#   model_step(model_carry, meta, env_state, t) -> (logits, new_carry, hidden, progress)
#   (progress [B] of a progress monitor, or None: recorded as zeros)
# Optional post-action callback (e.g. the a_t_prev feature update):
#   model_post(model_carry, meta, action) -> model_carry
ModelStepFn = Callable


def visited_history(state0: EnvState, episode_len: int) -> torch.Tensor:
    """The visited-node history of ``avoid_cyclic`` (common.py:183-185):
    [B, T+1], slot t the node at time t, -1 while unfilled."""
    visited = torch.full((state0.node.shape[0], episode_len + 1), -1, dtype=state0.node.dtype,
                         device=state0.node.device)
    visited[:, 0] = state0.node
    return visited


def cyclic_mask(world: WorldTables, node: torch.Tensor, cand_mask: torch.Tensor,
                visited: torch.Tensor) -> torch.Tensor:
    """``cand_mask`` [B, MC+1] with the candidates that lead to an already
    visited node masked too (ref: follower.py:117-122; common.py:194-202):
    only valid candidates, since padding slots alias the node itself
    (always visited) and slot n doubles as STOP, which stays open."""
    c_next = world.cand_next[node]                                          # [B, MC]
    seen = (c_next[:, :, None] == visited[:, None, :]).any(dim=-1) & world.cand_valid[node]
    pad = seen.new_zeros((seen.shape[0], cand_mask.shape[1] - seen.shape[1]))
    return cand_mask | torch.cat([seen, pad], dim=1)


def rollout_scan(world: WorldTables, ep: EpisodeBatch, model_carry0: tuple,
                 model_step: ModelStepFn, episode_len: int, feedback: int,
                 compute_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None,
                 model_post: Optional[Callable] = None,
                 avoid_cyclic: bool = False) -> RolloutResult:
    """Run ``episode_len`` decoder steps over the batch; ``model_post``
    updates the carry from the chosen action before the env steps
    (common.py:208-210).  ``avoid_cyclic`` masks the candidates that lead
    to viewpoints already visited (``cyclic_mask``), from a history of
    the nodes on the device; a frozen step records the node that sticks,
    as a live step on an all-ended batch does."""
    with span("rollout.scan"):
        state = state0 = E.reset(world, ep)
        visited = visited_history(state0, episode_len) if avoid_cyclic else None
        mc = model_carry0
        records = []
        exit_ = EarlyExit()
        for t in range(episode_len):
            if exit_.dead(state.ended):
                exit_.skip()
                with span("rollout.env"):
                    records.append(frozen_record(world, state, records[-1]))
                    if visited is not None:
                        visited[:, t + 1] = state.node
                continue
            with span("rollout.observe"):
                meta = E.observe_meta(world, state, compute_dtype)
            with span("rollout.decode"):
                with exit_.live():
                    logits, mc, hidden, progress = model_step(mc, meta, state, t)
                    cand_mask = (meta.cand_mask if visited is None
                                 else cyclic_mask(world, state.node, meta.cand_mask, visited))
                    masked = torch.where(cand_mask, NEG_INF, logits)
                    action, log_prob, entropy = select_action(feedback, masked, meta.teacher,
                                                              generator)
                if model_post is not None:
                    mc = model_post(mc, meta, action)
            with span("rollout.env"):
                new_state, record = step_and_record(world, state, meta, masked, action,
                                                    log_prob, entropy, hidden, progress)
                if visited is not None:
                    visited[:, t + 1] = new_state.node
            records.append(record)
            state = new_state
        steps = StepRecord(*(torch.stack(field) for field in zip(*records)))
    return RolloutResult(final_state=state, start_node=state0.node, start_view=state0.view_idx,
                         steps=steps, model_carry=mc)


def step_and_record(world: WorldTables, state: EnvState, meta: E.ObsMeta, masked: torch.Tensor,
                    action: torch.Tensor, log_prob: torch.Tensor, entropy: torch.Tensor,
                    hidden: torch.Tensor, progress: Optional[torch.Tensor] = None
                    ) -> Tuple[EnvState, StepRecord]:
    """The env step of ``action`` from ``state`` and the step's record
    (common.py:204-240): the CE of the masked logits against the teacher,
    the stop conversion, the shaped reward, the distance after."""
    alive_before = torch.logical_not(state.ended)
    is_stop = E.action_is_stop(world, state, action)
    new_state = E.step(world, state, action)
    dist_after = world.dist[new_state.node].gather(1, state.goal_local[:, None])[:, 0]
    return new_state, StepRecord(
        node_after=new_state.node,
        view_after=new_state.view_idx,
        moved=alive_before & torch.logical_not(is_stop),
        alive_before=alive_before,
        ce=cross_entropy_per_sample(masked, meta.teacher, E.IGNORE_ID),
        ce_count=(meta.teacher != E.IGNORE_ID).sum(),
        logits=masked,
        log_prob=log_prob,
        entropy=entropy,
        hidden=hidden,
        reward=shaped_reward(is_stop, meta.dist, dist_after, alive_before),
        dist_after=dist_after,
        teacher=meta.teacher,
        action=action,
        progress=(torch.zeros_like(meta.dist) if progress is None else progress),
    )


def frozen_record(world: WorldTables, state: EnvState, like: StepRecord) -> StepRecord:
    """The record of a step after every episode has ended (common.py:
    250-268): zeros shaped as the live record ``like``, but the node and
    view stick, the teacher is IGNORE and ``dist_after`` is the distance
    to the goal now."""
    dist_now = world.dist[state.node].gather(1, state.goal_local[:, None])[:, 0]
    return StepRecord(*(torch.zeros_like(f) for f in like))._replace(
        node_after=state.node, view_after=state.view_idx,
        teacher=torch.full_like(state.node, E.IGNORE_ID),
        dist_after=dist_now.to(like.dist_after.dtype))


def ml_loss_mean_over_alive(steps: StepRecord) -> torch.Tensor:
    """The reference's CrossEntropyLoss(reduction='mean', ignore_index)
    summed over time (common.py:295-299): per step, the mean over the
    non-ignored samples (0 when there are none); in a data-parallel step
    the samples of every rank."""
    return (steps.ce.sum(dim=1) / M.global_sum(steps.ce_count).clamp_min(1).float()).sum()


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
    with span("data.assemble"):
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
