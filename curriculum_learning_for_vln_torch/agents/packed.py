"""Packed RL rollouts: continuous batching over an episode pool.

The port of ``curriculum_learning_for_vln_tpu/agents/packed.py``.  A
sampled rollout pays a full model step for every slot until the horizon,
though most episodes stop long before it; here, when a slot's episode
ends, the slot restarts at once on the next episode of a pool of N =
factor * B episodes, so one rollout of B slots completes up to N
episodes:

* the pool is encoded once (K1 at B = N); each step gathers the [B] active
  rows of the [N, L, H] context by the slot -> episode index;
* ended slots are refilled by a cumsum slot assignment and [B]-row
  gathers and selects — static shapes, and the pool pointer stays on the
  device, so the Python step loop never waits for the card;
* A2C returns segment by episode: the reverse-time discount resets at each
  episode's terminal step, and only each slot's final (possibly truncated)
  segment bootstraps from the critic.  With N == B this is the unpacked
  ``EnvDropAgent.rollout`` A2C.

A deliberate deviation from the reference's fixed-batch iteration, kept
from the JAX package: the shipped EnvDrop configs set ``TPU.PACKED_RL: 3``.
With the early exit on (``TPU.SCAN_EARLY_EXIT``, packed.py:145-161), once
the pool is spent and every slot has ended, the steps left are frozen as
in ``common.rollout_scan``: no model step, the record zeros but the slots'
episodes, the carry kept, the last live step's draws made and dropped.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..env import env as E
from ..env.env import EnvState, EpisodeBatch
from ..models.attention import NEG_INF
from ..parallel import mesh as M
from ..utils.profiling import span
from ..world.compiler import WorldTables
from . import common as C


class PackedStep(NamedTuple):
    """Stacked [T, B] records of the packed rollout (what A2C needs)."""

    slot_ep: torch.Tensor       # [T, B] i64 pool episode active at this step
    alive_before: torch.Tensor  # [T, B] bool
    ended_now: torch.Tensor     # [T, B] bool — the episode's terminal step
    reward: torch.Tensor        # [T, B] f32 shaped reward (alive-masked)
    log_prob: torch.Tensor      # [T, B]
    entropy: torch.Tensor       # [T, B]
    hidden: torch.Tensor        # [T, B, H] decoder hidden (critic input)


class PackedResult(NamedTuple):
    """``episodes_started`` and ``episodes_done`` count every rank's slots."""

    steps: PackedStep
    final_state: EnvState
    final_carry: tuple              # decoder carry (h, c, h_tilde)
    final_slot_ep: torch.Tensor     # [B]
    episodes_started: torch.Tensor  # scalar i64 (<= N)
    episodes_done: torch.Tensor     # scalar i64


class PackedLosses(NamedTuple):
    """As EnvDropLosses: in a data-parallel step each scalar but the
    episode counts is this rank's part of the global one."""

    rl_loss: torch.Tensor              # scalar (normalized per RL_NORMALIZE)
    rl_loss_per_episode: torch.Tensor  # [N] pool-episode attribution (SPCL)
    entropy_sum: torch.Tensor
    critic_loss_sum: torch.Tensor
    total_actions: torch.Tensor
    episodes_started: torch.Tensor
    episodes_done: torch.Tensor


def _sel(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row select with trailing-dim broadcast ([B] flag over [B, ...])."""
    return torch.where(flag.reshape(flag.shape + (1,) * (a.dim() - 1)), a, b)


def gather_episodes(pool: EpisodeBatch, ids: torch.Tensor) -> EpisodeBatch:
    return EpisodeBatch(*(field[ids] for field in pool))


# decode(model_carry, ctx, ctx_mask, meta, state) -> (logits, new_carry, hidden)
DecodeFn = Callable


def packed_rollout_scan(world: WorldTables, pool: EpisodeBatch, ctx_pool: torch.Tensor,
                        ctx_mask_pool: torch.Tensor, h0_pool: torch.Tensor,
                        c0_pool: torch.Tensor, decode: DecodeFn, batch_size: int,
                        episode_len: int, compute_dtype=torch.float32,
                        generator: Optional[torch.Generator] = None) -> PackedResult:
    """Run ``episode_len`` sampled steps over ``batch_size`` slots, refilling
    ended slots from ``pool`` (N episodes, all valid: the trainers check it
    once, engine.loop.check_pool_valid) until it is exhausted.

    In a data-parallel step the pool is the global one on every rank, the
    slots are the global slots, and a rank runs its ``batch_size`` of them
    (slots r * B ...): the refill's cumsum runs over every rank's ended
    flags in global slot order (an all-gather of a [B] flag a step), so
    the pointer and the counts are one process's."""
    with span("rollout.packed"):
        N, B = ctx_pool.shape[0], batch_size
        mesh = M.step_mesh()
        first = mesh.data_index * B if mesh is not None else 0
        ids = torch.arange(first, first + B, device=ctx_pool.device)
        state = E.reset(world, gather_episodes(pool, ids))
        # h_tilde starts at h (ref: envdrop.py:150)
        mc = (h0_pool[ids], c0_pool[ids], h0_pool[ids])
        next_ptr = torch.tensor(M.global_rows(B), device=ctx_pool.device)
        records = []
        exit_ = C.EarlyExit()
        for _ in range(episode_len):
            if exit_.dead(state.ended):
                exit_.skip()
                with span("rollout.env"):
                    records.append(PackedStep(*(torch.zeros_like(f) for f in records[-1]))
                                   ._replace(slot_ep=ids))
                continue
            with span("rollout.observe"):
                meta = E.observe_meta(world, state, compute_dtype)
            with span("rollout.decode"), exit_.live():
                logits, mc2, h1 = decode(mc, ctx_pool[ids], ctx_mask_pool[ids], meta, state)
                masked = torch.where(meta.cand_mask, NEG_INF, logits)
                action, log_prob, entropy = C.select_action(C.FEEDBACK_SAMPLE, masked,
                                                            meta.teacher, generator)
            with span("rollout.env"):
                alive_before = torch.logical_not(state.ended)
                is_stop = E.action_is_stop(world, state, action)
                new_state = E.step(world, state, action)
                dist_after = world.dist[new_state.node].gather(1, state.goal_local[:, None])[:, 0]
                records.append(PackedStep(
                    slot_ep=ids, alive_before=alive_before,
                    ended_now=new_state.ended & alive_before,
                    reward=C.shaped_reward(is_stop, meta.dist, dist_after, alive_before),
                    log_prob=log_prob, entropy=entropy, hidden=h1))

            # refill the ended slots from the pool, in global slot order
            with span("rollout.refill"):
                want = M.gather_rows(new_state.ended)
                cand_all = next_ptr + torch.cumsum(want.long(), 0) - 1
                can_all = want & (cand_all < N)
                can = can_all[first: first + B]
                ids = torch.where(can, cand_all[first: first + B], ids)
                fresh = E.reset(world, gather_episodes(pool, ids))
                state = EnvState(*(_sel(can, a, b) for a, b in zip(fresh, new_state)))
                h2, c2, ht2 = mc2
                mc = (_sel(can, h0_pool[ids], h2), _sel(can, c0_pool[ids], c2),
                      _sel(can, h0_pool[ids], ht2))
                next_ptr = next_ptr + can_all.sum()
        steps = PackedStep(*(torch.stack(field) for field in zip(*records)))
        return PackedResult(steps=steps, final_state=state, final_carry=mc, final_slot_ep=ids,
                            episodes_started=next_ptr,
                            episodes_done=M.global_sum(steps.ended_now.sum()))


def packed_a2c(result: PackedResult, values: torch.Tensor, last_value: torch.Tensor,
               gamma: float, rl_normalize: str, num_episodes: int) -> PackedLosses:
    """A2C over the packed records, ``values`` [T, B] in reverse time order
    and ``last_value`` [B] the bootstrap of slots alive at the end: the
    recurrence of ``EnvDropAgent.rollout``'s tail (ref: envdrop.py:222-264)
    with the discount reset to 0 at each episode's terminal step."""
    steps = result.steps
    T, B = steps.reward.shape
    alive = steps.alive_before.float()
    discount = torch.logical_not(result.final_state.ended).float() * last_value.float()
    rl_vecs = [None] * T
    critic_loss_sum = discount.new_zeros(())
    for i in range(T):
        t = T - 1 - i
        discount = torch.where(steps.ended_now[t], 0.0, discount)
        discount = discount * gamma + steps.reward[t]
        r_ = discount.detach()
        v_ = values[i].float()
        a_ = (r_ - v_).detach()
        mask = alive[t]
        rl_vecs[t] = (-steps.log_prob[t] * a_ * mask + 0.5 * (r_ - v_) ** 2 * mask
                      - 0.01 * steps.entropy[t] * mask)  # packed is always sampled
        critic_loss_sum = critic_loss_sum + (((r_ - v_) ** 2) * mask).sum()
    rl = torch.stack(rl_vecs)  # [T, B]
    if rl_normalize == "total":  # over every rank's slots in a data-parallel step
        rl = rl / M.global_sum(alive.sum()).clamp_min(1.0)
    elif rl_normalize == "batch":
        rl = rl / M.global_rows(B)
    # pool-episode attribution: each step's loss onto its episode
    per_episode = rl.new_zeros(num_episodes).index_add(0, steps.slot_ep.reshape(-1),
                                                       rl.reshape(-1))
    return PackedLosses(rl_loss=rl.sum(), rl_loss_per_episode=per_episode,
                        entropy_sum=(steps.entropy * alive).sum(),
                        critic_loss_sum=critic_loss_sum, total_actions=alive.sum(),
                        episodes_started=result.episodes_started,
                        episodes_done=result.episodes_done)
