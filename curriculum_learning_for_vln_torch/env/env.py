"""Pure-functional batched navigation environment on torch tensors.

The port of ``curriculum_learning_for_vln_tpu/env/env.py``: three pure
functions over packed ``WorldTables``, all arrays with a leading batch
dimension and static shapes (candidates padded to MC slots + 1 STOP slot):

    reset(world, episodes)        -> EnvState
    observe(world, state)         -> Observation         (pure gathers)
    step(world, state, action)    -> EnvState            (pure gathers)

``observe_meta`` is the non-feature part of ``observe``; the rollout uses
it with the fused observation kernels (ops/fused_obs.py), which read the
feature rows themselves, and ``observe_feats`` the feature part, which
the unfused decode of back-translation reads.  The teacher is the reference's goal-directed
shortest-path teacher; the JAX package's gt-route waypoint teacher (R4R)
is not ported yet.  Semantics parity notes are keyed to reference lines.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.angles import ANGLE_INC, NUM_VIEWS, make_angle_feat
from ..world.compiler import WorldTables

IGNORE_ID = -1  # matches BasicR2RAgent.ignore_id (ref: base.py:92)


class EpisodeBatch(NamedTuple):
    """Static-shape episode specs (one minibatch), on the device."""

    instr_tokens: torch.Tensor    # [B, L] i64
    instr_len: torch.Tensor       # [B] i64
    start_node: torch.Tensor      # [B] i64 global node id
    start_heading: torch.Tensor   # [B] f32
    goal: torch.Tensor            # [B] i64 global node id
    goal_local: torch.Tensor      # [B] i64 scan-local goal index
    item_idx: torch.Tensor        # [B] i64 dataset index
    valid: torch.Tensor           # [B] bool (False = padding slot)


class EnvState(NamedTuple):
    node: torch.Tensor        # [B] i64
    view_idx: torch.Tensor    # [B] i64 (0..35)
    heading: torch.Tensor     # [B] f32 discretized
    elevation: torch.Tensor   # [B] f32 discretized
    goal: torch.Tensor        # [B] i64
    goal_local: torch.Tensor  # [B] i64
    ended: torch.Tensor       # [B] bool


class ObsMeta(NamedTuple):
    """Everything of an observation except the feature rows."""

    cand_view: torch.Tensor   # [B, MC] i64 view index of each candidate
    cand_valid: torch.Tensor  # [B, MC] bool
    n_cands: torch.Tensor     # [B] i64 (STOP action index)
    cand_angle: torch.Tensor  # [B, MC, 128] heading-relative angle features
    cand_mask: torch.Tensor   # [B, MC+1] bool, True = mask out (beyond stop slot)
    teacher: torch.Tensor     # [B] i64 teacher action index; IGNORE_ID when ended
    dist: torch.Tensor        # [B] f32 geodesic distance to goal


class Observation(NamedTuple):
    pano_feat: torch.Tensor   # [B, 36, D+128]  view features + loc embedding
    cand_feat: torch.Tensor   # [B, MC+1, D+128]  candidate features; STOP slot zeros
    meta: ObsMeta


def _pick(table_rows: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """table_rows[b, col[b]] for a [B, K] table and a [B] index."""
    return table_rows.gather(1, col[:, None])[:, 0]


def reset(world: WorldTables, ep: EpisodeBatch) -> EnvState:
    """Start episodes: heading snapped to the 30-degree grid, elevation 0
    (MatterSim discretized-viewing-angles init; ref: common_env.py:66-70)."""
    # torch.round rounds half to even, as jnp.round does
    h_idx = torch.remainder(torch.round(ep.start_heading / ANGLE_INC).long(), 12)
    return EnvState(
        node=ep.start_node,
        view_idx=12 + h_idx,
        heading=h_idx.float() * ANGLE_INC,
        elevation=torch.zeros_like(ep.start_heading),
        goal=ep.goal,
        goal_local=ep.goal_local,
        ended=torch.logical_not(ep.valid),  # padding slots are born ended
    )


def observe_meta(world: WorldTables, state: EnvState,
                 compute_dtype=torch.float32) -> ObsMeta:
    """Candidate metadata, teacher, masks and distance for the current
    states (common_env.py:281-296 candidate angles; base.py:159-178
    teacher)."""
    node = state.node
    c_next = world.cand_next[node]         # [B, MC]
    c_valid = world.cand_valid[node]
    c_view = world.cand_view[node]
    n = world.n_cands[node]                # [B]
    base_heading = (state.view_idx % 12).float() * ANGLE_INC
    rel_h = world.cand_heading[node] - base_heading[:, None]
    angle = make_angle_feat(rel_h, world.cand_elev[node]).to(compute_dtype)  # [B, MC, 128]

    MC = c_view.shape[1]
    slot = torch.arange(MC + 1, device=node.device)[None, :]
    cand_mask = slot > n[:, None]
    teacher_next = _pick(world.next_hop[node], state.goal_local)
    match = (c_next == teacher_next[:, None]) & c_valid
    # first matching slot (0 when none), as jnp.argmax over a bool row
    teacher_move = match.to(torch.int8).argmax(dim=1)
    teacher = torch.where(teacher_next == node, n, teacher_move)
    teacher = torch.where(state.ended, torch.full_like(teacher, IGNORE_ID), teacher)
    dist = _pick(world.dist[node], state.goal_local)
    return ObsMeta(c_view, c_valid, n, angle, cand_mask, teacher, dist)


def assemble_cand_feat(cand_img: torch.Tensor, angle: torch.Tensor,
                       c_valid: torch.Tensor) -> torch.Tensor:
    """Candidate features from raw per-candidate view rows + angle feats,
    exactly as ``observe`` builds them (zeroed invalid slots, zero STOP
    slot appended)."""
    dtype = torch.promote_types(cand_img.dtype, angle.dtype)
    core = torch.cat([cand_img.to(dtype), angle.to(dtype)], dim=-1)
    core = torch.where(c_valid[:, :, None], core, torch.zeros((), dtype=dtype, device=core.device))
    B, _, F = core.shape
    return torch.cat([core, core.new_zeros((B, 1, F))], dim=1)


def observe_feats(world: WorldTables, state: EnvState, meta: ObsMeta,
                  compute_dtype=torch.float32):
    """(pano_feat [B, 36, D+128], cand_feat [B, MC+1, D+128]) of the current
    states in ``compute_dtype``, the candidates' angle features taken from
    ``meta``: the feature part of ``observe``."""
    feats = world.features[state.node][:, :NUM_VIEWS].to(compute_dtype)   # [B, 36, D]
    loc_emb = world.loc_embed[state.view_idx].to(compute_dtype)            # [B, 36, 128]
    dtype = torch.promote_types(feats.dtype, loc_emb.dtype)
    pano = torch.cat([feats.to(dtype), loc_emb.to(dtype)], dim=-1)
    D = feats.shape[-1]
    cand_img = feats.gather(1, meta.cand_view[:, :, None].expand(-1, -1, D))  # [B, MC, D]
    return pano, assemble_cand_feat(cand_img, meta.cand_angle, meta.cand_valid)


def observe(world: WorldTables, state: EnvState, compute_dtype=torch.float32) -> Observation:
    """The full observation with plain gathers (the unfused reference for
    the observation kernel):

    * pano_feat  = features ++ loc-embedding-for-current-view
                   (common_env.py:309, misc.py:316-317)
    * cand_feat  = per-candidate view feature ++ angle feature of
      (normalized_heading - base_heading, loc_elevation)
                   (common_env.py:281-296)
    """
    meta = observe_meta(world, state, compute_dtype)
    pano, cand_feat = observe_feats(world, state, meta, compute_dtype)
    return Observation(pano_feat=pano, cand_feat=cand_feat, meta=meta)


def step(world: WorldTables, state: EnvState, action: torch.Tensor) -> EnvState:
    """Apply a panoramic action.

    ``action`` in [0, MC] indexes candidate slots; the STOP index
    (== n_cands), IGNORE_ID, or an already-ended episode leaves the agent
    in place and marks it ended — the reference's "-1 means <end>"
    conversion (follower.py:141-146) plus makeActions' skip
    (common_env.py:97-98).  Moving lands the agent at the candidate node
    facing the candidate's view (misc.py:366-390 turn-then-forward)."""
    node = state.node
    is_stop = action_is_stop(world, state, action)
    a = action.clamp(0, world.max_candidates - 1)
    next_node = _pick(world.cand_next[node], a)
    next_view = _pick(world.cand_view[node], a)

    move = torch.logical_not(is_stop)
    new_view = torch.where(move, next_view, state.view_idx)
    new_heading = (new_view % 12).float() * ANGLE_INC
    new_elev = (new_view // 12 - 1).float() * ANGLE_INC
    return EnvState(
        node=torch.where(move, next_node, node),
        view_idx=new_view,
        heading=torch.where(move, new_heading, state.heading),
        elevation=torch.where(move, new_elev, state.elevation),
        goal=state.goal,
        goal_local=state.goal_local,
        ended=state.ended | is_stop,
    )


def action_is_stop(world: WorldTables, state: EnvState, action: torch.Tensor) -> torch.Tensor:
    """Whether an action resolves to STOP for the current state (before step)."""
    n = world.n_cands[state.node]
    return (action >= n) | (action < 0) | state.ended
