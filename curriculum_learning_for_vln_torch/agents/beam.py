"""Beam search ("dijkstra") over navigation states, and speaker rescoring.

The port of ``curriculum_learning_for_vln_tpu/agents/beam.py`` (ref:
tasks/R2R-judy/src/agent/base.py:183-464): for each episode, expand
(viewpoint, action) states in order of decreasing listener log-prob until
``beam_size`` <end> states are collected, saving each state's decoder
carry; the physical walk between expansions is stitched with an
incremental FloydGraph.  ``beam_rollout`` then rescores every finished
path with the speaker's per-word losses (ref: base.py:399-450).

The host drives the frontier, in the order the JAX package does, and one
decode step runs on the card per iteration over the gathered frontier:
``observe`` in f32, the agent's eval-mode decoder step on its f32
parameters, masked logits, log-softmax and argmax (beam.py:61-111; no
observation or scorer kernel runs).  The search runs under
``torch.inference_mode``, so the encoders run the inference scan K3.

* Children of an expansion share the parent's post-argmax carry (the
  reference updates a_t_prev from the argmax action before it stores the
  running states of all children, base.py:310-350).
* State scores accumulate the log-softmax of the masked logits; <end> is
  the action index ``n_cands``.
* A state's visual feature, the panorama at its parent and the chosen
  candidate's row ``cand_feat[min(j, MC)]``, is a pure gather from the
  world tables, so the port records the (node, view, slot) it was read
  at and ``path_features`` gathers the rows on the card for rescoring,
  instead of copying every iteration's panorama to the host (beam.py:
  233-236, 262): the same f32 values.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..env import env as E
from ..env.env import EnvState
from ..models import decoders as D
from ..models.attention import NEG_INF
from ..models.encoder import encoder_apply
from ..utils.angles import ANGLE_INC, make_angle_feat
from ..utils.floyd import FloydGraph
from ..utils.tokenizer import EOS_IDX, PAD_IDX
from ..world.compiler import CompiledWorld, WorldTables
from .common import chosen_feature

logger = logging.getLogger("main.beam")

START_ACTION = -95  # the reference's start-state marker (base.py:246)
END_ACTION = -1
BEAM_AGENTS = ("ENVDROP", "FOLLOWER", "SELF-MONITOR")


def _make_state(nodes: torch.Tensor, views: torch.Tensor) -> EnvState:
    nodes, views = nodes.long(), views.long()
    return EnvState(
        node=nodes,
        view_idx=views,
        heading=(views % 12).float() * ANGLE_INC,
        elevation=(views // 12 - 1).float() * ANGLE_INC,
        goal=nodes,
        goal_local=torch.zeros_like(nodes),
        ended=torch.zeros_like(nodes, dtype=torch.bool),
    )


def make_beam_decoder(agent, model_state):
    """One decode step over a batch of gathered search states:
    fn(tables, params, ctx, ctx_mask, nodes, views, carry) -> (log_probs
    [B, K], new_carry, pano_feat, cand_feat, argmax_action).  Tables,
    parameters and context are arguments; nothing is kept between calls."""
    name = agent.name
    if name not in BEAM_AGENTS:
        raise NotImplementedError(name)
    drop = agent.cfg.DROP_RATE

    @torch.inference_mode()
    def decode(tables, params, ctx, ctx_mask, nodes, views, carry):
        state = _make_state(nodes, views)
        obs = E.observe(tables, state)
        cand_mask = obs.meta.cand_mask
        if name == "FOLLOWER":
            h, c, a_prev = carry
            logits, (h1, c1), _ = D.follower_decoder_step(
                params["decoder"], obs.pano_feat, a_prev, obs.cand_feat, h, c, ctx, ctx_mask,
                False, drop)
        elif name == "SELF-MONITOR":
            h, c, a_prev = carry
            (logits, _), (h1, c1), _, _ = D.monitor_decoder_step(
                params["decoder"], model_state["decoder_bn"], a_prev, obs.cand_feat, cand_mask,
                h, c, ctx, ctx_mask, False, drop)
        else:
            h, c, h_tilde = carry
            a_t_angle = make_angle_feat(state.heading, state.elevation)
            logits, (h1, c1), h_tilde_new = D.envdrop_decoder_step(
                params["decoder"], a_t_angle, obs.pano_feat, obs.cand_feat, h_tilde, c, ctx,
                ctx_mask, False, drop, agent.cfg.FEAT_DROP_RATE, agent.angle_feat_size)
        masked = torch.where(cand_mask, NEG_INF, logits)
        a_t = torch.argmax(masked, dim=-1)  # the first maximum, as jnp.argmax
        if name == "ENVDROP":
            new_carry = (h1, c1, h_tilde_new)
        else:  # a_t_prev: the argmax candidate's feature (common.py:313-317)
            new_carry = (h1, c1, chosen_feature(obs.cand_feat, a_t))
        return torch.log_softmax(masked, dim=-1), new_carry, obs.pano_feat, obs.cand_feat, a_t

    return decode


@torch.inference_mode()
def path_features(tables: WorldTables, steps, T: int):
    """(img [P, T, 36, F], can [P, T, F]) f32 of P paths' recorded visual
    features (``steps[p]`` a list of (node, view, slot)), zeros past each
    path's length: the panorama at (node, view) and its candidate row
    ``slot``, as the decode step observed them."""
    P = len(steps)
    idx = np.zeros((3, P, T), np.int64)
    valid = np.zeros((P, T), bool)
    for p, feats in enumerate(steps):
        for k, key in enumerate(feats):
            idx[:, p, k] = key
            valid[p, k] = True
    dev = tables.features.device
    node, view, slot = (torch.from_numpy(a.reshape(-1)).to(dev) for a in idx)
    obs = E.observe(tables, _make_state(node, view))
    can = obs.cand_feat.gather(1, slot[:, None, None].expand(-1, 1, obs.cand_feat.shape[-1]))
    keep = torch.from_numpy(valid.reshape(-1)).to(dev)
    img = torch.where(keep[:, None, None], obs.pano_feat, 0.0)
    can = torch.where(keep[:, None], can[:, 0], 0.0)
    return img.reshape(P, T, *img.shape[1:]), can.reshape(P, T, -1)


class BeamSearch:
    """Host-orchestrated best-first search (ref: base.py:183-464)."""

    def __init__(self, agent, world: CompiledWorld, tables: WorldTables, max_iters: int = 500):
        self.agent = agent
        self.world = world
        self.tables = tables
        self.max_iters = max_iters
        self.iterations = 0  # of the last dijkstra

    # -- carry (host) helpers ----------------------------------------------
    def _init_carry(self, h0, c0):
        if self.agent.name in ("FOLLOWER", "SELF-MONITOR"):
            a0 = np.zeros((h0.shape[0], self.agent.action_emb_size), np.float32)
            return (_host(h0), _host(c0), a0)
        return (_host(h0), _host(c0), _host(h0))  # EnvDrop: h_tilde starts as h0

    @torch.inference_mode()
    def dijkstra(self, params, model_state, ep, data, max_candidates: int):
        """Expand best-first; returns reference-format result dicts (ref
        docstring: base.py:185-203), each path's ``visual_feature`` a list
        of the (node, view, slot) its features are read at."""
        agent = self.agent
        world, tables = self.world, self.tables
        B = int(ep.instr_tokens.shape[0])
        device = tables.features.device

        ctx_mask = ep.instr_tokens == PAD_IDX
        ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, False,
                                    agent.cfg.DROP_RATE)
        decode = make_beam_decoder(agent, model_state)

        item_idx = _host(ep.item_idx)
        start_nodes = _host(ep.start_node)
        start_views = 12 + np.mod(np.round(_host(ep.start_heading) / ANGLE_INC).astype(int), 12)
        tokens = _host(ep.instr_tokens)
        carry0 = self._init_carry(h0, c0)

        results = []
        for b in range(B):
            item = data[int(item_idx[b])]
            results.append({
                "scan": item["scan"],
                "instr_id": item["instr_id"],
                "instr_encoding": tokens[b],
                "dijk_path": [world.viewpoint_of(int(start_nodes[b]))],
                "paths": [],
            })

        id2state: List[Dict] = [
            {
                (int(start_nodes[b]), START_ACTION): {
                    "next_node": int(start_nodes[b]),
                    "view": int(start_views[b]),
                    "carry": tuple(x[b] for x in carry0),
                    "location": (int(start_nodes[b]), int(start_views[b])),
                    "from": None,
                    "feature": None,
                    "score": 0.0,
                    "scores": [],
                    "actions": [],
                }
            }
            for b in range(B)
        ]
        visited = [set() for _ in range(B)]
        finished = [set() for _ in range(B)]
        graphs = [FloydGraph() for _ in range(B)]
        ended = np.zeros(B, bool)
        n_parts = len(carry0)
        MC = world.cand_next.shape[1]

        self.iterations = 0
        for _ in range(self.max_iters):
            self.iterations += 1
            # (1) the best unvisited state of each episode (the first in
            # insertion order on a tie, as max() keeps it)
            chosen = []
            for b in range(B):
                if ended[b]:
                    chosen.append(next(iter(id2state[b].items())))
                    continue
                cand = [(sid, st) for sid, st in id2state[b].items() if sid not in visited[b]]
                chosen.append(max(cand, key=lambda kv: kv[1]["score"]))

            # (2) mark visited; terminal bookkeeping
            for b, (sid, st) in enumerate(chosen):
                if not ended[b]:
                    visited[b].add(sid)
                    if sid[1] == END_ACTION:
                        finished[b].add(sid)
                        if len(finished[b]) >= max_candidates:
                            ended[b] = True

            # (3) gather the carries and teleport; (4) Floyd stitch
            nodes = np.array([st["next_node"] for _, st in chosen], np.int64)
            views = np.array([st["view"] for _, st in chosen], np.int64)
            carry = tuple(torch.from_numpy(np.stack([st["carry"][i] for _, st in chosen]))
                          .to(device) for i in range(n_parts))
            for b in range(B):
                node = int(nodes[b])
                vp = world.viewpoint_of(node)
                if not graphs[b].visited(vp):
                    for j in range(int(world.n_cands[node])):
                        nxt = int(world.cand_next[node, j])
                        dis = float(world.dist[node, world.node_local[nxt]])
                        graphs[b].add_edge(vp, world.viewpoint_of(nxt), dis)
                    graphs[b].update(vp)
                results[b]["dijk_path"].extend(
                    graphs[b].path(results[b]["dijk_path"][-1], vp))

            # (5) one decode step for the whole frontier
            logp, new_carry, _, _, _ = decode(
                tables, params, ctx, ctx_mask, torch.from_numpy(nodes).to(device),
                torch.from_numpy(views).to(device), carry)
            logp = _host(logp)
            new_carry = tuple(_host(x) for x in new_carry)

            # (6) expand children
            for b, (sid, st) in enumerate(chosen):
                if sid[1] == END_ACTION or ended[b]:
                    continue
                g = int(nodes[b])
                n = int(world.n_cands[g])
                child_carry = tuple(new_carry[i][b] for i in range(n_parts))
                for j in range(n + 1):
                    new_score = st["score"] + float(logp[b, j])
                    if j < n:
                        nid = (g, j)
                        nxt = int(world.cand_next[g, j])
                        view = int(world.cand_view[g, j])
                    else:
                        nid = (g, END_ACTION)
                        nxt = g
                        view = int(views[b])
                    if nid not in id2state[b] or new_score > id2state[b][nid]["score"]:
                        id2state[b][nid] = {
                            "next_node": nxt,
                            "view": view,
                            "carry": child_carry,
                            "location": (nxt, view),
                            "from": sid,
                            "feature": (g, int(views[b]), min(j, MC)),
                            "score": new_score,
                            "scores": st["scores"] + [float(logp[b, j])],
                            "actions": st["actions"] + [n + 1],
                        }
                if len(visited[b]) == len(id2state[b]):
                    ended[b] = True

            if ended.all():
                break
        else:
            # the expansion budget ran out: name the episodes that did not
            # collect max_candidates finished states (the reference has no
            # iteration cap, base.py:183-397)
            short = [(results[b]["instr_id"], len(finished[b]))
                     for b in range(B) if not ended[b]]
            if short:
                logger.warning(
                    "beam search truncated at max_iters=%d: %d/%d episodes "
                    "short of %d finished paths: %s",
                    self.max_iters, len(short), B, max_candidates, short[:8])

        # (7) close the dijk path back to the start
        for b in range(B):
            results[b]["dijk_path"].extend(
                graphs[b].path(results[b]["dijk_path"][-1], results[b]["dijk_path"][0]))

        # (8) backtrack the finished paths
        for b, result in enumerate(results):
            for sid in finished[b]:
                info = {"trajectory": [], "action": [], "visual_feature": [],
                        "listener_scores": id2state[b][sid]["scores"],
                        "listener_actions": id2state[b][sid]["actions"]}
                cur = sid
                while cur[1] != START_ACTION:
                    st = id2state[b][cur]
                    info["trajectory"].append(self._waypoint(*st["location"]))
                    info["action"].append(cur[1])
                    info["visual_feature"].append(st["feature"])
                    cur = st["from"]
                info["trajectory"].append(self._waypoint(*id2state[b][cur]["location"]))
                for key in ("trajectory", "action", "visual_feature"):
                    info[key] = info[key][::-1]
                result["paths"].append(info)
        return results

    def _waypoint(self, node: int, view: int):
        return (self.world.viewpoint_of(node), (view % 12) * ANGLE_INC,
                (view // 12 - 1) * ANGLE_INC)

    def beam_rollout(self, params, model_state, ep, data, speaker, spk_params,
                     beam_size: int = 30):
        """Dijkstra + speaker rescoring (ref: base.py:399-450).  The time
        axis is padded to a multiple of 8 as in the JAX package: the
        speaker's encoder LSTMs are not packed (its reverse direction reads
        the zero padding), so the padding is part of the scores.  The JAX
        package's row padding (P = max(beam, paths)) only bounds its
        compiles and is left out: rows are independent."""
        results = self.dijkstra(params, model_state, ep, data, beam_size)
        for result in results:
            if not result["paths"]:
                continue
            steps = [p["visual_feature"] for p in result["paths"]]
            lengths = [len(s) for s in steps]
            T = -8 * (-max(max(lengths), 1) // 8)
            num = len(steps)
            insts = np.tile(result["instr_encoding"], (num, 1))
            per_word = self.rescore(speaker, spk_params, steps, lengths, T, insts)
            seq_lengths = np.argmax(insts == EOS_IDX, axis=1)
            for j, p in enumerate(result["paths"]):
                p.pop("visual_feature")
                p["speaker_scores"] = (-per_word[j])[: seq_lengths[j]]
        return results

    @torch.inference_mode()
    def rescore(self, speaker, spk_params, steps, lengths, T: int, insts: np.ndarray):
        """The speaker's per-word losses [P, L - 1] (numpy f32) of one
        episode's P finished paths against its instruction."""
        from .speaker import SpeakerFeatures

        img, can = path_features(self.tables, steps, T)
        dev = img.device
        feats = SpeakerFeatures(img, can, torch.tensor(lengths, dtype=torch.long, device=dev))
        per_word = speaker.teacher_forcing_loss(spk_params, feats,
                                                torch.from_numpy(insts).long().to(dev), False,
                                                for_listener=True)
        return _host(per_word)

    def beam_search(self, params, model_state, henv, data, speaker, spk_params,
                    beam_size: int = 30):
        """Beam search over a whole split, one result per instr_id."""
        out = {}
        for ep in henv.eval_batches():
            valid = _host(ep.valid)
            results = self.beam_rollout(params, model_state, ep, data, speaker, spk_params,
                                        beam_size)
            for b, r in enumerate(results):
                if valid[b] and r["instr_id"] not in out:
                    out[r["instr_id"]] = r
        return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, floats in f32 (bf16 has no numpy
    dtype; the widening is exact)."""
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()
