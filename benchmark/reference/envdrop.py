"""EnvDrop's SPCL training iteration, in plain float32 PyTorch.

The agent of Tan et al. (NAACL 2019) trained as the CL paper's recipe
runs it on CLR2R: per iteration an imitation rollout of the first batch,
teacher-forced for as many steps as its longest path needs (the
smallest bucket of 8 or 16 that holds hops + 1, else the horizon), and a
sampled A2C rollout over a pool of ``packed`` batches on ``batch`` slots:
a slot whose episode ends takes the pool's next episode at once, the
returns restart at each episode's end, and only a slot's last, cut-off
episode bootstraps from the critic.  The loss is w_il . (IL cross-
entropy summed over steps * ML_WEIGHT / B) + w_pool . (each pool
episode's A2C terms over the alive slot-steps of all slots), with SPCL's
per-item weights; one backward, the encoder's and the decoder's
gradients each clipped to a global norm of 40, and RMSprop (decay 0.99,
eps inside the root).

Dropout masks and the sampling noise are drawn from the run's generator
in the program's order; the env-dropout of the observation step is the
Philox mask of per-sample seeds drawn from it.  The sampled actions are
the program's, given in ``actions``, and each is judged against the
best noisy logit here: the widest gap below it, and the share of actions
that are not it, over the slots still running.  With
``actions`` None the sampling is this reference's own (the control).
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from .nets import NEG_INF, Draws, attend, dense, encoder, keep_drop, lstm_cell, mm
from .world import ANGLE_INC, angle_feat

IGNORE = -1


class Episodes(NamedTuple):
    tokens: torch.Tensor      # [B, L]
    lengths: torch.Tensor     # [B]
    start: torch.Tensor       # [B] global panorama
    heading: torch.Tensor     # [B] f32
    goal_local: torch.Tensor  # [B] the goal within its scan


class State(NamedTuple):
    node: torch.Tensor
    view: torch.Tensor
    heading: torch.Tensor
    elevation: torch.Tensor
    goal_local: torch.Tensor
    ended: torch.Tensor


def reset(ep: Episodes) -> State:
    """The start: heading snapped to the 30-degree grid, elevation 0."""
    h = torch.remainder(torch.round(ep.heading / ANGLE_INC).long(), 12)
    return State(ep.start, 12 + h, h.float() * ANGLE_INC, torch.zeros_like(ep.heading),
                 ep.goal_local, torch.zeros_like(ep.start, dtype=torch.bool))


def candidates(tab: dict, st: State):
    """(cand view [B, MC], valid, count, angle features [B, MC, 128],
    mask [B, MC + 1] of slots past the STOP slot, teacher action, distance
    to the goal)."""
    node = st.node
    c_next, valid, n = tab["cand_next"][node], tab["cand_valid"][node], tab["n_cands"][node]
    base = (st.view % 12).float() * ANGLE_INC
    ang = angle_feat(tab["cand_heading"][node] - base[:, None], tab["cand_elev"][node])
    MC = c_next.shape[1]
    mask = torch.arange(MC + 1, device=node.device)[None, :] > n[:, None]
    nxt = tab["next_hop"][node].gather(1, st.goal_local[:, None])[:, 0]
    match = (c_next == nxt[:, None]) & valid
    first = torch.where(match, torch.arange(MC, device=node.device)[None, :], MC).min(1).values
    teacher = torch.where(nxt == node, n, torch.where(first < MC, first, 0))
    teacher = torch.where(st.ended, IGNORE, teacher)
    dist = tab["dist"][node].gather(1, st.goal_local[:, None])[:, 0]
    return tab["cand_view"][node], valid, n, ang, mask, teacher, dist


def step(tab: dict, st: State, action: torch.Tensor):
    """(new state, STOP taken): STOP, an ignored action or an ended episode
    stays and ends; a move lands at the candidate facing its view."""
    n = tab["n_cands"][st.node]
    stop = (action >= n) | (action < 0) | st.ended
    a = action.clamp(0, tab["cand_next"].shape[1] - 1)[:, None]
    node = torch.where(stop, st.node, tab["cand_next"][st.node].gather(1, a)[:, 0])
    view = torch.where(stop, st.view, tab["cand_view"][st.node].gather(1, a)[:, 0])
    heading = torch.where(stop, st.heading, (view % 12).float() * ANGLE_INC)
    elev = torch.where(stop, st.elevation, (view // 12 - 1).float() * ANGLE_INC)
    return State(node, view, heading, elev, st.goal_local, st.ended | stop), stop


def reward(stop, dist_before, dist_after, alive):
    """+-2 for a STOP within / beyond 3 m of the goal, else the sign of the
    distance gained; 0 once ended."""
    term = (2.0 * (dist_after < 3.0).float() - 1.0) * 2.0
    return torch.where(stop, term, torch.sign(dist_before - dist_after)) * alive.float()


class Agent:
    """The agent's step over the world ``tab`` and the bf16 feature table
    ``features`` [N, 36, D] (read in f32), with precision ``q``."""

    def __init__(self, m: dict, tab: dict, features: torch.Tensor, q):
        self.m, self.tab, self.features, self.q = m, tab, features, q

    def decode(self, p: dict, mc, ctx, ctx_mask, st: State, draws: Draws):
        """One decoder step: logits [B, MC + 1], carry (h, c, h_tilde), h."""
        m, q, B = self.m, self.q, st.node.shape[0]
        rate, keep = m["DROP_RATE"], 1.0 - m["FEAT_DROP_RATE"]
        _h, c, h_tilde = mc
        c_view, valid, _n, ang, _mask, _t, _d = candidates(self.tab, st)
        tv = mm(h_tilde * (draws.rand((B, h_tilde.shape[1])) < 1 - rate) / (1 - rate),
                p["visual_attn"]["linear_in"]["w"], q)
        pano_seeds = draws.seeds(B)
        feats = q(self.features[st.node].float())                       # [B, 36, D]
        pano = torch.cat([keep_drop(feats, pano_seeds, keep), self.tab["loc_embed"][st.view]], -1)
        vis, _ = attend(tv, pano, None)
        cand_seeds = draws.seeds(B)
        cand_img = feats.gather(1, c_view[:, :, None].expand(-1, -1, feats.shape[2]))
        a_angle = angle_feat(st.heading, st.elevation)
        act = torch.tanh(dense(p["act_embed"], a_angle, q))
        act = act * (draws.rand(act.shape) < 1 - rate) / (1 - rate)
        h1, c1 = lstm_cell(p["lstm"], torch.cat([act, vis], -1), h_tilde, c, q)
        h1d = h1 * (draws.rand(h1.shape) < 1 - rate) / (1 - rate)
        weighted, _ = attend(mm(h1d, p["text_attn"]["linear_in"]["w"], q), ctx, ctx_mask)
        h_t = torch.tanh(mm(torch.cat([weighted, h1d], -1), p["text_attn"]["linear_out"]["w"], q))
        qv = mm(h_t * (draws.rand(h_t.shape) < 1 - rate) / (1 - rate), p["cand_attn"]["w"], q)
        rows = torch.cat([keep_drop(cand_img, cand_seeds, keep), ang], -1)
        s = torch.where(valid, torch.einsum("bkf,bf->bk", rows, qv), 0.0)
        return torch.cat([s, s.new_zeros((B, 1))], 1), (h1, c1, h_t), h1

    def critic(self, p: dict, x: torch.Tensor, draws: Draws) -> torch.Tensor:
        y = torch.relu(dense(p["fc1"], x, self.q))
        y = y * (draws.rand(y.shape) < 1 - self.m["DROP_RATE"]) / (1 - self.m["DROP_RATE"])
        return dense(p["fc2"], y, self.q)[..., 0]


def policy(masked: torch.Tensor, action: torch.Tensor):
    logp = torch.log_softmax(masked, -1)
    probs = logp.exp()
    ent = -(probs * torch.where(probs > 0, logp, 0.0)).sum(-1)
    return logp.gather(1, action.clamp(0, masked.shape[1] - 1)[:, None])[:, 0], ent


def il_length(hops_max: int, buckets, horizon: int) -> int:
    for b in sorted(buckets):
        if hops_max + 1 <= b < horizon:
            return b
    return horizon


def gather(ep: Episodes, ids: torch.Tensor) -> Episodes:
    return Episodes(*(f[ids] for f in ep))


class Iteration(NamedTuple):
    loss: torch.Tensor
    actions: torch.Tensor     # [T, B] the sampled actions taken
    action_gap: float         # widest gap of a given action below the best
    mismatch: float           # share of given actions that are not the best here
    episodes_done: int


def iteration(agent: Agent, p: dict, ep: Episodes, pool: Episodes, w_il, w_pool, il_len: int,
              draws: Draws, actions: Optional[torch.Tensor]) -> Iteration:
    """One iteration's loss (the graph kept for the backward)."""
    m, tab = agent.m, agent.tab
    B, rate = ep.tokens.shape[0], m["DROP_RATE"]
    enc, dec, crit = p["encoder"], p["decoder"], p["critic"]
    # imitation, teacher-forced
    ctx, h0, c0 = encoder(enc, ep.tokens, ep.lengths, rate, draws, agent.q)
    ctx_mask = ep.tokens == 0
    st, mc = reset(ep), (h0, c0, h0)
    ce_sum = ctx.new_zeros(B)
    for _ in range(il_len):
        _v, _valid, _n, _a, cmask, teacher, _d = candidates(tab, st)
        logits, mc, _h = agent.decode(dec, mc, ctx, ctx_mask, st, draws)
        logp = torch.log_softmax(torch.where(cmask, NEG_INF, logits), -1)
        picked = logp.gather(1, teacher.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
        ce_sum = ce_sum + torch.where(teacher == IGNORE, 0.0, -picked)
        st, _ = step(tab, st, teacher)
    ml_vec = ce_sum * m["ML_WEIGHT"] / B
    # the packed A2C rollout over the pool
    N, T = pool.tokens.shape[0], m["MAX_EPISODE_LEN"]
    ctx_p, h0_p, c0_p = encoder(enc, pool.tokens, pool.lengths, rate, draws, agent.q)
    mask_p = pool.tokens == 0
    ids = torch.arange(B, device=ctx.device)
    st = reset(gather(pool, ids))
    mc = (h0_p[ids], c0_p[ids], h0_p[ids])
    ptr = B
    rec, taken, gap, mismatched, decided = [], [], 0.0, 0, 0
    for t in range(T):
        _v, _valid, _n, _a, cmask, _teacher, dist = candidates(tab, st)
        logits, mc2, h1 = agent.decode(dec, mc, ctx_p[ids], mask_p[ids], st, draws)
        masked = torch.where(cmask, NEG_INF, logits)
        u = draws.rand(masked.shape).clamp_min(torch.finfo(torch.float32).tiny)
        noisy = masked.detach() + (-torch.log(-torch.log(u)))
        alive = ~st.ended
        if actions is None:
            action = noisy.argmax(-1)
        else:
            action = actions[t]
            below = noisy.max(-1).values - noisy.gather(1, action[:, None])[:, 0]
            gap = max(gap, float(torch.where(alive, below, 0.0).max()))
            mismatched += int((alive & (action != noisy.argmax(-1))).sum())
            decided += int(alive.sum())
        taken.append(action)
        logp, ent = policy(masked, action)
        new, stop = step(tab, st, action)
        dist_after = tab["dist"][new.node].gather(1, st.goal_local[:, None])[:, 0]
        rec.append((ids, alive, new.ended & alive, reward(stop, dist, dist_after, alive), logp,
                    ent, h1))
        want = new.ended
        nxt = ptr + torch.cumsum(want.long(), 0) - 1
        can = want & (nxt < N)
        ids = torch.where(can, nxt, ids)
        fresh = reset(gather(pool, ids))
        st = State(*(torch.where(can, a, b) for a, b in zip(fresh, new)))
        h2, c2, ht2 = mc2
        sel = can[:, None]
        mc = (torch.where(sel, h0_p[ids], h2), torch.where(sel, c0_p[ids], c2),
              torch.where(sel, h0_p[ids], ht2))
        ptr += int(can.sum())
    with torch.no_grad():  # the bootstrap of the slots still running
        last_h = agent.decode(dec, mc, ctx_p[ids], mask_p[ids], st, draws)[2]
        last_v = agent.critic(crit, last_h, draws)
    hidden = torch.stack([r[6] for r in rec])
    values = agent.critic(crit, hidden.flip(0), draws)
    disc = (~st.ended).float() * last_v
    terms = [None] * T
    for i in range(T):
        t = T - 1 - i
        slot_ep, alive, ended_now, rew, logp, ent, _ = rec[t]
        disc = torch.where(ended_now, 0.0, disc) * m["GAMMA"] + rew
        r, v = disc.detach(), values[i]
        a = alive.float()
        terms[t] = (-logp * (r - v).detach() + 0.5 * (r - v) ** 2 - 0.01 * ent) * a
    alive_total = torch.stack([r[1] for r in rec]).float().sum().clamp_min(1.0)
    per_ep = ctx.new_zeros(N)
    for t in range(T):
        per_ep = per_ep.index_add(0, rec[t][0], terms[t] / alive_total)
    loss = torch.dot(w_il, ml_vec) + torch.dot(w_pool, per_ep)
    done = int(sum(int(r[2].sum()) for r in rec))
    return Iteration(loss, torch.stack(taken), gap, mismatched / max(decided, 1), done)


def clip_(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    for g in grads:
        g.mul_(torch.clamp(max_norm / (norm + 1e-6), max=1.0))


def leaves(tree, path=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{path}/{i}")]
    return [(path, tree)]


class Run(NamedTuple):
    losses: List[float]
    action_gaps: List[float]  # each iteration's widest gap
    mismatches: List[float]   # each iteration's share of actions not the best here
    grad_norms: dict          # leaf -> norm of the first step's clipped gradient
    change_norms: dict        # leaf -> norm of the change after the steps
    actions: List[torch.Tensor]
    action_gap: float
    episodes_done: List[int]


def train(agent: Agent, p0: dict, batches, draws: Draws, lr: float, actions=None,
          nu0: Optional[dict] = None) -> Run:
    """The iterations of ``batches`` ((ep, pool, w_il, w_pool, il_len) each)
    from the parameters ``p0`` (in f32) and RMSprop's state ``nu0`` (leaf
    name -> tensor; zero where None)."""
    p = {k: v for k, v in _copy(p0).items()}
    named = leaves(p)
    for _, t in named:
        t.requires_grad_(True)
    nu = {name: (torch.zeros_like(t) if nu0 is None else nu0[name].detach().clone().float())
          for name, t in named}
    losses, acts, done, gaps, mismatches, grad_norms = [], [], [], [], [], {}
    for i, (ep, pool, w_il, w_pool, il_len) in enumerate(batches):
        it = iteration(agent, p, ep, pool, w_il, w_pool, il_len, draws,
                       None if actions is None else actions[i])
        for _, t in named:
            t.grad = None
        it.loss.backward()
        for key in ("encoder", "decoder"):
            clip_([t.grad for _, t in leaves(p[key]) if t.grad is not None], 40.0)
        with torch.no_grad():
            for name, t in named:
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                if i == 0:
                    grad_norms[name] = float(g.norm())
                nu[name].mul_(0.99).addcmul_(g, g, value=0.01)
                t.sub_(lr * g * torch.rsqrt(nu[name] + 1e-8))
        losses.append(float(it.loss.detach()))
        acts.append(it.actions)
        done.append(it.episodes_done)
        gaps.append(it.action_gap)
        mismatches.append(it.mismatch)
    p0_named = dict(leaves(p0))
    change = {name: float((t.detach() - p0_named[name]).norm()) for name, t in named}
    return Run(losses, gaps, mismatches, grad_norms, change, acts, max(gaps, default=0.0), done)


def replace_leaves(tree, values: list):
    """``tree`` with its leaves, in ``leaves``' order, replaced by ``values``."""
    it = iter(values)

    def go(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)

    out = go(tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def _copy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone().float()


def episodes_of(data: dict, paths: list, tab: dict, idx, device) -> Episodes:
    """The episodes of dataset rows ``idx``."""
    start = [tab["id"][(paths[p]["scan"], paths[p]["path"][0])] for p in data["path"][idx]]
    goal = [tab["id"][(paths[p]["scan"], paths[p]["path"][-1])] for p in data["path"][idx]]
    heading = [paths[p]["heading"] for p in data["path"][idx]]

    def t(a, dtype):
        return torch.tensor(a, dtype=dtype, device=device)

    goal_t = t(goal, torch.int64)
    return Episodes(torch.from_numpy(data["tokens"][idx]).to(device),
                    torch.from_numpy(data["lengths"][idx]).to(device), t(start, torch.int64),
                    t(heading, torch.float32), tab["node_local"][goal_t])


def relative_gap(got: float, want: float, floor: float) -> float:
    return abs(got - want) / max(abs(want), floor)


def worst_leaf_gap(got: dict, want: dict, exclude=()) -> tuple:
    """(worst gap, its leaf) of per-leaf norms: |got - want| over the
    larger of want's norm of that leaf and of the median leaf."""
    names = [k for k in want if k not in exclude]
    med = sorted(want[k] for k in names)[len(names) // 2] if names else 0.0
    worst = max(((relative_gap(got[k], want[k], med), k) for k in names), default=(0.0, ""))
    return worst if not math.isnan(worst[0]) else (math.inf, worst[1])
