"""The Self-Monitoring agent's served rollout, in plain float32 PyTorch.

Ma et al. (ICLR 2019), as the reference repository's MonitorDecoder has
it: a unidirectional LSTM encoder; per step the candidates' features
[view row; angle] (zero for invalid slots and the STOP slot) through the
BN-MLP (BatchNorm on the running statistics, Linear, BatchNorm, ReLU),
the previous action's row through the same MLP, positional encoding of
the context, text attention and candidate attention from the previous h,
the LSTM over [previous action; attended candidates; attended text], the
policy logits of the projected candidates against W [text; h1], and the
progress head tanh(W [text weights; sigmoid(W [h; cands]) * tanh(c1)]).

``judge`` follows the program's own trajectories (the viewpoints it
returned) and reads, at every step an episode is alive, the gap by which
the program's action's logit lies below the best logit here.  With a
``control`` precision it also reads the gap of the action the control
puts first, on the same steps.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .envdrop import Episodes, State, candidates, reset, step
from .nets import NEG_INF, attend, dense, encoder, lstm_cell, masked_softmax

EPS = 1e-5


def bn(params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    return (x - state["mean"]) * torch.rsqrt(state["var"] + EPS) * params["scale"] + params["bias"]


def mlp(p: dict, s: dict, x: torch.Tensor, q) -> torch.Tensor:
    x = bn(p["bn_in"], s["bn_in"], x)
    for lp, bp, bs in zip(p["layers"], p["bn_layers"], s["bns"]):
        x = torch.relu(bn(bp, bs, dense(lp, x, q)))
    return x


class Monitor:
    def __init__(self, tab: dict, features: torch.Tensor, q):
        self.tab, self.features, self.q = tab, features, q

    def start(self, p: dict, tokens, lengths, ep_state: State):
        ctx, h0, c0 = encoder(p["encoder"], tokens, lengths, 0.0, None, self.q)
        return ctx, (h0, c0, ctx.new_zeros((tokens.shape[0], self.features.shape[2] + 128)))

    def step(self, p: dict, bn_state: dict, carry, ctx, ctx_mask, st: State):
        """(masked logits [B, MC + 1], progress [B], candidate rows, (h1, c1))."""
        dec, q = p["decoder"], self.q
        h, c, a_prev = carry
        c_view, valid, _n, ang, cmask, _t, _d = candidates(self.tab, st)
        rows = self.features[st.node[:, None], c_view].float()
        core = torch.where(valid[:, :, None], torch.cat([q(rows), ang], -1), 0.0)
        cand = torch.cat([core, core.new_zeros((core.shape[0], 1, core.shape[2]))], 1)
        B, K, F = cand.shape
        s = bn_state["decoder_bn"]["mlp"]
        proj_prev = mlp(dec["proj_navigable_mlp"], s, a_prev, q)
        proj = mlp(dec["proj_navigable_mlp"], s, cand.reshape(B * K, F), q).reshape(B, K, -1)
        proj = proj * (~cmask).float()[:, :, None]
        pos = ctx + dec["pe"][None, :ctx.shape[1]]
        w_ctx, ctx_attn = attend(dense(dec["text_attn"]["linear_in"], h, q), pos, ctx_mask)
        target = dense(dec["visual_attn"]["linear_in_h"], h, q)
        attn = masked_softmax(torch.einsum("bkd,bd->bk", proj, target), cmask)
        w_cand = torch.einsum("bk,bkd->bd", attn, proj)
        h1, c1 = lstm_cell(dec["lstm"], torch.cat([proj_prev, w_cand, w_ctx], -1), h, c, q)
        h_tilde = dense(dec["action_linear"], torch.cat([w_ctx, h1], -1), q)
        logits = torch.where(cmask, NEG_INF, torch.einsum("bkd,bd->bk", proj, h_tilde))
        gate = torch.sigmoid(dense(dec["monitor_linear"], torch.cat([h, w_cand], -1), q))
        h_pm = gate * torch.tanh(c1)
        progress = torch.tanh(dense(dec["critic"], torch.cat([ctx_attn, h_pm], -1), q))[:, 0]
        return logits, progress, cand, (h1, c1)


def actions_of(tab: dict, st: State, moves: List[list], t: int) -> torch.Tensor:
    """The program's action at step ``t``: the candidate slot that leads to
    its ``t``-th move's panorama and view, or STOP after its last move."""
    B = st.node.shape[0]
    out = tab["n_cands"][st.node].clone()
    nxt = torch.full((B,), -1, dtype=torch.int64, device=st.node.device)
    view = torch.full((B,), -1, dtype=torch.int64, device=st.node.device)
    for b, mv in enumerate(moves):
        if t < len(mv):
            nxt[b], view[b] = mv[t]
    hit = (tab["cand_next"][st.node] == nxt[:, None]) & (tab["cand_view"][st.node] == view[:, None])
    hit &= tab["cand_valid"][st.node]
    MC = hit.shape[1]
    first = torch.where(hit, torch.arange(MC, device=hit.device)[None, :], MC).min(1).values
    # a move that matches no candidate is an action no slot has
    return torch.where(nxt >= 0, torch.where(first < MC, first, MC + 1), out)


@torch.no_grad()
def judge(model: Monitor, p: dict, bn_state: dict, tokens, lengths, start, heading,
          moves: List[list], horizon: int, control: Optional["Monitor"] = None):
    """(widest gap of the program's actions, widest gap of the control's
    first choices or None, decisions judged, longest trajectory)."""
    B = tokens.shape[0]
    ep_state = reset(Episodes(tokens, lengths, start, heading, torch.zeros_like(start)))
    ctx, carry = model.start(p, tokens, lengths, ep_state)
    ctx_mask = tokens == 0
    ctl = control.start(p, tokens, lengths, ep_state) if control is not None else None
    st, gap, ctl_gap, judged = ep_state, 0.0, 0.0, 0
    for t in range(horizon):
        if bool(st.ended.all()):
            break
        logits, _prog, cand, (h1, c1) = model.step(p, bn_state, carry, ctx, ctx_mask, st)
        action = actions_of(model.tab, st, moves, t)
        alive = ~st.ended
        best = logits.max(-1).values
        mine = torch.where(action <= logits.shape[1] - 1,
                           logits.gather(1, action.clamp(max=logits.shape[1] - 1)[:, None])[:, 0],
                           torch.full_like(best, NEG_INF))
        gap = max(gap, float(torch.where(alive, best - mine, 0.0).max()))
        judged += int(alive.sum())
        if control is not None:
            c_ctx, c_carry = ctl
            c_logits, _, c_cand, c_hc = control.step(p, bn_state, c_carry, c_ctx, ctx_mask, st)
            pick = c_logits.argmax(-1)
            theirs = logits.gather(1, pick[:, None])[:, 0]
            ctl_gap = max(ctl_gap, float(torch.where(alive, best - theirs, 0.0).max()))
            taken = action.clamp(0, c_cand.shape[1] - 1)[:, None, None]
            ctl = (c_ctx, (*c_hc, c_cand.gather(1, taken.expand(-1, 1, c_cand.shape[2]))[:, 0]))
        a = action.clamp(0, cand.shape[1] - 1)
        carry = (h1, c1, cand.gather(1, a[:, None, None].expand(-1, 1, cand.shape[2]))[:, 0])
        st, _ = step(model.tab, st, torch.where(action > cand.shape[1] - 1, -1, action))
    return gap, (ctl_gap if control is not None else None), judged, max(len(m) for m in moves)
