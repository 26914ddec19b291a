"""Hand-written BPTT for EnvDrop's decoder rollout (``TPU.FUSED_BPTT``).

The port of ``curriculum_learning_for_vln_tpu/ops/bptt.py``: a
``torch.autograd.Function`` over EnvDrop's whole decoder rollout (the
encoder stays outside, under autograd).  Its forward is the rollout loop
of ``agents/common.py::rollout_scan`` around EnvDrop's decode step, with
the same random draws in the same order, so flag on and flag off give
the same forward and leave the generator in the same state.  Its
backward differentiates the rollout by hand (bptt.py:267-443):

* the reverse loop carries only the recurrence cotangents (d h_tilde,
  d c), each [B, H];
* each step emits its weight-gradient factors (gate, attention and
  scorer cotangents), and after the loop every decoder weight gradient
  is one contraction ``einsum('tbi,tbo->io')`` accumulated in f32 and
  cast to the weight's dtype; d(ctx) is formed from the stacked
  attention factors the same way;
* the observations are gathered again from the world tables (they carry
  no gradient), and every dropout mask is drawn again, not stored: the
  forward keeps the generator's state at the start of each step, and the
  backward sets a second generator to it and makes that step's draws
  anew (``_draws``), in every ``TPU.OBS_MASKS`` mode (the prng modes'
  seeds, the ext mode's Bernoulli mask);
* the cotangent of the masked logits comes from differentiating the
  port's own CE and ``select_action`` terms (``common.policy_terms``) over
  the stacked [T, B, K] logits: zero at every masked slot.

As in the JAX package, the observations are plain gathers: the
observation kernels K4-K7 do not launch inside this rollout (their plain
versions, ``pano_attend_plain`` and ``cand_score_plain``, compute the
same function), and the loop runs every step: the early exit
(``TPU.SCAN_EARLY_EXIT``) does not apply.  The weights, the gradients and
the loop are plain PyTorch; the JAX package computes this outside any
Pallas kernel.  In a data-parallel step the draws are the global batch's
(ops/draws.py) in the forward and again in the backward, which runs
after the step's context has closed and so reopens it.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..env import env as E
from ..models.attention import masked_softmax
from ..models.core import apply_keep_mask, cross_entropy_per_sample, dense
from ..parallel import mesh as M
from ..utils.angles import make_angle_feat
from ..utils.tree import tree_leaves
from . import draws
from .cuda import cand_score as CS
from .cuda import pano_fused as PF
from .cuda.drop import NO_DROP, DropSpec

# StepRecord fields that carry a gradient; the others are marked
# non-differentiable
DIFFERENTIABLE = ("ce", "log_prob", "entropy", "hidden", "logits")


class _Masks(NamedTuple):
    """One step's draws, in the order EnvDrop's decode makes them."""

    m3: Optional[torch.Tensor]   # dropout of h_tilde_prev (the visual query)
    pano: DropSpec               # env-dropout of the panorama's image rows
    cand: DropSpec               # env-dropout of the candidates' image rows
    m0: Optional[torch.Tensor]   # dropout of the action embedding
    m4: Optional[torch.Tensor]   # dropout of h1
    m5: Optional[torch.Tensor]   # dropout of h_tilde


class _Plan:
    """What the Function needs besides its differentiable inputs; it also
    carries the final state out of the forward."""

    def __init__(self, agent, world, ep, ctx_mask, episode_len, feedback, generator,
                 avoid_cyclic, feat_mask, paths):
        self.agent, self.world, self.ep, self.ctx_mask = agent, world, ep, ctx_mask
        self.episode_len, self.feedback = episode_len, feedback
        self.generator, self.avoid_cyclic, self.feat_mask = generator, avoid_cyclic, feat_mask
        self.paths = paths
        self.final_state = None


def _paths(tree, prefix=()) -> List[tuple]:
    """The key paths of a nested dict's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


def _nest(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index or 0]
    return torch.default_generator


def _keep(shape, rate: float, generator, device) -> Optional[torch.Tensor]:
    """The keep-mask ``models.core.dropout`` draws for an input of ``shape``."""
    if rate == 0.0:
        return None
    return draws.rand(shape, generator, device, batch_dim=0) < 1.0 - rate


def _apply(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    return x if mask is None else apply_keep_mask(x, mask, rate)


def _draws(plan: _Plan, B: int, H: int, generator) -> _Masks:
    """The dropout draws of one step of EnvDrop's decode at train=True
    (agents/envdrop.py::_decode): the visual query's, the observation's
    env-dropout (not with a feature mask, which replaces it), then the
    action embedding's, h1's and h_tilde's.  The Gumbel draw of sample
    feedback comes after them, in ``select_action``."""
    agent, world = plan.agent, plan.world
    rate, device = agent.cfg.DROP_RATE, world.features.device
    _, V, Dim = world.features.shape
    m3 = _keep((B, H), rate, generator, device)
    pano = cand = NO_DROP
    if plan.feat_mask is None:
        pano = agent._obs_drop(B, V, Dim, True, device, generator)
        cand = agent._obs_drop(B, world.cand_view.shape[1], Dim, True, device, generator)
    m0 = _keep((B, agent.cfg.ACT_EMB_SIZE), rate, generator, device)
    m4 = _keep((B, H), rate, generator, device)
    m5 = _keep((B, H), rate, generator, device)
    return _Masks(m3, pano, cand, m0, m4, m5)


def _masked_observation(plan: _Plan, state: E.EnvState, meta: E.ObsMeta):
    """(pano [B, 36, F], cand [B, K, F]) of back-translation's decode: the
    gathered features times the shared feature mask, f32 (the STOP and
    invalid candidate rows zero)."""
    pano, cand = E.observe_feats(plan.world, state, meta, meta.cand_angle.dtype)
    return (plan.agent._apply_feat_mask(pano, plan.feat_mask),
            plan.agent._apply_feat_mask(cand, plan.feat_mask))


def _cand_img(world, state: E.EnvState, meta: E.ObsMeta) -> torch.Tensor:
    """The candidates' raw image rows [B, MC, D] in the table dtype."""
    feats = world.features[state.node]
    return feats.gather(1, meta.cand_view[:, :, None].expand(-1, -1, feats.shape[-1]))


def _visual_attention(plan: _Plan, state, meta, masks, tv):
    """(vis [B, F], alpha [B, 36], cand_img or None) of the observation op."""
    if plan.feat_mask is None:
        return PF.pano_attend_plain(state.node, state.view_idx, meta.cand_view,
                                    plan.world.features, plan.world.loc_embed, tv, masks.pano)
    pano, _ = _masked_observation(plan, state, meta)
    alpha = torch.softmax(torch.einsum("bvf,bf->bv", pano, tv.to(pano.dtype)), dim=-1)
    return torch.einsum("bv,bvf->bf", alpha, pano), alpha, None


def _scores(plan: _Plan, state, meta, masks, cand_img, q) -> torch.Tensor:
    """The candidate logits [B, K] of the projected query q."""
    if plan.feat_mask is None:
        return CS.cand_score_plain(cand_img, meta.cand_angle, meta.cand_valid, q, masks.cand)
    _, cand = _masked_observation(plan, state, meta)
    return torch.einsum("bkf,bf->bk", cand, q.to(cand.dtype))


def _softmax_bwd(alpha: torch.Tensor, d_alpha: torch.Tensor) -> torch.Tensor:
    """VJP of alpha = softmax(z) at d_alpha: alpha (d_alpha - <alpha, d_alpha>)."""
    return alpha * (d_alpha - (alpha * d_alpha).sum(dim=-1, keepdim=True))


def _forward(plan: _Plan, ctx, h0, c0, dec):
    from ..agents import common as C  # agents imports ops

    agent, world, T = plan.agent, plan.world, plan.episode_len
    cdt, drop = agent.compute_dtype, agent.cfg.DROP_RATE
    generator = plan.generator
    if generator is None:
        generator = _default_generator(world.features.device)
    B, H = h0.shape
    lp = dec["lstm"]
    b_lstm = (lp["b_ih"] + lp["b_hh"]).float()
    state = E.reset(world, plan.ep)
    visited = C.visited_history(state, T) if plan.avoid_cyclic else None
    h_tilde, c = h0, c0
    records, saved = [], []
    for t in range(T):
        gstate = generator.get_state()
        masks = _draws(plan, B, H, generator)
        meta = E.observe_meta(world, state, cdt)

        tv = dense(dec["visual_attn"]["linear_in"], _apply(h_tilde, masks.m3, drop))
        vis, alpha_v, cand_img = _visual_attention(plan, state, meta, masks, tv)
        act_pre = torch.tanh(dense(dec["act_embed"], make_angle_feat(state.heading,
                                                                      state.elevation)))
        x = torch.cat([_apply(act_pre, masks.m0, drop).float(), vis.float()], dim=-1)
        gates = x @ lp["w_ih"].float() + h_tilde.float() @ lp["w_hh"].float() + b_lstm
        i, f, g, o = gates.split(H, dim=-1)
        c1 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h1 = torch.sigmoid(o) * torch.tanh(c1)

        hd = _apply(h1, masks.m4, drop)
        target = dense(dec["text_attn"]["linear_in"], hd).to(ctx.dtype)
        alpha_c = masked_softmax(torch.einsum("blc,bc->bl", ctx, target).float(), plan.ctx_mask)
        wctx = torch.einsum("bl,blc->bc", alpha_c.to(ctx.dtype), ctx)
        dtype = torch.promote_types(wctx.dtype, hd.dtype)
        h_tilde_new = torch.tanh(dense(dec["text_attn"]["linear_out"],
                                       torch.cat([wctx.to(dtype), hd.to(dtype)], -1)))
        q = dense(dec["cand_attn"], _apply(h_tilde_new, masks.m5, drop))
        logits = _scores(plan, state, meta, masks, cand_img, q)

        cand_mask = (meta.cand_mask if visited is None
                     else C.cyclic_mask(world, state.node, meta.cand_mask, visited))
        masked = torch.where(cand_mask, C.NEG_INF, logits)
        action, log_prob, entropy = C.select_action(plan.feedback, masked, meta.teacher,
                                                    generator)
        new_state, record = C.step_and_record(world, state, meta, masked, action, log_prob,
                                              entropy, h1)
        if visited is not None:
            visited[:, t + 1] = new_state.node
        records.append(record)
        saved.append((state, gstate, cand_mask, gates, c1, h_tilde_new, alpha_v, alpha_c,
                      act_pre, vis, wctx))
        state, h_tilde, c = new_state, h_tilde_new, c1
    plan.final_state = state
    steps = C.StepRecord(*(torch.stack(field) for field in zip(*records)))
    # fresh tensors: the saved c1 and h_tilde must not be outputs themselves
    return steps, c.clone(), h_tilde.clone(), saved


def _backward(plan: _Plan, ctx, h0, c0, dec, saved, steps, grads, g_cT, g_htT):
    """Gradients of (ctx, h0, c0) and of the decoder's leaves, by key path
    in f32, from the cotangents ``grads`` of the DIFFERENTIABLE records."""
    from ..agents import common as C  # agents imports ops

    agent, world, T = plan.agent, plan.world, plan.episode_len
    cdt, drop = agent.compute_dtype, agent.cfg.DROP_RATE
    g_ce, g_lp, g_ent, g_hid, g_logits = (grads[k] for k in DIFFERENTIABLE)
    B, H = h0.shape
    Hc = ctx.shape[-1]
    states, gstates, cand_mask, gates, c1, h_tilde, alpha_v, alpha_c, act_pre, vis, wctx = (
        list(x) for x in zip(*saved))
    gates, c1, h_tilde, alpha_v, alpha_c, act_pre, vis, wctx = (
        torch.stack(x) for x in (gates, c1, h_tilde, alpha_v, alpha_c, act_pre, vis, wctx))
    cand_mask = torch.stack(cand_mask)

    # the masked logits' cotangent: the CE and select_action's terms
    # differentiated over every step at once
    with torch.enable_grad():
        ml = steps.logits.detach().requires_grad_(True)
        flat = ml.flatten(0, 1)
        log_prob, entropy = C.policy_terms(flat, steps.action.flatten())
        ce = cross_entropy_per_sample(flat, steps.teacher.flatten(), E.IGNORE_ID)
        objective = ((ce * g_ce.flatten()).sum() + (log_prob * g_lp.flatten()).sum()
                     + (entropy * g_ent.flatten()).sum())
        d_ml, = torch.autograd.grad(objective, ml)
    d_logits = torch.where(cand_mask, 0.0, d_ml + g_logits)

    W_ih, W_hh = dec["lstm"]["w_ih"].float(), dec["lstm"]["w_hh"].float()
    W_v = dec["visual_attn"]["linear_in"]["w"].float()
    W_t = dec["text_attn"]["linear_in"]["w"].float()
    W_o = dec["text_attn"]["linear_out"]["w"].float()
    W_c = dec["cand_attn"]["w"].float()
    h_tilde_prev = torch.cat([h0[None].float(), h_tilde[:-1]], dim=0)
    c_prev = torch.cat([c0[None].float(), c1[:-1]], dim=0)
    A = act_pre.shape[-1]

    generator = torch.Generator(device=world.features.device)
    dht, dc = g_htT.float(), g_cT.float()
    emits = []
    for t in reversed(range(T)):
        generator.set_state(gstates[t])
        masks = _draws(plan, B, H, generator)
        state = states[t]
        meta = E.observe_meta(world, state, cdt)

        # candidate scorer
        if plan.feat_mask is None:
            d_q = CS.cand_score_bwd_plain(_cand_img(world, state, meta), meta.cand_angle,
                                          meta.cand_valid, d_logits[t], masks.cand)
        else:
            _, cand = _masked_observation(plan, state, meta)
            d_q = torch.einsum("bk,bkf->bf", d_logits[t], cand)
        d_h_tilde = _apply(d_q @ W_c.t(), masks.m5, drop) + dht

        # text attention and its output projection
        da = d_h_tilde * (1.0 - h_tilde[t] * h_tilde[t])
        d_cat = da @ W_o.t()
        d_wctx, d_hd = d_cat[:, :Hc], d_cat[:, Hc:]
        d_s = _softmax_bwd(alpha_c[t], torch.einsum("bh,blh->bl", d_wctx, ctx.float()))
        d_tt = torch.einsum("bl,blh->bh", d_s, ctx.float())
        d_h1 = _apply(d_hd + d_tt @ W_t.t(), masks.m4, drop) + g_hid[t]

        # LSTM cell
        i, f, g, o = (torch.sigmoid(z) if k != 2 else torch.tanh(z)
                      for k, z in enumerate(gates[t].split(H, dim=-1)))
        tc = torch.tanh(c1[t])
        d_c1 = d_h1 * o * (1.0 - tc * tc) + dc
        dgates = torch.cat([d_c1 * g * i * (1.0 - i), d_c1 * c_prev[t] * f * (1.0 - f),
                            d_c1 * i * (1.0 - g * g), d_h1 * tc * o * (1.0 - o)], dim=-1)
        dc = d_c1 * f
        d_x = dgates @ W_ih.t()

        # visual attention over the panorama, gathered again
        if plan.feat_mask is None:
            d_tv = PF.pano_attend_bwd_plain(state.node, state.view_idx, world.features,
                                            world.loc_embed, alpha_v[t], d_x[:, A:], masks.pano)
        else:
            pano, _ = _masked_observation(plan, state, meta)
            d_sv = _softmax_bwd(alpha_v[t], torch.einsum("bvf,bf->bv", pano, d_x[:, A:]))
            d_tv = torch.einsum("bv,bvf->bf", d_sv, pano)
        dht = dgates @ W_hh.t() + _apply(d_tv @ W_v.t(), masks.m3, drop)
        d_act_pre = _apply(d_x[:, :A], masks.m0, drop) * (1.0 - act_pre[t] * act_pre[t])
        emits.append((dgates, d_tv, d_tt, d_s, d_wctx, da, d_q, d_act_pre,
                      _apply(act_pre[t], masks.m0, drop), _apply(h_tilde_prev[t], masks.m3, drop),
                      _apply(steps.hidden[t], masks.m4, drop), _apply(h_tilde[t], masks.m5, drop)))
    (dgates, d_tv, d_tt, d_s, d_wctx, da, d_q, d_act_pre, act_emb, q3, hd, htd) = (
        torch.stack(x[::-1]) for x in zip(*emits))

    def dW(inp, cot):
        return torch.einsum("tbi,tbo->io", inp.float(), cot)

    a_ang = make_angle_feat(torch.stack([s.heading for s in states]),
                            torch.stack([s.elevation for s in states]))
    db = dgates.sum(dim=(0, 1))
    d_dec = {
        ("act_embed", "w"): dW(a_ang, d_act_pre),
        ("act_embed", "b"): d_act_pre.sum(dim=(0, 1)),
        ("lstm", "w_ih"): dW(torch.cat([act_emb, vis.float()], dim=-1), dgates),
        ("lstm", "w_hh"): dW(h_tilde_prev, dgates),
        ("lstm", "b_ih"): db,
        ("lstm", "b_hh"): db,
        ("text_attn", "linear_in", "w"): dW(hd, d_tt),
        ("text_attn", "linear_out", "w"): dW(torch.cat([wctx.float(), hd], dim=-1), da),
        ("visual_attn", "linear_in", "w"): dW(q3, d_tv),
        ("cand_attn", "w"): dW(htd, d_q),
    }
    tt = hd @ W_t
    d_ctx = (torch.einsum("tbl,tbh->blh", alpha_c, d_wctx)
             + torch.einsum("tbl,tbh->blh", d_s, tt))
    return d_ctx.to(ctx.dtype), dht.to(h0.dtype), dc.to(c0.dtype), d_dec


class _Rollout(torch.autograd.Function):
    """The StepRecord fields and the final (c, h_tilde) of the rollout,
    differentiable in (ctx, h0, c0) and the decoder's leaves."""

    @staticmethod
    def forward(fctx, plan, ctx, h0, c0, *leaves):
        from ..agents import common as C  # agents imports ops

        dec = _nest(plan.paths, leaves)
        steps, cT, htT, saved = _forward(plan, ctx, h0, c0, dec)
        # the records the backward reads, detached: an output kept on fctx
        # itself would tie the graph into a cycle.  The backward frees them
        # (autograd frees saved tensors so), or they would live on as long
        # as any output of the rollout, into the next iteration
        fctx.plan, fctx.saved = plan, saved
        fctx.steps = C.StepRecord(*(f.detach() for f in steps))
        fctx.mesh = M.step_mesh()
        fctx.save_for_backward(ctx, h0, c0, *leaves)
        fctx.mark_non_differentiable(*(getattr(steps, k) for k in steps._fields
                                       if k not in DIFFERENTIABLE))
        return (*steps, cT, htT)

    @staticmethod
    def backward(fctx, *grads):
        ctx, h0, c0, *leaves = fctx.saved_tensors
        plan, saved, steps = fctx.plan, fctx.saved, fctx.steps
        if saved is None:
            raise RuntimeError("the BPTT rollout's backward runs once: its per-step records "
                               "are freed by it (retain_graph is not supported)")
        fctx.saved = fctx.steps = None
        named = dict(zip(steps._fields, grads))
        with M.sharded_step(fctx.mesh):
            d_ctx, d_h0, d_c0, d_dec = _backward(
                plan, ctx, h0, c0, _nest(plan.paths, leaves), saved, steps,
                {k: named[k] for k in DIFFERENTIABLE}, grads[-2], grads[-1])
        # each weight's gradient formed in f32, cast to the weight's dtype once
        return (None, d_ctx, d_h0, d_c0,
                *(d_dec[p].to(w.dtype) for p, w in zip(plan.paths, leaves)))


def envdrop_rollout_bptt(agent, dec: dict, world, ep: E.EpisodeBatch, ctx: torch.Tensor,
                         ctx_mask: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                         episode_len: int, feedback: int,
                         generator: Optional[torch.Generator] = None,
                         avoid_cyclic: bool = False,
                         feat_mask: Optional[torch.Tensor] = None):
    """EnvDrop's training rollout with the hand-written backward: the
    ``RolloutResult`` of ``rollout_scan`` over the agent's decode at
    train=True (h_tilde starting as h0), from the decoder's parameters
    ``dec`` (its compute copies), the encoder's (ctx, h0, c0) and its
    mask, drawing from ``generator``.  Returns the RolloutResult."""
    from ..agents import common as C  # agents imports ops

    plan = _Plan(agent, world, ep, ctx_mask, episode_len, feedback, generator, avoid_cyclic,
                 feat_mask, _paths(dec))
    leaves = tree_leaves(dec)  # in _paths' order
    out = _Rollout.apply(plan, ctx, h0, c0, *leaves)
    steps = C.StepRecord(*out[:len(C.StepRecord._fields)])
    cT, htT = out[-2:]
    state0 = E.reset(world, ep)
    return C.RolloutResult(final_state=plan.final_state, start_node=state0.node,
                           start_view=state0.view_idx, steps=steps,
                           model_carry=(steps.hidden[-1], cT, htT))
