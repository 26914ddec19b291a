"""The prng_shared mask mode of K4-K7 and the fused LSTM cell K8: the
plain twins (which the CPU runs) against the JAX package's Pallas kernels
in interpret mode, on the same numpy inputs.

* prng_shared: the rows of each group of 8 share one keep-mask, the
  Philox draw of the group's first seed (ops/philox.py); the plain twins
  in this mode equal mode ext fed that group-broadcast mask bit for bit,
  and through ext they match the JAX kernels fed the same mask; B = 10
  leaves a short last group of 2 rows.  The forward and backward draw the
  same mask: the linearity identity of tests/test_fused_obs.py:368-392
  for K6/K7, autograd through the explicit mask for K4/K5.
* K8: ``lstm_cell_plain`` against ``lstm_cell_pallas(interpret=True)``
  and the JAX ``lstm_cell``; the CUDA wrapper's input checks.

Tolerances: atol 1e-5 in f32 — both sides accumulate in f32 from the
same f32 values, only the order of the sums differs; the linearity
identity rtol 1e-4 (a sum of 10 x 17 products on each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.agents import common as t_common
from curriculum_learning_for_vln_torch.agents import envdrop as t_envdrop
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.ops import philox
from curriculum_learning_for_vln_torch.ops.cuda import cand_score as t_cand
from curriculum_learning_for_vln_torch.ops.cuda import lstm_cell as t_cell
from curriculum_learning_for_vln_torch.ops.cuda import pano_fused as t_pano
from curriculum_learning_for_vln_torch.ops.cuda.drop import DropSpec, keep_mask
from curriculum_learning_for_vln_tpu.ops.pallas.cand_score import (cand_score_bwd_pallas,
                                                                   cand_score_fwd_pallas)
from curriculum_learning_for_vln_tpu.ops.pallas.lstm import lstm_cell_pallas
from curriculum_learning_for_vln_tpu.ops.pallas.pano_fused import (pano_attend_bwd_pallas,
                                                                   pano_attend_fwd_pallas)
from curriculum_learning_for_vln_tpu.ops.rnn import lstm_cell as j_lstm_cell
from curriculum_learning_for_vln_tpu.utils.angles import all_loc_embeddings

torch.set_num_threads(2)

ATOL = 1e-5
B, N, V, D, A, MC = 10, 7, 36, 64, 128, 16
KEEP = 0.7
SEEDS = torch.arange(B, dtype=torch.int64) * 7919 - 3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _shared_and_ext(rows):
    """The prng_shared spec and the ext spec of its group-broadcast mask."""
    shared = DropSpec("prng_shared", seeds=SEEDS, keep=KEEP)
    mask = philox.keep_mask(philox.group_seeds(SEEDS), (rows, D), KEEP)
    return shared, DropSpec("ext", mask=mask, keep=KEEP), mask


def _pano_inputs(seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((N, V, D)).astype(np.float32)
    nodes, views = rng.integers(0, N, B), rng.integers(0, V, B)
    cand_view = rng.integers(0, V, (B, MC))
    tv = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    d_vis = (rng.standard_normal((B, D + A)) * 0.2).astype(np.float32)
    return feats, nodes, views, cand_view, tv, d_vis


def _cand_inputs(seed=9):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, MC, D)).astype(np.float32)
    ang = rng.standard_normal((B, MC, A)).astype(np.float32)
    valid = rng.random((B, MC)) < 0.6
    q = (rng.standard_normal((B, D + A)) * 0.3).astype(np.float32)
    d_logits = rng.standard_normal((B, MC + 1)).astype(np.float32)
    return img, ang, valid, q, d_logits


def test_group_shares_one_mask():
    """Rows b with the same b // 8 share the mask; rows 0 and 8 do not; the
    short last group (rows 8, 9) is its own group; the keep rate holds."""
    shared = DropSpec("prng_shared", seeds=SEEDS, keep=KEEP)
    mask = keep_mask(shared, (V, D))
    assert tuple(mask.shape) == (B, V, D)
    for b in range(1, 8):
        assert torch.equal(mask[b], mask[0])
    assert torch.equal(mask[9], mask[8])
    assert not torch.equal(mask[0], mask[8])
    # each group's mask is the per-row prng draw of its first row's seed
    per_row = keep_mask(DropSpec("prng", seeds=SEEDS, keep=KEEP), (V, D))
    assert torch.equal(mask[0], per_row[0]) and torch.equal(mask[8], per_row[8])
    assert not torch.equal(mask[1], per_row[1])
    n = mask[0].numel()
    assert abs(float(mask[0].float().mean()) - KEEP) < 5 * (KEEP * (1 - KEEP) / n) ** 0.5


def test_pano_shared_equals_ext_and_matches_pallas():
    """K4 and K5 in prng_shared: bit-equal to ext with the group mask, and
    (through ext) the JAX kernels fed that mask."""
    feats, nodes, views, cand_view, tv, d_vis = _pano_inputs()
    loc = all_loc_embeddings()
    shared, ext, mask = _shared_and_ext(V)
    idx = _t(nodes, views, cand_view)
    fwd_s = t_pano.pano_attend(*idx, *_t(feats, loc, tv), shared)
    fwd_e = t_pano.pano_attend(*idx, *_t(feats, loc, tv), ext)
    for s, e in zip(fwd_s, fwd_e):
        assert torch.equal(s, e)
    bwd_s = t_pano.pano_attend_bwd(idx[0], idx[1], *_t(feats, loc), fwd_s[1],
                                   torch.from_numpy(d_vis), shared)
    bwd_e = t_pano.pano_attend_bwd(idx[0], idx[1], *_t(feats, loc), fwd_e[1],
                                   torch.from_numpy(d_vis), ext)
    assert torch.equal(bwd_s, bwd_e)

    feats_p = np.pad(feats, ((0, 0), (0, 40 - V), (0, 0)))  # the JAX table's layout
    idx_j = [jnp.asarray(a, jnp.int32) for a in (nodes, views, cand_view)]
    mask_j = jnp.asarray(mask.numpy())
    vi_j, va_j, alpha_j, cand_j = pano_attend_fwd_pallas(
        *idx_j, jnp.asarray(feats_p), jnp.asarray(loc), jnp.asarray(tv[:, :D]),
        jnp.asarray(tv[:, D:]), mask=mask_j, keep=KEEP, interpret=True)
    _close(fwd_s[0], np.concatenate([_np(vi_j), _np(va_j)], -1))
    _close(fwd_s[1], alpha_j)
    np.testing.assert_array_equal(_np(fwd_s[2]), _np(cand_j))
    di_j, da_j, _ = pano_attend_bwd_pallas(
        *idx_j, jnp.asarray(feats_p), jnp.asarray(loc), alpha_j, jnp.asarray(d_vis[:, :D]),
        jnp.asarray(d_vis[:, D:]), mask=mask_j, keep=KEEP, interpret=True)
    _close(bwd_s, np.concatenate([_np(di_j), _np(da_j)], -1))


def test_cand_shared_equals_ext_and_matches_pallas():
    """K6 and K7 in prng_shared: bit-equal to ext with the group mask, and
    (through ext) the JAX kernels fed that mask."""
    img, ang, valid, q, d_logits = _cand_inputs()
    shared, ext, mask = _shared_and_ext(MC)
    tin = _t(img, ang, valid)
    out_s = t_cand.cand_score(*tin, torch.from_numpy(q), shared)
    assert torch.equal(out_s, t_cand.cand_score(*tin, torch.from_numpy(q), ext))
    dq_s = t_cand.cand_score_bwd(*tin, torch.from_numpy(d_logits), shared)
    assert torch.equal(dq_s, t_cand.cand_score_bwd(*tin, torch.from_numpy(d_logits), ext))

    jin = (jnp.asarray(img), jnp.asarray(ang), jnp.asarray(valid))
    mask_j = jnp.asarray(mask.numpy())
    out_j = cand_score_fwd_pallas(*jin, jnp.asarray(q[:, :D]), jnp.asarray(q[:, D:]),
                                  mask=mask_j, keep=KEEP, interpret=True)
    dqi_j, dqa_j = cand_score_bwd_pallas(*jin, jnp.asarray(d_logits), mask=mask_j, keep=KEEP,
                                         interpret=True)
    _close(out_s, out_j)
    _close(dq_s, np.concatenate([_np(dqi_j), _np(dqa_j)], -1))


def test_shared_forward_and_backward_draw_one_mask():
    """CandAttend is linear in q, so <d_q, v> == <g, fwd(v)> holds only if
    the backward regenerates the forward's mask; PanoAttend's d_tv equals
    autograd through the plain formulation with the explicit group mask."""
    img, ang, valid, q, d_logits = _cand_inputs(seed=10)
    shared, _, _ = _shared_and_ext(MC)
    tin = _t(img, ang, valid)
    rng = np.random.default_rng(11)
    v = torch.from_numpy(rng.standard_normal((B, D + A)).astype(np.float32))
    qt = torch.from_numpy(q).requires_grad_(True)
    out = t_fused.cand_attend_logits(*tin, qt, shared)
    g = torch.from_numpy(d_logits)
    (dq,) = torch.autograd.grad(out, qt, g)
    lhs = float((dq.double() * v.double()).sum())
    rhs = float((g.double() * t_fused.cand_attend_logits(*tin, v, shared).double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)

    feats, nodes, views, cand_view, tv, d_vis = _pano_inputs(seed=12)
    loc = torch.from_numpy(all_loc_embeddings())
    shared, _, mask = _shared_and_ext(V)
    idx = _t(nodes, views, cand_view)
    t = torch.from_numpy(tv).requires_grad_(True)
    vis, _ = t_fused.pano_attend_cands(*idx, torch.from_numpy(feats), loc, t, shared)
    (g_k,) = torch.autograd.grad(vis, t, torch.from_numpy(d_vis))
    t = torch.from_numpy(tv).requires_grad_(True)
    img_rows = torch.where(mask, torch.from_numpy(feats)[idx[0]] / KEEP, 0.0)
    rows = torch.cat([img_rows, loc[idx[1]]], dim=-1)
    alpha = torch.softmax(torch.einsum("bvf,bf->bv", rows, t), dim=-1)
    (g_w,) = torch.autograd.grad(torch.einsum("bv,bvf->bf", alpha, rows), t,
                                 torch.from_numpy(d_vis))
    _close(vis, torch.einsum("bv,bvf->bf", alpha, rows))
    _close(g_k, g_w)


def test_agent_prng_shared_rollout_equals_ext_with_group_masks(monkeypatch, synth_world,
                                                              synth_graphs, synth_dataset,
                                                              tokenizer):
    """EnvDropAgent runs OBS_MASKS prng_shared: its IL rollout has the loss
    and gradients of the ext rollout fed the group-broadcast masks of the
    same seeds (the same plain ops on the same masks: exact)."""
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
    from curriculum_learning_for_vln_torch.utils import tree
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.world import compiler

    world = compiler.compile_world(synth_graphs, max_candidates=16)
    world.features = synth_world.features.copy()
    tables = world.device_tables("f32", device="cpu")
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.DROP_RATE, m.FEAT_DROP_RATE = 0.0, 0.4
    env = R2RBatchEnv(world, expand_r2r_items(synth_dataset, tokenizer), B, seed=1, device="cpu")
    ep = env.next_batch()
    agents = {mode: t_envdrop.EnvDropAgent(m, 24, tokenizer.vocab_size(), 64, 6, obs_masks=mode)
              for mode in ("prng_shared", "ext")}
    params0 = agents["ext"].init(torch.Generator().manual_seed(0))
    drawn, replayed = [], []
    shared_drop = agents["prng_shared"]._obs_drop

    def record(B_, rows, D_, train, device, generator):
        spec = shared_drop(B_, rows, D_, train, device, generator)
        assert spec.mode == "prng_shared"
        drawn.append(keep_mask(spec, (rows, D_)))
        return spec

    def replay(shape, keep, generator, device):
        mask = drawn[len(replayed)]
        assert tuple(mask.shape) == tuple(shape)
        replayed.append(mask)
        return mask

    monkeypatch.setattr(agents["prng_shared"], "_obs_drop", record)
    monkeypatch.setattr(t_envdrop, "draw_keep_mask", replay)

    def il(agent):
        p = tree.tree_map(lambda x: x.clone().requires_grad_(True), params0)
        losses, _ = agent.rollout(p, tables, ep, t_common.FEEDBACK_TEACHER, train=True,
                                  generator=torch.Generator().manual_seed(4))
        losses.ml_loss.backward()
        return losses.ml_loss.detach(), [x.grad for x in tree.tree_leaves(p)]

    loss_s, grads_s = il(agents["prng_shared"])
    loss_e, grads_e = il(agents["ext"])
    assert len(drawn) == len(replayed) > 0
    assert torch.equal(drawn[0][0], drawn[0][7]) and not torch.equal(drawn[0][0], drawn[0][8])
    assert torch.equal(loss_s, loss_e)
    for gs, ge in zip(grads_s, grads_e, strict=True):
        assert (gs is None) == (ge is None) and (gs is None or torch.equal(gs, ge))


@pytest.mark.parametrize("shape", [(8, 32, 256), (5, 40, 24)])
def test_lstm_cell_plain_matches_pallas_and_jax(shape):
    """K8's plain twin, f32: (h', c') of lstm_cell_pallas in interpret mode
    and of the JAX lstm_cell (tests/test_models.py:153-168's inputs, and a
    batch and width off the Pallas tile)."""
    Bc, Din, H = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((Bc, Din)).astype(np.float32)
    h = rng.standard_normal((Bc, H)).astype(np.float32)
    c = rng.standard_normal((Bc, H)).astype(np.float32)
    w_ih = (rng.standard_normal((Din, 4 * H)) * 0.1).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    h_t, c_t = t_cell.lstm_cell(*_t(x, h, c, w_ih, w_hh, b))
    assert h_t.dtype == torch.float32 and tuple(c_t.shape) == (Bc, H)
    ins = [jnp.asarray(a) for a in (x, h, c, w_ih, w_hh, b)]
    for h_j, c_j in (lstm_cell_pallas(*ins, interpret=True), j_lstm_cell(*ins)):
        _close(h_t, h_j)
        _close(c_t, c_j)


def test_lstm_cell_wrapper_checks_inputs():
    """The CUDA wrapper checks dtypes, shapes, the hidden width (a multiple
    of 16: one N tile), the input width (a multiple of 8: whole 16-byte
    copies on either side of the x/h boundary) and 16-byte alignment
    before any launch; a CPU tensor takes the plain twin (no count)."""
    x, h, c = torch.zeros(4, 24), torch.zeros(4, 16), torch.zeros(4, 16)
    w_ih, w_hh, b = torch.zeros(24, 64), torch.zeros(16, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="w_hh"):
        t_cell.lstm_cell_cuda(x, h, c, w_ih, torch.zeros(16, 60), b)
    with pytest.raises(ValueError, match="c must be"):
        t_cell.lstm_cell_cuda(x, h, c.double(), w_ih, w_hh, b)
    for H in (12, 24):
        with pytest.raises(ValueError, match="multiple of 16"):
            t_cell.lstm_cell_cuda(x, torch.zeros(4, H), torch.zeros(4, H),
                                  torch.zeros(24, 4 * H), torch.zeros(H, 4 * H),
                                  torch.zeros(4 * H))
    with pytest.raises(ValueError, match="multiple of 8"):
        t_cell.lstm_cell_cuda(torch.zeros(4, 20), h, c, torch.zeros(20, 64), w_hh, b)
    with pytest.raises(ValueError, match="aligned"):
        t_cell.lstm_cell_cuda(torch.zeros(5 * 24 + 2)[2:].view(5, 24), torch.zeros(5, 16),
                              torch.zeros(5, 16), w_ih, w_hh, b)
    before = t_cell.launches
    t_cell.lstm_cell(x, h, c, w_ih, w_hh, b)
    assert t_cell.launches == before
