"""The port's latent capability paths against the JAX package:

* ``models/subinstr.py``: ``soft_dot_block_attention`` (with and without
  a pad mask), ``sub_monitor_decoder_step`` and ``instr_shifting_apply``
  at train=False, from JAX's initial parameters and BN state through the
  port's converter, within 1e-5; at train=True the port's step draws its
  dropout from the generator it is given (the same seed, the same step);
* ``utils/region_label.py``: ``REGION_LABELS`` and
  ``load_room_connectivity`` equal JAX's; the ``utils`` facade exports
  JAX's names;
* ``avoid_cyclic`` for EnvDrop, the Follower and the Self-Monitor under
  argmax feedback at train=False: JAX's actions and nodes exactly, the
  masked logits within 1e-5 (JAX's read inside its scan through
  ``jax.debug.callback``), the same slots masked, and no node visited
  twice by a moving episode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
import curriculum_learning_for_vln_torch.utils as t_utils
from curriculum_learning_for_vln_torch.agents.common import FEEDBACK_ARGMAX
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TEnvDrop
from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TFollower
from curriculum_learning_for_vln_torch.agents.monitor import SelfMonitorAgent as TMonitor
from curriculum_learning_for_vln_torch.convert import model_state_from_jax, params_from_jax
from curriculum_learning_for_vln_torch.models import subinstr as t_si
from curriculum_learning_for_vln_torch.models.attention import NEG_INF
from curriculum_learning_for_vln_torch.utils import region_label as t_region
from curriculum_learning_for_vln_torch.utils.tree import tree_leaves
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu import utils as j_utils
from curriculum_learning_for_vln_tpu.agents import common as j_common
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JEnvDrop
from curriculum_learning_for_vln_tpu.agents.follower import FollowerAgent as JFollower
from curriculum_learning_for_vln_tpu.agents.monitor import SelfMonitorAgent as JMonitor
from curriculum_learning_for_vln_tpu.models import subinstr as j_si
from curriculum_learning_for_vln_tpu.utils import region_label as j_region
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults
from test_torch_follower import episode_batches

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 10, 10
TOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# models/subinstr.py
# ---------------------------------------------------------------------------

SUB_LENGTHS = np.array([[3, 4, 2], [2, 2, 5], [1, 6, 3], [4, 4, 2]], np.int32)


@pytest.mark.parametrize("with_mask", [False, True])
def test_block_attention_matches_jax(with_mask):
    Bn, L, D = 4, 12, 8
    j_p = j_si.soft_dot_block_attention_init(jax.random.PRNGKey(0), D)
    t_p = t_si.soft_dot_block_attention_init(torch.Generator().manual_seed(0), D)
    t_p["linear_in"]["w"] = _t(j_p["linear_in"]["w"])
    rng = np.random.default_rng(1)
    h = rng.standard_normal((Bn, D)).astype(np.float32)
    ctx = rng.standard_normal((Bn, L, D)).astype(np.float32)
    sel = np.array([1, 2, 0, 1], np.int32)
    mask = (np.arange(L)[None, :] >= np.array([12, 10, 11, 9])[:, None]) if with_mask else None
    w_j, a_j = j_si.soft_dot_block_attention(j_p, jnp.asarray(h), jnp.asarray(ctx),
                                             jnp.asarray(SUB_LENGTHS), jnp.asarray(sel),
                                             None if mask is None else jnp.asarray(mask))
    w_t, a_t = t_si.soft_dot_block_attention(t_p, _t(h), _t(ctx), _t(SUB_LENGTHS).long(),
                                             _t(sel).long(), None if mask is None else _t(mask))
    _close(w_t, w_j)
    np.testing.assert_allclose(a_t.numpy(), _np(a_j), rtol=1e-6, atol=TOL)
    # block 1 of sample 0 spans [1 + 3, 1 + 3 + 4): the weights elsewhere are 0
    raw = a_t[0, 4:8]
    expected = torch.softmax(raw, 0) @ _t(ctx)[0, 4:8]
    _close(w_t[0], expected.numpy())


def _sub_monitor(H=32, K=5, L=12, mlp=(16,)):
    A = FEAT_DIM + 128
    j_p, j_s = j_si.sub_monitor_decoder_init(jax.random.PRNGKey(3), H, max_enc_len=L,
                                             mlp_dims=mlp, action_embed_size=A)
    j_p = jax.tree_util.tree_map(np.asarray, j_p)
    t_p = params_from_jax(j_p)
    t_s = model_state_from_jax({"decoder_bn": jax.tree_util.tree_map(np.asarray, j_s)})
    rng = np.random.default_rng(2)
    x = {"a_prev": rng.standard_normal((4, A)), "cands": rng.standard_normal((4, K, A)),
         "h": rng.standard_normal((4, H)) * 0.5, "c": rng.standard_normal((4, H)) * 0.5,
         "ctx": rng.standard_normal((4, L, H))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    cand_mask = np.zeros((4, K), bool)
    cand_mask[:, -1] = True
    cand_mask[2, 2:] = True
    ctx_mask = np.arange(L)[None, :] >= np.array([12, 9, 11, 10])[:, None]
    return j_p, j_s, t_p, t_s["decoder_bn"], x, cand_mask, ctx_mask


def test_sub_monitor_step_and_shifting_match_jax():
    j_p, j_s, t_p, t_s, x, cand_mask, ctx_mask = _sub_monitor()
    sel = np.array([0, 1, 2, 1], np.int32)
    (lj, wj), (h1j, c1j), bnj, (caj, vaj) = j_si.sub_monitor_decoder_step(
        j_p, j_s, jnp.asarray(x["a_prev"]), jnp.asarray(x["cands"]), jnp.asarray(cand_mask),
        jnp.asarray(x["h"]), jnp.asarray(x["c"]), jnp.asarray(x["ctx"]),
        jnp.asarray(SUB_LENGTHS), jnp.asarray(sel), jnp.asarray(ctx_mask),
        jax.random.PRNGKey(1), train=False)
    (lt, wt), (h1t, c1t), bnt, (cat_, vat) = t_si.sub_monitor_decoder_step(
        t_p, t_s, _t(x["a_prev"]), _t(x["cands"]), _t(cand_mask), _t(x["h"]), _t(x["c"]),
        _t(x["ctx"]), _t(SUB_LENGTHS).long(), _t(sel).long(), _t(ctx_mask), train=False)
    for got, want in ((lt, lj), (wt, wj), (h1t, h1j), (c1t, c1j), (vat, vaj)):
        _close(got, want)
    np.testing.assert_allclose(cat_.numpy(), _np(caj), rtol=1e-6, atol=TOL)
    t_bn, j_bn = tree_leaves(bnt), jax.tree_util.tree_leaves(bnj)
    assert len(t_bn) == len(j_bn)
    for got, want in zip(t_bn, j_bn):
        _close(got, want)

    H, A = x["h"].shape[1], x["a_prev"].shape[1]
    j_sp = jax.tree_util.tree_map(np.asarray, j_si.instr_shifting_init(
        jax.random.PRNGKey(4), H, H, A, 3))
    t_sp = params_from_jax(j_sp)
    e_t = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    pj = j_si.instr_shifting_apply(j_sp, h1j, c1j, jnp.asarray(x["a_prev"]), wj, jnp.asarray(e_t),
                                   jax.random.PRNGKey(2), train=False)
    pt = t_si.instr_shifting_apply(t_sp, h1t, c1t, _t(x["a_prev"]), wt, _t(e_t), train=False)
    _close(pt, pj)
    assert pt.shape == (4,) and bool(((pt >= 0) & (pt <= 1)).all())


def test_sub_monitor_train_draws_from_its_generator():
    _, _, t_p, t_s, x, cand_mask, ctx_mask = _sub_monitor()
    sel = torch.tensor([0, 1, 2, 1])

    def step(seed):
        gen = torch.Generator().manual_seed(seed)
        out = t_si.sub_monitor_decoder_step(
            t_p, t_s, _t(x["a_prev"]), _t(x["cands"]), _t(cand_mask), _t(x["h"]), _t(x["c"]),
            _t(x["ctx"]), _t(SUB_LENGTHS).long(), sel, _t(ctx_mask), train=True,
            generator=gen)
        prob = t_si.instr_shifting_apply(
            params_from_jax(jax.tree_util.tree_map(np.asarray, j_si.instr_shifting_init(
                jax.random.PRNGKey(4), 32, 32, x["a_prev"].shape[1], 3))),
            out[1][0], out[1][1], _t(x["a_prev"]), out[0][1], torch.eye(3)[[0, 1, 2, 1]],
            train=True, generator=gen)
        return out[0][0], prob, gen.get_state()

    (l1, p1, g1), (l2, p2, g2), (l3, _, g3) = step(7), step(7), step(8)
    assert torch.equal(l1, l2) and torch.equal(p1, p2) and torch.equal(g1, g2)
    assert not torch.equal(l1, l3) and not torch.equal(g1, g3)
    assert bool(torch.isfinite(l1[~_t(cand_mask)]).all())


# ---------------------------------------------------------------------------
# utils/region_label.py and the utils facade
# ---------------------------------------------------------------------------

def test_region_labels_and_room_connectivity(tmp_path):
    assert t_region.REGION_LABELS == j_region.REGION_LABELS
    assert len(t_region.REGION_LABELS) == 31
    lines = {"scanA": ["0 vp0 0 k", "1 vp1 0 k", "2 vp2 1 b"], "scanB": ["0 vq0 3 h"]}
    for scan, rows in lines.items():
        (tmp_path / f"{scan}_panorama_to_region.txt").write_text("\n".join(rows) + "\n")
    got = t_region.load_room_connectivity(sorted(lines), str(tmp_path))
    assert got == j_region.load_room_connectivity(sorted(lines), str(tmp_path))
    assert got["scanA"] == {"0_k": ["vp0", "vp1"], "1_b": ["vp2"]}


def test_utils_facade_exports_jax_names():
    assert t_utils.__all__ == j_utils.__all__
    for name in t_utils.__all__:
        assert getattr(t_utils, name) is not None, name
    assert t_utils.REGION_LABELS is t_region.REGION_LABELS
    for v in (0, 13, 35):
        assert t_utils.view_heading(v) == pytest.approx(float(j_utils.view_heading(v)))
        assert t_utils.view_elevation(v) == pytest.approx(float(j_utils.view_elevation(v)))
    for h, e in ((0.0, 0.0), (1.3, -0.6), (6.1, 0.9), (-0.4, 0.2)):
        assert t_utils.heading_to_view_index(h, e) == j_utils.heading_to_view_index(h, e)
        assert t_utils.canonical_angle(h * 3) == pytest.approx(j_utils.canonical_angle(h * 3))


# ---------------------------------------------------------------------------
# avoid_cyclic through the three agents
# ---------------------------------------------------------------------------

def _agents(name, tok):
    m = getattr(get_cfg_defaults().MODEL, {"ENVDROP": "ENVDROP", "FOLLOWER": "FOLLOWER",
                                            "SELF-MONITOR": "MONITOR"}[name])
    m.DROP_RATE = 0.0
    V = tok.vocab_size()
    if name == "ENVDROP":
        m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE, m.FEAT_DROP_RATE = 32, 16, 64, 0.0
        return (JEnvDrop(m, ENC_LEN, V, FEAT_DIM, EPISODE_LEN),
                TEnvDrop(m, ENC_LEN, V, FEAT_DIM, EPISODE_LEN))
    if name == "FOLLOWER":
        m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS = 30, 32, 1
        return JFollower(m, V, FEAT_DIM, EPISODE_LEN), TFollower(m, V, FEAT_DIM, EPISODE_LEN)
    m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS, m.ENC_BIDIRECTION = 16, 32, 1, False
    m.MLP_HIDDEN = (48,)
    return (JMonitor(m, ENC_LEN, V, FEAT_DIM, EPISODE_LEN),
            TMonitor(m, ENC_LEN, V, FEAT_DIM, EPISODE_LEN))


@pytest.fixture(scope="module")
def worlds(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    return {"tok": tok, "j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"), "j_ep": j_ep, "t_ep": t_ep}


@pytest.mark.parametrize("name", ["ENVDROP", "FOLLOWER", "SELF-MONITOR"])
def test_avoid_cyclic_matches_jax(worlds, monkeypatch, name):
    j_agent, t_agent = _agents(name, worlds["tok"])
    j_params, j_state = j_agent.init(jax.random.PRNGKey(11))
    t_params = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    t_state = model_state_from_jax(jax.tree_util.tree_map(np.asarray, j_state))
    seen = []
    select = j_common.select_action

    def recording(feedback, masked_logits, teacher, rng):
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), masked_logits, ordered=True)
        return select(feedback, masked_logits, teacher, rng)

    monkeypatch.setattr(j_common, "select_action", recording)
    kw = {} if name == "ENVDROP" else {"model_state": t_state}
    for avoid in (False, True):
        seen.clear()
        _, j_res, _ = j_agent.rollout(j_params, j_state, worlds["j_tables"], worlds["j_ep"],
                                      jax.random.PRNGKey(0), feedback=j_common.FEEDBACK_ARGMAX,
                                      train=False, avoid_cyclic=avoid)
        jax.effects_barrier()
        with torch.no_grad():
            _, t_res = t_agent.rollout(t_params, worlds["t_tables"], worlds["t_ep"],
                                       FEEDBACK_ARGMAX, train=False, avoid_cyclic=avoid,
                                       **kw)[:2]
        for f in ("action", "node_after", "moved", "teacher"):
            np.testing.assert_array_equal(getattr(t_res.steps, f).numpy(),
                                          np.asarray(getattr(j_res.steps, f)), err_msg=f)
        j_logits = np.stack(seen)
        t_logits = t_res.steps.logits.numpy()
        assert j_logits.shape == t_logits.shape
        np.testing.assert_array_equal(t_logits == NEG_INF, j_logits == NEG_INF)
        live = t_logits != NEG_INF
        np.testing.assert_allclose(t_logits[live], j_logits[live], rtol=0, atol=TOL)
        if avoid:
            nodes = np.concatenate([t_res.start_node.numpy()[None], t_res.steps.node_after.numpy()])
            moved = np.concatenate([np.ones((1, B), bool), t_res.steps.moved.numpy()])
            for b in range(B):
                path = nodes[moved[:, b], b]
                assert len(set(path.tolist())) == len(path), f"episode {b} revisits a node"
            # after a first move, the way back is masked
            back = 0
            cand_next = worlds["t_tables"].cand_next.numpy()
            cand_valid = worlds["t_tables"].cand_valid.numpy()
            for b in np.flatnonzero(moved[1] & t_res.steps.alive_before.numpy()[1]):
                slots = np.flatnonzero((cand_next[nodes[1, b]] == nodes[0, b])
                                       & cand_valid[nodes[1, b]])
                assert (t_logits[1, b, slots] == NEG_INF).all()
                back += len(slots)
            assert back > 0


@pytest.mark.parametrize("name", ["ENVDROP", "FOLLOWER"])
def test_avoid_cyclic_with_the_early_exit(worlds, name):
    """With the early exit on, a frozen step records the node that sticks in
    the visited history, as a live step on an all-ended batch does: the
    rollout is the flag-off one, record for record."""
    _, t_agent = _agents(name, worlds["tok"])
    t_agent.episode_len = 24  # long enough for an all-ended tail
    params = t_agent.init(torch.Generator().manual_seed(3))
    params = params[0] if isinstance(params, tuple) else params
    res = {}
    try:
        for on in (False, True):
            t_common.set_early_exit(on)
            with torch.no_grad():
                res[on] = t_agent.rollout(params, worlds["t_tables"], worlds["t_ep"],
                                          FEEDBACK_ARGMAX, train=False, avoid_cyclic=True)[1]
    finally:
        t_common.set_early_exit(False)
    dead = ~res[False].steps.alive_before.any(dim=1)
    assert int(dead.sum()) >= 2, "no all-ended tail"
    for f in ("node_after", "view_after", "moved", "alive_before", "teacher", "ce", "reward",
              "dist_after"):
        assert torch.equal(getattr(res[True].steps, f), getattr(res[False].steps, f)), f
    live = ~dead  # a frozen record's action and logits are 0, as JAX's
    for f in ("action", "logits"):
        assert torch.equal(getattr(res[True].steps, f)[live], getattr(res[False].steps, f)[live])
