"""The port's EnvDrop serving slice against the JAX package, from the same
parameters (``params_from_jax``), dropout off, in f32.

Module level: the encoder, ``soft_dot`` and one EnvDrop decoder step.
Slice level: the JAX ``Navigator(use_pallas=False)`` (the JAX suite
holds it equal to its Pallas path) against the port's
``Navigator(device="cpu")``: identical trajectories and per-step masked
logits within atol 1e-4 (an 8-step recurrence of f32 products whose sums
run in another order).  Then a JAX checkpoint with an optimizer state,
served through ``Navigator.from_checkpoint``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import curriculum_learning_for_vln_tpu.agents.common as j_common
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import load_jax_checkpoint, params_from_jax
from curriculum_learning_for_vln_torch.models import attention as t_att
from curriculum_learning_for_vln_torch.models import decoders as t_dec
from curriculum_learning_for_vln_torch.models.encoder import encoder_apply as t_encoder_apply
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.serve import Navigator as TNavigator
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer as TTokenizer
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.engine.checkpoint import save_checkpoint
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.models import attention as j_att
from curriculum_learning_for_vln_tpu.models import decoders as j_dec
from curriculum_learning_for_vln_tpu.models.encoder import encoder_apply as j_encoder_apply
from curriculum_learning_for_vln_tpu.ops import fused_obs as j_fused
from curriculum_learning_for_vln_tpu.serve import Navigator as JNavigator
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults
from curriculum_learning_for_vln_tpu.utils.tokenizer import PAD_IDX

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 8, 10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model_cfg():
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    return m


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    """Both packages' worlds (from the same graphs and features), their
    tokenizers, one JAX EnvDrop parameter tree and its conversion."""
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    j_tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    t_tok = TTokenizer(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), ENC_LEN, j_tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    t_agent = TAgent(_model_cfg(), ENC_LEN, t_tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    reqs = [{"instruction": it["instructions"][0], "scan": it["scan"],
             "start_viewpoint": it["path"][0], "heading": it["heading"]}
            for it in synth_dataset[:B - 1]]  # one padding slot
    return {"j_world": synth_world, "t_world": t_world, "j_tok": j_tok, "t_tok": t_tok,
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params,
            "t_params": params_from_jax(_np_tree(j_params)), "requests": reqs}


def _close(got: torch.Tensor, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def test_encoder_matches_jax(setup):
    rng = np.random.default_rng(1)
    lengths = np.array([12, 3, 7, 1, 12, 5, 9, 2, 11, 6])
    tokens = rng.integers(3, setup["j_tok"].vocab_size(), (B, ENC_LEN))
    tokens[np.arange(ENC_LEN)[None, :] >= lengths[:, None]] = PAD_IDX
    ctx_j, h_j, c_j = j_encoder_apply(setup["j_params"]["encoder"], jnp.asarray(tokens),
                                      jnp.asarray(lengths), jax.random.PRNGKey(0), False)
    ctx_t, h_t, c_t = t_encoder_apply(setup["t_params"]["encoder"], torch.from_numpy(tokens),
                                      torch.from_numpy(lengths), False)
    assert tuple(ctx_t.shape) == (B, ENC_LEN, 64)
    for got, want in ((ctx_t, ctx_j), (h_t, h_j), (c_t, c_j)):
        _close(got, want)


@pytest.mark.parametrize("prec,atol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_soft_dot_matches_jax(setup, prec, atol):
    """Both contractions in the context's dtype, the softmax in f32
    (attention.py:51-62); bf16: one bf16 rounding of O(1) values."""
    rng = np.random.default_rng(2)
    p = setup["j_params"]["decoder"]["text_attn"]
    h = rng.standard_normal((B, 64)).astype(np.float32)
    ctx = rng.standard_normal((B, ENC_LEN, 64)).astype(np.float32)
    mask = rng.random((B, ENC_LEN)) < 0.3
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[prec]
    out_j, att_j = j_att.soft_dot(p, jnp.asarray(h), jnp.asarray(ctx).astype(jdt), jnp.asarray(mask))
    out_t, att_t = t_att.soft_dot(setup["t_params"]["decoder"]["text_attn"], torch.from_numpy(h),
                                  torch.from_numpy(ctx).to(tdt), torch.from_numpy(mask))
    assert att_t.dtype == torch.float32
    _close(att_t, att_j.astype(jnp.float32), atol)
    _close(out_t, out_j.astype(jnp.float32), atol)


def test_decoder_step_matches_jax(setup):
    """One fused-observation decoder step: visual query, observation op,
    decoder, candidate scorer (the JAX "xla" formulation) and the critic."""
    rng = np.random.default_rng(4)
    tables = setup["j_world"].device_tables("f32")
    t_tables = setup["t_world"].device_tables("f32", device="cpu")
    MC = 16
    node = rng.integers(0, tables.features.shape[0], B)
    view = rng.integers(0, 36, B)
    c_view = rng.integers(0, 36, (B, MC))
    cand_angle = rng.standard_normal((B, MC, 128)).astype(np.float32)
    cand_valid = rng.random((B, MC)) < 0.6
    a_angle = rng.standard_normal((B, 128)).astype(np.float32)
    h_tilde = (rng.standard_normal((B, 64)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, 64)) * 0.5).astype(np.float32)
    ctx = (rng.standard_normal((B, ENC_LEN, 64)) * 0.5).astype(np.float32)
    ctx_mask = np.arange(ENC_LEN)[None, :] >= rng.integers(1, ENC_LEN + 1, B)[:, None]
    pj, pt = setup["j_params"]["decoder"], setup["t_params"]["decoder"]
    key = jax.random.PRNGKey(0)

    tv_j = j_dec.envdrop_visual_query(pj, jnp.asarray(h_tilde), key, False)
    j_fused.set_backend("xla")
    vis_j, cand_j = j_fused.pano_attend_cands((0.3, False), jnp.asarray(node), jnp.asarray(view),
                                              jnp.asarray(c_view), tables.features,
                                              tables.loc_embed, tv_j, key)
    logits_j, (h1_j, c1_j), ht_j = j_dec.envdrop_decoder_from_vis(
        pj, jnp.asarray(a_angle), vis_j, None, jnp.asarray(h_tilde), jnp.asarray(c),
        jnp.asarray(ctx), jnp.asarray(ctx_mask), key, False,
        cand_scorer=lambda q: j_fused.cand_attend_logits(
            (0.3, False), cand_j, jnp.asarray(cand_angle), jnp.asarray(cand_valid), q, key))

    tv_t = t_dec.envdrop_visual_query(pt, torch.from_numpy(h_tilde))
    vis_t, cand_t = t_fused.pano_attend_cands(
        torch.from_numpy(node), torch.from_numpy(view), torch.from_numpy(c_view),
        t_tables.features, t_tables.loc_embed, tv_t)
    logits_t, (h1_t, c1_t), ht_t = t_dec.envdrop_decoder_from_vis(
        pt, torch.from_numpy(a_angle), vis_t, torch.from_numpy(h_tilde), torch.from_numpy(c),
        torch.from_numpy(ctx), torch.from_numpy(ctx_mask),
        lambda q: t_fused.cand_attend_logits(cand_t, torch.from_numpy(cand_angle),
                                             torch.from_numpy(cand_valid), q))

    assert tuple(logits_t.shape) == (B, MC + 1)
    for got, want in ((tv_t, tv_j), (vis_t, vis_j), (cand_t, cand_j), (logits_t, logits_j),
                      (h1_t, h1_j), (c1_t, c1_j), (ht_t, ht_j)):
        _close(got, want)
    v_j = j_dec.critic_apply(setup["j_params"]["critic"], h1_j, key, False)
    _close(t_dec.critic_apply(setup["t_params"]["critic"], h1_t), v_j)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_env_matches_jax(setup, prec):
    """reset, observe (full gathers and metadata), action_is_stop and step
    over random actions, STOP, IGNORE and padding slots included."""
    rng = np.random.default_rng(6)
    jt = setup["j_world"].device_tables(prec)
    tt = setup["t_world"].device_tables(prec, device="cpu")
    N = setup["t_world"].num_nodes
    start = rng.integers(0, N, B)
    goal = np.array([rng.choice(np.flatnonzero(setup["t_world"].node_scan
                                                == setup["t_world"].node_scan[s])) for s in start])
    fields = {"instr_tokens": np.ones((B, ENC_LEN)), "instr_len": np.full(B, ENC_LEN),
              "start_node": start, "start_heading": rng.uniform(0, 7, B).astype(np.float32),
              "goal": goal, "goal_local": setup["t_world"].node_local[goal],
              "item_idx": np.arange(B), "valid": np.arange(B) < B - 2}
    j_ep = j_env.EpisodeBatch(**{k: jnp.asarray(v if v.dtype.kind != "i" else v.astype(np.int32))
                                 for k, v in fields.items()})
    t_ep = t_env.EpisodeBatch(**{k: torch.from_numpy(v if v.dtype.kind != "i" else v.astype(np.int64))
                                 for k, v in fields.items()})
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[prec]
    js, ts = j_env.reset(jt, j_ep), t_env.reset(tt, t_ep)
    for _ in range(6):
        jo, to = j_env.observe(jt, js, jdt), t_env.observe(tt, ts, tdt)
        np.testing.assert_array_equal(to.pano_feat.float().numpy(),
                                      np.asarray(jo.pano_feat.astype(jnp.float32)))
        # candidate angle features: sin/cos from two libraries, a few ulps apart
        np.testing.assert_allclose(to.cand_feat.float().numpy(),
                                   np.asarray(jo.cand_feat.astype(jnp.float32)), rtol=0, atol=1e-6)
        for name in ("cand_mask", "n_cands", "teacher", "dist", "cand_view", "cand_valid",
                     "cand_angle"):
            got, want = getattr(to.meta, name), getattr(jo, name)
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                       rtol=0, atol=1e-6, err_msg=name)
        action = rng.integers(-1, 18, B)
        np.testing.assert_array_equal(
            t_env.action_is_stop(tt, ts, torch.from_numpy(action)).numpy(),
            np.asarray(j_env.action_is_stop(jt, js, jnp.asarray(action, jnp.int32))))
        js = j_env.step(jt, js, jnp.asarray(action, jnp.int32))
        ts = t_env.step(tt, ts, torch.from_numpy(action))
        for name in ("node", "view_idx", "heading", "elevation", "ended"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                          name)


def _jax_masked_logits(monkeypatch, run):
    """Run ``run()`` (a JAX rollout) and return the masked logits it
    selected its actions from, step by step."""
    seen = []
    select = j_common.select_action

    def recording_select(feedback, masked_logits, teacher, rng):
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), masked_logits, ordered=True)
        return select(feedback, masked_logits, teacher, rng)

    monkeypatch.setattr(j_common, "select_action", recording_select)
    out = run()
    jax.effects_barrier()
    return out, np.stack(seen)


def test_navigator_matches_jax(setup, monkeypatch):
    s = setup
    j_nav = JNavigator(s["j_world"], s["j_agent"], s["j_params"], {}, s["j_tok"], max_batch=B,
                       precision="f32", use_pallas=False)
    t_nav = TNavigator(s["t_world"], s["t_agent"], s["t_params"], s["t_tok"], max_batch=B,
                       precision="f32", device="cpu")
    j_out, j_logits = _jax_masked_logits(monkeypatch, lambda: j_nav.navigate_batch(s["requests"]))
    t_out = t_nav.navigate_batch(s["requests"])

    assert [o["trajectory"] for o in t_out] == [o["trajectory"] for o in j_out]
    assert any(len(o["trajectory"]) > 2 for o in t_out)  # the agents really move
    t_result = t_nav.rollout(t_nav.episodes(s["requests"]))
    assert j_logits.shape == tuple(t_result.steps.logits.shape) == (EPISODE_LEN, B, 17)
    _close(t_result.steps.logits, j_logits, atol=1e-4)

    with pytest.raises(ValueError, match="micro-batch"):
        t_nav.navigate_batch(s["requests"] * 2)


def test_from_checkpoint_with_optimizer_state(setup, tmp_path):
    s = setup
    opt = optax.rmsprop(1e-4)
    ckpt = str(tmp_path / "envdrop.ckpt")
    save_checkpoint(ckpt, s["j_params"], opt_state=opt.init(s["j_params"]), model_state={},
                    epoch=3)
    nav = TNavigator.from_checkpoint(s["t_world"], s["t_agent"], ckpt, s["t_tok"], max_batch=B,
                                     precision="f32", device="cpu")
    direct = TNavigator(s["t_world"], s["t_agent"], s["t_params"], s["t_tok"], max_batch=B,
                        precision="f32", device="cpu")
    assert nav.navigate_batch(s["requests"]) == direct.navigate_batch(s["requests"])
    assert load_jax_checkpoint(ckpt)["model_state"] == {}

    # the loader reads the optax-holding bundle without importing jax or optax
    code = ("import sys; from curriculum_learning_for_vln_torch.convert import load_jax_checkpoint;"
            f"b = load_jax_checkpoint({ckpt!r});"
            "assert b['params']['decoder']['lstm']['w_ih'].shape == (16 + 64 + 128, 256);"
            "assert not {'jax', 'optax'} & set(sys.modules), sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
