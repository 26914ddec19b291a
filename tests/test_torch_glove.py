"""Frozen GloVe embeddings for the Follower (``MODEL.FOLLOWER.GLOVE_PATH``)
in the port against the JAX package:

* ``utils.glove.load_glove`` on a ``.npy`` table and on a GloVe text file
  (missing words, a malformed line, the <PAD> row): JAX's table, exactly;
  and its refusals;
* ``build_agent`` with GLOVE_PATH in either format gives the Follower
  JAX's table, and ``main.check_ported`` takes the option;
* the Follower with the table, from JAX's parameters, f32, DROP_RATE 0:
  logits and losses of an argmax rollout within 1e-4 (a rollout's f32
  recurrence, as tests/test_torch_follower.py), and at train=True the
  loss and every gradient leaf within 1e-4, with no gradient reaching the
  table in either package;
* one RMSprop and one Adam step (``agent_one_iter``, DROP_RATE as the
  config ships it): the table unchanged bit for bit, the rest of the
  encoder moved.
"""
import os

import jax
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.agents.common import FEEDBACK_ARGMAX, FEEDBACK_TEACHER
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.utils.glove import load_glove
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import build_agent as j_build_agent
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg
from curriculum_learning_for_vln_tpu.utils.glove import load_glove as j_load_glove

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, B = 30, 8


def _text_glove(path, vocab, rng):
    """A GloVe text file over most of ``vocab`` (every third word left out),
    with words outside it and a malformed line."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("zzz-not-a-word " + " ".join(["0.5"] * DIM) + "\n")
        f.write(vocab[5] + " 1.0 2.0\n")  # too short: skipped
        for i, w in enumerate(vocab):
            if i % 3:
                f.write(w + " " + " ".join(f"{x:.6f}" for x in rng.standard_normal(DIM)) + "\n")


def test_load_glove_matches_jax(tmp_path, tokenizer):
    vocab = tokenizer.vocab
    rng = np.random.default_rng(0)
    table = rng.standard_normal((len(vocab), DIM)).astype(np.float32)
    np.save(tmp_path / "g.npy", table)
    for v in (vocab, None):
        got = load_glove(str(tmp_path / "g.npy"), v, dim=DIM)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, j_load_glove(str(tmp_path / "g.npy"), v, dim=DIM))
        np.testing.assert_array_equal(got, table)  # aligned already: taken as it is
    _text_glove(tmp_path / "g.txt", vocab, rng)
    for seed in (0, 5):
        got = load_glove(str(tmp_path / "g.txt"), vocab, dim=DIM, seed=seed)
        want = j_load_glove(str(tmp_path / "g.txt"), vocab, dim=DIM, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (len(vocab), DIM) and not got[0].any()  # <PAD> zeroed
    with pytest.raises(ValueError, match="vocab"):
        load_glove(str(tmp_path / "g.npy"), vocab[:-1], dim=DIM)
    with pytest.raises(ValueError, match="vocab"):
        load_glove(str(tmp_path / "g.txt"), None, dim=DIM)


def _cfgs(path, drop=0.0):
    cfgs = []
    for make in (t_cfg, j_cfg):
        cfg = make()
        cfg.merge_from_list(["MODEL.NAME", "FOLLOWER", "TPU.PRECISION", "f32",
                             "MODEL.FOLLOWER.WORD_EMB_SIZE", DIM, "MODEL.FOLLOWER.HIDDEN_SIZE", 32,
                             "MODEL.FOLLOWER.ENC_LAYERS", 2, "MODEL.FOLLOWER.DROP_RATE", drop,
                             "MODEL.FOLLOWER.GLOVE_PATH", str(path), "DATA.MAX_ENC_LEN", 24,
                             "AGENT.MAX_EPISODE_LEN", 6, "TRAIN.OPTIM", "rms"])
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("fmt", ["npy", "txt"])
def test_build_agent_loads_the_table_as_jax(tmp_path, tokenizer, fmt):
    vocab = tokenizer.vocab
    rng = np.random.default_rng(1)
    path = tmp_path / f"g.{fmt}"
    if fmt == "npy":
        np.save(path, rng.standard_normal((len(vocab), DIM)).astype(np.float32))
    else:
        _text_glove(path, vocab, rng)
    t_c, j_c = _cfgs(path)
    t_agent = t_build_agent(t_c, len(vocab), 64, vocab=vocab)
    j_agent = j_build_agent(j_c, len(vocab), 64, vocab=vocab)
    np.testing.assert_array_equal(t_agent.glove, np.asarray(j_agent.glove))
    params, _ = t_agent.init(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(params["encoder"]["embedding"]["w"].numpy(), t_agent.glove)
    args, cfg = t_main.parse_args(["--device", "cpu", "--config-file",
                                   os.path.join(REPO, "configs/follower/follower_config.yaml"),
                                   "MODEL.FOLLOWER.GLOVE_PATH", str(path)])
    t_main.check_ported(args, cfg)  # ported: no longer refused


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer, tmp_path_factory):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    path = tmp_path_factory.mktemp("glove") / "g.npy"
    np.save(path, np.random.default_rng(2).standard_normal((tokenizer.vocab_size(), DIM))
            .astype(np.float32))
    data = expand_r2r_items(synth_dataset, tokenizer)
    return {"path": path, "t_tables": t_world.device_tables("f32", "cpu"),
            "j_tables": synth_world.device_tables(),
            "t_ep": TEnv(t_world, data, B, tokenizer, seed=3, device="cpu").next_batch(),
            "j_ep": JEnv(synth_world, data, B, tokenizer, seed=3).next_batch()}


def test_follower_with_glove_matches_jax(setup, tokenizer):
    s = setup
    t_c, j_c = _cfgs(s["path"])
    t_agent = t_build_agent(t_c, tokenizer.vocab_size(), 64, vocab=tokenizer.vocab)
    j_agent = j_build_agent(j_c, tokenizer.vocab_size(), 64, vocab=tokenizer.vocab)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(j_params["encoder"]["embedding"]["w"]),
                                  t_agent.glove)

    def t_params():
        p = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
        return t_tree.tree_map(lambda t: t.requires_grad_(True), p)

    lj, rj, _ = j_agent.rollout(j_params, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1),
                                feedback=FEEDBACK_ARGMAX, train=False)
    with torch.no_grad():
        lt, rt, _ = t_agent.rollout(t_params(), s["t_tables"], s["t_ep"], FEEDBACK_ARGMAX)
    np.testing.assert_array_equal(rt.steps.action.numpy(), np.asarray(rj.steps.action))
    alive = rt.steps.alive_before.numpy()
    np.testing.assert_array_equal(alive, np.asarray(rj.steps.alive_before))
    np.testing.assert_allclose(rt.steps.logits.numpy()[alive],
                               _masked_logits(j_agent, j_params, s)[alive], rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(lt.ml_loss), float(lj.ml_loss), rtol=0, atol=1e-4)

    # train=True, teacher feedback: the loss and every gradient leaf
    def j_loss(p):
        return j_agent.rollout(p, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1),
                               feedback=FEEDBACK_TEACHER, train=True)[0].ml_loss

    j_val, j_grads = jax.value_and_grad(j_loss)(j_params)
    tp = t_params()
    t_val = t_agent.rollout(tp, s["t_tables"], s["t_ep"], FEEDBACK_TEACHER, train=True,
                            generator=torch.Generator().manual_seed(0))[0].ml_loss
    t_val.backward()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=0, atol=1e-4)
    assert tp["encoder"]["embedding"]["w"].grad is None  # detached: no gradient at all
    assert not np.asarray(j_grads["encoder"]["embedding"]["w"]).any()  # JAX's stop_gradient
    for (path, got), want in zip(_leaves_with_paths(tp), jax.tree_util.tree_leaves(j_grads),
                                 strict=True):
        g = np.zeros(want.shape, np.float32) if got.grad is None else got.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=1e-4, err_msg=path)
    assert tp["encoder"]["enc2dec"]["w"].grad.abs().sum() > 0  # the rest of the encoder learns


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_with_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves_with_paths(v, f"{prefix}/{i}")]
    return [] if tree is None else [(prefix, tree)]


def _masked_logits(j_agent, j_params, s):
    """JAX's per-step masked logits [T, B, K] of the argmax rollout, as
    its scan hands them to ``select_action`` (its StepRecord keeps none):
    the scan run eagerly, step by step, under ``jax.disable_jit``."""
    import curriculum_learning_for_vln_tpu.agents.common as jc

    seen = []
    orig = jc.select_action

    def spy(feedback, masked_logits, teacher, rng):
        seen.append(np.asarray(masked_logits))
        return orig(feedback, masked_logits, teacher, rng)

    jc.select_action = spy
    try:
        with jax.disable_jit():
            j_agent.rollout(j_params, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1),
                            feedback=FEEDBACK_ARGMAX, train=False)
    finally:
        jc.select_action = orig
    return np.stack(seen)


@pytest.mark.parametrize("optim", ["rms", "adam"])
def test_table_stays_frozen_through_a_step(setup, tokenizer, optim):
    s = setup
    t_c, _ = _cfgs(s["path"], drop=0.5)  # the config's dropout: the table is not dropped
    agent = t_build_agent(t_c, tokenizer.vocab_size(), 64, vocab=tokenizer.vocab)
    params, ms = agent.init(torch.Generator().manual_seed(0))
    params = t_tree.tree_map(lambda t: t.requires_grad_(True), params)
    before = t_tree.tree_map(lambda t: t.detach().clone(), params)
    opt = t_loop.make_optimizer(optim, 1e-2, params)
    logs, _ = t_loop.agent_one_iter(agent, opt, "sample", s["t_tables"], params, ms, s["t_ep"],
                                    torch.Generator().manual_seed(1))
    assert np.isfinite(float(logs["loss"]))
    table = params["encoder"]["embedding"]["w"]
    assert table.grad is None and torch.equal(table.detach(), before["encoder"]["embedding"]["w"])
    np.testing.assert_array_equal(table.detach().numpy(), agent.glove)
    moved = [not torch.equal(a.detach(), b) for a, b in
             zip(t_tree.tree_leaves(params["encoder"]["layers"]),
                 t_tree.tree_leaves(before["encoder"]["layers"]))]
    assert all(moved)
