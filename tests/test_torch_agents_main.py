"""The port's agent factory, CLI, checkpoints, conversion and serving for
the Follower and the Self-Monitor, on the CPU, against the JAX package.

* ``TestAgent`` (``check_the_code``) on the synthetic world: SR 1.0,
  navigation error 0, the summary equal to JAX ``check_the_code``'s;
* ``build_agent`` for all four agent names, in the dtype TPU.PRECISION
  names;
* ``main.check_ported`` accepts the four configs under
  ``configs/{follower,monitor}/`` and ``--check-the-code``, and still
  refuses the rest;
* ``python -m curriculum_learning_for_vln_torch.main --device cpu`` style
  runs (in process) of one tiny epoch for FOLLOWER and SELF-MONITOR,
  classic and SPCL; the Self-Monitor's checkpoint keeps its BN state, the
  JAX package's loader reads it in the JAX layout, and it serves;
* a JAX Follower and a JAX Self-Monitor checkpoint served by the port's
  ``Navigator``: argmax trajectories equal to JAX ``Navigator``'s
  (f32, DROP_RATE irrelevant at eval);
* ``convert`` both ways for both trees and the model state.
"""
import os

import jax
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import convert as t_convert
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.engine import trainer as t_trainer
from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint as t_load
from curriculum_learning_for_vln_torch.serve import Navigator as TNavigator
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer as TTokenizer
from curriculum_learning_for_vln_torch.utils.tree import tree_leaves
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu import pipeline as j_pipeline
from curriculum_learning_for_vln_tpu.agents import build_agent as j_build_agent
from curriculum_learning_for_vln_tpu.engine import trainer as j_trainer
from curriculum_learning_for_vln_tpu.engine.checkpoint import load_checkpoint as j_load
from curriculum_learning_for_vln_tpu.engine.checkpoint import save_checkpoint as j_save
from curriculum_learning_for_vln_tpu.serve import Navigator as JNavigator
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("follower/follower_config.yaml", "follower/follower_cl_config.yaml",
           "monitor/selfmonitor_config.yaml", "monitor/selfmonitor_cl_config.yaml")
# a tiny synthetic universe and narrow widths (the configs' shapes otherwise)
TINY = ["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3, "TPU.SYNTHETIC_NODES", 24,
        "TPU.SYNTHETIC_TRAIN_PATHS", 20, "TPU.SYNTHETIC_VAL_PATHS", 6, "TRAIN.BATCH_SIZE", 8,
        "AGENT.MAX_EPISODE_LEN", 6, "DATA.MAX_ENC_LEN", 16,
        "MODEL.FOLLOWER.WORD_EMB_SIZE", 30, "MODEL.FOLLOWER.HIDDEN_SIZE", 32,
        "MODEL.MONITOR.WORD_EMB_SIZE", 16, "MODEL.MONITOR.HIDDEN_SIZE", 32,
        "MODEL.MONITOR.MLP_HIDDEN", "(48,)", "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", ""]


def _cfg(make, config, extra=()):
    cfg = make()
    cfg.merge_from_file(os.path.join(REPO, "configs", config))
    cfg.merge_from_list([*TINY, *extra])
    return cfg


def test_check_the_code_matches_jax():
    cfg_t, cfg_j = (_cfg(make, "follower/follower_config.yaml") for make in (t_cfg, j_cfg))
    tok_t, tok_j = t_pipeline.build_tokenizer(cfg_t), j_pipeline.build_tokenizer(cfg_j)
    world_t, _, valid_t, _ = t_pipeline.build_environments(cfg_t, tok_t, seed=3, device="cpu")
    world_j, _, valid_j, _ = j_pipeline.build_environments(cfg_j, tok_j, seed=3)
    got = t_trainer.check_the_code(cfg_t, world_t.device_tables("f32", "cpu"), valid_t)
    want = j_trainer.check_the_code(cfg_j, world_j.device_tables("f32"), valid_j)
    assert got["success_rate"] == 1.0 and got["nav_error"] == 0.0
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["FOLLOWER", "SELF-MONITOR", "ENVDROP", "TEST"])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_build_agent_for_every_name(name, prec):
    overrides = ["MODEL.NAME", name, "TPU.PRECISION", prec]
    cfg_t, cfg_j = t_cfg(), j_cfg()
    for cfg in (cfg_t, cfg_j):
        cfg.merge_from_list(overrides)
    agent, jagent = t_build_agent(cfg_t, 20, feat_dim=64), j_build_agent(cfg_j, 20, feat_dim=64)
    assert agent.name == jagent.name == name and agent.episode_len == jagent.episode_len
    if name != "TEST":
        assert agent.compute_dtype == {"bf16": torch.bfloat16, "f32": torch.float32}[prec]
        assert agent.feature_size == jagent.feature_size == 64 + 128
    if name == "ENVDROP":
        assert agent.obs_masks == cfg_t.TPU.OBS_MASKS
    cfg_t.merge_from_list(["MODEL.NAME", "SPEAKER"])
    with pytest.raises(NotImplementedError):
        t_build_agent(cfg_t, 20)


def test_check_ported_accepts_the_agents_and_refuses_the_rest():
    for config in CONFIGS:
        args, cfg = t_main.parse_args(["--device", "cpu", "--config-file",
                                       os.path.join(REPO, "configs", config)])
        t_main.check_ported(args, cfg)
        args, cfg = t_main.parse_args(["--device", "cpu", "--check-the-code", "--config-file",
                                       os.path.join(REPO, "configs", config)])
        t_main.check_ported(args, cfg)
        args, cfg = t_main.parse_args(["--device", "cpu", "--beam", "3", "--config-file",
                                       os.path.join(REPO, "configs", config)])
        t_main.check_ported(args, cfg)  # beam search runs every ported agent
    for config in CONFIGS:  # back-translation is EnvDrop's alone
        args, cfg = t_main.parse_args(["--device", "cpu", "--self-train", "--config-file",
                                       os.path.join(REPO, "configs", config)])
        with pytest.raises(ValueError, match="--self-train"):
            t_main.check_ported(args, cfg)
    for extra in (["MODEL.FOLLOWER.GLOVE_PATH", "glove.npy"], ["TRAIN.CLMODE", "AUTO"],
                  ["TRAIN.EVAL_TRAIN", "True"], ["TPU.SCAN_EARLY_EXIT", "True"],
                  ["AGENT.TEACHER", "path"], ["TPU.FUSED_BPTT", "True"]):  # ported since
        args, cfg = t_main.parse_args(["--device", "cpu", "--config-file",
                                       os.path.join(REPO, "configs", CONFIGS[1]), *extra])
        t_main.check_ported(args, cfg)
    # JAX's build_agent raises on SPEAKER; its trainer fails on TEST (no loss_fn)
    for extra, what in ((["MODEL.NAME", "SPEAKER"], "SPEAKER"), (["MODEL.NAME", "TEST"], "TEST"),
                        (["--beam", "3", "MODEL.NAME", "TEST"], "TEST")):
        args, cfg = t_main.parse_args(["--device", "cpu", "--config-file",
                                       os.path.join(REPO, "configs", CONFIGS[1]), *extra])
        with pytest.raises(NotImplementedError, match=what):
            t_main.check_ported(args, cfg)
    args, cfg = t_main.parse_args(["--device", "cpu", "--check-the-code", "--config-file",
                                   os.path.join(REPO, "configs", CONFIGS[1]), "MODEL.NAME", "TEST"])
    t_main.check_ported(args, cfg)  # the TestAgent's own mode


@pytest.mark.parametrize("config", CONFIGS)
def test_main_trains_one_tiny_epoch(config, tmp_path):
    """Classic (the R2R configs) and SPCL (the _cl_ configs, SELF-PACE as
    shipped, its update at the end of the epoch) through ``main``."""
    ckpt = tmp_path / "ckpt"
    argv = ["--device", "cpu", "--seed", "3", "--config-file", os.path.join(REPO, "configs", config),
            *map(str, TINY), "TRAIN.MAX_EPOCH", "1", "TRAIN.ITER_PER_EPOCH", "2",
            "TRAIN.EVAL_INTERVAL", "1", "TRAIN.SELF_PACE.INTERVAL", "1",
            "OUTPUT.CKPT_DIR", str(ckpt)]
    args, cfg = t_main.parse_args(argv)
    t_main.main(args, cfg)
    bundle = t_load(str(ckpt / "latest.ckpt"))
    assert bundle["epoch"] == 1
    assert (bundle["curriculum"] is not None) == ("_cl_" in config)
    if cfg.MODEL.NAME == "SELF-MONITOR":
        # the BN state after the epoch, in the JAX layout, read by the JAX loader
        jb = j_load(str(ckpt / "latest.ckpt"))
        _, j_state = j_build_agent(_cfg(j_cfg, config), 40, 64).init(jax.random.PRNGKey(0))
        assert (jax.tree_util.tree_structure(jb["model_state"])
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, j_state)))
        assert float(jb["model_state"]["decoder_bn"]["mlp"]["bn_in"]["count"]) > 0
    else:
        assert bundle["model_state"] == {}


@pytest.fixture(scope="module")
def served(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    enc_len = 12
    j_tok = type(tokenizer)(tokenizer.vocab, encoding_length=enc_len)
    t_tok = TTokenizer(tokenizer.vocab, encoding_length=enc_len)
    reqs = [{"instruction": it["instructions"][0], "scan": it["scan"],
             "start_viewpoint": it["path"][0], "heading": it["heading"]}
            for it in synth_dataset[:7]]
    return t_world, synth_world, t_tok, j_tok, reqs


@pytest.mark.parametrize("config", ["follower/follower_config.yaml",
                                    "monitor/selfmonitor_config.yaml"])
def test_jax_checkpoint_serves_like_jax(served, config, tmp_path):
    t_world, j_world, t_tok, j_tok, reqs = served
    cfg_j = _cfg(j_cfg, config, ["TPU.PRECISION", "f32", "DATA.MAX_ENC_LEN", 12])
    cfg_t = _cfg(t_cfg, config, ["TPU.PRECISION", "f32", "DATA.MAX_ENC_LEN", 12])
    j_agent = j_build_agent(cfg_j, j_tok.vocab_size(), 64)
    t_agent = t_build_agent(cfg_t, t_tok.vocab_size(), 64)
    params, state = j_agent.init(jax.random.PRNGKey(5))
    if state:  # a BN state that is not the initial one
        state = jax.tree_util.tree_map(lambda a: a + 0.25, state)
    path = str(tmp_path / "jax.ckpt")
    j_save(path, params, model_state=state, epoch=2)
    j_nav = JNavigator(j_world, j_agent, params, state, j_tok, max_batch=8, precision="f32",
                       use_pallas=False)
    t_nav = TNavigator.from_checkpoint(t_world, t_agent, path, t_tok, max_batch=8,
                                       precision="f32", device="cpu")
    want = [o["trajectory"] for o in j_nav.navigate_batch(reqs)]
    got = [o["trajectory"] for o in t_nav.navigate_batch(reqs)]
    assert got == want
    assert any(len(t) > 1 for t in got)  # the agents really move
    # the Navigator holds the checkpoint's model state
    served_state = tree_leaves(t_nav.model_state)
    assert len(served_state) == len(jax.tree_util.tree_leaves(state))
    for a, b in zip(served_state, jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("config", ["follower/follower_config.yaml",
                                    "monitor/selfmonitor_config.yaml"])
def test_convert_both_ways(config):
    cfg = _cfg(j_cfg, config)
    j_agent = j_build_agent(cfg, 40, 64)
    params, state = j_agent.init(jax.random.PRNGKey(5))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    tp = t_convert.params_from_jax(np_params)
    ts = t_convert.model_state_from_jax(np_state)
    assert t_convert.tree_kind(np_params) == cfg.MODEL.NAME
    back, back_state = t_convert.params_to_jax(tp), t_convert.model_state_to_jax(ts)
    for tree, ref in ((back, np_params), (back_state, np_state)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, b)
    # the port's own initial trees have the JAX trees' structure and shapes
    t_agent = t_build_agent(_cfg(t_cfg, config), 40, 64)
    own, own_state = t_agent.init(torch.Generator().manual_seed(0))
    for tree, ref in ((t_convert.params_to_jax(own), np_params),
                      (t_convert.model_state_to_jax(own_state), np_state)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref)
        assert ([np.shape(a) for a in jax.tree_util.tree_leaves(tree)]
                == [np.shape(a) for a in jax.tree_util.tree_leaves(ref)])
    with pytest.raises(ValueError, match="not an EnvDrop, Follower or Self-Monitor"):
        t_convert.params_from_jax({"encoder": np_params["encoder"]})
