"""Beam search with speaker rescoring, the slice as a whole: the port's
``BeamSearch.beam_rollout`` / ``beam_search`` and ``run_beam_eval``
against the JAX package's, and the port's ``main --beam``.

The shared synthetic world (3 scans x 24 nodes, 64-d features), tiny
agents (EnvDrop H = 64, the Follower H = 64 with one encoder layer) and a
tiny speaker (RNN_DIM 64, WEMB 32), all in f32, the JAX parameters
carried across with ``convert.py`` or read by the port from the JAX
package's own checkpoint files:

* ``beam_rollout``: the per-word speaker scores of every finished path
  within 1e-4 (the speaker's f32 encoder and decoder, summed in another
  order), and ``visual_feature`` popped;
* ``beam_search`` over a 7-item split: one result per instr_id, JAX's;
* ``run_beam_eval`` with an agent checkpoint (OUTPUT.RESUME) and a
  speaker checkpoint (AIDE.SPEAKER.RESUME) written by the JAX package:
  the same selected trajectories, the same SR and SPL, and the same
  files (the submission format; the full beam's scores within 1e-5 /
  1e-4);
* ``main --beam 2 --device cpu`` with the flags of the JAX package's
  ``test_beam_cli``: the ``beam(2) val_unseen: SR=`` line and both
  files per split; the modes the port still refuses raise with --beam.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch.agents import beam as t_beam
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TEnvDrop
from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TFollower
from curriculum_learning_for_vln_torch.agents.speaker import Speaker as TSpeaker
from curriculum_learning_for_vln_torch.engine import beam_eval as t_beam_eval
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils import config as t_config
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import beam as j_beam
from curriculum_learning_for_vln_tpu.agents import EnvDropAgent as JEnvDrop
from curriculum_learning_for_vln_tpu.agents import FollowerAgent as JFollower
from curriculum_learning_for_vln_tpu.agents.speaker import Speaker as JSpeaker
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine import beam_eval as j_beam_eval
from curriculum_learning_for_vln_tpu.engine import checkpoint as j_checkpoint
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils import config as j_config

torch.set_num_threads(2)
FEAT_DIM, ENC_LEN, EP_LEN = 64, 24, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(config, name="FOLLOWER"):
    cfg = config.get_cfg_defaults()
    cfg.MODEL.NAME = name
    m = cfg.MODEL.FOLLOWER
    m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS = 32, 64, 1
    m = cfg.MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    s = cfg.AIDE.SPEAKER
    s.RNN_DIM, s.WEMB, s.MAX_DECODE = 64, 32, 16
    cfg.TPU.PRECISION = "f32"
    cfg.AGENT.MAX_EPISODE_LEN = EP_LEN
    cfg.DATA.MAX_ENC_LEN = ENC_LEN
    return cfg


def _agents(name, vocab):
    jc, tc = _cfg(j_config), _cfg(t_config)
    if name == "FOLLOWER":
        return (JFollower(jc.MODEL.FOLLOWER, vocab, FEAT_DIM, episode_len=EP_LEN),
                TFollower(tc.MODEL.FOLLOWER, vocab, FEAT_DIM, EP_LEN))
    return (JEnvDrop(jc.MODEL.ENVDROP, ENC_LEN, vocab, FEAT_DIM, episode_len=EP_LEN),
            TEnvDrop(tc.MODEL.ENVDROP, ENC_LEN, vocab, FEAT_DIM, EP_LEN))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def ctx(synth_world, synth_graphs, synth_dataset, tokenizer):
    data = expand_r2r_items(synth_dataset, tokenizer)
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    vocab = tokenizer.vocab_size()
    j_spk = JSpeaker(_cfg(j_config).AIDE.SPEAKER, vocab, feat_dim=FEAT_DIM, episode_len=EP_LEN)
    t_spk = TSpeaker(_cfg(t_config).AIDE.SPEAKER, vocab, feat_dim=FEAT_DIM, episode_len=EP_LEN)
    j_spk_params, _ = j_spk.init(jax.random.PRNGKey(1))
    t_spk_params, _ = t_spk.prepare(convert.params_from_jax(_np(j_spk_params)))
    return synth_world, t_world, data, j_spk, t_spk, j_spk_params, t_spk_params


def _compare_scored(got, want):
    assert [r["instr_id"] for r in got] == [r["instr_id"] for r in want]
    n = 0
    for r_t, r_j in zip(got, want):
        assert r_t["dijk_path"] == r_j["dijk_path"]
        assert len(r_t["paths"]) == len(r_j["paths"])
        for p_t, p_j in zip(r_t["paths"], r_j["paths"]):
            assert "visual_feature" not in p_t and "visual_feature" not in p_j
            assert p_t["trajectory"] == p_j["trajectory"]
            np.testing.assert_allclose(p_t["listener_scores"], p_j["listener_scores"], rtol=0,
                                       atol=1e-5)
            s_t, s_j = np.asarray(p_t["speaker_scores"]), np.asarray(p_j["speaker_scores"])
            assert s_t.shape == s_j.shape and s_t.size > 0
            np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-4)
            assert np.all(s_t <= 1e-6)  # negated per-word losses
            n += 1
    assert n > 0


@pytest.mark.parametrize("name", ["FOLLOWER", "ENVDROP"])
def test_beam_rollout_speaker_scores_match_jax(ctx, tokenizer, name):
    world, t_world, data, j_spk, t_spk, j_spk_params, t_spk_params = ctx
    j_agent, t_agent = _agents(name, tokenizer.vocab_size())
    j_params, j_state = j_agent.init(jax.random.PRNGKey(0))
    t_params = convert.params_from_jax(_np(j_params))
    j_ep = JEnv(world, data, batch_size=3, tokenizer=tokenizer, seed=11).next_batch()
    t_ep = TEnv(t_world, data, 3, tokenizer, seed=11, device="cpu").next_batch()
    want = j_beam.BeamSearch(j_agent, world, world.device_tables(), max_iters=40).beam_rollout(
        j_params, j_state, j_ep, data, j_spk, j_spk_params, beam_size=3)
    got = t_beam.BeamSearch(t_agent, t_world, t_world.device_tables("f32", device="cpu"),
                            max_iters=40).beam_rollout(t_params, {}, t_ep, data, t_spk,
                                                       t_spk_params, beam_size=3)
    _compare_scored(got, want)


def test_full_beam_search_split_matches_jax(ctx, tokenizer):
    world, t_world, data, j_spk, t_spk, j_spk_params, t_spk_params = ctx
    small = data[:7]
    j_agent, t_agent = _agents("FOLLOWER", tokenizer.vocab_size())
    j_params, j_state = j_agent.init(jax.random.PRNGKey(0))
    t_params = convert.params_from_jax(_np(j_params))
    want = j_beam.BeamSearch(j_agent, world, world.device_tables(), max_iters=30).beam_search(
        j_params, j_state, JEnv(world, small, batch_size=3, tokenizer=tokenizer, seed=2), small,
        j_spk, j_spk_params, beam_size=2)
    got = t_beam.BeamSearch(t_agent, t_world, t_world.device_tables("f32", device="cpu"),
                            max_iters=30).beam_search(
        t_params, {}, TEnv(t_world, small, 3, tokenizer, seed=2, device="cpu"), small, t_spk,
        t_spk_params, beam_size=2)
    assert list(got) == list(want)
    assert set(got) == {it["instr_id"] for it in small}
    _compare_scored(list(got.values()), list(want.values()))


def test_run_beam_eval_matches_jax_from_jax_checkpoints(ctx, tokenizer, tmp_path, monkeypatch):
    world, t_world, data, j_spk, _, j_spk_params, _ = ctx
    # the JAX run_beam_eval hands the pickled numpy parameters straight to its
    # jitted scans, which cannot index numpy arrays with a traced step; its
    # trainer puts them on the device first (M.replicate), as done here
    load = j_checkpoint.load_checkpoint
    monkeypatch.setattr(j_checkpoint, "load_checkpoint", lambda path: {
        k: jax.tree_util.tree_map(jnp.asarray, v) if k in ("params", "model_state") else v
        for k, v in load(path).items()})
    vocab = tokenizer.vocab_size()
    j_agent, t_agent = _agents("FOLLOWER", vocab)
    j_params, j_state = j_agent.init(jax.random.PRNGKey(5))
    j_checkpoint.save_checkpoint(str(tmp_path / "ckpt" / "agent.ckpt"), _np(j_params),
                                 model_state=j_state)
    j_spk.save(str(tmp_path / "speaker.ckpt"), _np(j_spk_params), None)
    splits = {"val_seen": data[:12], "val_unseen": data[12:24]}
    out = {}
    for pkg, config in (("jax", j_config), ("port", t_config)):
        cfg = _cfg(config)
        cfg.OUTPUT.CKPT_DIR = str(tmp_path / "ckpt")
        cfg.OUTPUT.RESUME = "agent"
        cfg.OUTPUT.RESULT_DIR = str(tmp_path / pkg)
        cfg.AIDE.SPEAKER.RESUME = str(tmp_path / "speaker.ckpt")
        cfg.TPU.BEAM_SPEAKER_WEIGHT = 0.5
        if pkg == "jax":
            envs = {k: JEnv(world, v, batch_size=4, tokenizer=tokenizer, seed=0, name=k)
                    for k, v in splits.items()}
            out[pkg] = j_beam_eval.run_beam_eval(cfg, j_agent, world, envs, tokenizer,
                                                 beam_size=3, seed=9)
        else:
            envs = {k: TEnv(t_world, v, 4, tokenizer, seed=0, name=k, device="cpu")
                    for k, v in splits.items()}
            out[pkg] = t_beam_eval.run_beam_eval(cfg, t_agent, t_world, envs, tokenizer,
                                                 beam_size=3, seed=9, device="cpu")
    for split in splits:
        for key in ("success_rate", "spl", "nav_error", "lengths"):
            assert out["port"][split][key] == out["jax"][split][key], (split, key)
        with open(tmp_path / "port" / f"beam_{split}.json") as f:
            sel_t = json.load(f)
        with open(tmp_path / "jax" / f"beam_{split}.json") as f:
            sel_j = json.load(f)
        assert sel_t == sel_j and len(sel_t) == 12
        assert all(set(r) == {"instr_id", "trajectory"} for r in sel_t)
        with open(tmp_path / "port" / f"beam_{split}_full.json") as f:
            full_t = json.load(f)
        with open(tmp_path / "jax" / f"beam_{split}_full.json") as f:
            full_j = json.load(f)
        for r_t, r_j in zip(full_t, full_j):
            assert set(r_t) == set(r_j) == {"instr_id", "dijk_path", "paths"}
            assert r_t["instr_id"] == r_j["instr_id"] and r_t["dijk_path"] == r_j["dijk_path"]
            for p_t, p_j in zip(r_t["paths"], r_j["paths"]):
                assert set(p_t) == set(p_j)
                assert p_t["trajectory"] == p_j["trajectory"]
                np.testing.assert_allclose(p_t["listener_scores"], p_j["listener_scores"],
                                           rtol=0, atol=1e-5)
                np.testing.assert_allclose(p_t["speaker_scores"], p_j["speaker_scores"], rtol=0,
                                           atol=1e-4)


BEAM_CLI = ["--config-file", os.path.join(REPO, "configs/follower/follower_config.yaml"),
            "--seed", "7", "--beam", "2", "TPU.SYNTHETIC_WORLD", "True",
            "TPU.SYNTHETIC_SCANS", "2", "TPU.SYNTHETIC_NODES", "24",
            "TPU.SYNTHETIC_VAL_PATHS", "4", "TPU.SYNTHETIC_TRAIN_PATHS", "12",
            "TRAIN.BATCH_SIZE", "4", "AGENT.MAX_EPISODE_LEN", "6", "DATA.MAX_ENC_LEN", "24",
            "MODEL.FOLLOWER.WORD_EMB_SIZE", "32", "MODEL.FOLLOWER.HIDDEN_SIZE", "64",
            "MODEL.FOLLOWER.ENC_LAYERS", "1", "AIDE.SPEAKER.RNN_DIM", "64",
            "AIDE.SPEAKER.WEMB", "32", "AIDE.SPEAKER.MAX_DECODE", "12"]


def test_main_beam_runs_on_the_synthetic_world(tmp_path, capsys):
    args, cfg = t_main.parse_args(["--device", "cpu", *BEAM_CLI,
                                   "OUTPUT.CKPT_DIR", str(tmp_path / "ckpt"),
                                   "OUTPUT.RESULT_DIR", str(tmp_path / "results"),
                                   "OUTPUT.LOG_DIR", str(tmp_path / "logs")])
    t_main.main(args, cfg)
    stdout = capsys.readouterr().out
    assert "beam(2) val_unseen: SR=" in stdout and "beam(2) val_seen: SR=" in stdout
    for split in ("val_seen", "val_unseen"):
        with open(tmp_path / "results" / f"beam_{split}.json") as f:
            selected = json.load(f)
        assert len(selected) == 12  # 4 paths x 3 instructions, the submission format
        for r in selected:
            assert set(r) == {"instr_id", "trajectory"}
            vp, h, e = r["trajectory"][0]
            assert isinstance(vp, str)
        with open(tmp_path / "results" / f"beam_{split}_full.json") as f:
            full = json.load(f)
        assert all(p["listener_scores"] and p["speaker_scores"] for r in full for p in r["paths"])


PORTED_SINCE = ("GLOVE", "curriculum", "EVAL_TRAIN", "SCAN_EARLY_EXIT", "FUSED_BPTT")


@pytest.mark.parametrize("extra,what", [
    (["MODEL.NAME", "SPEAKER"], "SPEAKER"),
    (["MODEL.FOLLOWER.GLOVE_PATH", "glove.npy"], "GLOVE"),
    (["DATA.NAME", "CLR2R", "TRAIN.CLMODE", "AUTO"], "curriculum"),
    (["TRAIN.EVAL_TRAIN", "True"], "EVAL_TRAIN"),
    (["TPU.SCAN_EARLY_EXIT", "True"], "SCAN_EARLY_EXIT"),
    (["TPU.FUSED_BPTT", "True"], "FUSED_BPTT")])
def test_main_beam_still_refuses_what_is_not_ported(extra, what):
    args, cfg = t_main.parse_args(["--device", "cpu", *BEAM_CLI, *extra])
    if what in PORTED_SINCE:  # GloVe, AUTO, EVAL_TRAIN, the early exit and the BPTT are ported
        t_main.check_ported(args, cfg)
        return
    with pytest.raises(NotImplementedError, match=what):
        t_main.check_ported(args, cfg)
