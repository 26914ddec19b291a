"""Back-translation self-training, the slice as a whole: the port's
``engine.self_train`` against the JAX package's, and ``main --self-train``.

* ``self_train`` on the JAX test's setup (tests/test_self_train.py: 60
  real and the rest augmentation items of the synthetic dataset, B = 4, T
  = 6, EnvDrop at H = 64, the speaker at RNN_DIM 64, MAX_DECODE 16),
  speaker_iters 2, iters_per_epoch 4, one epoch, in f32: both dropout rates
  and the speaker's at 0; both samplers patched to argmax(logits + one
  fixed noise); the initial parameters (``Speaker.init``, ``agent.init``)
  and the shared noise masks (``make_drop_mask``, a 0.3 dropout mask each
  back-translated iteration) recorded from the JAX run and fed to the
  port (pytest's ``monkeypatch``, in this process only).  The speaker's
  pretraining losses, the real and back-translated losses of every
  iteration, and the final EnvDrop and speaker parameters agree within
  1e-4 (a run of f32 updates whose sums run in another order).
* ``main --self-train --device cpu`` on a tiny synthetic universe runs to
  its end (200 speaker iterations, as the JAX main gives), through the
  speaker, real and back-translated iterations; ``--beam`` with a mode
  the port does not run yet still raises.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.agents.speaker import Speaker as TSpeaker
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils import config as t_config
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.agents.speaker import Speaker as JSpeaker
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine.self_train import self_train as j_self_train
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.models import core as j_core
from curriculum_learning_for_vln_tpu.utils import config as j_config

# the module (the package exports its function of the same name)
t_st = importlib.import_module("curriculum_learning_for_vln_torch.engine.self_train")
torch.set_num_threads(2)

FEAT_DIM, EP_LEN, B = 64, 6, 4
ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(config):
    cfg = config.get_cfg_defaults()
    m = cfg.MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.ML_WEIGHT, m.GAMMA, m.RL_NORMALIZE = 0.2, 0.9, "total"
    m.DROP_RATE = m.FEAT_DROP_RATE = 0.0
    cfg.TRAIN.OPTIM, cfg.TRAIN.LR = "rms", 1e-3
    s = cfg.AIDE.SPEAKER
    s.RNN_DIM, s.WEMB, s.MAX_DECODE, s.LR = 64, 32, 16, 1e-3
    s.DROPOUT = s.FEAT_DROPOUT = 0.0
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_self_train_matches_jax(synth_world, synth_graphs, synth_dataset, tokenizer,
                                monkeypatch):
    data = expand_r2r_items(synth_dataset, tokenizer)
    V = tokenizer.vocab_size()
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))

    # the JAX run, its initial parameters, masks and pretraining losses recorded
    cfg_j = _cfg(j_config)
    j_agent = JAgent(cfg_j.MODEL.ENVDROP, 24, V, FEAT_DIM, episode_len=EP_LEN)
    j_spk = JSpeaker(cfg_j.AIDE.SPEAKER, V, feat_dim=FEAT_DIM, episode_len=EP_LEN)
    rec = {"masks": [], "pretrain": []}
    spk_init, agent_init, spk_steps = j_spk.init, j_agent.init, j_spk.train_steps

    def record_mask(rng, feat_dim):
        m = j_core.dropout_mask(rng, (feat_dim,), 0.3)
        rec["masks"].append(np.asarray(m))
        return m

    def record_spk_init(key):
        rec["spk"] = spk_init(key)[0]
        return spk_init(key)

    def record_agent_init(key):
        rec["agent"] = agent_init(key)[0]
        return agent_init(key)

    def record_steps(*args, **kwargs):
        out = spk_steps(*args, **kwargs)
        rec["pretrain"] += out[2]
        return out

    monkeypatch.setattr(j_spk, "make_drop_mask", record_mask)
    monkeypatch.setattr(j_spk, "init", record_spk_init)
    monkeypatch.setattr(j_agent, "init", record_agent_init)
    monkeypatch.setattr(j_spk, "train_steps", record_steps)
    params_j, _, (spk_j, _), losses_j = j_self_train(
        cfg_j, j_agent, j_spk, JEnv(synth_world, data[:60], B, tokenizer, seed=1),
        JEnv(synth_world, data[60:], B, tokenizer, seed=2), synth_world.device_tables(),
        seed=0, speaker_iters=2, epochs=1, iters_per_epoch=4)
    assert len(rec["masks"]) == 2 and len(rec["pretrain"]) == 2

    # the port from the same start
    cfg_t = _cfg(t_config)
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    t_agent = TAgent(cfg_t.MODEL.ENVDROP, 24, V, FEAT_DIM, EP_LEN)
    t_spk = TSpeaker(cfg_t.AIDE.SPEAKER, V, feat_dim=FEAT_DIM, episode_len=EP_LEN)
    masks = iter(rec["masks"])
    t_pretrain = []
    t_steps = t_spk.train_steps

    def t_record_steps(*args, **kwargs):
        out = t_steps(*args, **kwargs)
        t_pretrain.extend(out[2])
        return out

    monkeypatch.setattr(t_spk, "init", lambda generator, device=None: t_spk.prepare(
        convert.params_from_jax(_np(rec["spk"])), device))
    monkeypatch.setattr(t_agent, "init",
                        lambda generator, device=None: convert.params_from_jax(_np(rec["agent"])))
    monkeypatch.setattr(t_spk, "make_drop_mask", lambda generator, feat_dim, device=None:
                        torch.from_numpy(next(masks).copy()))
    monkeypatch.setattr(t_spk, "train_steps", t_record_steps)
    params_t, state_t, (spk_t, _), losses_t = t_st.self_train(
        cfg_t, t_agent, t_spk, TEnv(t_world, data[:60], B, tokenizer, seed=1, device="cpu"),
        TEnv(t_world, data[60:], B, tokenizer, seed=2, device="cpu"),
        t_world.device_tables("f32", device="cpu"), seed=0, speaker_iters=2, epochs=1,
        iters_per_epoch=4)

    assert state_t == {} and next(masks, None) is None
    np.testing.assert_allclose(t_pretrain, rec["pretrain"], rtol=0, atol=ATOL)
    for k in ("real", "bt"):
        assert len(losses_t[k]) == 2
        np.testing.assert_allclose(losses_t[k], losses_j[k], rtol=0, atol=ATOL, err_msg=k)
    for got_tree, want_tree, start in ((params_t, params_j, rec["agent"]),
                                       (spk_t, spk_j, rec["spk"])):
        got, want = t_tree.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL)
        moved = max(float(np.abs(np.asarray(w) - np.asarray(s)).max())
                    for w, s in zip(want, jax.tree_util.tree_leaves(start)))
        assert moved > 10 * ATOL  # the run really trains both


TINY = ["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3, "TPU.SYNTHETIC_NODES", 24,
        "TPU.SYNTHETIC_TRAIN_PATHS", 30, "TPU.SYNTHETIC_VAL_PATHS", 6, "TPU.PRECISION", "f32",
        "TRAIN.BATCH_SIZE", 4, "TRAIN.MAX_EPOCH", 1, "TRAIN.ITER_PER_EPOCH", 2,
        "AGENT.MAX_EPISODE_LEN", 5, "DATA.MAX_ENC_LEN", 20, "MODEL.ENVDROP.WORD_EMB_SIZE", 16,
        "MODEL.ENVDROP.ACT_EMB_SIZE", 8, "MODEL.ENVDROP.HIDDEN_SIZE", 32,
        "AIDE.SPEAKER.RNN_DIM", 32, "AIDE.SPEAKER.WEMB", 16, "AIDE.SPEAKER.MAX_DECODE", 8]


@pytest.mark.parametrize("config", ["envdrop_config.yaml", "envdrop_cl_config.yaml"])
def test_main_self_train_runs(config, tmp_path, monkeypatch):
    """R2R (one env) and CLR2R under NAIVE (round_5), as the JAX main picks
    the episode source; the speaker, real and back-translated iterations
    all run."""
    calls = {"bt": 0, "pretrain": []}
    bt_step, pretrain = t_st.backtranslation_step, t_st.pretrain_speaker

    def count_bt(*args, **kwargs):
        calls["bt"] += 1
        return bt_step(*args, **kwargs)

    def spy_pretrain(*args, **kwargs):
        out = pretrain(*args, **kwargs)
        calls["pretrain"] = out[2]
        return out

    monkeypatch.setattr(t_st, "backtranslation_step", count_bt)
    monkeypatch.setattr(t_st, "pretrain_speaker", spy_pretrain)
    opts = TINY + ["OUTPUT.LOG_DIR", str(tmp_path / "logs"), "OUTPUT.TSBOARD_DIR", "",
                   "OUTPUT.CKPT_DIR", str(tmp_path / "ckpt")]
    if "_cl_" in config:
        opts += ["TRAIN.CLMODE", "NAIVE"]
    args, cfg = t_main.parse_args(["--device", "cpu", "--self-train", "--seed", "1",
                                   "--config-file", os.path.join(REPO, "configs/envdrop", config),
                                   *map(str, opts)])
    t_main.main(args, cfg)
    assert len(calls["pretrain"]) == 200 and np.isfinite(calls["pretrain"]).all()
    assert calls["bt"] == 1  # iterations 0 and 1 of one epoch: real, then back-translated


def test_main_beam_is_still_refused():
    """--beam is ported; with what JAX's main cannot run either (an agent
    its build_agent does not know) it is still refused, before any data is
    loaded."""
    args, cfg = t_main.parse_args(["--device", "cpu", "--beam", "3"])
    t_main.check_ported(args, cfg)
    args, cfg = t_main.parse_args(["--device", "cpu", "--beam", "3", "TPU.FUSED_BPTT", "True"])
    t_main.check_ported(args, cfg)  # ported since
    args, cfg = t_main.parse_args(["--device", "cpu", "--beam", "3", "MODEL.NAME", "SPEAKER"])
    with pytest.raises(NotImplementedError, match="SPEAKER"):
        t_main.main(args, cfg)
