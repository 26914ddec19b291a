"""The port's Exp3.S curriculum (``TRAIN.CLMODE AUTO``) and the per-round
train evaluation (``TRAIN.EVAL_TRAIN``) against the JAX package:

* ``Exp3S``: the arms drawn, ``pi``, ``log_w`` and the reward window over a
  seeded reward stream, exactly (the same numpy arithmetic);
* ``AutoCurriculum``: ``from_config``'s defaults for the zero
  placeholders, the arms ``iter_env`` draws, ``on_epoch_losses``' rewards
  and ``curriculum_state``, exactly; a bandit that the JAX package
  checkpoints resumes in the port, and the port's checkpoint in the JAX
  package;
* a short AUTO run, ``envdrop_cl_config.yaml`` (PACKED_RL 3 as shipped,
  which AUTO turns off) on a synthetic world through ``pipeline`` and
  ``main.build_trainer``, f32, dropout 0, both samplers replayed to the
  same choice, from JAX's initial parameters, with ``eval_train`` on: the
  same arms, per-iteration losses within 1e-4 (an RMSprop run of 8
  iterations whose f32 sums run in another order), the bandit's ``log_w``
  within 1e-6 of JAX's bandit fed the port's losses, and the per-round
  train scores (``Evaluation(data_name="CLR2R")``) and validation scores
  within 1e-6 of JAX's ``train_evaluator``'s.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import auto_curriculum as t_auto
from curriculum_learning_for_vln_torch.engine import trainer as t_trainer
from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_tpu import pipeline as j_pipeline
from curriculum_learning_for_vln_tpu.agents import build_agent as j_build_agent
from curriculum_learning_for_vln_tpu.engine import auto_curriculum as j_auto
from curriculum_learning_for_vln_tpu.engine import trainer as j_trainer
from curriculum_learning_for_vln_tpu.engine.checkpoint import load_checkpoint as j_load
from curriculum_learning_for_vln_tpu.engine.checkpoint import save_checkpoint as j_save
from curriculum_learning_for_vln_tpu.engine.loop import make_optimizer as j_make_optimizer
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CL_CONFIG = os.path.join(REPO, "configs/envdrop/envdrop_cl_config.yaml")
BANDITS = [dict(n_arms=5, eta=0.1, eps=0.05, alpha=0.001, beta=0.2, rrsize=100, seed=0),
           dict(n_arms=5, eta=0.6, eps=0.2, alpha=0.05, beta=0.1, rrsize=7, seed=11),
           dict(n_arms=3, eta=0.3, eps=0.01, alpha=0.0, beta=0.3, rrsize=2, seed=5)]


# ---------------------------------------------------------------------------
# The bandit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", BANDITS, ids=["defaults", "fast", "narrow"])
def test_exp3s_matches_jax_exactly(kw):
    t, j = t_auto.Exp3S(**kw), j_auto.Exp3S(**kw)
    rewards = np.random.default_rng(kw["seed"] + 1)
    for i in range(400):
        arm = t.sample()
        assert arm == j.sample()
        # a stream that favours arm 1, with ties and outliers in it
        r = float(rewards.normal(0.5 if arm == 1 else -0.2, 1.0)) if i % 17 else 0.0
        t.update(arm, r)
        j.update(arm, r)
        assert np.array_equal(t.log_w, j.log_w)
    np.testing.assert_array_equal(t.pi, j.pi)
    assert list(t.history) == list(j.history) and t.history.maxlen == j.history.maxlen
    assert abs(t.pi.sum() - 1.0) < 1e-9 and t.pi.min() >= kw["eps"] / kw["n_arms"] - 1e-12


def test_from_config_reads_the_placeholders_as_defaults():
    cfgs = (t_cfg(), j_cfg())
    for c in cfgs:  # the schema's zeros
        assert c.TRAIN.AUTO_CULM.ETA == 0.0 and c.TRAIN.AUTO_CULM.RRSIZE == 0
    t, j = t_auto.AutoCurriculum.from_config(cfgs[0], 3), j_auto.AutoCurriculum.from_config(
        cfgs[1], 3)
    assert t._cfg == j._cfg == dict(eta=0.1, eps=0.05, alpha=0.001, beta=0.2, rrsize=100, seed=3)
    for c in cfgs:
        c.merge_from_list(["TRAIN.AUTO_CULM.ETA", 0.4, "TRAIN.AUTO_CULM.RRSIZE", 9])
    t, j = t_auto.AutoCurriculum.from_config(cfgs[0]), j_auto.AutoCurriculum.from_config(cfgs[1])
    assert t._cfg == j._cfg and t._cfg["eta"] == 0.4 and t._cfg["rrsize"] == 9
    assert not t.supports_packed_rl() and not j.supports_packed_rl()


class _Env:
    def __init__(self, k):
        self.k = k


def _drive(trainer, envs, epochs=4, iters=6, seed=0):
    """select_env, then per iteration iter_env, per epoch on_epoch_losses
    of a seeded loss stream that falls faster on the easy rounds; the
    rounds drawn."""
    losses = np.random.default_rng(seed)
    drawn = []
    for ep in range(1, epochs + 1):
        epoch_env = trainer.select_env(envs, ep)
        assert epoch_env is envs
        ks = [trainer.iter_env(epoch_env, envs).k for _ in range(iters)]
        drawn += ks
        trainer.on_epoch_losses([float(5.0 - ep * (6 - k) * 0.1 + losses.normal(0, 0.05))
                                 for k in ks])
    return drawn


def test_auto_curriculum_matches_jax_exactly():
    envs = {f"round_{k}": _Env(k) for k in (3, 1, 5, 2, 4)}  # select_env sorts the keys
    t, j = t_auto.AutoCurriculum(eta=0.3, seed=2), j_auto.AutoCurriculum(eta=0.3, seed=2)
    assert t.curriculum_state() is None
    drawn = _drive(t, envs)
    assert drawn == _drive(j, envs)
    assert t._arms == j._arms == [] and len(set(drawn)) > 1
    st, sj = t.curriculum_state(), j.curriculum_state()
    assert st["kind"] == sj["kind"] == "exp3s"
    np.testing.assert_array_equal(st["log_w"], sj["log_w"])
    np.testing.assert_array_equal(st["history"], sj["history"])
    assert st["last_loss"] == sj["last_loss"] and set(st["last_loss"]) <= set(range(5))
    assert len(st["history"]) == 4 * 6 - len(st["last_loss"])  # a reward from each arm's 2nd draw


def _bandit_state(seed=2):
    j = j_auto.AutoCurriculum(eta=0.3, seed=seed)
    _drive(j, {f"round_{k}": _Env(k) for k in range(1, 6)}, seed=seed)
    return j


def _assert_same_bandit(a, b):
    np.testing.assert_array_equal(a.bandit.log_w, b.bandit.log_w)
    assert list(a.bandit.history) == list(b.bandit.history)
    assert a._last_loss == b._last_loss


def test_bandit_checkpoints_cross_between_packages(tmp_path):
    """JAX's bundle (a deque turned array, int keys) into the port, before
    and after ``select_env`` builds the bandit; the port's into JAX."""
    j = _bandit_state()
    params = {"w": np.zeros((2, 2), np.float32)}
    opt = j_make_optimizer("rms", 1e-4)
    j_save(str(tmp_path / "j.ckpt"), params, opt.init(params), {}, jax.random.PRNGKey(0),
           epoch=4, curriculum=j.curriculum_state())
    bundle = load_checkpoint(str(tmp_path / "j.ckpt"))
    envs = {f"round_{k}": _Env(k) for k in range(1, 6)}
    early, late = t_auto.AutoCurriculum(eta=0.3, seed=2), t_auto.AutoCurriculum(eta=0.3, seed=2)
    early.load_curriculum_state(bundle["curriculum"])  # before the bandit exists
    early.select_env(envs, 5)
    late.select_env(envs, 5)
    late.load_curriculum_state(bundle["curriculum"])
    for t in (early, late):
        _assert_same_bandit(t, j)
    late.load_curriculum_state({"weight": np.ones(3)})  # SPCL state: not the bandit's, ignored
    _assert_same_bandit(late, j)

    save_checkpoint(str(tmp_path / "t.ckpt"), {"w": torch.zeros(2, 2)}, epoch=4,
                    curriculum=late.curriculum_state())
    for load in (load_checkpoint, j_load):
        back = j_auto.AutoCurriculum(eta=0.3, seed=2)
        back.select_env(envs, 5)
        back.load_curriculum_state(load(str(tmp_path / "t.ckpt"))["curriculum"])
        _assert_same_bandit(back, j)


# ---------------------------------------------------------------------------
# A short AUTO run against the JAX trainer
# ---------------------------------------------------------------------------

B, ITERS, EPOCHS = 8, 4, 2


def _cfgs(tmp_path, *extra):
    overrides = ["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3, "TPU.SYNTHETIC_NODES", 24,
                 "TPU.SYNTHETIC_TRAIN_PATHS", 40, "TPU.SYNTHETIC_VAL_PATHS", 6,
                 "TRAIN.BATCH_SIZE", B, "DATA.MAX_ENC_LEN", 16, "TRAIN.CLMODE", "AUTO",
                 "TPU.PRECISION", "f32", "TPU.MESH_DATA", 1, "AGENT.MAX_EPISODE_LEN", 6,
                 "MODEL.ENVDROP.WORD_EMB_SIZE", 32, "MODEL.ENVDROP.ACT_EMB_SIZE", 16,
                 "MODEL.ENVDROP.HIDDEN_SIZE", 64, "MODEL.ENVDROP.DROP_RATE", 0.0,
                 "MODEL.ENVDROP.FEAT_DROP_RATE", 0.0, "TRAIN.MAX_EPOCH", EPOCHS,
                 "TRAIN.ITER_PER_EPOCH", ITERS, "TRAIN.EVAL_INTERVAL", EPOCHS,
                 "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", "", *extra]
    cfgs = []
    for make, sub in ((t_cfg, "t"), (j_cfg, "j")):
        cfg = make()
        cfg.merge_from_file(CL_CONFIG)
        cfg.merge_from_list(overrides + ["OUTPUT.CKPT_DIR", str(tmp_path / sub)])
        cfgs.append(cfg)
    return cfgs


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)

    def j_categorical(key, logits, axis=-1):
        assert logits.shape == noise.shape
        return jnp.argmax(logits + noise, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", j_categorical)
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def _recording(cls):
    class Recording(cls):
        def iter_env(self, epoch_env, train_env):
            env = super().iter_env(epoch_env, train_env)
            self.drawn.append(self._arms[-1])
            return env

        def on_epoch_losses(self, losses):
            self.losses.append(list(losses))
            super().on_epoch_losses(losses)

    return Recording


def _eval_envs(env_cls, world, train_env, tok, seed, **kw):
    """Per-round train-evaluation envs as main builds them (2 x BATCH_SIZE,
    seeds seed + 100 + k), over the synthetic rounds."""
    return {k: env_cls(world, e.data, 2 * B, tok, seed + 100 + int(k[-1]), "train", **kw)
            for k, e in train_env.items()}


def test_auto_training_matches_jax(tmp_path, fixed_sampler, monkeypatch):
    seed = 4
    t_c, j_c = _cfgs(tmp_path)
    assert t_c.TPU.PACKED_RL == 3  # as shipped: AUTO turns it off
    t_tok, j_tok = t_pipeline.build_tokenizer(t_c), j_pipeline.build_tokenizer(j_c)
    t_world, t_train, t_valid, feat_dim = t_pipeline.build_environments(t_c, t_tok, seed=seed,
                                                                        device="cpu")
    j_world, j_train, j_valid, _ = j_pipeline.build_environments(j_c, j_tok, seed=seed)
    # AUTO's arms are the individual rounds, round k seeded seed + k
    assert sorted(t_train) == sorted(j_train) == [f"round_{k}" for k in range(1, 6)]
    for k in t_train:
        assert [it["instr_id"] for it in t_train[k].data] == \
            [it["instr_id"] for it in j_train[k].data]
    assert not ({it["instr_id"] for it in t_train["round_1"].data}
                & {it["instr_id"] for it in t_train["round_2"].data})  # not cumulative

    j_agent = j_build_agent(j_c, j_tok.vocab_size(), feat_dim)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))  # the JAX trainer's init key
    j_params, _ = j_agent.init(init_rng)
    t_agent = t_build_agent(t_c, t_tok.vocab_size(), feat_dim)
    monkeypatch.setattr(t_agent, "init", lambda generator, device=None: params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_params)))
    summaries = {"t": [], "j": []}
    monkeypatch.setattr(t_trainer, "prettyprint", lambda s: summaries["t"].append(s))
    monkeypatch.setattr(j_trainer, "prettyprint", lambda s: summaries["j"].append(s))

    trainer = t_main.build_trainer(t_c, t_train, t_trainer.logger, seed=seed)
    assert type(trainer) is t_auto.AutoCurriculum
    t_run = _recording(t_auto.AutoCurriculum).from_config(t_c, seed=seed)
    j_run = _recording(j_auto.AutoCurriculum).from_config(j_c, seed=seed)
    assert t_run._cfg == trainer._cfg == j_run._cfg
    for run in (t_run, j_run):
        run.drawn, run.losses = [], []
    t_run.train(t_c, t_agent, "", t_train, t_valid, seed=seed, device="cpu", eval_train=True,
                eval_train_env=_eval_envs(TEnv, t_world, t_train, t_tok, seed, device="cpu"))
    j_run.train(j_c, j_agent, None, j_train, j_valid, eval_train=True,
                eval_train_env=_eval_envs(JEnv, j_world, j_train, j_tok, seed), seed=seed)

    assert t_run.drawn == j_run.drawn and len(t_run.drawn) == EPOCHS * ITERS
    np.testing.assert_allclose(np.asarray(t_run.losses), np.asarray(j_run.losses), rtol=0,
                               atol=1e-4)
    # the bandit on the host: JAX's, fed the port's losses in the same order
    replay = j_auto.AutoCurriculum.from_config(j_c, seed=seed)
    envs = {f"round_{k}": _Env(k) for k in range(1, 6)}
    for ep, losses in enumerate(t_run.losses, 1):
        replay.select_env(envs, ep)
        for _ in losses:
            replay.iter_env(envs, envs)
        assert replay._arms == t_run.drawn[(ep - 1) * ITERS: ep * ITERS]
        replay.on_epoch_losses(losses)
    np.testing.assert_allclose(t_run.bandit.log_w, replay.bandit.log_w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_run.bandit.log_w, j_run.bandit.log_w, rtol=0, atol=1e-3)
    assert len(t_run.bandit.history) > 0

    # one evaluation epoch: the train rounds first (eval_round_k), then validation
    assert len(summaries["t"]) == len(summaries["j"]) == 2
    train_scores, val_scores = summaries["t"]
    assert sorted(train_scores) == [f"round_{k}" for k in range(1, 6)]
    assert sorted(val_scores) == ["val_seen", "val_unseen"]
    for got, want in zip(summaries["t"], summaries["j"]):
        assert sorted(got) == sorted(want)
        for key in want:
            for mk in t_trainer.METRIC_KEYS:
                np.testing.assert_allclose(got[key][mk], want[key][mk], rtol=0, atol=1e-6,
                                           err_msg=f"{key}/{mk}")
    # every round's train split scored as CLR2R, one item a path
    assert all(train_scores[k]["success_rate"] >= 0.0 for k in train_scores)


def test_auto_resumes_a_jax_bandit(tmp_path, monkeypatch):
    """OUTPUT.RESUME of a JAX checkpoint: the port's AUTO run starts from the
    JAX bandit (its first draw reads the restored weights) and goes on
    rewarding it."""
    seed = 4
    t_c, j_c = _cfgs(tmp_path, "TRAIN.MAX_EPOCH", 3, "TRAIN.ITER_PER_EPOCH", 2,
                   "TRAIN.EVAL_INTERVAL", 10, "OUTPUT.RESUME", "jax_auto")
    tok = t_pipeline.build_tokenizer(t_c)
    _, train_env, valid_env, feat_dim = t_pipeline.build_environments(t_c, tok, seed=seed,
                                                                      device="cpu")
    j = _bandit_state(seed)
    j_agent = j_build_agent(j_c, tok.vocab_size(), feat_dim)
    j_params, _ = j_agent.init(jax.random.PRNGKey(1))
    opt = j_make_optimizer("rms", 1e-4)
    j_save(str(tmp_path / "t" / "jax_auto.ckpt"), j_params, opt.init(j_params), {},
           jax.random.PRNGKey(9), epoch=2, curriculum=j.curriculum_state())

    class Resumed(t_auto.AutoCurriculum):
        def iter_env(self, epoch_env, train_env):
            if not hasattr(self, "first"):
                self.first = (self.bandit.log_w.copy(), list(self.bandit.history),
                              dict(self._last_loss))
            return super().iter_env(epoch_env, train_env)

    t = Resumed.from_config(t_c, seed=seed)
    t.train(t_c, t_build_agent(t_c, tok.vocab_size(), feat_dim), "", train_env, valid_env,
            seed=seed, device="cpu")
    log_w, history, last = t.first
    np.testing.assert_array_equal(log_w, j.bandit.log_w)
    assert history == list(j.bandit.history) and last == j._last_loss
    assert len(t.bandit.history) > len(history)  # epoch 3 (the only one left) rewarded it
    saved = load_checkpoint(str(tmp_path / "t" / "latest.ckpt"))
    assert saved["epoch"] == 3 and str(saved["curriculum"]["kind"]) == "exp3s"
    np.testing.assert_array_equal(saved["curriculum"]["log_w"], t.bandit.log_w)
