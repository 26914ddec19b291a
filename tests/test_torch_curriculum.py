"""The port's curriculum trainers and their host side against the JAX
package:

* the SPCL solver: ``spcl_update_weight`` for the linear, log and binary
  pace functions, with the projection onto {w : a.w <= c} taken and not
  taken, and ``spcl_update_lambda`` on both sides of its branch;
* the NAIVE round schedule;
* ``CLR2RBatchEnv``'s difficulties, capacity, length, index and batch
  order, and the CLR2R branches of ``pipeline.build_environments`` (the
  cumulative NAIVE round envs, the SELF-PACE env) on the synthetic world;
* ``load_clr2r_rounds`` on ``assets/CLR2Rv3``: the same items and tokens;
* one SPCL-weighted iteration (dropout 0, both samplers replayed to the
  same choice): the weighted loss, the per-item record and the update
  equal the JAX weighted ``build_train_step``'s, with SGD at lr 1 so the
  update is the clipped gradient;
* a checkpoint that the JAX package writes in an SPCL run resumes in the
  port with its parameters, weights, lambda and loss record;
* ``main`` picks the trainer by TRAIN.CLMODE and refuses what the port
  does not run.

Tolerances: the solver 1e-6 (the same f32 arithmetic; the projection's
dot products sum 60 terms in another order); the weighted iteration 1e-4
(an 8-step recurrence of f32 products whose sums run in another order);
the host side exactly.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.data import datasets as t_ds
from curriculum_learning_for_vln_torch.engine import curriculum as t_cur
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.engine.trainer import ClassicTrainer
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv as TCLEnv
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer as TTok
from curriculum_learning_for_vln_torch.utils.tokenizer import read_vocab as t_read_vocab
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu import pipeline as j_pipeline
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.data import datasets as j_ds
from curriculum_learning_for_vln_tpu.engine import curriculum as j_cur
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from curriculum_learning_for_vln_tpu.engine.checkpoint import save_checkpoint as j_save
from curriculum_learning_for_vln_tpu.env.host_env import CLR2RBatchEnv as JCLEnv
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg
from curriculum_learning_for_vln_tpu.utils.tokenizer import Tokenizer as JTok
from curriculum_learning_for_vln_tpu.utils.tokenizer import read_vocab as j_read_vocab

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CL_CONFIG = os.path.join(REPO, "configs/envdrop/envdrop_cl_config.yaml")


# ---------------------------------------------------------------------------
# SPCL solver
# ---------------------------------------------------------------------------

def _solver_inputs(pace, project):
    rng = np.random.default_rng({"linear": 0, "log": 1, "binary": 2}[pace])
    n = 60
    a = rng.integers(1, 6, n).astype(np.float32)
    lamb = np.float32(0.8 if pace == "log" else 2.0)  # log: zeta = 1 - lamb > 0
    loss = (rng.random(n) * 1.5 * lamb).astype(np.float32)  # easy and hard items
    weight = rng.random(n).astype(np.float32)
    # a.w of the pace weights lies within [0.01, 1] * sum(a): c below it
    # takes the projection, c above it does not
    c = np.float32(0.05 * a.sum() if project else 2.0 * a.sum())
    return weight, a, c, lamb, loss


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("pace", ["linear", "log", "binary"])
def test_spcl_update_weight_matches_jax(pace, project):
    ins = _solver_inputs(pace, project)
    want = np.asarray(j_cur.spcl_update_weight(*(jnp.asarray(x) for x in ins), pace_func=pace))
    got = t_cur.spcl_update_weight(*(torch.tensor(x) for x in ins), pace_func=pace)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    weight, a, c, lamb, loss = ins
    if pace == "log":
        easy = np.log(loss + 1.0 - lamb) / np.log(1.0 - lamb)
    else:
        easy = 1.0 - loss / lamb if pace == "linear" else np.ones_like(loss)
    w_pace = np.maximum(np.where(loss >= lamb, 0.01, easy), 0.01)
    assert (float(np.dot(a, w_pace)) > c) == project  # the branch this case covers
    assert np.allclose(got.numpy(), w_pace, rtol=0, atol=1e-6) != project


@pytest.mark.parametrize("lamb", [0.5, 3.0])
def test_spcl_update_lambda_matches_jax(lamb):
    """lambda + mu below the largest loss, lambda + mu / 2 at or above it."""
    got = t_cur.spcl_update_lambda(torch.tensor(lamb), 2.0, torch.tensor(1.7))
    want = j_cur.spcl_update_lambda(jnp.asarray(lamb, jnp.float32), 2.0, jnp.asarray(1.7))
    assert float(got) == float(want) == (lamb + 2.0 if lamb < 1.7 else lamb + 1.0)


class _Round:
    def __init__(self, k):
        self.k = k

    def size(self):
        return self.k


@pytest.mark.parametrize("switch", [1, 3, 20])
def test_naive_round_schedule_matches_jax(switch):
    envs = {f"round_{k}": _Round(k) for k in range(1, 6)}
    t_naive, j_naive = t_cur.NaiveCurriculum(switch), j_cur.NaiveCurriculum(switch)
    got = [t_naive.select_env(envs, ep).k for ep in range(1, 121)]
    assert got == [j_naive.select_env(envs, ep).k for ep in range(1, 121)]
    assert got[0] == 1 and got[-1] == 5 and got[switch] == 2  # round_2 from epoch switch + 1


# ---------------------------------------------------------------------------
# CLR2R host side
# ---------------------------------------------------------------------------

def _rounds(items):
    per = len(items) // 5
    return {f"round_{k}": items[(k - 1) * per: k * per if k < 5 else len(items)]
            for k in range(1, 6)}


@pytest.mark.parametrize("seed", [0, 5])
def test_clr2r_env_matches_jax(synth_world, synth_graphs, synth_dataset, tokenizer, seed):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    items = j_ds.expand_r2r_items(synth_dataset, tokenizer)
    rounds = _rounds(items)
    je = JCLEnv(synth_world, rounds, 8, 0.8, tokenizer, seed)
    te = TCLEnv(t_world, rounds, 8, 0.8, tokenizer, seed, device="cpu")
    assert len(te) == len(je) == len(items)
    np.testing.assert_array_equal(te.a, je.a)
    assert te.c == je.c == pytest.approx(0.8 * je.a.sum())
    assert te.a[0] == 1 and te.a[-1] == 5
    for it in items[::7]:
        assert te.index(it) == je.index(it)
    for _ in range(2 * len(items) // 8 + 3):  # past a wraparound reshuffle
        jb, tb = je.next_batch(), te.next_batch()
        np.testing.assert_array_equal(te.cur_batch_index, je.cur_batch_index)
        np.testing.assert_array_equal(tb.instr_tokens.numpy(), np.asarray(jb.instr_tokens))


def _synthetic_cfgs(mode):
    overrides = ["TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3,
                 "TPU.SYNTHETIC_NODES", 24, "TPU.SYNTHETIC_TRAIN_PATHS", 40,
                 "TPU.SYNTHETIC_VAL_PATHS", 6, "TRAIN.BATCH_SIZE", 8, "DATA.MAX_ENC_LEN", 16,
                 "TRAIN.CLMODE", mode]
    cfgs = []
    for make in (t_cfg, j_cfg):
        cfg = make()
        cfg.merge_from_file(CL_CONFIG)
        cfg.merge_from_list(overrides)
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("mode", ["NAIVE", "SELF-PACE"])
def test_clr2r_pipeline_matches_jax(mode):
    """NAIVE: five cumulative round envs, round k seeded seed + k;
    SELF-PACE: one CLR2R env; both with JAX's items and batch order."""
    t_c, j_c = _synthetic_cfgs(mode)
    t_tok, j_tok = t_pipeline.build_tokenizer(t_c), j_pipeline.build_tokenizer(j_c)
    _, t_train, t_valid, _ = t_pipeline.build_environments(t_c, t_tok, seed=4, device="cpu")
    _, j_train, j_valid, _ = j_pipeline.build_environments(j_c, j_tok, seed=4)
    assert set(t_valid) == set(j_valid)
    if mode == "NAIVE":
        pairs = [(t_train[k], j_train[k]) for k in sorted(j_train)]
        sizes = [t.size() for t, _ in pairs]
        assert len(pairs) == 5 and sizes == sorted(sizes) and sizes[0] < sizes[-1]
    else:
        assert isinstance(t_train, TCLEnv)
        np.testing.assert_array_equal(t_train.a, j_train.a)
        assert t_train.c == j_train.c
        pairs = [(t_train, j_train)]
    for te, je in pairs:
        assert [it["instr_id"] for it in te.data] == [it["instr_id"] for it in je.data]
        for _ in range(3):
            te.next_batch(), je.next_batch()
            np.testing.assert_array_equal(te.cur_batch_index, je.cur_batch_index)


def test_load_clr2r_rounds_matches_jax():
    vocab = os.path.join(REPO, "assets/train_vocab.txt")
    t_tok, j_tok = TTok(t_read_vocab(vocab), 80), JTok(j_read_vocab(vocab), 80)
    data_dir = os.path.join(REPO, "assets/CLR2Rv3")
    got = t_ds.load_clr2r_rounds(t_tok, data_dir)
    want = j_ds.load_clr2r_rounds(j_tok, data_dir)
    assert list(got) == list(want) == [f"round_{k}" for k in range(1, 6)]
    for k in want:
        assert len(got[k]) == len(want[k]) > 0
        for g, w in zip(got[k], want[k]):
            assert g["instr_id"] == w["instr_id"] and g["instr_length"] == w["instr_length"]
            np.testing.assert_array_equal(np.asarray(g["instr_encoding"]),
                                          np.asarray(w["instr_encoding"]))
    assert t_ds.clr2r_split_name(3) == j_ds.clr2r_split_name(3) == "train_round[3]_v3"


# ---------------------------------------------------------------------------
# The weighted iteration, the checkpoint, main
# ---------------------------------------------------------------------------

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 8, 10


def _model_cfg(cfg):
    m = cfg.MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.DROP_RATE = m.FEAT_DROP_RATE = 0.0
    m.ML_WEIGHT, m.GAMMA, m.RL_NORMALIZE = 0.2, 0.9, "total"
    return m


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def test_weighted_iteration_matches_jax(synth_world, synth_graphs, synth_dataset, tokenizer,
                                        fixed_sampler):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(j_cfg()), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    t_agent = TAgent(_model_cfg(j_cfg()), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    j_ep = JEnv(synth_world, j_ds.expand_r2r_items(synth_dataset, tok), B, seed=2).next_batch()

    def field(name):
        a = np.array(getattr(j_ep, name))
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)

    t_ep = t_env.EpisodeBatch(*(field(f) for f in t_env.EpisodeBatch._fields))
    w = np.random.default_rng(3).uniform(0.01, 1.0, B).astype(np.float32)

    opt = j_loop.make_optimizer("sgd", 1.0)
    step = j_loop.build_train_step(j_agent, opt, "sample", weighted=True)
    new_j, _, _, logs_j = step(synth_world.device_tables("f32"),
                               jax.tree_util.tree_map(jnp.array, j_params), opt.init(j_params),
                               {}, j_ep, jax.random.PRNGKey(3), jnp.asarray(w))
    tp = t_tree.tree_map(lambda t: t.requires_grad_(True),
                         params_from_jax(jax.tree_util.tree_map(np.asarray, j_params)))
    optimizer = t_loop.make_optimizer("sgd", 1.0, tp)
    logs_t = t_loop.one_iter(t_agent, optimizer, "sample", t_world.device_tables("f32", "cpu"),
                             tp, t_ep, torch.Generator().manual_seed(3),
                             weights=torch.from_numpy(w))
    for k in ("loss", "ml_loss", "rl_loss", "loss_per_sample"):
        np.testing.assert_allclose(logs_t[k].numpy(), np.asarray(logs_j[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    unweighted = float(logs_t["ml_loss"] + logs_t["rl_loss"])
    assert abs(float(logs_t["loss"]) - unweighted) > 1e-3  # the weights matter
    for got, want in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(new_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


class _Bookkeeping:
    """What the JAX SelfPacedCurriculum reads of its CLR2R env."""

    def __init__(self, env):
        self.a, self.c = env.a, env.c

    def __len__(self):
        return len(self.a)


def test_jax_spcl_checkpoint_resumes_in_port(tmp_path):
    t_c, j_c = _synthetic_cfgs("SELF-PACE")
    for cfg in (t_c, j_c):
        cfg.merge_from_list(["AGENT.MAX_EPISODE_LEN", 6, "OUTPUT.CKPT_DIR", str(tmp_path),
                             "OUTPUT.TSBOARD_DIR", "", "OUTPUT.LOG_DIR", "", "TRAIN.MAX_EPOCH",
                             3, "OUTPUT.RESUME", "jax_spcl"])
        _model_cfg(cfg)
    tok = t_pipeline.build_tokenizer(t_c)
    _, train_env, valid_env, feat_dim = t_pipeline.build_environments(t_c, tok, seed=4,
                                                                      device="cpu")
    # the JAX run's state after an SPCL update
    j_agent = JAgent(j_c.MODEL.ENVDROP, 16, tok.vocab_size(), feat_dim, 6)
    j_params, _ = j_agent.init(jax.random.PRNGKey(2))
    j_spcl = j_cur.SelfPacedCurriculum(_Bookkeeping(train_env), init_lamb=2.0, miu=2.0)
    loss = jnp.asarray(np.random.default_rng(1).random(len(train_env)).astype(np.float32) * 3)
    j_spcl.lamb = j_cur.spcl_update_lambda(j_spcl.lamb, 2.0, loss.max())
    j_spcl.weight = j_cur.spcl_update_weight(j_spcl.weight, j_spcl.a, j_spcl.c, j_spcl.lamb,
                                             loss)
    opt = j_loop.make_optimizer("rms", 1e-4)
    j_save(str(tmp_path / "jax_spcl.ckpt"), j_params, opt.init(j_params), {},
           jax.random.PRNGKey(9), epoch=3, curriculum=j_spcl.state_dict(loss),
           cfg_yaml=j_c.dump())

    trainer = t_cur.SelfPacedCurriculum.from_config(t_c, train_env)
    assert not np.array_equal(trainer.weight.numpy(), np.asarray(j_spcl.weight))
    agent = TAgent(t_c.MODEL.ENVDROP, 16, tok.vocab_size(), feat_dim, 6,
                   compute_dtype=torch.bfloat16)
    params, _ = trainer.train(t_c, agent, "", train_env, valid_env, seed=4, device="cpu")
    np.testing.assert_array_equal(trainer.weight.numpy(), np.asarray(j_spcl.weight))
    assert float(trainer.lamb) == float(j_spcl.lamb) == 4.0  # 2 + MIU: below the max loss
    np.testing.assert_array_equal(trainer.loss_for_item.numpy(), np.asarray(loss))
    for got, want in zip(t_tree.tree_leaves(params), jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def test_main_picks_the_trainer_by_clmode():
    for extra, cls in (([], t_cur.NaiveCurriculum),
                       (["TRAIN.CLMODE", "SELF-PACE"], t_cur.SelfPacedCurriculum),
                       (["DATA.NAME", "R2R", "TRAIN.CLMODE", ""], ClassicTrainer)):
        args, cfg = t_main.parse_args(["--device", "cpu", "--config-file", CL_CONFIG,
                                       "TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS",
                                       "3", "TPU.SYNTHETIC_NODES", "24", *extra])
        t_main.check_ported(args, cfg)
        assert cfg.TPU.PACKED_RL == 3  # the config as shipped
        tok = t_pipeline.build_tokenizer(cfg)
        _, train_env, _, _ = t_pipeline.build_environments(cfg, tok, seed=1, device="cpu")
        trainer = t_main.build_trainer(cfg, train_env, logging.getLogger("test"))
        assert type(trainer) is cls
