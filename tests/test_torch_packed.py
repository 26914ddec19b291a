"""Packed RL (agents/packed.py, ``TPU.PACKED_RL``) in the port, against
itself and the JAX package, in f32 with both dropout rates at 0 and both
packages' samplers patched (pytest's ``monkeypatch``, this process only)
to the same deterministic choice, argmax(logits + a fixed noise):

* at factor 1 (pool == batch) the packed A2C loss and its gradients equal
  the port's unpacked A2C rollout's, and the loss equals JAX's
  ``rollout_packed``;
* at factor 3 the slot -> episode records, the terminal steps, the
  per-episode losses and the episode counters equal JAX's;
* the weighted packed objective with all-ones weights equals the
  unweighted one (zeros give a zero loss);
* ``check_pool_valid`` rejects a padding episode;
* the packed classic and SPCL trainers train on a tiny synthetic world.

Tolerances: atol 1e-4 for losses and gradients through a rollout — a
9-step recurrence of f32 products whose sums run in another order; the
records (indices, flags, counts) exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.engine.checkpoint import load_checkpoint
from curriculum_learning_for_vln_torch.engine.curriculum import SelfPacedCurriculum
from curriculum_learning_for_vln_torch.engine.trainer import ClassicTrainer
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 9, 8
ATOL = 1e-4


def _model_cfg():
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.DROP_RATE = m.FEAT_DROP_RATE = 0.0
    m.ML_WEIGHT, m.GAMMA, m.RL_NORMALIZE = 0.2, 0.9, "total"
    return m


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    t_agent = TAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    fields = {"instr_tokens": [], "instr_len": [], "start_node": [], "start_heading": [],
              "goal": [], "goal_local": []}
    for it in synth_dataset[:3 * B]:
        tokens, length = tok.encode_sentence(it["instructions"][0])
        start = synth_world.global_id(it["scan"], it["path"][0])
        goal = synth_world.global_id(it["scan"], it["path"][-1])
        for k, v in zip(fields, (tokens, length, start, it["heading"], goal,
                                 synth_world.node_local[goal])):
            fields[k].append(v)
    arr = {k: np.asarray(v) for k, v in fields.items()}
    arr["start_heading"] = arr["start_heading"].astype(np.float32)
    arr["item_idx"] = np.arange(3 * B)
    arr["valid"] = np.ones(3 * B, bool)

    def pools(n):
        j_ep = j_env.EpisodeBatch(
            **{k: jnp.asarray(v[:n].astype(np.int32) if v.dtype.kind == "i" else v[:n])
               for k, v in arr.items()},
            path_local=jnp.asarray(arr["goal_local"][:n, None].astype(np.int32)),
            path_len=jnp.ones(n, jnp.int32))
        t_ep = t_env.EpisodeBatch(**{k: torch.from_numpy(v[:n].astype(np.int64)
                                                         if v.dtype.kind == "i" else v[:n])
                                     for k, v in arr.items()})
        return j_ep, t_ep

    return {"j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"),
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params, "pools": pools}


@pytest.fixture()
def fixed_sampler(monkeypatch):
    """Both packages sample argmax(logits + NOISE), NOISE one fixed
    [B, MC+1] array for every step."""
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def _t_params(j_params):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(True), p)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                                          np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=atol)


def test_factor_one_equals_unpacked_and_jax(setup, fixed_sampler):
    s = setup
    j_pool, t_pool = s["pools"](B)
    lj, _ = s["j_agent"].rollout_packed(s["j_params"], {}, s["j_tables"], j_pool,
                                        jax.random.PRNGKey(7), batch_size=B)
    tp = _t_params(s["j_params"])
    packed, result = s["t_agent"].rollout_packed(tp, s["t_tables"], t_pool, batch_size=B,
                                                 generator=torch.Generator().manual_seed(7))
    packed.rl_loss.backward()
    g_packed = [p.grad for p in t_tree.tree_leaves(tp)]
    tp2 = _t_params(s["j_params"])
    unpacked, res_u = s["t_agent"].rollout(tp2, s["t_tables"], t_pool, t_common.FEEDBACK_SAMPLE,
                                           train=True, train_ml=False, train_rl=True,
                                           generator=torch.Generator().manual_seed(7))
    unpacked.rl_loss.backward()
    assert res_u.steps.moved.any() and int(result.episodes_started) == B
    assert torch.equal(result.steps.slot_ep, torch.arange(B).expand(EPISODE_LEN, B))
    for got, want in ((packed.rl_loss, unpacked.rl_loss),
                      (packed.entropy_sum, unpacked.entropy_sum),
                      (packed.critic_loss_sum, unpacked.critic_loss_sum),
                      (packed.total_actions, unpacked.total_actions)):
        _close(got, want.detach())
    _close(packed.rl_loss_per_episode, unpacked.rl_loss_per_sample.detach())
    for gp, gu in zip(g_packed, (p.grad for p in t_tree.tree_leaves(tp2)), strict=True):
        assert (gp is None) == (gu is None)
        if gp is not None:
            _close(gp, gu)
    for got, want in ((packed.rl_loss, lj.rl_loss), (packed.entropy_sum, lj.entropy_sum),
                      (packed.critic_loss_sum, lj.critic_loss_sum),
                      (packed.total_actions, lj.total_actions)):
        _close(got, want)


def test_factor_three_records_match_jax(setup, fixed_sampler):
    s = setup
    j_pool, t_pool = s["pools"](3 * B)
    lj, rj = s["j_agent"].rollout_packed(s["j_params"], {}, s["j_tables"], j_pool,
                                         jax.random.PRNGKey(11), batch_size=B)
    lt, rt = s["t_agent"].rollout_packed(_t_params(s["j_params"]), s["t_tables"], t_pool,
                                         batch_size=B, generator=torch.Generator().manual_seed(1))
    started = int(rt.episodes_started)
    assert B < started <= 3 * B and 0 < int(rt.episodes_done) <= started  # slots refill
    np.testing.assert_array_equal(rt.steps.slot_ep.numpy(), np.asarray(rj.steps.slot_ep))
    np.testing.assert_array_equal(rt.steps.ended_now.numpy(), np.asarray(rj.steps.ended_now))
    np.testing.assert_array_equal(rt.steps.alive_before.numpy(),
                                  np.asarray(rj.steps.alive_before))
    np.testing.assert_array_equal(rt.final_slot_ep.numpy(), np.asarray(rj.final_slot_ep))
    assert started == int(rj.episodes_started)
    assert int(rt.episodes_done) == int(lj.episodes_done) == int(rj.episodes_done)
    _close(lt.rl_loss_per_episode, lj.rl_loss_per_episode)
    _close(lt.rl_loss, lj.rl_loss)
    _close(lt.rl_loss_per_episode[started:], np.zeros(3 * B - started))  # never started
    _close(lt.rl_loss_per_episode.sum(), lt.rl_loss.detach())


def test_weighted_ones_equals_unweighted(setup, fixed_sampler):
    """dot(1, ml_vec) + dot(1, rl_per_episode) is the unweighted total, with
    the same gradients; zero weights give a zero loss."""
    s = setup
    _, t_pool = s["pools"](2 * B)
    ep = t_env.EpisodeBatch(*(f[:B] for f in t_pool))

    def run(w_il=None, w_pool=None):
        tp = _t_params(s["j_params"])
        total, logs = t_loop.packed_iteration_loss(
            s["t_agent"], s["t_tables"], tp, ep, t_pool, torch.Generator().manual_seed(3),
            w_il, w_pool)
        total.backward()
        return total.detach(), logs, [p.grad for p in t_tree.tree_leaves(tp)]

    loss_u, logs_u, g_u = run()
    loss_w, _, g_w = run(torch.ones(B), torch.ones(2 * B))
    assert float(logs_u["rl_loss"].detach()) != 0.0 and int(logs_u["episodes_started"]) >= B
    _close(loss_w, loss_u, atol=1e-5)
    for a, b in zip(g_w, g_u, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, atol=1e-5)
    loss_0, _, _ = run(torch.zeros(B), torch.zeros(2 * B))
    assert float(loss_0) == 0.0


def test_check_pool_valid_rejects_padding(setup):
    _, t_pool = setup["pools"](2 * B)
    pool = t_loop.concat_batches([t_env.EpisodeBatch(*(f[:B] for f in t_pool)),
                                  t_env.EpisodeBatch(*(f[B:] for f in t_pool))])
    for got, want in zip(pool, t_pool):
        assert torch.equal(got, want)
    t_loop.check_pool_valid(pool)  # full-valid batches pass
    valid = pool.valid.clone()
    valid[3] = False
    with pytest.raises(ValueError, match="padding"):
        t_loop.check_pool_valid(pool._replace(valid=valid))


def _tiny_cfg(tmp_path, *extra):
    cfg = t_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/envdrop/envdrop_cl_config.yaml"))
    cfg.merge_from_list([
        "TPU.SYNTHETIC_WORLD", True, "TPU.SYNTHETIC_SCANS", 3, "TPU.SYNTHETIC_NODES", 24,
        "TPU.SYNTHETIC_TRAIN_PATHS", 40, "TPU.SYNTHETIC_VAL_PATHS", 6, "TRAIN.MAX_EPOCH", 2,
        "TRAIN.ITER_PER_EPOCH", 2, "TRAIN.BATCH_SIZE", 8, "TRAIN.EVAL_INTERVAL", 2,
        "AGENT.MAX_EPISODE_LEN", 6, "DATA.MAX_ENC_LEN", 16, "MODEL.ENVDROP.HIDDEN_SIZE", 64,
        "MODEL.ENVDROP.WORD_EMB_SIZE", 32, "MODEL.ENVDROP.ACT_EMB_SIZE", 16,
        "OUTPUT.CKPT_DIR", str(tmp_path / "ckpt"), "OUTPUT.TSBOARD_DIR", "",
        "OUTPUT.LOG_DIR", "", *extra])
    return cfg


def _agent(cfg, tok, feat_dim):
    return TAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, tok.vocab_size(), feat_dim,
                  cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=torch.bfloat16,
                  obs_masks=cfg.TPU.OBS_MASKS)


def test_packed_classic_trainer_smoke(tmp_path, monkeypatch):
    """PACKED_RL 3 as the CL config ships it, through the classic trainer:
    every iteration draws 3 batches and logs its episode counts."""
    cfg = _tiny_cfg(tmp_path, "DATA.NAME", "R2R", "TRAIN.CLMODE", "")
    assert cfg.TPU.PACKED_RL == 3
    tok = t_pipeline.build_tokenizer(cfg)
    world, train_env, valid_env, feat_dim = t_pipeline.build_environments(cfg, tok, seed=3,
                                                                          device="cpu")
    calls = []
    packed_one_iter = t_loop.packed_one_iter

    def spy(agent, optimizer, tables, params, ep, pool, *args):
        logs = packed_one_iter(agent, optimizer, tables, params, ep, pool, *args)
        calls.append((pool.valid.shape[0], int(logs["episodes_done"]),
                      int(logs["episodes_started"])))
        return logs

    monkeypatch.setattr("curriculum_learning_for_vln_torch.engine.trainer.packed_one_iter", spy)
    ClassicTrainer().train(cfg, _agent(cfg, tok, feat_dim), "", train_env, valid_env, seed=3,
                           device="cpu")
    assert len(calls) == 4 and all(n == 24 and 8 <= st <= 24 and d <= st for n, d, st in calls)
    assert load_checkpoint(str(tmp_path / "ckpt" / "latest.ckpt"))["curriculum"] is None


def test_packed_spcl_trainer_smoke(tmp_path):
    """SELF-PACE with PACKED_RL 3 and OBS_MASKS prng_shared: the weighted
    packed iteration, an SPCL update after each epoch, the curriculum state
    in the checkpoint."""
    cfg = _tiny_cfg(tmp_path, "TRAIN.CLMODE", "SELF-PACE", "TPU.OBS_MASKS", "prng_shared",
                    "TRAIN.SELF_PACE.INTERVAL", 1)
    tok = t_pipeline.build_tokenizer(cfg)
    world, train_env, valid_env, feat_dim = t_pipeline.build_environments(cfg, tok, seed=3,
                                                                          device="cpu")
    trainer = SelfPacedCurriculum.from_config(cfg, train_env)
    w0, lamb0 = trainer.weight.clone(), float(trainer.lamb)
    trainer.train(cfg, _agent(cfg, tok, feat_dim), "", train_env, valid_env, seed=3,
                  device="cpu")
    recorded = int((trainer.loss_for_item > 0).sum())
    assert 8 <= recorded <= 4 * 8  # the IL batch of each of the 4 iterations
    # two updates, each of MIU, or MIU / 2 once lambda reaches the largest loss
    mu = cfg.TRAIN.SELF_PACE.MIU
    assert float(trainer.lamb) in [lamb0 + k * mu / 2 for k in (2, 3, 4)]
    assert not torch.equal(trainer.weight, w0)
    state = load_checkpoint(str(tmp_path / "ckpt" / "latest.ckpt"))["curriculum"]
    np.testing.assert_array_equal(state["weight"], trainer.weight.numpy())
    np.testing.assert_array_equal(state["loss_for_item"], trainer.loss_for_item.numpy())
