"""The rollout early exit (``TPU.SCAN_EARLY_EXIT``) in the port:

* flag on against flag off, for the three agents at the lengths of the JAX
  package's test (EnvDrop sampled at T = 13: the IL rollout's dead tail
  comes before the A2C rollout; the Self-Monitor and the Follower teacher-
  forced at T = 10), with the configs' dropout on: the same loss and
  update within 1e-5 in f32, the generator left in the same state (a
  frozen step makes the live step's draws again), and frozen steps really
  taken; the Self-Monitor's BN statistics are those of the live steps
  alone (the flag-off run cut at the last live step);
* the trajectories and every record field the losses read, equal;
* the packed pool (as JAX tests/test_packed.py:155): a pool of 2 x 8
  drained within T = 22, loss and gradients equal within 1e-5;
* the port's flag-on update against the JAX package's flag-on update
  (dropout 0, both samplers replayed to the same choice, JAX's initial
  parameters, an IL rollout with an all-dead tail of two steps or more): the
  losses within 1e-4, the tolerance of the port's other iteration-against-
  JAX tests, and each leaf's update (new - old) / lr within 1e-4 of that
  leaf's largest update element;
* ``engine.loop.configure_runtime`` sets the flag from the config both
  ways, as the trainers' first step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.agents import init_agent
from curriculum_learning_for_vln_torch.agents.common import (FEEDBACK_SAMPLE, FEEDBACK_TEACHER,
                                                             assemble_trajectories)
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import build_agent as j_build_agent
from curriculum_learning_for_vln_tpu.agents import common as j_common
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine.loop import build_train_step
from curriculum_learning_for_vln_tpu.engine.loop import make_optimizer as j_make_optimizer
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults as j_cfg

torch.set_num_threads(2)

B = 8
CASES = [("ENVDROP", "sample", 13), ("SELF-MONITOR", "teacher", 10), ("FOLLOWER", "teacher", 10)]


def base_cfg(make, model, T, drop=None):
    """JAX tests/test_knobs.py's narrow widths, f32."""
    cfg = make()
    cfg.merge_from_list(["MODEL.NAME", model, "TPU.PRECISION", "f32", "DATA.MAX_ENC_LEN", 24,
                         "AGENT.MAX_EPISODE_LEN", T,
                         "MODEL.FOLLOWER.WORD_EMB_SIZE", 32, "MODEL.FOLLOWER.HIDDEN_SIZE", 64,
                         "MODEL.FOLLOWER.ENC_LAYERS", 1, "MODEL.ENVDROP.WORD_EMB_SIZE", 32,
                         "MODEL.ENVDROP.ACT_EMB_SIZE", 16, "MODEL.ENVDROP.HIDDEN_SIZE", 64,
                         "MODEL.ENVDROP.ML_WEIGHT", 0.2, "MODEL.ENVDROP.GAMMA", 0.9,
                         "MODEL.MONITOR.WORD_EMB_SIZE", 32, "MODEL.MONITOR.HIDDEN_SIZE", 64,
                         "MODEL.MONITOR.MLP_HIDDEN", (32, 64)])
    if drop is not None:
        cfg.merge_from_list(["MODEL.ENVDROP.DROP_RATE", drop, "MODEL.ENVDROP.FEAT_DROP_RATE",
                             drop])
    return cfg


@pytest.fixture(scope="module")
def host(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    data = expand_r2r_items(synth_dataset, tokenizer)
    return {"t_world": t_world, "t_tables": t_world.device_tables("f32", "cpu"),
            "j_tables": synth_world.device_tables(), "data": data,
            "t_ep": TEnv(t_world, data, B, tokenizer, seed=9, device="cpu").next_batch(),
            "j_ep": JEnv(synth_world, data, B, tokenizer, seed=9).next_batch()}


@pytest.fixture()
def flag():
    """set_early_exit for the test, off again after it."""
    yield t_common.set_early_exit
    t_common.set_early_exit(False)


def _iteration(agent, cfg, tables, params0, model_state, ep, seed=4):
    """One training iteration (SGD, lr 1e-2) from a copy of ``params0``:
    (the logs, the new parameters, the new model state, the generator's
    state after it)."""
    params = t_tree.tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                             params0)
    opt = t_loop.make_optimizer("sgd", 1e-2, params)
    gen = torch.Generator().manual_seed(seed)
    if agent.name == "ENVDROP":
        logs = t_loop.one_iter(agent, opt, cfg.AGENT.FEEDBACK, tables, params, ep, gen)
    else:
        logs, model_state = t_loop.agent_one_iter(agent, opt, cfg.AGENT.FEEDBACK, tables, params,
                                                  model_state, ep, gen)
    return logs, params, model_state, gen.get_state()


@pytest.mark.parametrize("model,fb,T", CASES)
def test_update_identical_with_the_flag(host, tokenizer, flag, model, fb, T):
    cfg = base_cfg(t_cfg, model, T)
    cfg.AGENT.FEEDBACK = fb
    agent = t_build_agent(cfg, tokenizer.vocab_size(), 64)
    params0, ms0 = init_agent(agent, torch.Generator().manual_seed(0))
    tables, ep = host["t_tables"], host["t_ep"]
    runs = {}
    for on in (False, True):
        flag(on)
        runs[on] = _iteration(agent, cfg, tables, params0, ms0, ep)
    (l0, p0, s0, g0), (l1, p1, s1, g1) = runs[False], runs[True]
    assert torch.equal(g0, g1), "the generator ends elsewhere with the early exit"
    np.testing.assert_allclose(float(l1["loss"]), float(l0["loss"]), rtol=0, atol=1e-5)
    for a, b in zip(t_tree.tree_leaves(p1), t_tree.tree_leaves(p0), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-5)

    # the rollout itself: frozen steps taken, the records the losses read equal
    feedback = FEEDBACK_SAMPLE if fb == "sample" else FEEDBACK_TEACHER
    res = {}
    for on in (False, True):
        flag(on)
        out = agent.rollout(params0, tables, ep, feedback, train=True,
                            generator=torch.Generator().manual_seed(4),
                            **({} if model == "ENVDROP" else {"model_state": ms0}))
        res[on] = out
    r0, r1 = res[False][1], res[True][1]
    dead = ~r0.steps.alive_before.any(dim=1)
    assert int(dead.sum()) >= 2, "no all-dead tail: raise T"
    for f in ("node_after", "view_after", "moved", "alive_before", "teacher", "ce", "ce_count",
              "reward", "dist_after"):
        assert torch.equal(getattr(r1.steps, f), getattr(r0.steps, f)), f
    for f in ("log_prob", "entropy"):  # masked by alive_before wherever they are read
        a, b = getattr(r1.steps, f), getattr(r0.steps, f)
        assert torch.equal(a[~dead], b[~dead]) and not a[dead].any()
    assert assemble_trajectories(host["t_world"], ep, r1, host["data"]) == \
        assemble_trajectories(host["t_world"], ep, r0, host["data"])
    if model == "SELF-MONITOR":
        # BN statistics accumulate over the live steps only
        live = int((~dead).sum())
        flag(False)
        _, _, ms_cut = agent.rollout(params0, tables, ep, feedback, train=True,
                                     generator=torch.Generator().manual_seed(4),
                                     model_state=ms0, episode_len=live)
        for a, b, c in zip(t_tree.tree_leaves(res[True][2]), t_tree.tree_leaves(ms_cut),
                           t_tree.tree_leaves(res[False][2]), strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        assert any(not torch.equal(a, c) for a, c in zip(t_tree.tree_leaves(res[True][2]),
                                                          t_tree.tree_leaves(res[False][2])))


def test_packed_pool_identical_with_the_flag(host, tokenizer, synth_world, flag):
    cfg = base_cfg(t_cfg, "ENVDROP", 22)
    agent = t_build_agent(cfg, tokenizer.vocab_size(), 64)
    params0, _ = init_agent(agent, torch.Generator().manual_seed(0))
    henv = TEnv(host["t_world"], host["data"], B, tokenizer, seed=9, device="cpu")
    pool = t_loop.concat_batches([henv.next_batch() for _ in range(2)])
    runs = {}
    for on in (False, True):
        flag(on)
        params = t_tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), params0)
        gen = torch.Generator().manual_seed(17)
        rl, res = agent.rollout_packed(params, host["t_tables"], pool, batch_size=B,
                                       generator=gen)
        rl.rl_loss.backward()
        runs[on] = (rl, res, [p.grad for p in t_tree.tree_leaves(params)], gen.get_state())
    (rl0, res0, g0, s0), (rl1, res1, g1, s1) = runs[False], runs[True]
    assert not res0.steps.alive_before[-1].any(), "no all-dead tail: raise episode_len"
    assert int(res0.episodes_started) == 2 * B and torch.equal(s0, s1)
    for f in ("slot_ep", "alive_before", "ended_now", "reward"):
        assert torch.equal(getattr(res1.steps, f), getattr(res0.steps, f)), f
    np.testing.assert_allclose(float(rl1.rl_loss.detach()), float(rl0.rl_loss.detach()), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rl1.rl_loss_per_episode.detach().numpy(),
                               rl0.rl_loss_per_episode.detach().numpy(), rtol=0, atol=1e-5)
    for a, b in zip(g1, g0, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def test_flag_on_update_matches_jax(host, tokenizer, flag, fixed_sampler):
    T, lr = 13, 1e-2
    j_c, t_c = base_cfg(j_cfg, "ENVDROP", T, drop=0.0), base_cfg(t_cfg, "ENVDROP", T, drop=0.0)
    j_agent = j_build_agent(j_c, tokenizer.vocab_size(), 64)
    t_agent = t_build_agent(t_c, tokenizer.vocab_size(), 64)
    j_params, mstate = j_agent.init(jax.random.PRNGKey(0))
    opt = j_make_optimizer("sgd", lr)
    try:
        j_common.set_early_exit(True)
        step = build_train_step(j_agent, opt, "sample")
        new_j, _, _, logs_j = step(host["j_tables"], jax.tree_util.tree_map(jnp.array, j_params),
                                   opt.init(j_params), mstate, host["j_ep"],
                                   jax.random.PRNGKey(4))
        # the step's teacher-forced IL rollout, the one with a dead tail at this T
        _, j_res, _ = j_agent.rollout(j_params, mstate, host["j_tables"], host["j_ep"],
                                      jax.random.PRNGKey(4), j_common.FEEDBACK_TEACHER, train=True)
    finally:
        j_common.set_early_exit(False)
    flag(True)
    params0 = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    _, t_res = t_agent.rollout(params0, host["t_tables"], host["t_ep"], FEEDBACK_TEACHER,
                               train=True, generator=torch.Generator().manual_seed(4))
    t_alive = t_res.steps.alive_before.numpy()
    assert np.array_equal(t_alive, np.asarray(j_res.steps.alive_before))
    assert int((~t_alive.any(axis=1)).sum()) >= 2, "no all-dead tail: raise T"
    logs_t, new_t, _, _ = _iteration(t_agent, t_c, host["t_tables"], params0, {}, host["t_ep"])
    for k in ("loss", "ml_loss", "rl_loss"):
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    # the updates (new - old) / lr: each leaf within 1e-4 of its own largest element
    for p0, got, old, want in zip(t_tree.tree_leaves(params0), t_tree.tree_leaves(new_t),
                                  jax.tree_util.tree_leaves(j_params),
                                  jax.tree_util.tree_leaves(new_j), strict=True):
        du_t = (got.detach().double().numpy() - p0.double().numpy()) / lr
        du_j = (np.asarray(want, np.float64) - np.asarray(old, np.float64)) / lr
        scale = max(float(np.abs(du_j).max()), 1e-3)
        np.testing.assert_allclose(du_t, du_j, rtol=0, atol=1e-4 * scale)


def test_configure_runtime_sets_the_flag_both_ways(flag):
    cfg = t_cfg()
    assert cfg.TPU.SCAN_EARLY_EXIT is False  # off by default, as in the JAX package
    for on in (True, False):
        cfg.TPU.SCAN_EARLY_EXIT = on
        t_loop.configure_runtime(cfg)
        assert t_common._EARLY_EXIT is on and t_common.EarlyExit().on is on
