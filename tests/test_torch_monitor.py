"""The port's Self-Monitor agent against the JAX package, from the same
parameters and BN state (``params_from_jax``, ``model_state_from_jax``),
on B = 10 episodes (one a padding slot) of a small synthetic world, at
narrow widths (embedding 16, one LSTM layer of 32, MLP 48).

* ``batchnorm`` and ``mlp_bn`` in train (batch statistics, the running
  statistics returned) and eval (running statistics);
* ``positional_encoding_table`` and ``positional_encoding``;
* one ``monitor_decoder_step`` in eval and in train (with the BN state it
  returns), in f32, and in bf16;
* rollouts in teacher, argmax and sample feedback (both samplers patched
  with pytest's ``monkeypatch`` to argmax(logits + one fixed noise)):
  actions, nodes, progress, the progress targets' losses — ``ml_loss``,
  ``ml_loss_per_sample`` and ``progress_loss``;
* the loss, every gradient leaf and the BN state at train=True, and one
  Adam update against JAX ``build_train_step`` (no clip).

The Self-Monitor's decoder has dropout sites at fixed rates (the BN-MLP
0.5, the positional encoding 0.1), which the two packages draw from
different generators.  The train=True cases set both to 0 in both
packages, in this test's process only: ``monkeypatch`` replaces the
decoders modules' ``mlp_bn`` and ``positional_encoding`` with
``functools.partial(..., drop_rate=0.0 / rate=0.0)``; DROP_RATE is 0.
Nothing in the JAX package changes.

Tolerances: 1e-5 for one unit or step in f32; atol 1e-4 through a rollout
(a recurrence of f32 products whose sums run in another order); in bf16
one step's logits and progress within 3e-2 x max(1, max |JAX|): the two
frameworks round bf16 products at other places (a bf16 ulp is 2^-8).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch.agents.monitor import SelfMonitorAgent as TAgent
from curriculum_learning_for_vln_torch.convert import model_state_from_jax, params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.models import attention as t_att
from curriculum_learning_for_vln_torch.models import core as t_core
from curriculum_learning_for_vln_torch.models import decoders as t_dec
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import (FEEDBACK_ARGMAX, FEEDBACK_SAMPLE,
                                                    FEEDBACK_TEACHER)
from curriculum_learning_for_vln_tpu.agents.common import cast_compute_params
from curriculum_learning_for_vln_tpu.agents.monitor import SelfMonitorAgent as JAgent
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from curriculum_learning_for_vln_tpu.models import attention as j_att
from curriculum_learning_for_vln_tpu.models import core as j_core
from curriculum_learning_for_vln_tpu.models import decoders as j_dec
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults
from test_torch_follower import episode_batches

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B, H, MLP = 64, 12, 6, 10, 32, 48
F = FEAT_DIM + 128
ATOL = 1e-4
FEEDBACK = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX, "sample": FEEDBACK_SAMPLE}


def _model_cfg():
    m = get_cfg_defaults().MODEL.MONITOR
    m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS, m.ENC_BIDIRECTION = 16, H, 1, False
    m.MLP_HIDDEN = (MLP,)
    m.DROP_RATE = 0.0
    return m


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, j_state = j_agent.init(jax.random.PRNGKey(0))
    # BN biases off their initial 0: the first step's a_prev rows are all
    # zero, so with a zero bias their pre-ReLU values sit on the kink, where
    # the gradient's sign is f32 rounding in either package
    mlp = j_params["decoder"]["proj_navigable_mlp"]
    rng = np.random.default_rng(8)
    for bn in (mlp["bn_in"], *mlp["bn_layers"]):
        bn["bias"] = bn["bias"] + jnp.asarray(rng.uniform(-0.5, 0.5, bn["bias"].shape),
                                              jnp.float32)
    t_agent = TAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    return {"j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"),
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params, "j_state": j_state,
            "j_ep": j_ep, "t_ep": t_ep}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _t_params(j_params, grad=True):
    p = params_from_jax(_np(j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(grad), p)


def _close_trees(t_tree_or_leaves, j_tree, atol=ATOL):
    """Leaf by leaf; a port leaf of None (no gradient reached it) is JAX's zeros."""
    t_leaves = (t_tree_or_leaves if isinstance(t_tree_or_leaves, list)
                else t_tree.tree_leaves(t_tree_or_leaves))
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for got, want in zip(t_leaves, j_leaves):
        got = np.zeros(want.shape, np.float32) if got is None else got.detach().float().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.fixture()
def no_fixed_dropout(monkeypatch):
    """The BN-MLP's and the positional encoding's dropout at rate 0 in both
    packages' decoders (this process only)."""
    monkeypatch.setattr(j_dec, "mlp_bn", functools.partial(j_att.mlp_bn, drop_rate=0.0))
    monkeypatch.setattr(j_dec, "positional_encoding",
                        functools.partial(j_att.positional_encoding, rate=0.0))
    monkeypatch.setattr(t_dec, "mlp_bn", functools.partial(t_att.mlp_bn, drop_rate=0.0))
    monkeypatch.setattr(t_dec, "positional_encoding",
                        functools.partial(t_att.positional_encoding, rate=0.0))


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_and_mlp_bn_match_jax(train):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((13, F)) * 3 + 1).astype(np.float32)
    jp, js = j_att.mlp_bn_init(jax.random.PRNGKey(4), F, [MLP, 24])
    # a running state that is not the initial one
    js = jax.tree_util.tree_map(lambda a: a + 0.3 * rng.random(a.shape).astype(np.float32), js)
    tp, ts = (t_tree.tree_map(lambda a: torch.tensor(np.array(a)), t) for t in (jp, js))
    y_j, s_j = j_core.batchnorm(jp["bn_in"], js["bn_in"], jnp.asarray(x), train)
    y_t, s_t = t_core.batchnorm(tp["bn_in"], ts["bn_in"], torch.from_numpy(x), train)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-5)
    _close_trees([s_t[k] for k in sorted(s_t)], [s_j[k] for k in sorted(s_j)], atol=1e-6)
    y_j, s_j = j_att.mlp_bn(jp, js, jnp.asarray(x), jax.random.PRNGKey(0), train, drop_rate=0.0)
    y_t, s_t = t_att.mlp_bn(tp, ts, torch.from_numpy(x), train, drop_rate=0.0)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-5)
    _close_trees(s_t, s_j, atol=1e-5)
    assert float(s_t["bn_in"]["count"]) == float(js["bn_in"]["count"]) + (1 if train else 0)


def test_positional_encoding_matches_jax():
    pe_j = j_att.positional_encoding_table(H, ENC_LEN)
    pe_t = t_att.positional_encoding_table(H, ENC_LEN)
    np.testing.assert_allclose(pe_t.numpy(), np.asarray(pe_j), rtol=0, atol=1e-6)
    x = np.random.default_rng(3).standard_normal((4, ENC_LEN, H)).astype(np.float32)
    for train in (False, True):  # rate 0 at train: the sum alone
        y_j = j_att.positional_encoding(pe_j, jnp.asarray(x), jax.random.PRNGKey(0), train,
                                        rate=0.0)
        y_t = t_att.positional_encoding(pe_t, torch.from_numpy(x), train, rate=0.0)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0, atol=1e-6)


def _step_inputs(s, seed):
    rng = np.random.default_rng(seed)
    tt = s["t_tables"]
    node = torch.from_numpy(rng.integers(0, tt.features.shape[0], B))
    view = torch.from_numpy(rng.integers(0, 36, B))
    state = t_env.reset(tt, s["t_ep"])._replace(node=node, view_idx=view)
    obs = t_env.observe(tt, state)
    h, c = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    a_prev = obs.cand_feat[:, 0].numpy()
    ctx = rng.standard_normal((B, ENC_LEN, H)).astype(np.float32)
    ctx_mask = np.arange(ENC_LEN)[None, :] >= rng.integers(1, ENC_LEN + 1, B)[:, None]
    return (a_prev, obs.cand_feat.numpy(), obs.meta.cand_mask.numpy(), h, c, ctx, ctx_mask)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("train", [False, True])
def test_decoder_step_matches_jax(setup, no_fixed_dropout, train, prec):
    s = setup
    dt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[prec]
    a_prev, cand_feat, cand_mask, h, c, ctx, ctx_mask = _step_inputs(s, 1)
    jp = cast_compute_params(s["j_params"]["decoder"], jdt)
    tp = t_common.cast_compute_params(_t_params(s["j_params"], grad=False)["decoder"], dt)
    j_bn = s["j_state"]["decoder_bn"]
    t_bn = model_state_from_jax(_np(s["j_state"]))["decoder_bn"]
    (lg_j, pr_j), (h_j, c_j), bn_j, _ = j_dec.monitor_decoder_step(
        jp, j_bn, jnp.asarray(a_prev).astype(jdt), jnp.asarray(cand_feat).astype(jdt),
        jnp.asarray(cand_mask), jnp.asarray(h), jnp.asarray(c), jnp.asarray(ctx),
        jnp.asarray(ctx_mask), jax.random.PRNGKey(0), train, 0.0)
    T = torch.from_numpy
    (lg_t, pr_t), (h_t, c_t), bn_t, _ = t_dec.monitor_decoder_step(
        tp, t_bn, T(a_prev).to(dt), T(cand_feat).to(dt), T(cand_mask), T(h), T(c), T(ctx),
        T(ctx_mask), train, 0.0)
    valid = ~cand_mask
    if prec == "f32":
        pairs = ((lg_t.numpy()[valid], np.asarray(lg_j)[valid]), (pr_t, pr_j), (h_t, h_j),
                 (c_t, c_j))
        for got, want in pairs:
            np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-5)
        _close_trees(bn_t, bn_j, atol=1e-5)
    else:
        for got, want in ((lg_t.float().numpy()[valid], np.asarray(lg_j, np.float32)[valid]),
                          (pr_t.float().numpy(), np.asarray(pr_j, np.float32))):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=3e-2 * max(1.0, float(np.abs(want).max())))


def _j_rollout(s, fb, train, params=None, lamb=0.5):
    return s["j_agent"].rollout(params if params is not None else s["j_params"], s["j_state"],
                                s["j_tables"], s["j_ep"], jax.random.PRNGKey(1), feedback=fb,
                                train=train, lamb=lamb)


@pytest.mark.parametrize("feedback", ["teacher", "argmax", "sample"])
def test_rollout_matches_jax(setup, fixed_sampler, feedback):
    s = setup
    fb = FEEDBACK[feedback]
    lj, rj, msj = _j_rollout(s, fb, False, lamb=0.3)
    state = model_state_from_jax(_np(s["j_state"]))
    lt, rt, mst = s["t_agent"].rollout(_t_params(s["j_params"], grad=False), s["t_tables"],
                                       s["t_ep"], fb, model_state=state, lamb=0.3)
    assert mst is state  # eval leaves the BN state as it was
    for name in ("action", "node_after", "moved", "alive_before", "teacher"):
        np.testing.assert_array_equal(getattr(rt.steps, name).numpy(),
                                      np.asarray(getattr(rj.steps, name)), name)
    for name in ("ce", "hidden", "progress", "dist_after"):
        np.testing.assert_allclose(getattr(rt.steps, name).numpy(),
                                   np.asarray(getattr(rj.steps, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    for name in ("ml_loss", "ml_loss_per_sample", "progress_loss"):
        np.testing.assert_allclose(getattr(lt, name).numpy(), np.asarray(getattr(lj, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    assert float(lt.progress_loss) > 0 and rt.steps.progress.abs().max() > 0
    if feedback != "teacher":
        assert rt.steps.moved.any()


@pytest.mark.parametrize("feedback", ["teacher", "sample"])
def test_loss_grads_and_bn_state_match_jax(setup, no_fixed_dropout, fixed_sampler, feedback):
    s = setup
    fb = FEEDBACK[feedback]

    def j_loss(p):
        losses, _, ms = _j_rollout(s, fb, True, params=p)
        return s["j_agent"].loss_fn(losses), (losses, ms)

    (val_j, (lj, msj)), grads_j = jax.value_and_grad(j_loss, has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    state = model_state_from_jax(_np(s["j_state"]))
    lt, _, mst = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], fb, train=True,
                                      model_state=state)
    total = s["t_agent"].loss_fn(lt)
    total.backward()
    np.testing.assert_allclose(total.item(), float(val_j), rtol=0, atol=ATOL)
    for name in ("ml_loss_per_sample", "progress_loss"):
        np.testing.assert_allclose(getattr(lt, name).detach().numpy(),
                                   np.asarray(getattr(lj, name)), rtol=0, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)
    # the BN statistics after 2 x EPISODE_LEN BN-MLP calls, carrying no gradient
    _close_trees(mst, msj)
    assert not any(t.requires_grad for t in t_tree.tree_leaves(mst))
    assert float(mst["decoder_bn"]["mlp"]["bn_in"]["count"]) == 2 * EPISODE_LEN


def test_adam_update_matches_jax_train_step(setup, no_fixed_dropout, fixed_sampler):
    """One sample-feedback iteration at PROGMONITOR_WEIGHT 0.5 and one Adam
    step, no clip: the updated parameters and the BN state equal those of
    the JAX build_train_step ("xla" backends)."""
    s = setup
    lr = 1e-3
    opt = j_loop.make_optimizer("adam", lr)
    step = j_loop.build_train_step(s["j_agent"], opt, "sample", progmonitor_weight=0.5)
    j_params = jax.tree_util.tree_map(jnp.array, s["j_params"])
    new_j, _, ms_j, logs_j = step(s["j_tables"], j_params, opt.init(j_params), s["j_state"],
                                  s["j_ep"], jax.random.PRNGKey(3))
    tp = _t_params(s["j_params"])
    optimizer = t_loop.make_optimizer("adam", lr, tp)
    logs_t, ms_t = t_loop.agent_one_iter(
        s["t_agent"], optimizer, "sample", s["t_tables"], tp,
        model_state_from_jax(_np(s["j_state"])), s["t_ep"], torch.Generator().manual_seed(3),
        lamb=0.5)
    for k in ("loss", "ml_loss", "loss_per_sample", "progress_loss"):
        np.testing.assert_allclose(logs_t[k].numpy(), np.asarray(logs_j[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    moved = [float((p.detach() - torch.from_numpy(np.array(w))).abs().max())
             for p, w in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(s["j_params"]))]
    assert max(moved) > 10 * ATOL
    # a shift of the input of a BatchNorm is taken out with the batch mean:
    # the gradients of BN(in)'s bias and of the first layer's bias are 0 up
    # to f32 rounding, which Adam's first step, lr g / (|g| + 1e-8), turns
    # into moves of up to lr in either direction; every other leaf equals
    # JAX's
    mlp = ("decoder", "proj_navigable_mlp")
    for path in (mlp + ("bn_in", "bias"), mlp + ("layers", 0, "b")):
        p0 = np.array(_leaf(s["j_params"], path))
        for leaf in (_leaf(tp, path, pop=True).detach().numpy(), _leaf(new_j, path, pop=True)):
            assert float(np.abs(np.asarray(leaf) - p0).max()) <= lr * (1 + 1e-6)
    _close_trees(tp, new_j)
    _close_trees(ms_t, ms_j)


def _leaf(tree, path, pop=False):
    """The leaf at ``path``, taken out of the tree with ``pop``."""
    for k in path[:-1]:
        tree = tree[k]
    return tree.pop(path[-1]) if pop else tree[path[-1]]
