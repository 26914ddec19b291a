"""The port's hand-written rollout BPTT (``ops/bptt.py``, ``TPU.FUSED_BPTT``)
at the sizes of tests/test_bptt.py (H = 64, B = 6, T = 8, 64-d features):

* against the JAX package's BPTT (``EnvDropAgent(use_fused_bptt=True)``,
  ops/bptt.py there) from the same parameters, dropout 0: the IL loss
  (teacher feedback) and the A2C loss (sample feedback, both samplers
  replayed to argmax(logits + one fixed noise)) and every gradient leaf in
  f32, within 1e-4 x max(1, |JAX|);
* against the port's own autograd rollout, dropout on (DROP_RATE 0.5,
  FEAT_DROP_RATE 0.3), in every TPU.OBS_MASKS mode, teacher and sample
  feedback, with back-translation's feature mask, with ``avoid_cyclic``,
  and with SPCL weights over a bucketed (shorter) IL rollout: the same
  forward (records equal), the loss and every gradient leaf within JAX's
  test bounds (rtol 2e-4, atol 2e-5), and the generator left where the
  autograd rollout leaves it; in bf16 the loss equal, every leaf finite
  and within 1e-2 of autograd's in relative L2 (the autograd path sums
  each step's weight gradient in bf16, the BPTT once in f32);
* one whole ``one_iter`` update with the flag on against the flag off;
* ``build_agent`` reads TPU.FUSED_BPTT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch.agents import build_agent as t_build_agent
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.models.core import dropout_mask
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults as t_cfg
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import FEEDBACK_SAMPLE, FEEDBACK_TEACHER
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults
from test_torch_follower import episode_batches

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 24, 8, 6
RTOL, ATOL = 2e-4, 2e-5


def _model_cfg(drop=0.0, fdrop=0.0):
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.ENC_BIDIRECTION, m.ENC_LAYERS = True, 1
    m.ML_WEIGHT, m.GAMMA, m.RL_NORMALIZE = 0.2, 0.9, "total"
    m.DROP_RATE, m.FEAT_DROP_RATE = drop, fdrop
    return m


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    data = expand_r2r_items(synth_dataset, tokenizer)
    return {"tok": tok, "j_tables": synth_world.device_tables("f32"),
            "t_world": t_world, "t_ep": t_ep, "j_ep": j_ep,
            "t_ep_env": TEnv(t_world, data, B, tokenizer, seed=7, device="cpu").next_batch()}


def _fresh(params):
    return t_tree.tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


def _grads(params):
    return [p.grad for p in t_tree.tree_leaves(params)]


def _pairs(g0, g1):
    """The gradient leaves both rollouts reached (the critic's none without
    an A2C loss: None in both)."""
    for a, b in zip(g0, g1, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            yield a, b


# ---------------------------------------------------------------------------
# against the JAX package's BPTT
# ---------------------------------------------------------------------------

@pytest.fixture()
def fixed_sampler(monkeypatch):
    """Both packages sample argmax(logits + NOISE), NOISE one fixed
    [B, MC+1] array for every step."""
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


@pytest.mark.parametrize("feedback", [FEEDBACK_TEACHER, FEEDBACK_SAMPLE])
def test_bptt_matches_jax_bptt(setup, fixed_sampler, feedback):
    s = setup
    rl = feedback == FEEDBACK_SAMPLE
    j_agent = JAgent(_model_cfg(), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_agent.use_fused_bptt = True
    j_params, _ = j_agent.init(jax.random.PRNGKey(1))

    def j_loss(p):
        losses, _, _ = j_agent.rollout(p, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(4),
                                       feedback=feedback, train=True, train_ml=not rl,
                                       train_rl=rl)
        return j_agent.loss_fn(losses)

    val_j, grads_j = jax.value_and_grad(j_loss)(j_params)
    t_agent = TAgent(_model_cfg(), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN)
    t_agent.use_fused_bptt = True
    tp = _fresh(params_from_jax(jax.tree_util.tree_map(np.asarray, j_params)))
    losses, result = t_agent.rollout(tp, s["t_world"].device_tables("f32", "cpu"), s["t_ep"],
                                     feedback, train=True, train_ml=not rl, train_rl=rl,
                                     generator=torch.Generator().manual_seed(4))
    loss = t_agent.loss_fn(losses)
    loss.backward()
    if rl:
        assert result.steps.moved.any()
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=0, atol=1e-4 * max(1, abs(val_j)))
    j_leaves = jax.tree_util.tree_leaves(grads_j)
    t_leaves = _grads(tp)
    assert len(t_leaves) == len(j_leaves)
    for got, want in zip(t_leaves, j_leaves):
        want = np.asarray(want)
        got = np.zeros(want.shape, np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# against the port's autograd rollout, dropout on
# ---------------------------------------------------------------------------

def _run(agent, params, tables, ep, fused, feedback, weights=None, seed=3, **kw):
    agent.use_fused_bptt = fused
    p = _fresh(params)
    gen = torch.Generator().manual_seed(seed)
    rl = feedback == FEEDBACK_SAMPLE
    losses, result = agent.rollout(p, tables, ep, feedback, train=True, train_ml=not rl,
                                   train_rl=rl, generator=gen, **kw)
    loss = agent.loss_fn(losses, weights)
    loss.backward()
    return loss.detach(), _grads(p), result, gen.get_state()


def _assert_same_rollout(r0, r1):
    """The same forward: every record equal."""
    for f in r0.steps._fields:
        assert torch.equal(getattr(r0.steps, f), getattr(r1.steps, f)), f


CASES = [(mode, fb) for mode in ("prng", "prng_shared", "ext")
         for fb in (FEEDBACK_TEACHER, FEEDBACK_SAMPLE)]


@pytest.mark.parametrize("mode,feedback", CASES)
def test_bptt_matches_autograd_with_dropout(setup, mode, feedback):
    s = setup
    agent = TAgent(_model_cfg(0.5, 0.3), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN,
                   obs_masks=mode)
    params = agent.init(torch.Generator().manual_seed(2))
    tables = s["t_world"].device_tables("f32", "cpu")
    l0, g0, r0, s0 = _run(agent, params, tables, s["t_ep_env"], False, feedback)
    l1, g1, r1, s1 = _run(agent, params, tables, s["t_ep_env"], True, feedback)
    assert torch.equal(s0, s1), "the generator ends elsewhere"
    _assert_same_rollout(r0, r1)
    assert torch.equal(l0, l1)
    for a, b in _pairs(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("option", ["feat_mask", "avoid_cyclic", "spcl_bucketed"])
def test_bptt_matches_autograd_options(setup, option):
    s = setup
    agent = TAgent(_model_cfg(0.5, 0.3), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN)
    params = agent.init(torch.Generator().manual_seed(3))
    tables = s["t_world"].device_tables("f32", "cpu")
    feedback, kw, weights = FEEDBACK_TEACHER, {}, None
    if option == "feat_mask":  # back-translation's shared noise (ref: envdrop.py:105-121)
        kw["feat_mask"] = dropout_mask((FEAT_DIM,), 0.4, torch.Generator().manual_seed(9))
    elif option == "avoid_cyclic":
        feedback, kw["avoid_cyclic"] = FEEDBACK_SAMPLE, True
    else:
        kw["episode_len"] = 4
        weights = torch.linspace(0.1, 1.0, B)
    runs = [_run(agent, params, tables, s["t_ep_env"], fused, feedback, weights, **kw)
            for fused in (False, True)]
    (l0, g0, r0, s0), (l1, g1, r1, s1) = runs
    assert torch.equal(s0, s1)
    _assert_same_rollout(r0, r1)
    assert r1.steps.ce.shape[0] == kw.get("episode_len", EPISODE_LEN)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in _pairs(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)


def test_bptt_bf16_close_to_autograd(setup):
    s = setup
    agent = TAgent(_model_cfg(0.5, 0.3), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN,
                   compute_dtype=torch.bfloat16)
    params = agent.init(torch.Generator().manual_seed(5))
    tables = s["t_world"].device_tables("bf16", "cpu")
    (l0, g0, r0, s0), (l1, g1, r1, s1) = (
        _run(agent, params, tables, s["t_ep_env"], fused, FEEDBACK_SAMPLE) for fused in (0, 1))
    assert torch.equal(s0, s1)
    _assert_same_rollout(r0, r1)
    assert torch.equal(l0, l1) and bool(torch.isfinite(l1))
    for a, b in _pairs(g0, g1):
        assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
        assert float((b - a).norm()) <= 1e-2 * float(a.norm()) + 1e-6


def test_one_iter_with_the_flag(setup):
    """IL + A2C, one backward, the clip at 40, RMSprop: the update with the
    flag on equals the flag-off update."""
    s = setup
    cfg = t_cfg()
    cfg.merge_from_list(["MODEL.NAME", "ENVDROP", "TPU.PRECISION", "f32", "DATA.MAX_ENC_LEN",
                         ENC_LEN, "AGENT.MAX_EPISODE_LEN", EPISODE_LEN,
                         "MODEL.ENVDROP.WORD_EMB_SIZE", 32, "MODEL.ENVDROP.ACT_EMB_SIZE", 16,
                         "MODEL.ENVDROP.HIDDEN_SIZE", 64, "TPU.OBS_MASKS", "prng_shared"])
    tables = s["t_world"].device_tables("f32", "cpu")
    out = {}
    for flag in (False, True):
        cfg.TPU.FUSED_BPTT = flag
        agent = t_build_agent(cfg, s["tok"].vocab_size(), FEAT_DIM)
        assert agent.use_fused_bptt is flag
        params = _fresh(agent.init(torch.Generator().manual_seed(6)))
        opt = t_loop.make_optimizer("rms", 1e-3, params)
        gen = torch.Generator().manual_seed(8)
        logs = t_loop.one_iter(agent, opt, "sample", tables, params, s["t_ep_env"], gen)
        out[flag] = (logs, params, gen.get_state())
    (l0, p0, g0), (l1, p1, g1) = out[False], out[True]
    assert torch.equal(g0, g1)
    for k in ("loss", "ml_loss", "rl_loss", "critic_loss", "entropy", "total_actions"):
        np.testing.assert_allclose(float(l1[k]), float(l0[k]), rtol=1e-6, err_msg=k)
    for a, b in zip(t_tree.tree_leaves(p0), t_tree.tree_leaves(p1), strict=True):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=0, atol=1e-6)


def _graph_nodes(root):
    seen, todo = {}, [root]
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen[id(node)] = node
        todo.extend(n for n, _ in node.next_functions)
    return list(seen.values())


@pytest.mark.parametrize("fused", [False, True])
def test_rollout_residuals_are_freed_by_the_backward(setup, fused):
    """The BPTT's per-step records and the observation ops' ext masks go
    with the backward, as autograd's saved tensors do, and not with the
    rollout's outputs, which the trainer's logs keep into the next
    iteration."""
    s = setup
    agent = TAgent(_model_cfg(0.5, 0.3), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN,
                   obs_masks="ext")
    agent.use_fused_bptt = fused
    p = _fresh(agent.init(torch.Generator().manual_seed(2)))
    tables = s["t_world"].device_tables("f32", "cpu")
    losses, _ = agent.rollout(p, tables, s["t_ep_env"], FEEDBACK_SAMPLE, train=True,
                              train_ml=False, train_rl=True,
                              generator=torch.Generator().manual_seed(3))
    loss = agent.loss_fn(losses)
    kinds = ("_RolloutBackward",) if fused else ("PanoAttendBackward", "CandAttendBackward")
    ops = [n for n in _graph_nodes(loss.grad_fn) if type(n).__name__ in kinds]
    assert ops and not any(hasattr(n, "drop") for n in ops)
    if fused:
        assert len(ops) == 1 and ops[0].saved is not None
        loss.backward(retain_graph=True)
        assert ops[0].saved is None and ops[0].steps is None
        with pytest.raises(RuntimeError, match="runs once"):
            loss.backward()
    else:
        assert len(ops) == 2 * EPISODE_LEN
        loss.backward()
        for n in ops:
            with pytest.raises(RuntimeError):
                n.saved_tensors  # freed with the ext masks
