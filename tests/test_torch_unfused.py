"""The port's plain route (TPU.USE_PALLAS False: ``ops.set_kernels(False)``)
against the JAX package's XLA route, the route JAX's CPU runs take: the
LSTM step loop and EnvDrop's unfused decode, from the same parameters
(``params_from_jax``), in f32 with both dropout rates at 0, on B = 10
episodes (one a padding slot) of a small synthetic world.

* ``rnn.masked_lstm`` on the plain backend against ``masked_lstm_xla``,
  forward and reverse, over lengths with a 0 and a full row: outputs, final
  state and the gradients of xs and the weights (autograd against
  ``jax.vjp``), and in bf16 the forward;
* EnvDrop ``rollout`` at train=False in teacher and argmax feedback:
  masked logits, actions, nodes, hidden states and CE;
* the IL loss and its gradients, and the A2C loss and its gradients (both
  samplers patched, in this process only, to argmax(logits + one fixed
  noise)), the A2C tail's bootstrap step on the unfused decode;
* ``rollout_packed(feat_mask=...)`` (back-translation's shared noise over
  a pool of 2 x B) against JAX's.

Every test runs with the JAX backends at "xla" (JAX's own default on the
CPU) and the port's at "plain", and restores both.  Tolerances: atol 1e-4
through a rollout (a recurrence of f32 products summed in another order),
1e-5 for the LSTM alone; bf16 forward 1e-2 of the output's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch import ops as t_ops
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.ops import rnn as t_rnn
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import (FEEDBACK_ARGMAX, FEEDBACK_SAMPLE,
                                                    FEEDBACK_TEACHER)
from curriculum_learning_for_vln_tpu.agents import common as j_common
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.ops import fused_obs as j_fused
from curriculum_learning_for_vln_tpu.ops import rnn as j_rnn
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults
from test_torch_follower import episode_batches

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 8, 10
ATOL = 1e-4


@pytest.fixture(autouse=True)
def routes():
    """JAX on its XLA backends, the port on its plain route; both restored."""
    saved = (j_rnn.get_backend(), j_fused.get_backend(), t_rnn.get_backend(),
             t_fused.get_backend())
    j_rnn.set_backend("xla")
    j_fused.set_backend("xla")
    t_ops.set_kernels(False)
    yield
    j_rnn.set_backend(saved[0])
    j_fused.set_backend(saved[1])
    t_rnn.set_backend(saved[2])
    t_fused.set_backend(saved[3])


def _model_cfg():
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
    m.DROP_RATE = m.FEAT_DROP_RATE = 0.0
    m.ML_WEIGHT, m.GAMMA, m.RL_NORMALIZE = 0.2, 0.9, "total"
    return m


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    # obs_masks "prng": the plain route must not read it
    t_agent = TAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    j_pool, t_pool = episode_batches(synth_world, synth_dataset[B:], tok, 2 * B + 1)
    valid = slice(0, 2 * B)  # a packed pool holds only valid episodes
    j_pool = j_env.EpisodeBatch(*(f[valid] for f in j_pool))
    t_pool = t_env.EpisodeBatch(*(f[valid] for f in t_pool))
    return {"j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"),
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params,
            "j_ep": j_ep, "t_ep": t_ep, "j_pool": j_pool, "t_pool": t_pool}


def _t_params(j_params, grad=True):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(grad), p)


def _close_trees(t_leaves, j_tree, atol=ATOL):
    """Leaf by leaf; a port leaf of None (no gradient reached it) is JAX's zeros."""
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for got, want in zip(t_leaves, j_leaves):
        got = np.zeros(want.shape, np.float32) if got is None else got.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.fixture()
def fixed_sampler(monkeypatch):
    """Both packages sample argmax(logits + NOISE), NOISE one fixed
    [B, MC+1] array for every step."""
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


@pytest.fixture()
def no_fused_op(monkeypatch):
    """Any call of the observation ops or the LSTM scan's wrappers fails."""
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel op ran on the plain route")

    for mod, names in ((pano_fused, ("pano_attend", "pano_attend_bwd")),
                       (cand_score, ("cand_score", "cand_score_bwd")),
                       (lstm_scan, ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


# ---------------------------------------------------------------------------
# masked_lstm
# ---------------------------------------------------------------------------

def _lstm_inputs(Bl=7, L=9, D=20, H=16):
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((Bl, L, D)).astype(np.float32)
    w_ih = (0.3 * rng.standard_normal((D, 4 * H))).astype(np.float32)
    w_hh = (0.3 * rng.standard_normal((H, 4 * H))).astype(np.float32)
    b = (0.1 * rng.standard_normal(4 * H)).astype(np.float32)
    lengths = np.array([0, L, 3, 1, L - 1, 5, 2])[:Bl]
    return xs, lengths, w_ih, w_hh, b


@pytest.mark.parametrize("reverse", [False, True])
def test_masked_lstm_plain_matches_xla(reverse, no_fused_op):
    xs, lengths, w_ih, w_hh, b = _lstm_inputs()
    rng = np.random.default_rng(12)
    d_out = rng.standard_normal((xs.shape[0], xs.shape[1], w_hh.shape[0])).astype(np.float32)
    d_h, d_c = (rng.standard_normal((xs.shape[0], w_hh.shape[0])).astype(np.float32)
                for _ in range(2))

    def j_fn(xs_, w_ih_, w_hh_, b_):
        return j_rnn.masked_lstm_xla(xs_, jnp.asarray(lengths, jnp.int32), w_ih_, w_hh_, b_,
                                     reverse=reverse)

    (j_out, (j_h, j_c)), vjp = jax.vjp(j_fn, *map(jnp.asarray, (xs, w_ih, w_hh, b)))
    j_grads = vjp((jnp.asarray(d_out), (jnp.asarray(d_h), jnp.asarray(d_c))))

    t_in = [torch.tensor(a, requires_grad=True) for a in (xs, w_ih, w_hh, b)]
    t_out, (t_h, t_c) = t_rnn.masked_lstm(t_in[0], torch.from_numpy(lengths), *t_in[1:],
                                          reverse=reverse)
    assert t_out.dtype == t_h.dtype == torch.float32
    for got, want in ((t_out, j_out), (t_h, j_h), (t_c, j_c)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not t_out[0].any() and not t_h[0].any()  # a length-0 row: zeros throughout
    t_grads = torch.autograd.grad((t_out, t_h, t_c), t_in,
                                  (torch.from_numpy(d_out), torch.from_numpy(d_h),
                                   torch.from_numpy(d_c)))
    for got, want in zip(t_grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert not t_grads[0][0].any()  # nothing reaches a length-0 row's inputs


def test_masked_lstm_plain_bf16_forward_matches_xla(no_fused_op):
    xs, lengths, w_ih, w_hh, b = _lstm_inputs()
    j_in = [jnp.asarray(a, jnp.bfloat16) for a in (xs, w_ih, w_hh, b)]
    j_out, (j_h, _) = j_rnn.masked_lstm_xla(j_in[0], jnp.asarray(lengths, jnp.int32), *j_in[1:])
    t_in = [torch.from_numpy(a).to(torch.bfloat16) for a in (xs, w_ih, w_hh, b)]
    t_out, (t_h, _) = t_rnn.masked_lstm(t_in[0], torch.from_numpy(lengths), *t_in[1:])
    assert t_out.dtype == torch.float32  # the state stays f32, as in JAX
    for got, want in ((t_out, j_out), (t_h, j_h)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# EnvDrop on the unfused decode
# ---------------------------------------------------------------------------

def jax_masked_logits(monkeypatch, run):
    """Run ``run()`` (a JAX rollout) and return the masked logits it
    selected its actions from, step by step (as test_torch_slice.py)."""
    seen = []
    select = j_common.select_action

    def recording_select(feedback, masked_logits, teacher, rng):
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), masked_logits, ordered=True)
        return select(feedback, masked_logits, teacher, rng)

    monkeypatch.setattr(j_common, "select_action", recording_select)
    out = run()
    jax.effects_barrier()
    return out, np.stack(seen)


@pytest.mark.parametrize("feedback", ["teacher", "argmax"])
def test_rollout_matches_jax(setup, feedback, no_fused_op, monkeypatch):
    s = setup
    fb = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX}[feedback]
    (lj, rj, _), j_logits = jax_masked_logits(monkeypatch, lambda: s["j_agent"].rollout(
        s["j_params"], {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1), feedback=fb,
        train=False))
    lt, rt = s["t_agent"].rollout(_t_params(s["j_params"], grad=False), s["t_tables"], s["t_ep"],
                                  fb)
    for name in ("action", "node_after", "moved", "alive_before", "teacher"):
        np.testing.assert_array_equal(getattr(rt.steps, name).numpy(),
                                      np.asarray(getattr(rj.steps, name)), name)
    live = j_logits > -1e29
    np.testing.assert_array_equal(rt.steps.logits.numpy() > -1e29, live)
    np.testing.assert_allclose(rt.steps.logits.numpy()[live], j_logits[live], rtol=0, atol=ATOL)
    for name in ("ce", "hidden"):
        np.testing.assert_allclose(getattr(rt.steps, name).numpy(),
                                   np.asarray(getattr(rj.steps, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(lt.ml_loss.numpy(), np.asarray(lj.ml_loss), rtol=0, atol=ATOL)
    if feedback == "argmax":
        assert rt.steps.moved.any()  # the policy really moves


def _j_grads(s, fb, train_rl):
    def loss(p):
        losses, _, _ = s["j_agent"].rollout(p, {}, s["j_tables"], s["j_ep"],
                                            jax.random.PRNGKey(2), feedback=fb, train=True,
                                            train_ml=not train_rl, train_rl=train_rl)
        return losses.rl_loss if train_rl else losses.ml_loss, losses
    return jax.value_and_grad(loss, has_aux=True)(s["j_params"])


@pytest.mark.parametrize("arm", ["il", "a2c"])
def test_loss_and_grads_match_jax(setup, fixed_sampler, no_fused_op, arm):
    """The IL loss (teacher) and the A2C loss (sample, with the bootstrap
    step's unfused decode), each with every gradient leaf."""
    s = setup
    train_rl = arm == "a2c"
    fb = FEEDBACK_SAMPLE if train_rl else FEEDBACK_TEACHER
    (val_j, lj), grads_j = _j_grads(s, fb, train_rl)
    tp = _t_params(s["j_params"])
    lt, _ = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], fb, train=True,
                                 train_ml=not train_rl, train_rl=train_rl,
                                 generator=torch.Generator().manual_seed(2))
    total = lt.rl_loss if train_rl else lt.ml_loss
    total.backward()
    np.testing.assert_allclose(total.item(), float(val_j), rtol=0, atol=ATOL)
    vec_t, vec_j = ((lt.rl_loss_per_sample, lj.rl_loss_per_sample) if train_rl
                    else (lt.ml_loss_per_sample, lj.ml_loss_per_sample))
    np.testing.assert_allclose(vec_t.detach().numpy(), np.asarray(vec_j), rtol=0, atol=ATOL)
    if train_rl:
        np.testing.assert_allclose(lt.critic_loss_sum.item(), float(lj.critic_loss_sum),
                                   rtol=1e-5, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)


def test_rollout_packed_feat_mask_matches_jax(setup, fixed_sampler, no_fused_op):
    """Back-translation's shared noise over a packed pool of 2 x B episodes,
    B slots: the loss and its gradients."""
    s = setup
    mask = (np.random.default_rng(4).random(FEAT_DIM) < 0.7).astype(np.float32) / 0.7

    def j_loss(p):
        losses, _ = s["j_agent"].rollout_packed(p, {}, s["j_tables"], s["j_pool"],
                                                jax.random.PRNGKey(3), B,
                                                feat_mask=jnp.asarray(mask))
        return losses.rl_loss, losses

    (val_j, lj), grads_j = jax.value_and_grad(j_loss, has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    lt, rt = s["t_agent"].rollout_packed(tp, s["t_tables"], s["t_pool"], batch_size=B,
                                         generator=torch.Generator().manual_seed(3),
                                         feat_mask=torch.from_numpy(mask))
    lt.rl_loss.backward()
    np.testing.assert_allclose(lt.rl_loss.item(), float(val_j), rtol=0, atol=ATOL)
    assert int(lt.episodes_done) == int(lj.episodes_done) > 0
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)
