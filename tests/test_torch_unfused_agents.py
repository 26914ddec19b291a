"""The Follower's and the Self-Monitor's plain route (TPU.USE_PALLAS
False: ``ops.set_kernels(False)``) against the JAX package's XLA route:
their unfused branches (JAX follower.py:109-114, monitor.py:106-107),
``obs.cand_feat`` / ``obs.pano_feat`` gathered plainly, from the same
parameters (and, for the Self-Monitor, BN state), in f32 with DROP_RATE 0,
on B = 10 episodes (one a padding slot) at the narrow widths of
``test_torch_follower.py`` and ``test_torch_monitor.py``:

* ``rollout`` at train=False in teacher and argmax feedback: the masked
  logits each action was chosen from, actions, nodes, CE, hidden states
  (and the progress monitor's outputs) and the losses;
* at train=True, teacher-forced: the loss and every gradient leaf (and the
  Self-Monitor's BN statistics; its fixed-rate BN-MLP and positional
  dropouts at 0 in both packages, as ``test_torch_monitor.py`` sets them).

No kernel op may run (each wrapper raises if called).  Every test runs
with the JAX backends at "xla" and the port's at "plain", restoring both.
Tolerance: atol 1e-4 through a rollout, as in the fused route's tests.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TFollower
from curriculum_learning_for_vln_torch.agents.monitor import SelfMonitorAgent as TMonitor
from curriculum_learning_for_vln_torch.convert import model_state_from_jax
from curriculum_learning_for_vln_torch.models import attention as t_att
from curriculum_learning_for_vln_torch.models import decoders as t_dec
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import FEEDBACK_ARGMAX, FEEDBACK_TEACHER
from curriculum_learning_for_vln_tpu.agents.follower import FollowerAgent as JFollower
from curriculum_learning_for_vln_tpu.agents.monitor import SelfMonitorAgent as JMonitor
from curriculum_learning_for_vln_tpu.models import attention as j_att
from curriculum_learning_for_vln_tpu.models import decoders as j_dec
from test_torch_follower import _model_cfg as follower_cfg
from test_torch_follower import episode_batches
from test_torch_monitor import _model_cfg as monitor_cfg
from test_torch_unfused import _close_trees, _t_params, jax_masked_logits, no_fused_op, routes

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 6, 10
ATOL = 1e-4
FEEDBACK = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX}
_ = (no_fused_op, routes)  # fixtures of test_torch_unfused.py: routes is autouse here too


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    j_follower = JFollower(follower_cfg(), tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_monitor = JMonitor(monitor_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    f_params, _ = j_follower.init(jax.random.PRNGKey(0))
    m_params, m_state = j_monitor.init(jax.random.PRNGKey(0))
    # BN biases off 0, as test_torch_monitor.py sets them: the first step's
    # all-zero a_prev rows would otherwise sit on the ReLU's kink
    mlp = m_params["decoder"]["proj_navigable_mlp"]
    rng = np.random.default_rng(8)
    for bn in (mlp["bn_in"], *mlp["bn_layers"]):
        bn["bias"] = bn["bias"] + jnp.asarray(rng.uniform(-0.5, 0.5, bn["bias"].shape),
                                              jnp.float32)
    return {
        "j_tables": synth_world.device_tables("f32"),
        "t_tables": t_world.device_tables("f32", device="cpu"), "j_ep": j_ep, "t_ep": t_ep,
        "FOLLOWER": (j_follower, TFollower(follower_cfg(), tok.vocab_size(), FEAT_DIM,
                                           EPISODE_LEN), f_params, {}),
        "SELF-MONITOR": (j_monitor, TMonitor(monitor_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM,
                                             EPISODE_LEN), m_params, m_state),
    }


@pytest.fixture()
def no_fixed_dropout(monkeypatch):
    """The Self-Monitor's BN-MLP and positional-encoding dropouts at rate 0
    in both packages' decoders (this process only)."""
    monkeypatch.setattr(j_dec, "mlp_bn", functools.partial(j_att.mlp_bn, drop_rate=0.0))
    monkeypatch.setattr(j_dec, "positional_encoding",
                        functools.partial(j_att.positional_encoding, rate=0.0))
    monkeypatch.setattr(t_dec, "mlp_bn", functools.partial(t_att.mlp_bn, drop_rate=0.0))
    monkeypatch.setattr(t_dec, "positional_encoding",
                        functools.partial(t_att.positional_encoding, rate=0.0))


def _t_state(j_state):
    return model_state_from_jax(jax.tree_util.tree_map(np.array, j_state))


@pytest.mark.parametrize("feedback", ["teacher", "argmax"])
@pytest.mark.parametrize("name", ["FOLLOWER", "SELF-MONITOR"])
def test_rollout_matches_jax(setup, no_fused_op, monkeypatch, name, feedback):
    s = setup
    j_agent, t_agent, j_params, j_state = s[name]
    fb = FEEDBACK[feedback]
    (lj, rj, _), j_logits = jax_masked_logits(monkeypatch, lambda: j_agent.rollout(
        j_params, j_state, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1), feedback=fb,
        train=False))
    lt, rt, _ = t_agent.rollout(_t_params(j_params, grad=False), s["t_tables"], s["t_ep"], fb,
                                model_state=_t_state(j_state))
    for field in ("action", "node_after", "moved", "alive_before", "teacher"):
        np.testing.assert_array_equal(getattr(rt.steps, field).numpy(),
                                      np.asarray(getattr(rj.steps, field)), field)
    live = j_logits > -1e29
    np.testing.assert_array_equal(rt.steps.logits.numpy() > -1e29, live)
    np.testing.assert_allclose(rt.steps.logits.numpy()[live], j_logits[live], rtol=0, atol=ATOL)
    for field in ("ce", "hidden", "progress"):
        np.testing.assert_allclose(getattr(rt.steps, field).numpy(),
                                   np.asarray(getattr(rj.steps, field)), rtol=0, atol=ATOL,
                                   err_msg=field)
    for got, want in ((lt.ml_loss, lj.ml_loss), (lt.ml_loss_per_sample, lj.ml_loss_per_sample)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if feedback == "argmax":
        assert rt.steps.moved.any()  # the policy really moves


@pytest.mark.parametrize("name", ["FOLLOWER", "SELF-MONITOR"])
def test_loss_and_grads_match_jax(setup, no_fused_op, no_fixed_dropout, name):
    s = setup
    j_agent, t_agent, j_params, j_state = s[name]

    def j_loss(p):
        losses, _, ms = j_agent.rollout(p, j_state, s["j_tables"], s["j_ep"],
                                        jax.random.PRNGKey(2), feedback=FEEDBACK_TEACHER,
                                        train=True)
        return j_agent.loss_fn(losses), (losses, ms)

    (val_j, (lj, msj)), grads_j = jax.value_and_grad(j_loss, has_aux=True)(j_params)
    tp = _t_params(j_params)
    lt, _, mst = t_agent.rollout(tp, s["t_tables"], s["t_ep"], FEEDBACK_TEACHER, train=True,
                                 generator=torch.Generator().manual_seed(2),
                                 model_state=_t_state(j_state))
    total = t_agent.loss_fn(lt)
    total.backward()
    np.testing.assert_allclose(total.item(), float(val_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lt.ml_loss_per_sample.detach().numpy(),
                               np.asarray(lj.ml_loss_per_sample), rtol=0, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)
    if name == "SELF-MONITOR":  # the BN statistics after the rollout
        _close_trees(t_tree.tree_leaves(mst), msj)
