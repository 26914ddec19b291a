"""The port's Follower agent against the JAX package, from the same
parameters (``params_from_jax``), in f32 with DROP_RATE 0, on B = 10
episodes (one a padding slot) of a small synthetic world, at narrow
widths (embedding 30, a 2-layer BiLSTM of 16 a direction, hidden 32).

* one decoder step: the reparameterised fused form the port runs
  (``follower_visual_query``, the observation op's plain twin,
  ``follower_decoder_from_vis``) and the reference-shaped
  ``follower_decoder_step``, both against JAX's ``follower_decoder_step``;
* rollouts in teacher, argmax and sample feedback (both samplers patched
  with pytest's ``monkeypatch``, in this process only, to argmax(logits +
  one fixed noise)): actions, nodes, CE, hidden states and both losses;
* the loss and every gradient leaf at train=True (``linear_in_v.b`` gets
  a zero gradient in both packages: the softmax ignores its term);
* one Adam update against JAX ``build_train_step`` (no clip);
* the SPCL-weighted objective dot(w, ml_vec) / sum(w) and its gradient.

Tolerances: atol 1e-4 for losses, hidden states, gradients and parameters
through a rollout — a recurrence of f32 products whose sums run in another
order (the fused form adds b_v's constant nowhere); 1e-5 for one decoder
step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.models import decoders as t_dec
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import (FEEDBACK_ARGMAX, FEEDBACK_SAMPLE,
                                                    FEEDBACK_TEACHER)
from curriculum_learning_for_vln_tpu.agents.follower import FollowerAgent as JAgent
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.models import decoders as j_dec
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 6, 10
ATOL = 1e-4
FEEDBACK = {"teacher": FEEDBACK_TEACHER, "argmax": FEEDBACK_ARGMAX, "sample": FEEDBACK_SAMPLE}


def _model_cfg():
    m = get_cfg_defaults().MODEL.FOLLOWER
    m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS, m.ENC_BIDIRECTION = 30, 32, 2, True
    m.DROP_RATE = 0.0
    return m


def episode_batches(synth_world, synth_dataset, tok, n):
    """The same n episodes (the last a padding slot) for both packages."""
    fields = {"instr_tokens": [], "instr_len": [], "start_node": [], "start_heading": [],
              "goal": [], "goal_local": []}
    for it in synth_dataset[:n]:
        tokens, length = tok.encode_sentence(it["instructions"][0])
        start = synth_world.global_id(it["scan"], it["path"][0])
        goal = synth_world.global_id(it["scan"], it["path"][-1])
        for k, v in zip(fields, (tokens, length, start, it["heading"], goal,
                                 synth_world.node_local[goal])):
            fields[k].append(v)
    arr = {k: np.asarray(v) for k, v in fields.items()}
    arr["start_heading"] = arr["start_heading"].astype(np.float32)
    arr["item_idx"] = np.arange(n)
    arr["valid"] = np.arange(n) < n - 1
    j_ep = j_env.EpisodeBatch(
        **{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
           for k, v in arr.items()},
        path_local=jnp.asarray(arr["goal_local"][:, None].astype(np.int32)),
        path_len=jnp.ones(n, jnp.int32))
    t_ep = t_env.EpisodeBatch(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                                     else v) for k, v in arr.items()})
    return j_ep, t_ep


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    t_agent = TAgent(_model_cfg(), tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    return {"j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"),
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params,
            "j_ep": j_ep, "t_ep": t_ep}


# leaves that add a per-sample constant to every score of a softmax, so
# that their gradient is 0: b_v of the visual attention, and ActionScoring's
# b_act (times the query) and output bias
SHIFT_INVARIANT = (("decoder", "visual_attn", "linear_in_v", "b"),
                   ("decoder", "decode_action", "linear_act", "b"),
                   ("decoder", "decode_action", "linear_out", "b"))


def _pop(tree, path, keep=False):
    """The leaf at ``path``, taken out of the tree unless ``keep``."""
    for k in path[:-1]:
        tree = tree[k]
    return tree[path[-1]] if keep else tree.pop(path[-1])


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


def test_decoder_step_matches_jax(setup):
    s = setup
    rng = np.random.default_rng(1)
    H, F, L = 32, FEAT_DIM + 128, ENC_LEN
    jp = s["j_params"]["decoder"]
    tp = _t_params(s["j_params"], grad=False)["decoder"]
    h, c = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    a_prev = rng.standard_normal((B, F)).astype(np.float32)
    ctx = rng.standard_normal((B, L, H)).astype(np.float32)
    ctx_mask = np.arange(L)[None, :] >= rng.integers(1, L + 1, B)[:, None]
    tt = s["t_tables"]
    node = torch.from_numpy(rng.integers(0, tt.features.shape[0], B))
    view = torch.from_numpy(rng.integers(0, 36, B))
    state = t_env.reset(tt, s["t_ep"])._replace(node=node, view_idx=view)
    meta = t_env.observe_meta(tt, state)
    obs = t_env.observe(tt, state)
    want = j_dec.follower_decoder_step(
        jp, jnp.asarray(obs.pano_feat.numpy()), jnp.asarray(a_prev),
        jnp.asarray(obs.cand_feat.numpy()), jnp.asarray(h), jnp.asarray(c), jnp.asarray(ctx),
        jnp.asarray(ctx_mask), jax.random.PRNGKey(0), False, 0.0)
    T = torch.from_numpy
    # the reference-shaped step
    got = t_dec.follower_decoder_step(tp, obs.pano_feat, T(a_prev), obs.cand_feat, T(h), T(c),
                                      T(ctx), T(ctx_mask), False, 0.0)
    # the fused form: the observation op on the reparameterised query
    tv = t_dec.follower_visual_query(tp, T(h))
    vis, cand_img = t_fused.pano_attend_cands(node, view, meta.cand_view, tt.features,
                                              tt.loc_embed, tv)
    cand_feat = t_env.assemble_cand_feat(cand_img, meta.cand_angle, meta.cand_valid)
    torch.testing.assert_close(cand_feat, obs.cand_feat, rtol=0, atol=0)
    fused = t_dec.follower_decoder_from_vis(tp, vis, T(a_prev), cand_feat, T(h), T(c), T(ctx),
                                            T(ctx_mask), False, 0.0)
    for out in (got, fused):
        (logits, (h1, c1), _) = out
        for g, w in ((logits, want[0]), (h1, want[1][0]), (c1, want[1][1])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("feedback", ["teacher", "argmax", "sample"])
def test_rollout_matches_jax(setup, fixed_sampler, feedback):
    s = setup
    fb = FEEDBACK[feedback]
    lj, rj, _ = s["j_agent"].rollout(s["j_params"], {}, s["j_tables"], s["j_ep"],
                                     jax.random.PRNGKey(1), feedback=fb, train=False)
    lt, rt, ms = s["t_agent"].rollout(_t_params(s["j_params"], grad=False), s["t_tables"],
                                      s["t_ep"], t_common.FEEDBACK_IDS[feedback])
    assert ms == {}
    for name in ("action", "node_after", "moved", "alive_before", "teacher"):
        np.testing.assert_array_equal(getattr(rt.steps, name).numpy(),
                                      np.asarray(getattr(rj.steps, name)), name)
    for name in ("ce", "hidden", "progress"):
        np.testing.assert_allclose(getattr(rt.steps, name).numpy(),
                                   np.asarray(getattr(rj.steps, name)), rtol=0, atol=ATOL,
                                   err_msg=name)
    for got, want in ((lt.ml_loss, lj.ml_loss), (lt.ml_loss_per_sample, lj.ml_loss_per_sample)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if feedback != "teacher":
        assert rt.steps.moved.any()  # the policy really moves
    assert int(rt.steps.ce_count[0]) == B - 1  # the padding slot is ignored


def _j_loss(s, fb, weights=None):
    def loss(p):
        losses, _, _ = s["j_agent"].rollout(p, {}, s["j_tables"], s["j_ep"],
                                            jax.random.PRNGKey(2), feedback=fb, train=True)
        return s["j_agent"].loss_fn(losses, weights), losses
    return loss


@pytest.mark.parametrize("feedback", ["teacher", "sample"])
def test_loss_and_grads_match_jax(setup, fixed_sampler, feedback):
    s = setup
    fb = FEEDBACK[feedback]
    (val_j, lj), grads_j = jax.value_and_grad(_j_loss(s, fb), has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    lt, _, _ = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], fb, train=True,
                                    generator=torch.Generator().manual_seed(2))
    total = s["t_agent"].loss_fn(lt)
    total.backward()
    np.testing.assert_allclose(total.item(), float(val_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lt.ml_loss_per_sample.detach().numpy(),
                               np.asarray(lj.ml_loss_per_sample), rtol=0, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)
    # b_v adds a per-sample constant to every view's score: no gradient in
    # either (exactly none in the port's reparameterised form; JAX's
    # unfused softmax VJP leaves f32 rounding, ~1e-10); nor, up to
    # rounding, the other shift-invariant leaves
    bv = tp["decoder"]["visual_attn"]["linear_in_v"]["b"]
    assert bv.grad is None or float(bv.grad.abs().max()) == 0.0
    for path in SHIFT_INVARIANT:
        assert float(jnp.abs(_pop(grads_j, path, keep=True)).max()) < 1e-7, path


def test_adam_update_matches_jax_train_step(setup, fixed_sampler):
    """One sample-feedback iteration and Adam step, no clip: the updated
    parameters equal the JAX build_train_step's ("xla" backends)."""
    s = setup
    lr = 1e-3
    opt = j_loop.make_optimizer("adam", lr)
    step = j_loop.build_train_step(s["j_agent"], opt, "sample")
    j_params = jax.tree_util.tree_map(jnp.array, s["j_params"])
    new_j, _, ms_j, logs_j = step(s["j_tables"], j_params, opt.init(j_params), {}, s["j_ep"],
                                  jax.random.PRNGKey(3))
    tp = _t_params(s["j_params"])
    optimizer = t_loop.make_optimizer("adam", lr, tp)
    logs_t, ms_t = t_loop.agent_one_iter(s["t_agent"], optimizer, "sample", s["t_tables"], tp,
                                         {}, s["t_ep"], torch.Generator().manual_seed(3))
    assert ms_t == {} and ms_j == {}
    for k in ("loss", "ml_loss", "loss_per_sample"):
        np.testing.assert_allclose(logs_t[k].numpy(), np.asarray(logs_j[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    moved = [float((p.detach() - torch.from_numpy(np.array(w))).abs().max())
             for p, w in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(s["j_params"]))]
    assert max(moved) > 10 * ATOL  # the step really moves the parameters
    # the shift-invariant leaves' gradients are 0 up to f32 rounding (~1e-9),
    # which Adam's first step, lr g / (|g| + 1e-8), turns into moves of up
    # to lr in either direction: those leaves move by at most lr in both
    # packages, and every other leaf equals JAX's
    for path in SHIFT_INVARIANT:
        p0 = _pop(s["j_params"], path, keep=True)
        for moved_leaf in (_pop(tp, path).detach().numpy(), np.asarray(_pop(new_j, path))):
            assert float(np.abs(moved_leaf - np.asarray(p0)).max()) <= lr * (1 + 1e-6)
    _close_trees(t_tree.tree_leaves(tp), new_j)


def test_spcl_weighted_objective_matches_jax(setup):
    """dot(w, ml_vec) / sum(w), normalised (unlike EnvDrop's), and its
    gradient, teacher-forced."""
    s = setup
    w = np.random.default_rng(9).uniform(0.01, 1.0, B).astype(np.float32)
    (val_j, lj), grads_j = jax.value_and_grad(_j_loss(s, FEEDBACK_TEACHER, jnp.asarray(w)),
                                              has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    lt, _, _ = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], FEEDBACK_TEACHER, train=True)
    total = s["t_agent"].loss_fn(lt, torch.from_numpy(w))
    np.testing.assert_allclose(total.item(), float(np.dot(w, lt.ml_loss_per_sample.detach())
                                                   / w.sum()), rtol=1e-6)
    total.backward()
    np.testing.assert_allclose(total.item(), float(val_j), rtol=0, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)
