"""The port's EnvDrop training iteration against the JAX package, from the
same parameters (``params_from_jax``), in f32 with both dropout rates at
0, on B = 10 episodes (one a padding slot) of a small synthetic world.

* the IL loss (teacher-forced rollout at train=True) and its gradient
  against ``jax.value_and_grad`` over the JAX ``EnvDropAgent.rollout``;
* the A2C loss and its gradient, with both packages' samplers patched
  (pytest's ``monkeypatch``, on this process only) to the same
  deterministic choice, argmax(logits + a fixed noise);
* one whole ``one_iter`` update against the JAX ``build_train_step``
  with its default "xla" backends;
* the port's RMSprop and Adam against optax over 3 steps, and the
  submodule gradient clip against JAX's;
* the port alone, env dropout on: the agent's OBS_MASKS "ext" rollout
  against its "prng" rollout given the same masks.

Tolerances: atol 1e-4 for losses, gradients and parameters through a
rollout — an 8-step recurrence of f32 products whose sums run in another
order; 1e-6 for the optimizers and (relative) the clip, which see
identical f32 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
import curriculum_learning_for_vln_torch.agents.envdrop as t_envdrop
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.ops import philox
from curriculum_learning_for_vln_torch.ops.cuda import drop as t_drop
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import FEEDBACK_SAMPLE, FEEDBACK_TEACHER
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from curriculum_learning_for_vln_tpu.env import env as j_env
from curriculum_learning_for_vln_tpu.utils.config import get_cfg_defaults

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 8, 10
ATOL = 1e-4
LR = 1e-3


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
    items = synth_dataset[:B]
    fields = {"instr_tokens": [], "instr_len": [], "start_node": [], "start_heading": [],
              "goal": [], "goal_local": []}
    for it in items:
        tokens, length = tok.encode_sentence(it["instructions"][0])
        start = synth_world.global_id(it["scan"], it["path"][0])
        goal = synth_world.global_id(it["scan"], it["path"][-1])
        for k, v in zip(fields, (tokens, length, start, it["heading"], goal,
                                 synth_world.node_local[goal])):
            fields[k].append(v)
    arr = {k: np.asarray(v) for k, v in fields.items()}
    arr["start_heading"] = arr["start_heading"].astype(np.float32)
    arr["item_idx"] = np.arange(B)
    arr["valid"] = np.arange(B) < B - 1  # one padding slot, born ended
    j_ep = j_env.EpisodeBatch(
        **{k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
           for k, v in arr.items()},
        path_local=jnp.asarray(arr["goal_local"][:, None].astype(np.int32)),
        path_len=jnp.ones(B, jnp.int32))
    t_ep = t_env.EpisodeBatch(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                                     else v) for k, v in arr.items()})
    return {"j_tables": synth_world.device_tables("f32"),
            "t_tables": t_world.device_tables("f32", device="cpu"),
            "j_agent": j_agent, "t_agent": t_agent, "j_params": j_params,
            "j_ep": j_ep, "t_ep": t_ep}


def _t_params(j_params):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(True), p)


def _close_trees(t_leaves, j_tree, atol=ATOL, rtol=0.0):
    """Leaf by leaf; a port leaf of None (no gradient reached it) is JAX's zeros."""
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for got, want in zip(t_leaves, j_leaves):
        got = np.zeros(want.shape, np.float32) if got is None else got.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture()
def fixed_sampler(monkeypatch):
    """Both packages sample argmax(logits + NOISE), NOISE one fixed
    [B, MC+1] array for every step."""
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def test_il_loss_and_grads_match_jax(setup):
    s = setup

    def j_loss(p):
        losses, _, _ = s["j_agent"].rollout(p, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(1),
                                            feedback=FEEDBACK_TEACHER, train=True)
        return losses.ml_loss, losses.ml_loss_per_sample

    (val_j, vec_j), grads_j = jax.value_and_grad(j_loss, has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    losses, result = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], t_common.FEEDBACK_TEACHER,
                                          train=True, generator=torch.Generator().manual_seed(1))
    losses.ml_loss.backward()
    assert losses.ml_loss.item() > 0 and losses.rl_loss.item() == 0.0
    np.testing.assert_allclose(float(losses.ml_loss), float(val_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(losses.ml_loss_per_sample.detach().numpy(), np.asarray(vec_j),
                               rtol=0, atol=ATOL)
    assert int(result.steps.ce_count[0]) == B - 1  # the padding slot is ignored
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)


def test_a2c_loss_and_grads_match_jax(setup, fixed_sampler):
    s = setup

    def j_loss(p):
        losses, _, _ = s["j_agent"].rollout(p, {}, s["j_tables"], s["j_ep"], jax.random.PRNGKey(2),
                                            feedback=FEEDBACK_SAMPLE, train=True, train_ml=False,
                                            train_rl=True)
        return losses.rl_loss, losses

    (val_j, lj), grads_j = jax.value_and_grad(j_loss, has_aux=True)(s["j_params"])
    tp = _t_params(s["j_params"])
    lt, result = s["t_agent"].rollout(tp, s["t_tables"], s["t_ep"], t_common.FEEDBACK_SAMPLE,
                                      train=True, train_ml=False, train_rl=True,
                                      generator=torch.Generator().manual_seed(2))
    lt.rl_loss.backward()
    assert result.steps.moved.any()  # the sampled policy really moves
    for got, want in ((lt.rl_loss, val_j), (lt.rl_loss_per_sample, lj.rl_loss_per_sample),
                      (lt.critic_loss_sum, lj.critic_loss_sum), (lt.entropy_sum, lj.entropy_sum),
                      (lt.total_actions, lj.total_actions)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    _close_trees([p.grad for p in t_tree.tree_leaves(tp)], grads_j)


def test_one_iter_update_matches_jax_train_step(setup, fixed_sampler):
    """IL + A2C, one backward, the clip at 40, RMSprop: the updated
    parameters equal the JAX build_train_step's ("xla" backends)."""
    s = setup
    opt = j_loop.make_optimizer("rms", LR)
    step = j_loop.build_train_step(s["j_agent"], opt, "sample")
    j_params = jax.tree_util.tree_map(jnp.array, s["j_params"])
    new_j, _, _, logs_j = step(s["j_tables"], j_params, opt.init(j_params), {}, s["j_ep"],
                               jax.random.PRNGKey(3))
    tp = _t_params(s["j_params"])
    optimizer = t_loop.make_optimizer("rms", LR, tp)
    logs_t = t_loop.one_iter(s["t_agent"], optimizer, "sample", s["t_tables"], tp, s["t_ep"],
                             torch.Generator().manual_seed(3))
    for k in ("loss", "ml_loss", "rl_loss", "critic_loss", "entropy", "total_actions"):
        np.testing.assert_allclose(float(logs_t[k]), float(logs_j[k]), rtol=0, atol=ATOL, err_msg=k)
    moved = [float((p.detach() - torch.from_numpy(np.array(w))).abs().max())
             for p, w in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(s["j_params"]))]
    assert max(moved) > 10 * ATOL  # the step really moves the parameters
    _close_trees(t_tree.tree_leaves(tp), new_j)


def test_ext_obs_masks_equal_prng_given_its_masks(setup, monkeypatch):
    """OBS_MASKS "ext" through the agent: the IL rollout whose env-dropout
    keep-masks are passed in as tensors has the loss and gradients of the
    prng rollout whose seeds make those masks (ops/philox.py) — exactly,
    since both take the same plain ops on the same masks.  The ext draw
    itself keeps elements at the configured rate."""
    s = setup
    m = _model_cfg()
    m.FEAT_DROP_RATE = 0.4
    agents = {mode: TAgent(m, ENC_LEN, s["t_agent"].vocab_size, FEAT_DIM, EPISODE_LEN,
                           obs_masks=mode) for mode in ("prng", "ext")}
    drawn, replayed = [], []
    prng_drop = agents["prng"]._obs_drop

    def record(B_, rows, D_, train, device, generator):
        spec = prng_drop(B_, rows, D_, train, device, generator)
        assert spec.mode == "prng"
        drawn.append(philox.keep_mask(spec.seeds, (rows, D_), spec.keep))
        return spec

    def replay(shape, keep, generator, device):
        mask = drawn[len(replayed)]
        assert tuple(mask.shape) == tuple(shape) and keep == pytest.approx(0.6)
        replayed.append(mask)
        return mask

    monkeypatch.setattr(agents["prng"], "_obs_drop", record)
    monkeypatch.setattr(t_envdrop, "draw_keep_mask", replay)

    def il(agent):
        tp = _t_params(s["j_params"])
        losses, _ = agent.rollout(tp, s["t_tables"], s["t_ep"], t_common.FEEDBACK_TEACHER,
                                  train=True, generator=torch.Generator().manual_seed(4))
        losses.ml_loss.backward()
        return losses.ml_loss.detach(), [p.grad for p in t_tree.tree_leaves(tp)]

    loss_p, grads_p = il(agents["prng"])
    loss_e, grads_e = il(agents["ext"])
    assert len(drawn) == len(replayed) > 0
    assert torch.equal(loss_e, loss_p)
    for ge, gp in zip(grads_e, grads_p, strict=True):
        assert (ge is None) == (gp is None) and (ge is None or torch.equal(ge, gp))

    gen = torch.Generator().manual_seed(5)
    mask = t_drop.draw_keep_mask((B, 36, FEAT_DIM), 0.6, gen, "cpu")
    n = mask.numel()
    assert abs(float(mask.float().mean()) - 0.6) < 5 * (0.6 * 0.4 / n) ** 0.5  # binomial


@pytest.mark.parametrize("name", ["rms", "adam"])
def test_optimizers_match_optax(name):
    """Three steps on random gradients, tiny ones included: RMSprop's eps
    sits inside the square root as in optax (torch.optim.RMSprop puts it
    outside, which moves a 1e-5 gradient ~100 times further)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (7,)}}
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    opt = j_loop.make_optimizer(name, LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = t_tree.tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(True), params)
    optimizer = t_loop.make_optimizer(name, LR, tp)
    for i in range(3):
        scale = 10.0 ** -rng.integers(0, 6, size=(5, 3))
        grads = {"a": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
                 "b": {"c": rng.standard_normal(shapes["b"]["c"]).astype(np.float32) * 1e-5}}
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.asarray(g).copy())
        optimizer.step()
    _close_trees(t_tree.tree_leaves(tp), jp, atol=1e-6)


def test_clip_submodule_grads_matches_jax():
    """Encoder and decoder clipped to a global norm of 40 (+ 1e-6), the
    critic untouched; a submodule under the norm is left as it is."""
    rng = np.random.default_rng(1)
    grads = {"encoder": {"w": rng.standard_normal((20, 30)).astype(np.float32) * 5},
             "decoder": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                         "v": [rng.standard_normal(3).astype(np.float32)]},
             "critic": {"w": rng.standard_normal((6,)).astype(np.float32) * 100}}
    want = j_loop.clip_submodule_grads(jax.tree_util.tree_map(jnp.asarray, grads),
                                       ("encoder", "decoder"), 40.0)
    params = t_tree.tree_map(lambda a: torch.zeros(a.shape, requires_grad=True), grads)
    for p, g in zip(t_tree.tree_leaves(params), jax.tree_util.tree_leaves(grads)):
        p.grad = torch.from_numpy(np.asarray(g).copy())
    norms = t_loop.clip_submodule_grads(params, ("encoder", "decoder"), 40.0)
    assert float(norms["encoder"]) > 40.0 > float(norms["decoder"])
    # the norm's sum runs in another order: one f32 ulp of the scale
    _close_trees([p.grad for p in t_tree.tree_leaves(params)], want, atol=1e-7, rtol=1e-6)
