"""EnvDrop's back-translation rollout in the port against the JAX package:
``rollout(feat_mask=...)``, the shared noise on the image dims and the
unfused decode (JAX envdrop.py:78-120, 198-230), from the same parameters
(``params_from_jax``) on B = 10 episodes (one a padding slot) of a small
synthetic world, both dropout rates at 0, the mask drawn by JAX
(``dropout_mask`` at 0.3).

* one unfused ``envdrop_decoder_step`` (decoders.py:255-288) over a masked
  panorama and candidates, and at train=False without a mask, in f32:
  within 1e-5;
* the IL loss and the A2C loss (both samplers patched, pytest's
  ``monkeypatch``, to argmax(logits + one fixed noise), as
  ``tests/test_torch_train.py`` does) of a masked rollout, and their
  gradients, every leaf: in f32 within 1e-4; with bf16 features and
  compute weights within 3e-2 x max(1, max |JAX|) (the port's bf16
  tolerance: bf16 products rounded at other places, a bf16 ulp 2^-8).  In
  bf16 the masked panorama and candidates reach the decoder in f32 (jnp
  promotes the bf16 features times the f32 mask), which a spy on the
  decoder step holds, and no observation kernel's plain twin runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import curriculum_learning_for_vln_torch.agents.common as t_common
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TAgent
from curriculum_learning_for_vln_torch.convert import params_from_jax
from curriculum_learning_for_vln_torch.models import decoders as t_dec
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.utils import tree as t_tree
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import FEEDBACK_SAMPLE, FEEDBACK_TEACHER
from curriculum_learning_for_vln_tpu.agents.envdrop import EnvDropAgent as JAgent
from curriculum_learning_for_vln_tpu.models import core as j_core
from curriculum_learning_for_vln_tpu.models import decoders as j_dec
from test_torch_follower import episode_batches
from test_torch_train import _model_cfg

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B = 64, 12, 8, 10
PREC = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def setup(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    tok = type(tokenizer)(tokenizer.vocab, encoding_length=ENC_LEN)
    j_agent = JAgent(_model_cfg(), ENC_LEN, tok.vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_params, _ = j_agent.init(jax.random.PRNGKey(0))
    j_ep, t_ep = episode_batches(synth_world, synth_dataset, tok, B)
    mask = j_core.dropout_mask(jax.random.PRNGKey(3), (FEAT_DIM,), 0.3)
    return {"j_world": synth_world, "t_world": t_world, "tok": tok, "j_params": j_params,
            "j_ep": j_ep, "t_ep": t_ep, "mask": mask}


@pytest.fixture()
def fixed_sampler(monkeypatch):
    noise = np.random.default_rng(5).gumbel(size=(B, 17)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits + noise, axis=axis))
    monkeypatch.setattr(t_common, "gumbel_noise",
                        lambda shape, generator, device: torch.from_numpy(noise))


def _t_params(j_params, grad=True):
    p = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    return t_tree.tree_map(lambda t: t.requires_grad_(grad), p)


def _close(got, want, atol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want, jnp.float32)), rtol=0, atol=atol)


@pytest.mark.parametrize("masked", [True, False])
def test_unfused_decoder_step_matches_jax(setup, masked):
    rng = np.random.default_rng(4)
    K, F, H = 17, FEAT_DIM + 128, 64
    pano = rng.standard_normal((B, 36, F)).astype(np.float32)
    cand = rng.standard_normal((B, K, F)).astype(np.float32)
    if masked:
        m = np.asarray(setup["mask"])
        pano[..., :FEAT_DIM] *= m
        cand[..., :FEAT_DIM] *= m
    a_angle = rng.standard_normal((B, 128)).astype(np.float32)
    h_tilde, c = ((rng.standard_normal((B, H)) * 0.5).astype(np.float32) for _ in range(2))
    ctx = (rng.standard_normal((B, ENC_LEN, H)) * 0.5).astype(np.float32)
    ctx_mask = np.arange(ENC_LEN)[None, :] >= rng.integers(1, ENC_LEN + 1, B)[:, None]
    pj = setup["j_params"]["decoder"]
    pt = _t_params(setup["j_params"], grad=False)["decoder"]
    J, T = jnp.asarray, torch.from_numpy
    lj, (h1j, c1j), htj = j_dec.envdrop_decoder_step(
        pj, J(a_angle), J(pano), J(cand), J(h_tilde), J(h_tilde), J(c), J(ctx), J(ctx_mask),
        jax.random.PRNGKey(0), False, already_dropfeat=masked)
    lt, (h1t, c1t), htt = t_dec.envdrop_decoder_step(
        pt, T(a_angle), T(pano), T(cand), T(h_tilde), T(c), T(ctx), T(ctx_mask), False,
        already_dropfeat=masked)
    assert tuple(lt.shape) == (B, K)
    for got, want in ((lt, lj), (h1t, h1j), (c1t, c1j), (htt, htj)):
        _close(got, want, 1e-5)


def _rollout_case(setup, prec, feedback, monkeypatch):
    dt, jdt = PREC[prec]
    s = setup
    j_agent = JAgent(_model_cfg(), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN)
    j_agent.compute_dtype = jdt
    t_agent = TAgent(_model_cfg(), ENC_LEN, s["tok"].vocab_size(), FEAT_DIM, EPISODE_LEN,
                     compute_dtype=dt)
    sample = feedback == FEEDBACK_SAMPLE
    kw = dict(train=True, train_ml=not sample, train_rl=sample)

    def j_loss(p):
        losses, _, _ = j_agent.rollout(p, {}, s["j_world"].device_tables(prec), s["j_ep"],
                                       jax.random.PRNGKey(1), feedback=feedback,
                                       feat_mask=s["mask"], **kw)
        return (losses.rl_loss if sample else losses.ml_loss), losses

    (val_j, lj), grads_j = jax.value_and_grad(j_loss, has_aux=True)(s["j_params"])
    seen = []
    step = t_dec.envdrop_decoder_step

    def spy(p, a_t_angle, pano, cand, *args, **kwargs):
        seen.append((pano.dtype, cand.dtype))
        return step(p, a_t_angle, pano, cand, *args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("an observation op ran on the masked path")

    monkeypatch.setattr(t_dec, "envdrop_decoder_step", spy)
    for name in ("pano_attend_cands", "cand_attend_logits"):
        monkeypatch.setattr(t_fused, name, refuse)
    tp = _t_params(s["j_params"])
    lt, result = t_agent.rollout(tp, s["t_world"].device_tables(prec, device="cpu"), s["t_ep"],
                                 feedback, generator=torch.Generator().manual_seed(1),
                                 feat_mask=torch.from_numpy(np.array(s["mask"])), **kw)
    (lt.rl_loss if sample else lt.ml_loss).backward()
    # the masked features promote to f32 whatever the compute dtype (envdrop.py:85-87)
    assert seen and set(seen) == {(torch.float32, torch.float32)}
    assert len(seen) == EPISODE_LEN + sample  # the A2C tail's bootstrap step
    return val_j, lj, grads_j, lt, result, tp


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_masked_il_loss_and_grads_match_jax(setup, prec, monkeypatch):
    val_j, lj, grads_j, lt, result, tp = _rollout_case(setup, prec, FEEDBACK_TEACHER, monkeypatch)
    assert lt.ml_loss.item() > 0 and lt.rl_loss.item() == 0.0
    scale = lambda x: 1e-4 if prec == "f32" else 3e-2 * max(1.0, float(jnp.abs(x).max()))
    _close(lt.ml_loss, val_j, scale(val_j))
    _close(lt.ml_loss_per_sample, lj.ml_loss_per_sample, scale(lj.ml_loss_per_sample))
    for p, g in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(grads_j), strict=True):
        _close(torch.zeros_like(p) if p.grad is None else p.grad, g, scale(g))


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_masked_a2c_loss_and_grads_match_jax(setup, prec, fixed_sampler, monkeypatch):
    val_j, lj, grads_j, lt, result, tp = _rollout_case(setup, prec, FEEDBACK_SAMPLE, monkeypatch)
    assert result.steps.moved.any()  # the sampled policy really moves
    scale = lambda x: 1e-4 if prec == "f32" else 3e-2 * max(1.0, float(jnp.abs(x).max()))
    for got, want in ((lt.rl_loss, val_j), (lt.rl_loss_per_sample, lj.rl_loss_per_sample),
                      (lt.critic_loss_sum, lj.critic_loss_sum), (lt.entropy_sum, lj.entropy_sum),
                      (lt.total_actions, lj.total_actions)):
        _close(got, want, scale(want))
    for p, g in zip(t_tree.tree_leaves(tp), jax.tree_util.tree_leaves(grads_j), strict=True):
        _close(torch.zeros_like(p) if p.grad is None else p.grad, g, scale(g))
