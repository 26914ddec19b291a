"""The speaker's optimizer and shared noise mask in the port.

* ``engine.loop.ClippedAdam`` against ``optax.chain(optax.clip_by_global_norm(
  40), optax.adam(lr))`` (the JAX speaker's, speaker.py:122-125) over 3
  steps, once with the gradients' global norm above 40 and once below it,
  a leaf without a gradient counting as optax's zero gradient: the
  parameters within 1e-6; and ``clip_by_global_norm_`` alone against
  optax's clip (relative 1e-6): no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``;
* ``models.core.dropout_mask``: f32 values 0 and 1 / keep only, kept at
  the keep probability (the JAX draw's distribution; the two packages'
  generators differ, so only it is held).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.models import core as t_core
from curriculum_learning_for_vln_tpu.models import core as j_core

torch.set_num_threads(2)

SHAPES = {"a": (5, 7), "b": (3,), "c": (4, 2)}  # "c" gets no gradient
LR = 1e-3


def _grads(scale, step):
    rng = np.random.default_rng(step)
    g = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    g["c"] = np.zeros(SHAPES["c"], np.float32)
    return g


@pytest.mark.parametrize("scale", [1.0, 30.0])  # global norms ~5 (below 40) and ~150 (above)
def test_clipped_adam_matches_optax(scale):
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    opt = optax.chain(optax.clip_by_global_norm(40.0), optax.adam(LR))
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)
    pt = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p0.items()}
    adam = t_loop.ClippedAdam([pt[k] for k in sorted(pt)], LR, 40.0)
    norms = []
    for step in range(3):
        g = _grads(scale, step)
        norms.append(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))))
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = None if k == "c" else torch.from_numpy(g[k])
        adam.step()
    assert all(n > 40 for n in norms) if scale > 1 else all(n < 40 for n in norms)
    for k in SHAPES:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=0, atol=1e-6)
    assert not torch.equal(pt["a"].detach(), torch.from_numpy(p0["a"]))


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_global_clip_is_optax_clip(scale):
    g = _grads(scale, 7)
    want, _ = optax.clip_by_global_norm(40.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                     optax.EmptyState())
    got = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    norm = t_loop.clip_by_global_norm_([got[k] for k in sorted(got)], 40.0)
    assert float(norm) == pytest.approx(float(optax.global_norm(g)), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_mask_distribution(rate):
    keep = 1.0 - rate
    mask = t_core.dropout_mask((200_000,), rate, torch.Generator().manual_seed(0))
    ref = np.asarray(j_core.dropout_mask(jax.random.PRNGKey(0), (8,), rate))
    assert mask.dtype == torch.float32 and ref.dtype == np.float32
    values = {0.0, float(np.float32(1.0) / np.float32(keep))}
    assert set(np.unique(ref).tolist()) <= values
    assert set(np.unique(mask.numpy()).tolist()) == values
    assert float((mask > 0).float().mean()) == pytest.approx(keep, abs=5e-3)
