"""The port's inverted dropout against the JAX package's, bit for bit.

``models.core.dropout`` keeps an element as x divided by the keep
probability rounded to x's dtype, as ``apply_keep_mask`` in the JAX
package does (core.py:91-94): a bf16 x is divided by bf16(1 - rate).
Dividing by the Python float 1 - rate, which torch applies in f32, puts a
third of the elements one bf16 ulp off at rate 0.1 (the Self-Monitor's
positional-encoding dropout); EnvDrop's 0.5 is exact either way.  Given
one keep-mask drawn with numpy (the port's draw replaced, with pytest's
``monkeypatch``, by uniforms that give that mask), 100,000 bf16 normals
come out equal bit for bit at rates 0.1, 0.3 and 0.5, and f32 ones too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.models import core as t_core
from curriculum_learning_for_vln_tpu.models import core as j_core


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_equals_jax_bit_for_bit(rate, prec, monkeypatch):
    rng = np.random.default_rng(int(rate * 10))
    x = rng.standard_normal(100_000).astype(np.float32)
    keep = rng.random(x.shape) < 1.0 - rate
    dt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}[prec]
    want = np.asarray(j_core.apply_keep_mask(jnp.asarray(x).astype(jdt), jnp.asarray(keep), rate)
                      .astype(jnp.float32))
    # uniforms below the keep probability exactly where the numpy mask keeps
    u = torch.from_numpy(np.where(keep, 0.0, 0.999999).astype(np.float32))
    monkeypatch.setattr(t_core.torch, "rand", lambda *a, **k: u)
    got = t_core.dropout(torch.from_numpy(x).to(dt), rate, True)
    assert got.dtype == dt
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        t_core.apply_keep_mask(torch.from_numpy(x).to(dt), torch.from_numpy(keep), rate)
        .float().numpy(), want)
