"""The port's inverted dropout on the card: the same bits as on the CPU,
and no host sync.

* At rates 0.1, 0.3 and 0.5, in bf16 and f32, ``dropout`` and
  ``apply_keep_mask`` on the card give, bit for bit, what they give on
  the CPU for the inputs of ``test_torch_keep_mask.py``, which holds the
  CPU's result bit for bit against the JAX package.  A divisor that is a
  CPU scalar fails here: the card applies one as a multiply by its f32
  reciprocal.
* ``dropout`` and one step of ``VLNBertPretrainer`` at a tiny config
  (after one warm-up step) run under
  ``torch.cuda.set_sync_debug_mode("error")``, which raises at any call
  that makes the host wait for the card.

This file does not import JAX, so that it runs where the card is:

    python3 -m pytest -q --noconftest tests/test_torch_keep_mask_card.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up.)  Without a card
every test skips.
"""
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.engine import pretrain as tp
from curriculum_learning_for_vln_torch.models import core as t_core
from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextmanager
def no_sync():
    """Raise at any call inside that waits for the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_on_card_equals_cpu_bit_for_bit(card, rate, prec, monkeypatch):
    rng = np.random.default_rng(int(rate * 10))
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)).to(DTYPES[prec])
    keep = torch.from_numpy(rng.random(x.shape) < 1.0 - rate)
    want = t_core.apply_keep_mask(x, keep, rate)
    got = t_core.apply_keep_mask(x.to(card), keep.to(card), rate)
    assert got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)
    # uniforms below the keep probability exactly where the mask keeps
    u = torch.where(keep, 0.0, 0.999999).to(card)
    monkeypatch.setattr(t_core.torch, "rand", lambda *a, **k: u)
    assert torch.equal(t_core.dropout(x.to(card), rate, True).cpu(), want)


@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_dropout_makes_no_sync(card, prec):
    x = torch.randn((64, 256), device=card).to(DTYPES[prec])
    gen = torch.Generator(card).manual_seed(0)
    with no_sync():
        y = t_core.dropout(x, 0.1, True, gen)
    assert y.dtype == x.dtype


def test_pretrainer_step_makes_no_sync(card):
    cfg = VilBertConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, max_position_embeddings=16, v_feature_size=24, v_target_size=10,
        v_hidden_size=40, v_num_hidden_layers=2, v_num_attention_heads=2, v_intermediate_size=40,
        bi_hidden_size=24, bi_num_attention_heads=3, v_biattention_id=(0, 1),
        t_biattention_id=(0, 1))
    B, LT, R = 6, 12, 5
    g = torch.Generator().manual_seed(0)
    lengths = torch.randint(3, LT + 1, (B,), generator=g)
    tokens = torch.where(torch.arange(LT)[None] < lengths[:, None],
                         torch.randint(4, 40, (B, LT), generator=g), 0)
    region_mask = (torch.arange(R)[None] < torch.randint(2, R + 1, (B,), generator=g)[:, None])
    region_mask = region_mask.float()
    locs = torch.randn((B, R, 12), generator=g)
    locs[..., 11] = torch.arange(R).float()
    batch = {"tokens": tokens, "feats": torch.rand((B, R, 24), generator=g) * region_mask[..., None],
             "locs": locs * region_mask[..., None], "region_mask": region_mask,
             "region_targets": torch.softmax(torch.randn((B, R, 10), generator=g), -1),
             "align_labels": torch.randint(0, 2, (B,), generator=g)}
    batch = {k: v.to(card) for k, v in batch.items()}
    trainer = tp.VLNBertPretrainer(cfg, mask_idx=3)
    params, optimizer = trainer.init(torch.Generator().manual_seed(1), card)
    gen = torch.Generator(card).manual_seed(2)
    trainer.step(params, optimizer, batch, gen)  # Adam's state and the card's handles
    with no_sync():
        logs = trainer.step(params, optimizer, batch, gen)
    assert torch.isfinite(logs["loss"]).item() and trainer.counters.steps == 2
