"""The ViLBERT scorer on the card at ``VilBertConfig``'s default widths
(hidden 768, 12 text and 3 vision layers, bi 1024 x 16 heads) with the
shipped vocabulary and 2048-d features, about 1.4e8 parameters with Adam
in f32, seeded random weights.

* ``score_paths`` on the card against the same parameters on the CPU.
* Pretraining steps (B = 32): finite losses that fall over 20 steps; the
  scoring of 1,000 items, finite; no kernel of the port launches.
* ``build_clr2r`` writes five rounds.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_card_world import (FEAT_DIM, REPO, SEED, card, launch_counts,  # noqa: F401
                              launches_of, reset_launch_counts, serving)

VIL_BATCH = 32  # pretraining batch
VIL_STEPS = 20  # pretraining steps after one warm-up
VIL_ITEMS = 1000  # items scored by score_difficulty
VIL_PATH = 8  # max_path_len of the scorer's inputs (R2R paths have at most 7 nodes)


@pytest.fixture(scope="module")
def setup(serving, card):
    from curriculum_learning_for_vln_torch.agents.vln_bert import VLNBertScorer
    from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
    from curriculum_learning_for_vln_torch.engine.pretrain import VLNBertPretrainer
    from curriculum_learning_for_vln_torch.models.vilbert import VilBertConfig

    world, data, _, tok, *_ = serving
    cfg = VilBertConfig(vocab_size=tok.vocab_size(), v_feature_size=FEAT_DIM)
    trainer = VLNBertPretrainer(cfg, mask_idx=1)
    reset_launch_counts()
    params, opt = trainer.init(torch.Generator().manual_seed(SEED), card)
    return cfg, trainer, params, opt, VLNBertScorer(cfg), expand_r2r_items(data, tok)


def test_score_paths_on_the_card_agrees_with_the_cpu(setup, serving, card):
    """f32 products summed in another order over 15 layers, TF32 off:
    within 1e-3 of the scores' scale."""
    from curriculum_learning_for_vln_torch.engine.pretrain import pretrain_arrays
    from curriculum_learning_for_vln_torch.utils import tree

    _, _, params, _, scorer, items = setup
    world, _, _, tok, *_ = serving
    toks, feats, locs, rmask, _ = pretrain_arrays(world, items[:8], tok, VIL_PATH, FEAT_DIM)
    am = (toks != 0).astype(np.float32)
    host = [torch.from_numpy(a) for a in (toks, feats, locs, am, rmask)]
    s_gpu = scorer.score_paths(params, *(t.to(card) for t in host)).float().cpu()
    s_cpu = scorer.score_paths(tree.tree_map(lambda t: t.detach().cpu(), params), *host)
    scale = float(s_cpu.abs().max())
    err = float((s_gpu - s_cpu).abs().max())
    assert err <= 1e-3 * scale, f"score_paths card vs CPU |diff| {err:.3g} of scale {scale:.3g}"


def test_pretraining_loss_falls_and_scores_are_finite(setup, serving, card):
    from curriculum_learning_for_vln_torch.engine.pretrain import (pretrain_batches,
                                                                   score_difficulty)

    cfg, trainer, params, opt, scorer, items = setup
    world, _, _, tok, *_ = serving
    gen = torch.Generator(device=card).manual_seed(SEED + 2)
    uniform = torch.full((world.features.shape[0], cfg.v_target_size), 1.0 / cfg.v_target_size,
                         device=card)  # no region labels: the region loss is inert
    batches = pretrain_batches(world, items, tok, VIL_BATCH, VIL_PATH, FEAT_DIM,
                               node_targets=uniform, epochs=2, seed=SEED, device=card)
    trainer.step(params, opt, next(batches), gen)  # warm-up
    losses = [float(trainer.step(params, opt, next(batches), gen)["loss"])
              for _ in range(VIL_STEPS)]
    assert all(np.isfinite(losses)), f"finite losses {losses}"
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert tail < head, f"the pretraining loss falls: first five {head:.4f}, last five {tail:.4f}"
    many = (items * (VIL_ITEMS // len(items) + 1))[:VIL_ITEMS]
    scores = score_difficulty(scorer, params, world, many, tok, VIL_PATH, FEAT_DIM)
    assert scores.shape == (VIL_ITEMS,) and bool(np.isfinite(scores).all()), "finite scores"
    counts = launch_counts()
    assert counts == launches_of(), f"no kernel of the port on the ViLBERT path: {counts}"


def test_build_clr2r_writes_five_rounds(card, tmp_path):
    run = subprocess.run([sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r",
                          "--out", str(tmp_path)], capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    rounds = sorted(f for f in os.listdir(tmp_path) if f.endswith("_v3.json"))
    assert run.returncode == 0 and len(rounds) == 5, \
        f"build_clr2r: rc {run.returncode}, {rounds}\n{run.stderr[-4000:]}"
