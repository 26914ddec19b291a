"""Back-translation self-training (speaker-augmented EnvDrop).

The port of ``curriculum_learning_for_vln_tpu/engine/self_train.py``.  The
reference carries the plumbing of EnvDrop's back-translation stage
(tasks/R2R-judy/src/agent/envdrop.py:105-121, src/agent/speaker.py:75-88)
but no driver; the JAX package's driver, here on one device:

1. ``pretrain_speaker``: the speaker's teacher-forcing updates on
   shortest-path features;
2. ``self_train``: EnvDrop iterations alternating between real
   instructions (even iterations: ``engine.loop.one_iter`` in sample
   feedback, IL + A2C) and speaker-generated ones (odd iterations:
   ``backtranslation_step``, IL + A2C over the batch the speaker
   rewrote, the shared noise mask on the features of both).

The JAX package's mesh set-up (self_train.py:84-92) is not carried over:
the port trains on one GPU.  Each back-translated iteration runs the
speaker's encoder through K3 (four launches) and EnvDrop's encoder through
K1 and K2 (four each); its decode is the unfused one, so K4-K7 do not
launch in it.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..agents.common import FEEDBACK_SAMPLE, FEEDBACK_TEACHER
from ..env.env import EpisodeBatch
from ..utils.tree import tree_map
from ..world.compiler import WorldTables
from .loop import _update, make_optimizer, one_iter

logger = logging.getLogger("main.self_train")


def pretrain_speaker(cfg, speaker, tables: WorldTables, train_env, iters: int,
                     init_generator: torch.Generator, generator: Optional[torch.Generator]):
    """A speaker initialised from ``init_generator`` (on the CPU, so a seed
    gives the same weights on any device), trained for ``iters`` teacher-
    forcing steps on ``train_env`` with ``generator`` drawing its dropout
    (self_train.py:30-36).  Returns (params, optimizer, losses)."""
    params, optimizer = speaker.init(init_generator, device=tables.features.device)
    params, optimizer, losses = speaker.train_steps(params, optimizer, tables, train_env,
                                                    generator, iters)
    if losses:
        logger.info("speaker pretrain: %d iters, loss %.4f -> %.4f", iters, losses[0],
                    losses[-1])
    return params, optimizer, losses


def backtranslation_loss(agent, tables: WorldTables, params: dict, ep: EpisodeBatch,
                         feat_mask: torch.Tensor, generator: Optional[torch.Generator]):
    """The objective of one back-translated iteration (self_train.py:46-58):
    the teacher-forced IL rollout and the sampled A2C rollout of ``ep`` at
    the full horizon, both with the shared noise ``feat_mask``; their
    ml_loss + rl_loss.  Returns (total, logs)."""
    il, _ = agent.rollout(params, tables, ep, FEEDBACK_TEACHER, train=True, train_ml=True,
                          train_rl=False, generator=generator, feat_mask=feat_mask)
    rl, _ = agent.rollout(params, tables, ep, FEEDBACK_SAMPLE, train=True, train_ml=False,
                          train_rl=True, generator=generator, feat_mask=feat_mask)
    total = il.ml_loss + rl.rl_loss
    return total, {"loss": total, "ml_loss": il.ml_loss, "rl_loss": rl.rl_loss}


def backtranslation_step(agent, optimizer: torch.optim.Optimizer, tables: WorldTables,
                         params: dict, ep: EpisodeBatch, feat_mask: torch.Tensor,
                         generator: Optional[torch.Generator]) -> dict:
    """One back-translated update (self_train.py:39-67): ``backtranslation_loss``,
    the clip at 40 of the encoder's and the decoder's gradients, one step
    of the shared optimizer.  Returns the detached logs."""
    total, logs = backtranslation_loss(agent, tables, params, ep, feat_mask, generator)
    return _update(optimizer, params, total, logs)


def self_train(cfg, agent, speaker, train_env, aug_env, tables: WorldTables, seed: int = 2020,
               speaker_iters: int = 200, epochs: int = 1, iters_per_epoch: Optional[int] = None):
    """Speaker pretraining, then ``epochs`` x ``iters_per_epoch`` (default
    TRAIN.ITER_PER_EPOCH) EnvDrop iterations, real on even iterations and
    back-translated on odd ones, over ``aug_env``'s episodes (self_train.py:
    70-120).  One optimizer (TRAIN.OPTIM) serves both kinds.  The speaker
    and EnvDrop are initialised from CPU generators seeded ``seed`` and
    ``seed + 1``; one generator on the tables' device, seeded ``seed + 2``,
    draws every dropout mask, sampled action and noise mask.  Returns
    (params, model state {}, (speaker params, speaker optimizer), losses
    {"real": [...], "bt": [...]})."""
    device = tables.features.device
    generator = torch.Generator(device=device).manual_seed(seed + 2)
    spk_params, spk_opt, _ = pretrain_speaker(cfg, speaker, tables, train_env, speaker_iters,
                                              torch.Generator().manual_seed(seed), generator)
    params = tree_map(lambda t: t.to(device).requires_grad_(True),
                      agent.init(torch.Generator().manual_seed(seed + 1)))
    optimizer = make_optimizer(cfg.TRAIN.OPTIM, cfg.TRAIN.LR, params)

    iters = iters_per_epoch or cfg.TRAIN.ITER_PER_EPOCH
    losses = {"real": [], "bt": []}
    for ep_i in range(epochs):
        for it in range(iters):
            if it % 2 == 0:  # real instructions
                logs = one_iter(agent, optimizer, "sample", tables, params,
                                train_env.next_batch(), generator)
                losses["real"].append(float(logs["loss"]))
            else:  # back-translated
                batch = aug_env.next_batch()
                new_ep, noise = speaker.back_translate(
                    spk_params, tables, aug_env, batch, enc_len=int(batch.instr_tokens.shape[1]),
                    generator=generator, feat_dim=agent.img_feat_size)
                logs = backtranslation_step(agent, optimizer, tables, params, new_ep, noise,
                                            generator)
                losses["bt"].append(float(logs["loss"]))
        logger.info("self-train epoch %d: real %.4f bt %.4f", ep_i,
                    np.mean(losses["real"][-iters // 2:]), np.mean(losses["bt"][-iters // 2:]))
    return params, {}, (spk_params, spk_opt), losses
