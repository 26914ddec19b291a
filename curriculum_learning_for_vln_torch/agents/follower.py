"""Follower agent (Speaker-Follower, Fried et al. 2018).

The port of ``curriculum_learning_for_vln_tpu/agents/follower.py`` (ref:
tasks/R2R-judy/src/agent/follower.py:21-232): the encoder (2-layer BiLSTM
as shipped: K3, or K1 and K2 under autograd), then per step the
observation op (K4, K5 in mask mode none: the Follower has no env
dropout) on the reparameterised visual query, the decoder and
ActionScoring, in teacher, argmax or sample feedback, with the CE-vs-
teacher imitation loss.  Off the fused observation path (the "plain"
backend, TPU.USE_PALLAS False: ``fused_obs.enabled_for``) the step is
``follower_decoder_step`` over the gathered panorama and candidates
(follower.py:109-114), and no observation kernel runs.  ``a_t_prev`` is
the chosen candidate's feature, taken from the carried candidate rows.
At train=True every dropout site draws its mask from the rollout's
generator in the order the step runs them.  With ``glove`` (a pretrained [vocab, WORD_EMB_SIZE] table,
``MODEL.FOLLOWER.GLOVE_PATH``; follower.py:35-51, 78) the encoder's
embedding is that table, frozen (models/encoder.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..env import env as E
from ..env.env import EpisodeBatch
from ..models import decoders as D
from ..models.encoder import encoder_apply, encoder_init
from ..ops import fused_obs
from ..parallel import mesh as M
from ..utils.profiling import span
from ..utils.tokenizer import PAD_IDX
from ..world.compiler import WorldTables
from . import common as C


class FollowerLosses(NamedTuple):
    ml_loss: torch.Tensor             # scalar: the per-step mean-over-alive CE summed over t
    ml_loss_per_sample: torch.Tensor  # [B]: per-sample CE sums (SPCL)


class FollowerAgent:
    name = "FOLLOWER"

    def __init__(self, model_cfg, vocab_size: int, feat_dim: int, episode_len: int,
                 compute_dtype: torch.dtype = torch.float32, glove: Optional[np.ndarray] = None):
        self.cfg = model_cfg
        self.vocab_size = vocab_size
        self.feature_size = feat_dim + 128
        self.action_emb_size = self.feature_size
        self.episode_len = episode_len
        self.compute_dtype = compute_dtype  # must equal the feature table's dtype
        self.glove = glove  # optional frozen pretrained embeddings (ref: units.py:30-37)

    def init(self, generator: torch.Generator, device=None) -> Tuple[dict, dict]:
        """Seeded f32 parameters on ``device``, and the (empty) model state."""
        params = {
            "encoder": encoder_init(
                generator, self.vocab_size, self.cfg.WORD_EMB_SIZE, self.cfg.HIDDEN_SIZE,
                padding_idx=PAD_IDX, bidirectional=self.cfg.ENC_BIDIRECTION,
                num_layers=self.cfg.ENC_LAYERS, device=device, glove=self.glove),
            "decoder": D.follower_decoder_init(generator, self.cfg.HIDDEN_SIZE,
                                               self.action_emb_size, self.feature_size,
                                               device=device),
        }
        return params, {}

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch, feedback: int,
                train: bool = False, episode_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                model_state: Optional[dict] = None, avoid_cyclic: bool = False
                ) -> Tuple[FollowerLosses, C.RolloutResult, dict]:
        """One batched rollout: (losses, result, model_state), the last as
        given (the Follower has none).  ``avoid_cyclic`` masks the
        candidates that lead back to visited viewpoints (follower.py:69)."""
        C.check_dtype(world, self.compute_dtype)
        params = C.cast_compute_params(params, self.compute_dtype)
        dec = params["decoder"]
        drop = self.cfg.DROP_RATE
        ctx_mask = ep.instr_tokens == PAD_IDX
        with span("rollout.encode"):
            ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, train,
                                        drop, generator, use_glove=self.glove is not None)
        B = ep.instr_tokens.shape[0]
        a_prev0 = torch.zeros((B, self.action_emb_size), dtype=self.compute_dtype,
                              device=ctx.device)
        fused = fused_obs.enabled_for(world.features, self.compute_dtype)

        def model_step(mc, meta: E.ObsMeta, state: E.EnvState, t):
            h, c, a_prev, _ = mc
            if not fused:
                pano, cand_feat = E.observe_feats(world, state, meta, self.compute_dtype)
                logits, (h1, c1), _ = D.follower_decoder_step(
                    dec, pano, a_prev, cand_feat, h, c, ctx, ctx_mask, train, drop, generator)
                return logits, (h1, c1, a_prev, cand_feat), h1, None
            tv = D.follower_visual_query(dec, h)
            vis, cand_img = fused_obs.pano_attend_cands(state.node, state.view_idx, meta.cand_view,
                                                        world.features, world.loc_embed, tv)
            cand_feat = E.assemble_cand_feat(cand_img, meta.cand_angle, meta.cand_valid)
            logits, (h1, c1), _ = D.follower_decoder_from_vis(
                dec, vis, a_prev, cand_feat, h, c, ctx, ctx_mask, train, drop, generator)
            return logits, (h1, c1, a_prev, cand_feat), h1, None

        def model_post(mc, meta, action):
            # a_t_prev = the chosen candidate's feature (ref: follower.py:164)
            h, c, _, cand_feat = mc
            return h, c, C.chosen_feature(cand_feat, action).to(self.compute_dtype), cand_feat

        result = C.rollout_scan(world, ep, (h0, c0, a_prev0, None), model_step,
                                episode_len or self.episode_len, feedback,
                                compute_dtype=self.compute_dtype, generator=generator,
                                model_post=model_post, avoid_cyclic=avoid_cyclic)
        with span("rollout.loss"):
            losses = FollowerLosses(ml_loss=C.ml_loss_mean_over_alive(result.steps),
                                    ml_loss_per_sample=C.ml_loss_per_sample(result.steps))
        return losses, result, model_state if model_state is not None else {}

    def loss_fn(self, losses: FollowerLosses, weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The objective; with SPCL weights w the weighted per-sample loss
        normalised by sum(w) (ref: curriculum.py:297-301), over every rank's
        rows in a data-parallel step."""
        if weights is None:
            return losses.ml_loss
        return torch.dot(weights, losses.ml_loss_per_sample) / M.global_sum(weights.sum())
