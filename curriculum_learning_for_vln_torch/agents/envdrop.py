"""EnvDrop agent (Tan et al. 2019), serving rollout.

The port of ``curriculum_learning_for_vln_tpu/agents/envdrop.py`` for
``train=False``: ``init`` and the argmax/teacher ``rollout`` through the
fused decode (envdrop.py:89-110) — encoder BiLSTM (K3), then per step the
observation kernel (K4), the decoder, and the candidate scorer (K6).  The
A2C tail, ``rollout_packed`` and the BPTT path come with the training
slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..env.env import EpisodeBatch
from ..models import decoders as D
from ..models.encoder import encoder_apply, encoder_init
from ..ops import fused_obs
from ..utils.angles import make_angle_feat
from ..utils.tokenizer import PAD_IDX
from ..world.compiler import WorldTables
from . import common as C


class EnvDropAgent:
    name = "ENVDROP"

    def __init__(self, model_cfg, max_enc_len: int, vocab_size: int, feat_dim: int,
                 episode_len: int, compute_dtype: torch.dtype = torch.float32):
        self.cfg = model_cfg
        self.max_enc_len = max_enc_len
        self.vocab_size = vocab_size
        self.img_feat_size = feat_dim
        self.angle_feat_size = 128
        self.feature_size = feat_dim + 128
        self.episode_len = episode_len
        # dtype of the compute weights; must equal the feature table's dtype
        self.compute_dtype = compute_dtype

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Seeded f32 parameters on ``device`` (EnvDrop has no model state)."""
        params = {
            "encoder": encoder_init(
                generator, self.vocab_size, self.cfg.WORD_EMB_SIZE, self.cfg.HIDDEN_SIZE,
                padding_idx=PAD_IDX, bidirectional=self.cfg.ENC_BIDIRECTION,
                num_layers=self.cfg.ENC_LAYERS, device=device),
            "decoder": D.envdrop_decoder_init(
                generator, self.cfg.HIDDEN_SIZE, self.cfg.ACT_EMB_SIZE,
                self.angle_feat_size, self.feature_size, device=device),
            "critic": D.critic_init(generator, self.cfg.HIDDEN_SIZE, device=device),
        }
        return params

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch, feedback: int,
                train: bool = False, episode_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> C.RolloutResult:
        """One batched episode rollout (no dropout: ``train`` must be False);
        ``generator`` draws the actions of sample feedback."""
        if train:
            raise NotImplementedError("the training rollout (dropout masks, A2C) is not ported yet")
        if world.features.dtype != self.compute_dtype:
            # the JAX package silently drops its fused path on this mismatch
            raise ValueError(f"feature table dtype {world.features.dtype} differs from the "
                             f"compute dtype {self.compute_dtype}")
        params = C.cast_compute_params(params, self.compute_dtype)
        dec = params["decoder"]
        ctx_mask = ep.instr_tokens == PAD_IDX
        ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, False)

        def model_step(mc, meta, state, t):
            _h, c, h_tilde = mc
            a_t_angle = make_angle_feat(state.heading, state.elevation)
            tv = D.envdrop_visual_query(dec, h_tilde)
            vis, cand_img = fused_obs.pano_attend_cands(
                state.node, state.view_idx, meta.cand_view, world.features, world.loc_embed, tv)

            def scorer(q):
                return fused_obs.cand_attend_logits(cand_img, meta.cand_angle, meta.cand_valid, q)

            logits, (h1, c1), h_tilde_new = D.envdrop_decoder_from_vis(
                dec, a_t_angle, vis, h_tilde, c, ctx, ctx_mask, scorer)
            return logits, (h1, c1, h_tilde_new), h1

        # h_tilde starts as the encoder's h (ref: envdrop.py:150)
        return C.rollout_scan(world, ep, (h0, c0, h0), model_step,
                              episode_len or self.episode_len, feedback,
                              compute_dtype=self.compute_dtype, generator=generator)
