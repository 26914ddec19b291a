"""EnvDrop agent (Tan et al. 2019): IL + A2C with environmental dropout.

The port of ``curriculum_learning_for_vln_tpu/agents/envdrop.py``:
``init``, and ``rollout`` in every feedback mode, at ``train=False``
(serving, evaluation) and ``train=True`` (the teacher-forced IL rollout
and the sampled A2C rollout of one training iteration, envdrop.py:
186-334), through the fused decode — encoder BiLSTM (K3, or K1/K2 under
autograd), then per step the observation op (K4/K5), the decoder and the
candidate scorer (K6/K7).  At ``train=True`` every dropout site draws its
mask from the rollout's generator, in the order the step runs them; the
observation ops' env-dropout masks follow ``obs_masks`` (TPU.OBS_MASKS,
loop.py:68-71): "prng" (per-sample seeds drawn per step and per site,
masks made in the kernels) or "ext" (keep-masks drawn here).

``rollout_packed`` and the hand-written BPTT path (``FUSED_BPTT``) are
not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..env import env as E
from ..env.env import EpisodeBatch
from ..models import decoders as D
from ..models.encoder import encoder_apply, encoder_init
from ..ops import fused_obs, philox
from ..ops.cuda.drop import NO_DROP, DropSpec, draw_keep_mask
from ..utils.angles import make_angle_feat
from ..utils.tokenizer import PAD_IDX
from ..world.compiler import WorldTables
from . import common as C

OBS_MASK_MODES = ("prng", "ext")


class EnvDropLosses(NamedTuple):
    ml_loss: torch.Tensor              # scalar: summed CE * ML_WEIGHT / B (ref: envdrop.py:268)
    ml_loss_per_sample: torch.Tensor   # [B]: per-sample CE sums (SPCL)
    rl_loss: torch.Tensor              # scalar A2C loss (normalized per RL_NORMALIZE)
    rl_loss_per_sample: torch.Tensor   # [B]
    entropy_sum: torch.Tensor          # scalar log
    critic_loss_sum: torch.Tensor      # scalar log
    total_actions: torch.Tensor        # scalar log (sum of alive masks)


class EnvDropAgent:
    name = "ENVDROP"

    def __init__(self, model_cfg, max_enc_len: int, vocab_size: int, feat_dim: int,
                 episode_len: int, compute_dtype: torch.dtype = torch.float32,
                 obs_masks: str = "prng"):
        if obs_masks not in OBS_MASK_MODES:
            raise NotImplementedError(f"OBS_MASKS {obs_masks!r} is not ported; "
                                      f"use one of {OBS_MASK_MODES}")
        self.cfg = model_cfg
        self.max_enc_len = max_enc_len
        self.vocab_size = vocab_size
        self.img_feat_size = feat_dim
        self.angle_feat_size = 128
        self.feature_size = feat_dim + 128
        self.episode_len = episode_len
        # dtype of the compute weights; must equal the feature table's dtype
        self.compute_dtype = compute_dtype
        self.obs_masks = obs_masks

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

    # ------------------------------------------------------------------
    def _obs_drop(self, B: int, rows: int, D_: int, train: bool, device,
                  generator: Optional[torch.Generator]) -> DropSpec:
        """The env-dropout of one observation site for one step."""
        rate = self.cfg.FEAT_DROP_RATE
        if not train or rate == 0.0:
            return NO_DROP
        keep = 1.0 - rate
        if self.obs_masks == "prng":
            return DropSpec("prng", seeds=philox.draw_seeds(B, generator, device), keep=keep)
        return DropSpec("ext", mask=draw_keep_mask((B, rows, D_), keep, generator, device),
                        keep=keep)

    def _decode(self, dec: dict, world: WorldTables, ctx, ctx_mask, train: bool,
                generator: Optional[torch.Generator]):
        """One decoder step: visual query, observation op (K4), decoder,
        candidate scorer (K6)."""
        drop = self.cfg.DROP_RATE
        B = ctx.shape[0]
        _, V, Dim = world.features.shape

        def decode(mc, meta: E.ObsMeta, state: E.EnvState):
            _h, c, h_tilde = mc
            a_t_angle = make_angle_feat(state.heading, state.elevation)
            tv = D.envdrop_visual_query(dec, h_tilde, train, drop, generator)
            pano_drop = self._obs_drop(B, V, Dim, train, ctx.device, generator)
            vis, cand_img = fused_obs.pano_attend_cands(
                state.node, state.view_idx, meta.cand_view, world.features, world.loc_embed, tv,
                pano_drop)
            cand_drop = self._obs_drop(B, meta.cand_view.shape[1], Dim, train, ctx.device,
                                       generator)

            def scorer(q):
                return fused_obs.cand_attend_logits(cand_img, meta.cand_angle, meta.cand_valid,
                                                    q, cand_drop)

            logits, (h1, c1), h_tilde_new = D.envdrop_decoder_from_vis(
                dec, a_t_angle, vis, h_tilde, c, ctx, ctx_mask, scorer, train, drop, generator)
            return logits, (h1, c1, h_tilde_new), h1

        return decode

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch, feedback: int,
                train: bool = False, train_ml: bool = True, train_rl: bool = False,
                episode_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[EnvDropLosses, C.RolloutResult]:
        """One batched episode rollout.  Returns (losses, result); the A2C
        terms are computed with sample feedback and ``train_rl``.
        ``generator`` (on the device of the tables) draws the dropout masks
        and the sampled actions."""
        if feedback != C.FEEDBACK_SAMPLE:
            train_rl = False  # (ref: envdrop.py:100)
        if world.features.dtype != self.compute_dtype:
            # the JAX package silently drops its fused path on this mismatch
            raise ValueError(f"feature table dtype {world.features.dtype} differs from the "
                             f"compute dtype {self.compute_dtype}")
        params = C.cast_compute_params(params, self.compute_dtype)
        drop = self.cfg.DROP_RATE
        ctx_mask = ep.instr_tokens == PAD_IDX
        ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, train,
                                    drop, generator)
        B = ep.instr_tokens.shape[0]
        decode = self._decode(params["decoder"], world, ctx, ctx_mask, train, generator)

        def model_step(mc, meta, state, t):
            return decode(mc, meta, state)

        # h_tilde starts as the encoder's h (ref: envdrop.py:150)
        result = C.rollout_scan(world, ep, (h0, c0, h0), model_step,
                                episode_len or self.episode_len, feedback,
                                compute_dtype=self.compute_dtype, generator=generator)
        steps = result.steps
        alive = steps.alive_before.float()

        # ---------------- A2C tail (ref: envdrop.py:222-264) ----------------
        if train_rl:
            with torch.no_grad():  # one extra decode step bootstraps the return
                final = result.final_state
                meta = E.observe_meta(world, final, self.compute_dtype)
                _, _, last_h = decode(result.model_carry, meta, final)
                last_value = D.critic_apply(params["critic"], last_h, train, drop, generator)
            # critic values of all steps, latest first, as one batched call
            values = D.critic_apply(params["critic"], steps.hidden.flip(0), train, drop,
                                    generator)
            gamma = self.cfg.GAMMA
            discount = torch.logical_not(result.final_state.ended).float() * last_value.float()
            T = steps.reward.shape[0]
            rl_vec = torch.zeros_like(discount)
            critic_loss_sum = discount.new_zeros(())
            for i in range(T):
                t = T - 1 - i
                mask = alive[t]
                discount = discount * gamma + steps.reward[t]
                r_ = discount.detach()
                v_ = values[i].float()
                a_ = (r_ - v_).detach()
                loss_vec = -steps.log_prob[t] * a_ * mask + 0.5 * (r_ - v_) ** 2 * mask
                if feedback == C.FEEDBACK_SAMPLE:
                    loss_vec = loss_vec - 0.01 * steps.entropy[t] * mask
                critic_loss_sum = critic_loss_sum + (((r_ - v_) ** 2) * mask).sum()
                rl_vec = rl_vec + loss_vec
            total = alive.sum().clamp_min(1.0)
            if self.cfg.RL_NORMALIZE == "total":
                rl_vec = rl_vec / total
            elif self.cfg.RL_NORMALIZE == "batch":
                rl_vec = rl_vec / B
            rl_loss = rl_vec.sum()
        else:
            zero = alive.new_zeros(())
            rl_vec, rl_loss, critic_loss_sum = alive.new_zeros(B), zero, zero
            total = alive.sum()

        ml_weight = self.cfg.ML_WEIGHT
        if train_ml:
            ml_loss = C.ml_loss_sum(steps) * ml_weight / B
            ml_vec = C.ml_loss_per_sample(steps) * ml_weight / B
        else:
            ml_loss, ml_vec = alive.new_zeros(()), alive.new_zeros(B)
        losses = EnvDropLosses(
            ml_loss=ml_loss, ml_loss_per_sample=ml_vec, rl_loss=rl_loss,
            rl_loss_per_sample=rl_vec, entropy_sum=(steps.entropy * alive).sum(),
            critic_loss_sum=critic_loss_sum, total_actions=total)
        return losses, result

    def loss_fn(self, losses: EnvDropLosses, weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """IL + RL objective; with SPCL weights, dot(w, per-sample) without
        sum-normalization (ref: curriculum.py:294-296)."""
        if weights is None:
            return losses.ml_loss + losses.rl_loss
        return torch.dot(weights, losses.ml_loss_per_sample + losses.rl_loss_per_sample)
