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
masks made in the kernels), "prng_shared" (the same seeds, one mask per
group of 8 rows) or "ext" (keep-masks drawn here).  ``rollout_packed``
(envdrop.py:124-183) is the sampled A2C rollout over an episode pool
(agents/packed.py).  ``rollout(feat_mask=...)`` is back-translation's
rollout (envdrop.py:198-230): the shared noise mask on the image dims of
the gathered features, the unfused decode, no observation kernel;
``rollout_packed`` takes no mask (the back-translation step does not
pack).

The hand-written BPTT path (``FUSED_BPTT``) is not ported.
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
from .packed import PackedLosses, PackedResult, packed_a2c, packed_rollout_scan

OBS_MASK_MODES = ("prng", "prng_shared", "ext")


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
        if self.obs_masks in ("prng", "prng_shared"):
            return DropSpec(self.obs_masks, seeds=philox.draw_seeds(B, generator, device),
                            keep=keep)
        return DropSpec("ext", mask=draw_keep_mask((B, rows, D_), keep, generator, device),
                        keep=keep)

    def _apply_feat_mask(self, feat: torch.Tensor, feat_mask: torch.Tensor) -> torch.Tensor:
        """The shared noise on the image dims (envdrop.py:83-87): the
        features times the f32 mask, which promotes bf16 features to f32,
        as jnp does; the angle dims follow."""
        a = self.angle_feat_size
        img = feat[..., :-a] * feat_mask
        return torch.cat([img, feat[..., -a:].to(img.dtype)], dim=-1)

    def _decode(self, dec: dict, world: WorldTables, train: bool,
                generator: Optional[torch.Generator], feat_mask: Optional[torch.Tensor] = None):
        """One decoder step with the text context passed in — shared by the
        per-batch rollout and the packed one, which gathers its context
        rows per step (envdrop.py:78-121): visual query, observation op
        (K4), decoder, candidate scorer (K6).  With ``feat_mask`` (the
        shared noise of back-translation) the step is the unfused one over
        the gathered features with the mask applied, as the JAX package
        turns its fused path off then (envdrop.py:213-221): no kernel of
        the observation path runs."""
        drop = self.cfg.DROP_RATE
        _, V, Dim = world.features.shape

        if feat_mask is not None:
            def decode_masked(mc, ctx, ctx_mask, meta: E.ObsMeta, state: E.EnvState):
                _h, c, h_tilde = mc
                a_t_angle = make_angle_feat(state.heading, state.elevation)
                # the features in the dtype the metadata was made in
                pano, cand = E.observe_feats(world, state, meta, meta.cand_angle.dtype)
                logits, (h1, c1), h_tilde_new = D.envdrop_decoder_step(
                    dec, a_t_angle, self._apply_feat_mask(pano, feat_mask),
                    self._apply_feat_mask(cand, feat_mask), h_tilde, c, ctx, ctx_mask, train,
                    drop, self.cfg.FEAT_DROP_RATE, self.angle_feat_size, already_dropfeat=True,
                    generator=generator)
                return logits, (h1, c1, h_tilde_new), h1

            return decode_masked

        def decode(mc, ctx, ctx_mask, meta: E.ObsMeta, state: E.EnvState):
            B = ctx.shape[0]
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

    def rollout_packed(self, params: dict, world: WorldTables, pool: EpisodeBatch,
                       batch_size: int, episode_len: Optional[int] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[PackedLosses, PackedResult]:
        """The sampled A2C rollout over an episode pool of N = factor * B
        episodes, ``batch_size`` slots at a time (agents/packed.py): the
        pool encoded once, the shared ``decode`` per step, the critic on a
        last decode step, and ``packed_a2c``.  With N == B it computes the
        unpacked ``rollout(train_rl=True)`` A2C loss."""
        C.check_dtype(world, self.compute_dtype)
        params = C.cast_compute_params(params, self.compute_dtype)
        drop = self.cfg.DROP_RATE
        ctx_mask_pool = pool.instr_tokens == PAD_IDX
        ctx_pool, h0_pool, c0_pool = encoder_apply(params["encoder"], pool.instr_tokens,
                                                   pool.instr_len, True, drop, generator)
        decode = self._decode(params["decoder"], world, True, generator)
        result = packed_rollout_scan(world, pool, ctx_pool, ctx_mask_pool, h0_pool, c0_pool,
                                     decode, batch_size, episode_len or self.episode_len,
                                     compute_dtype=self.compute_dtype, generator=generator)
        # A2C tail, as rollout's (ref: envdrop.py:222-264)
        with torch.no_grad():  # one extra decode step bootstraps the return
            final, ids = result.final_state, result.final_slot_ep
            meta = E.observe_meta(world, final, self.compute_dtype)
            _, _, last_h = decode(result.final_carry, ctx_pool[ids], ctx_mask_pool[ids], meta,
                                  final)
            last_value = D.critic_apply(params["critic"], last_h, True, drop, generator)
        values = D.critic_apply(params["critic"], result.steps.hidden.flip(0), True, drop,
                                generator)
        losses = packed_a2c(result, values, last_value, self.cfg.GAMMA, self.cfg.RL_NORMALIZE,
                            ctx_pool.shape[0])
        return losses, result

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch, feedback: int,
                train: bool = False, train_ml: bool = True, train_rl: bool = False,
                episode_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                model_state: Optional[dict] = None,
                feat_mask: Optional[torch.Tensor] = None
                ) -> Tuple[EnvDropLosses, C.RolloutResult]:
        """One batched episode rollout.  Returns (losses, result); the A2C
        terms are computed with sample feedback and ``train_rl``.
        ``generator`` (on the device of the tables) draws the dropout masks
        and the sampled actions.  ``feat_mask`` [D] f32 is back-
        translation's shared noise (envdrop.py:198-230): it replaces the
        env-dropout, and the decode is the unfused one.  EnvDrop has no
        model state: callers that serve any agent may pass one, and it is
        not read."""
        if feedback != C.FEEDBACK_SAMPLE:
            train_rl = False  # (ref: envdrop.py:100)
        C.check_dtype(world, self.compute_dtype)
        params = C.cast_compute_params(params, self.compute_dtype)
        drop = self.cfg.DROP_RATE
        ctx_mask = ep.instr_tokens == PAD_IDX
        ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, train,
                                    drop, generator)
        B = ep.instr_tokens.shape[0]
        decode = self._decode(params["decoder"], world, train, generator, feat_mask)

        def model_step(mc, meta, state, t):
            return (*decode(mc, ctx, ctx_mask, meta, state), None)

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
                # the JAX package observes this step in f32 (envdrop.py:226),
                # which the unfused decode reads; the fused one reads the table
                meta = E.observe_meta(world, final, torch.float32 if feat_mask is not None
                                      else self.compute_dtype)
                _, _, last_h = decode(result.model_carry, ctx, ctx_mask, meta, final)
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
