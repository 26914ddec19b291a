"""Self-Monitoring agent (Ma et al. 2019).

The port of ``curriculum_learning_for_vln_tpu/agents/monitor.py`` (ref:
tasks/R2R-judy/src/agent/monitor.py:21-258): the encoder (one LSTM layer
at H = 512 as shipped: K3, or K1 and K2 under autograd), then per step
the observation op for the candidate rows alone (K4 on a zero query, no
K5: ``fused_obs.pano_cands``), the MonitorDecoder with its BatchNorm
running statistics carried through the steps, and a joint loss of the
action CE and the progress monitor's MSE: t = 0 contributes the CE alone;
t > 0 contributes lamb * MSE(progress, target) + (1 - lamb) * CE, the
target being the normalised distance reduction, 1 within 3 m of the goal,
and frozen (no loss) for ended episodes (ref: monitor.py:148-165).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..env import env as E
from ..env.env import EpisodeBatch
from ..models import decoders as D
from ..models.encoder import encoder_apply, encoder_init
from ..ops import fused_obs
from ..utils.tokenizer import PAD_IDX
from ..utils.tree import tree_map
from ..world.compiler import WorldTables
from . import common as C


class MonitorLosses(NamedTuple):
    ml_loss: torch.Tensor             # scalar joint loss (the reference's reductions)
    ml_loss_per_sample: torch.Tensor  # [B] joint per-sample loss (SPCL)
    progress_loss: torch.Tensor       # scalar (recorded only; ref monitor.py:128)


class SelfMonitorAgent:
    name = "SELF-MONITOR"

    def __init__(self, model_cfg, max_enc_len: int, vocab_size: int, feat_dim: int,
                 episode_len: int, compute_dtype: torch.dtype = torch.float32):
        self.cfg = model_cfg
        self.max_enc_len = max_enc_len
        self.vocab_size = vocab_size
        self.feature_size = feat_dim + 128
        self.action_emb_size = self.feature_size
        self.episode_len = episode_len
        self.compute_dtype = compute_dtype  # must equal the feature table's dtype

    def init(self, generator: torch.Generator, device=None) -> Tuple[dict, dict]:
        """Seeded f32 parameters on ``device`` and the model state: the
        decoder's BN statistics under "decoder_bn"."""
        params = {
            "encoder": encoder_init(
                generator, self.vocab_size, self.cfg.WORD_EMB_SIZE, self.cfg.HIDDEN_SIZE,
                padding_idx=PAD_IDX, bidirectional=self.cfg.ENC_BIDIRECTION,
                num_layers=self.cfg.ENC_LAYERS, device=device),
        }
        params["decoder"], bn = D.monitor_decoder_init(
            generator, self.cfg.HIDDEN_SIZE, self.max_enc_len, mlp_dims=tuple(self.cfg.MLP_HIDDEN),
            action_embed_size=self.action_emb_size, device=device)
        return params, {"decoder_bn": bn}

    def rollout(self, params: dict, world: WorldTables, ep: EpisodeBatch, feedback: int,
                train: bool = False, episode_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                model_state: Optional[dict] = None, lamb: float = 0.5
                ) -> Tuple[MonitorLosses, C.RolloutResult, dict]:
        """One batched rollout: (losses, result, model_state), the BN
        statistics after the rollout when ``train`` (carrying no gradient),
        else ``model_state`` as given.  ``lamb`` weighs the progress MSE
        against the CE (TRAIN.PROGMONITOR_WEIGHT)."""
        C.check_dtype(world, self.compute_dtype)
        params = C.cast_compute_params(params, self.compute_dtype)
        dec = params["decoder"]
        drop = self.cfg.DROP_RATE
        # the context and its mask span the full MAX_ENC_LEN (ref: monitor.py:68-87)
        ctx_mask = ep.instr_tokens == PAD_IDX
        ctx, h0, c0 = encoder_apply(params["encoder"], ep.instr_tokens, ep.instr_len, train, drop,
                                    generator)
        B = ep.instr_tokens.shape[0]
        a_prev0 = torch.zeros((B, self.action_emb_size), dtype=self.compute_dtype,
                              device=ctx.device)

        def model_step(mc, meta: E.ObsMeta, state: E.EnvState, t):
            h, c, a_prev, bn, _ = mc
            cand_img = fused_obs.pano_cands(state.node, state.view_idx, meta.cand_view,
                                            world.features, world.loc_embed)
            cand_feat = E.assemble_cand_feat(cand_img, meta.cand_angle, meta.cand_valid)
            (logits, progress), (h1, c1), bn2, _ = D.monitor_decoder_step(
                dec, bn, a_prev, cand_feat, meta.cand_mask, h, c, ctx, ctx_mask, train, drop,
                generator)
            return logits, (h1, c1, a_prev, bn2, cand_feat), h1, progress

        def model_post(mc, meta, action):
            h, c, _, bn, cand_feat = mc
            return h, c, C.chosen_feature(cand_feat, action).to(self.compute_dtype), bn, cand_feat

        result = C.rollout_scan(world, ep, (h0, c0, a_prev0, model_state["decoder_bn"], None),
                                model_step, episode_len or self.episode_len, feedback,
                                compute_dtype=self.compute_dtype, generator=generator,
                                model_post=model_post)
        steps = result.steps

        # progress targets (ref: monitor.py:153-157) from the distance at the
        # current state: the previous step's dist_after
        start_dist = world.dist[ep.start_node].gather(1, ep.goal_local[:, None])[:, 0]
        dist_before = torch.cat([start_dist[None, :], steps.dist_after[:-1]], dim=0)  # [T, B]
        target = (start_dist[None, :] - dist_before) / start_dist[None, :].clamp_min(1e-8)
        target = torch.where(dist_before <= 3.0, 1.0, target)
        mse_vec = torch.where(steps.alive_before, (steps.progress - target) ** 2, 0.0)
        T = mse_vec.shape[0]
        later = torch.arange(T, device=mse_vec.device) > 0

        # scalar (the reference's reductions): per step t > 0, lamb mean_B(mse)
        # + (1 - lamb) mean_alive(ce); at t = 0 the CE alone
        ce_step_mean = steps.ce.sum(dim=1) / steps.ce_count.clamp_min(1)
        mse_step_mean = mse_vec.mean(dim=1)
        ml_scalar = torch.where(later, lamb * mse_step_mean + (1 - lamb) * ce_step_mean,
                                ce_step_mean).sum()
        # per sample (SPCL): the joint vector summed over time (ref: monitor.py:151-165)
        joint = torch.where(later[:, None], lamb * mse_vec + (1 - lamb) * steps.ce, steps.ce)
        losses = MonitorLosses(ml_loss=ml_scalar, ml_loss_per_sample=joint.sum(dim=0),
                               progress_loss=mse_step_mean[1:].sum())
        if train:
            model_state = {"decoder_bn": tree_map(torch.Tensor.detach, result.model_carry[3])}
        return losses, result, model_state

    def loss_fn(self, losses: MonitorLosses, weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The joint objective; with SPCL weights w the weighted per-sample
        loss normalised by sum(w) (ref: curriculum.py:297-301)."""
        if weights is None:
            return losses.ml_loss
        return torch.dot(weights, losses.ml_loss_per_sample) / weights.sum()
