"""Speaker: the instruction generator of back-translation.

The port of ``curriculum_learning_for_vln_tpu/agents/speaker.py`` (ref:
tasks/R2R-judy/src/agent/speaker.py:16-422):

* ``collect_shortest_path_features``: the teacher-forced walk over the
  env, each step's panorama and chosen candidate's feature (zeros once
  stopped or ended), and the number of alive steps (speaker.py:41-78);
* ``Speaker.teacher_forcing_loss``: the sequence cross-entropy against the
  instruction, <PAD> ignored; ``for_listener`` gives the per-word matrix
  (speaker.py:151-176);
* ``Speaker.infer`` / ``infer_batch``: greedy or sampled decoding up to
  MAX_DECODE words with <UNK> banned (NEG_INF on the f32 logits) and the
  words after <EOS> forced to <PAD>; sampling is argmax(logits + Gumbel
  noise) drawn from the generator, which is how ``jax.random.categorical``
  is defined (speaker.py:178-212, 283-303);
* ``Speaker.back_translate``: a shared feature-noise mask, a greedy decode
  through it, and the batch with the generated instructions injected, the
  generated length being the true one (a documented deviation from the
  reference, speaker.py:310-333);
* the speaker's optimizer, ``engine.loop.ClippedAdam`` (one global-norm
  clip at 40 in optax's form, then Adam), and ``save`` / ``load`` with its
  state (speaker.py:346-356).

bf16 compute keeps f32 masters, as the agents do: the features and the
compute weights in bf16, the decoder's recurrent state (h, c) in f32.  The
encoder's LSTMs run the scan kernels K3 (decoding, under ``torch.no_grad``)
and K1 / K2 (teacher forcing); the decoder's cell stays plain.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.checkpoint import load_checkpoint, restore_training_state, save_checkpoint
from ..engine.loop import ClippedAdam
from ..env import env as E
from ..env.env import EpisodeBatch
from ..models.attention import NEG_INF
from ..models.core import dropout_mask
from ..models.speaker_model import (speaker_decoder_apply, speaker_decoder_init,
                                    speaker_encoder_apply, speaker_encoder_init)
from ..utils.tokenizer import BOS_IDX, EOS_IDX, PAD_IDX, UNK_IDX
from ..utils.tree import tree_leaves, tree_map
from ..world.compiler import WorldTables
from .common import cast_compute_params, chosen_feature, gumbel_noise

CLIP_NORM = 40.0  # the speaker's global-norm clip (ref: speaker.py:85-86)


class SpeakerFeatures(NamedTuple):
    img_feats: torch.Tensor   # [B, T, 36, F]
    can_feats: torch.Tensor   # [B, T, F]
    lengths: torch.Tensor     # [B] steps incl. the stop step


@torch.no_grad()
def collect_shortest_path_features(world: WorldTables, ep: EpisodeBatch, episode_len: int,
                                   compute_dtype=torch.float32) -> SpeakerFeatures:
    """The teacher-forced walk of ``episode_len`` steps (ref: speaker.py:
    191-226): each step's panorama, and the chosen candidate's features
    where the episode is alive and the teacher moves (zeros at the stop
    step and after it, the reference's zero stop candidate), in
    ``compute_dtype``; ``lengths`` counts the alive steps."""
    state = E.reset(world, ep)
    imgs, cans, alives = [], [], []
    for _ in range(episode_len):
        obs = E.observe(world, state, compute_dtype)
        teacher = obs.meta.teacher
        alive = torch.logical_not(state.ended)
        is_move = (teacher >= 0) & (teacher < obs.meta.n_cands)
        can = chosen_feature(obs.cand_feat, teacher)
        cans.append(torch.where((alive & is_move)[:, None], can,
                                torch.zeros((), dtype=can.dtype, device=can.device)))
        imgs.append(obs.pano_feat)
        alives.append(alive)
        state = E.step(world, state, teacher)
    return SpeakerFeatures(img_feats=torch.stack(imgs, dim=1), can_feats=torch.stack(cans, dim=1),
                           lengths=torch.stack(alives).long().sum(dim=0))


def generated_to_instr_tokens(words: np.ndarray, enc_len: int):
    """Generated word ids [B, L] packed into encoder-shaped instructions
    (speaker.py:81-106): [BOS] + the words up to and including <EOS>,
    stopping at <PAD>, a terminal <EOS> forced, truncated to ``enc_len``
    with <EOS> last, padded with <PAD>.  Returns (tokens [B, enc_len],
    lengths [B]), int32."""
    B = words.shape[0]
    tokens = np.full((B, enc_len), PAD_IDX, np.int32)
    lengths = np.zeros(B, np.int32)
    for b in range(B):
        seq = [BOS_IDX]
        for w in words[b]:
            w = int(w)
            if w == PAD_IDX:
                break
            seq.append(w)
            if w == EOS_IDX:
                break
        if seq[-1] != EOS_IDX:
            seq.append(EOS_IDX)
        if len(seq) > enc_len:
            seq = seq[:enc_len]
            seq[-1] = EOS_IDX
        tokens[b, :len(seq)] = seq
        lengths[b] = len(seq)
    return tokens, lengths


class Speaker:
    def __init__(self, spk_cfg, vocab_size: int, feat_dim: int = 2048, angle_feat_size: int = 128,
                 episode_len: int = 35, compute_dtype: torch.dtype = torch.float32):
        self.cfg = spk_cfg
        self.vocab_size = vocab_size
        self.feature_size = feat_dim + angle_feat_size
        self.angle_feat_size = angle_feat_size
        self.episode_len = episode_len
        self.compute_dtype = compute_dtype

    def init(self, generator: torch.Generator, device=None) -> Tuple[dict, ClippedAdam]:
        """Seeded f32 parameters on ``device`` and a fresh optimizer."""
        params = {
            "encoder": speaker_encoder_init(generator, self.feature_size, self.cfg.RNN_DIM,
                                            self.cfg.BI_DIRECTION),
            "decoder": speaker_decoder_init(generator, self.vocab_size, self.cfg.WEMB, PAD_IDX,
                                            self.cfg.RNN_DIM),
        }
        return self.prepare(params, device)

    def prepare(self, params: dict, device=None) -> Tuple[dict, ClippedAdam]:
        """``params`` on ``device`` as trainable leaves, and a fresh optimizer
        over them."""
        params = tree_map(lambda t: t.to(device).requires_grad_(t.is_floating_point()), params)
        return params, ClippedAdam(tree_leaves(params), self.cfg.LR, CLIP_NORM)

    # ------------------------------------------------------------------
    def _encode(self, params: dict, feats: SpeakerFeatures, train: bool,
                generator: Optional[torch.Generator] = None,
                feat_mask: Optional[torch.Tensor] = None):
        """(ctx [B, T, RNN_DIM], ctx_mask [B, T]).  A ``feat_mask`` (the
        shared noise) is cast to the compute dtype before it scales the
        image dims, so bf16 features stay bf16 (speaker.py:138-149), unlike
        the EnvDrop rollout's f32 product."""
        cdt = self.compute_dtype
        img, can = feats.img_feats.to(cdt), feats.can_feats.to(cdt)
        if feat_mask is not None:
            a, m = self.angle_feat_size, feat_mask.to(cdt)
            img = torch.cat([img[..., :-a] * m, img[..., -a:]], dim=-1)
            can = torch.cat([can[..., :-a] * m, can[..., -a:]], dim=-1)
        ctx = speaker_encoder_apply(
            cast_compute_params(params["encoder"], cdt), can, img, train,
            drop_rate=self.cfg.DROPOUT, feat_drop_rate=self.cfg.FEAT_DROPOUT,
            angle_feat_size=self.angle_feat_size, already_dropfeat=feat_mask is not None,
            generator=generator)
        T = ctx.shape[1]
        return ctx, torch.arange(T, device=ctx.device)[None, :] >= feats.lengths[:, None]

    def teacher_forcing_loss(self, params: dict, feats: SpeakerFeatures, insts: torch.Tensor,
                             train: bool, generator: Optional[torch.Generator] = None,
                             for_listener: bool = False) -> torch.Tensor:
        """The cross-entropy of predicting word t + 1 from position t, <PAD>
        ignored, in f32 (ref: speaker.py:235-290): its mean over the words,
        or with ``for_listener`` the per-word matrix [B, L - 1]."""
        ctx, ctx_mask = self._encode(params, feats, train, generator)
        h0 = ctx.new_zeros((insts.shape[0], self.cfg.RNN_DIM), dtype=torch.float32)
        logits, _, _ = speaker_decoder_apply(
            cast_compute_params(params["decoder"], self.compute_dtype), insts, ctx, ctx_mask,
            h0, h0, train, drop_rate=self.cfg.DROPOUT, generator=generator)
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        targets = insts[:, 1:]
        picked = logp.gather(-1, targets[..., None])[..., 0]
        valid = targets != PAD_IDX
        per_word = torch.where(valid, -picked, 0.0)
        if for_listener:
            return per_word
        return per_word.sum() / valid.sum().clamp_min(1)

    def infer(self, params: dict, feats: SpeakerFeatures, sampling: bool = False,
              train: bool = False, feat_mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Greedy or sampled decoding (ref: speaker.py:292-376): (words [B,
        MAX_DECODE] with <PAD> after each <EOS>, the sampled words'
        log-probabilities [B, MAX_DECODE], zeros when greedy)."""
        ctx, ctx_mask = self._encode(params, feats, train, generator, feat_mask)
        B = ctx.shape[0]
        h = ctx.new_zeros((B, self.cfg.RNN_DIM), dtype=torch.float32)  # f32 recurrent state
        c = torch.zeros_like(h)
        word = torch.full((B,), BOS_IDX, dtype=torch.long, device=ctx.device)
        ended = torch.zeros((B,), dtype=torch.bool, device=ctx.device)
        dec = cast_compute_params(params["decoder"], self.compute_dtype)
        unk = torch.tensor([UNK_IDX], device=ctx.device)
        words, log_probs = [], []
        for _ in range(self.cfg.MAX_DECODE):
            logits, h, c = speaker_decoder_apply(dec, word[:, None], ctx, ctx_mask, h, c, train,
                                                 drop_rate=self.cfg.DROPOUT, generator=generator)
            # the choice in f32 (bf16 logits quantize the categorical)
            logits = logits[:, 0].float().index_fill(1, unk, NEG_INF)
            if sampling:
                noise = gumbel_noise(logits.shape, generator, logits.device)
                nxt = torch.argmax(logits + noise, dim=-1)
                log_prob = torch.log_softmax(logits, -1).gather(1, nxt[:, None])[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
                log_prob = logits.new_zeros(B)
            out_word = torch.where(ended, PAD_IDX, nxt)
            ended = ended | (out_word == EOS_IDX)
            words.append(out_word)
            log_probs.append(log_prob)
            word = nxt
        return torch.stack(words, dim=1), torch.stack(log_probs, dim=1)

    # ------------------------------------------------------------------
    def train_steps(self, params: dict, optimizer: ClippedAdam, world: WorldTables, henv,
                    generator: Optional[torch.Generator], iters: int):
        """``iters`` teacher-forcing updates on ``henv``'s next batches (ref:
        speaker.py:75-88), ``params`` updated in place.  Returns (params,
        optimizer, the losses)."""
        losses = []
        for _ in range(iters):
            ep = henv.next_batch()
            feats = collect_shortest_path_features(world, ep, self.episode_len,
                                                   self.compute_dtype)
            loss = self.teacher_forcing_loss(params, feats, ep.instr_tokens, True, generator)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        return params, optimizer, torch.stack(losses).tolist() if losses else []

    @torch.no_grad()
    def infer_batch(self, params: dict, world: WorldTables, ep: EpisodeBatch,
                    generator: Optional[torch.Generator] = None, sampling: bool = False,
                    feat_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Instructions [B, MAX_DECODE] for a batch's shortest paths: the
        feature walk, then ``infer`` (ref: envdrop.py:105-121)."""
        feats = collect_shortest_path_features(world, ep, self.episode_len, self.compute_dtype)
        words, _ = self.infer(params, feats, sampling=sampling, feat_mask=feat_mask,
                              generator=generator)
        return words

    def get_insts(self, params: dict, world: WorldTables, henv,
                  generator: Optional[torch.Generator] = None, tokenizer=None) -> dict:
        """One greedy instruction per path over the dataset (ref:
        speaker.py:90-102): path_id -> word ids, shrunk of <BOS> and <EOS>
        with a tokenizer."""
        path2inst = {}
        for ep in henv.eval_batches():
            words = self.infer_batch(params, world, ep, generator).cpu().numpy()
            idx, valid = ep.item_idx.cpu().numpy(), ep.valid.cpu().numpy()
            for b in range(len(idx)):
                if not valid[b]:
                    continue
                path_id = henv.data[int(idx[b])]["path_id"]
                if path_id not in path2inst:
                    inst = words[b].tolist()
                    path2inst[path_id] = tokenizer.shrink(inst) if tokenizer else inst
        return path2inst

    @torch.no_grad()
    def valid(self, params: dict, world: WorldTables, henv,
              generator: Optional[torch.Generator] = None, tokenizer=None, n_batches: int = 3):
        """Teacher-forcing evaluation (ref: speaker.py:104-123, 280-290):
        (path2inst, loss, word accuracy, sentence accuracy) over the first
        ``n_batches`` evaluation batches."""
        path2inst = self.get_insts(params, world, henv, generator, tokenizer)
        losses, word_correct, word_total, sent_correct, sent_total = [], 0, 0, 0, 0
        for i, ep in enumerate(henv.eval_batches()):
            if i == n_batches:
                break
            feats = collect_shortest_path_features(world, ep, self.episode_len,
                                                   self.compute_dtype)
            losses.append(float(self.teacher_forcing_loss(params, feats, ep.instr_tokens,
                                                           False)))
            ctx, ctx_mask = self._encode(params, feats, False)
            B = ep.instr_tokens.shape[0]
            h0 = ctx.new_zeros((B, self.cfg.RNN_DIM), dtype=torch.float32)
            logits, _, _ = speaker_decoder_apply(
                cast_compute_params(params["decoder"], self.compute_dtype), ep.instr_tokens,
                ctx, ctx_mask, h0, h0, False, drop_rate=self.cfg.DROPOUT)
            predict = torch.argmax(logits, dim=-1).cpu().numpy()
            insts = ep.instr_tokens.cpu().numpy()
            gt_mask = insts != PAD_IDX
            correct = (predict[:, :-1] == insts[:, 1:]) & gt_mask[:, 1:]
            word_correct += int(correct.sum())
            word_total += int(gt_mask[:, 1:].sum())
            sent_correct += int((correct.sum(1) == gt_mask[:, 1:].sum(1)).sum())
            sent_total += B
        loss = float(np.mean(losses)) if losses else 0.0
        return (path2inst, loss, word_correct / max(word_total, 1),
                sent_correct / max(sent_total, 1))

    def make_drop_mask(self, generator: Optional[torch.Generator], feat_dim: int,
                       device=None) -> torch.Tensor:
        """The shared environmental-drop noise [feat_dim] f32 of back-
        translation (ref: envdrop.py:106)."""
        return dropout_mask((feat_dim,), self.cfg.FEAT_DROPOUT, generator, device)

    def back_translate(self, params: dict, world: WorldTables, henv, ep: EpisodeBatch,
                       enc_len: int, generator: Optional[torch.Generator], feat_dim: int):
        """Greedy instructions for the current batch through a fresh shared
        noise mask, injected into ``henv``'s current episodes (ref:
        envdrop.py:105-121).  Returns (the new batch, the mask).  The
        generated length (BOS..EOS) is the one used; the reference keeps
        the old instruction length (envdrop.py:113-119)."""
        noise = self.make_drop_mask(generator, feat_dim, ep.instr_tokens.device)
        words = self.infer_batch(params, world, ep, generator, feat_mask=noise).cpu().numpy()
        tokens, lengths = generated_to_instr_tokens(words, enc_len)
        return henv.inject_batch(ep.item_idx.cpu().numpy(), tokens, lengths), noise

    # -- persistence, optimizer state included (ref: speaker.py:378-413) --
    def save(self, path: str, params: dict, optimizer: Optional[ClippedAdam] = None,
             epoch: int = 0) -> None:
        save_checkpoint(path, params, optimizer, epoch=epoch)

    def load(self, path: str, load_optim: bool = False, device=None):
        """(params on ``device``, an optimizer, the epoch) of a bundle; with
        ``load_optim`` the optimizer resumes a port bundle's state, while a
        JAX bundle's optax state has no counterpart and leaves it fresh."""
        from ..convert import params_from_jax

        bundle = load_checkpoint(path)
        params, optimizer = self.prepare(params_from_jax(bundle["params"]), device)
        if load_optim:
            restore_training_state(bundle, optimizer)
        return params, optimizer, int(bundle.get("epoch", 0))
