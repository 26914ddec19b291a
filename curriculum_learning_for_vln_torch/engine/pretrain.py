"""ViLBERT multi-modal pretraining and CLR2R difficulty scoring.

The port of ``curriculum_learning_for_vln_tpu/engine/pretrain.py``.  The
reference ships the pretraining heads (``BertForMultiModalPreTraining``,
ref: tasks/R2R-judy/src/model/vilbert.py:1431-1513) and the path-selection
scorer (vln_bert.py:24-75) but no program that runs them: the CLR2R
rounds were made offline.  This module has

* BERT-style masking (masked LM, masked vision regions) drawn on the
  device from an explicit ``torch.Generator`` (``draw_pretrain_masks``),
  and the loss given those masks (``pretrain_loss``: masked LM, masked
  regions, path-instruction alignment and the vil_logit BCE), so a test
  can feed in masks the JAX package drew;
* ``VLNBertPretrainer``: Adam in optax's form (``engine.loop.ClippedAdam``
  without a clip) over (tokens, regions, locations, alignment label)
  batches, with host-side counters of what its steps trained
  (``PretrainCounters``);
* ``pretrain_batches``: the batches in the JAX package's order, each
  path's (node, view) rows gathered on the card from the world's feature
  table every step;
* ``score_difficulty`` / ``make_clr2r_rounds``: the paper's CLR2R
  construction, ranking items by the scorer's compatibility logit
  (higher = easier) and cutting them into rounds (ref:
  curriculum_env.py:44-62 consumes the round files).

The masks are torch draws, so only their distribution matches the JAX
package's ``jax.random`` draws.  Spans (``utils/profiling.py``): a step is
``vln.iter``, its masks ``vln.pretrain.masks``, its loss terms
``vln.pretrain.loss``, its backward and Adam ``vln.update.backward`` and
``.optim``, a batch's gather ``vln.pretrain.batch``; the model's own are
``vln.vilbert.*`` (models/vilbert.py).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.vilbert import VilBertConfig, vlnbert_apply, vlnbert_init
from ..parallel import mesh as M
from ..parallel import vilbert_sharding as S
from ..utils.profiling import span
from ..utils.tokenizer import PAD_IDX
from ..utils.tree import tree_leaves, tree_map
from .loop import ClippedAdam

logger = logging.getLogger("main.pretrain")

N_SPECIAL_TOKENS = 4  # <PAD>, <UNK>, <EOS>, <BOS>: never masked


def mask_lm_tokens(generator: Optional[torch.Generator], tokens: torch.Tensor, vocab_size: int,
                   mask_idx: int, p: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT masking on the device of ``tokens``: select p of the non-special
    tokens; of those 80% become [MASK], 10% a random word, 10% stay.
    Returns (masked_tokens, labels), the label -1 where no prediction is
    asked."""
    dev = tokens.device
    maskable = tokens >= N_SPECIAL_TOKENS
    sel = (torch.rand(tokens.shape, generator=generator, device=dev) < p) & maskable
    kind = torch.rand(tokens.shape, generator=generator, device=dev)
    rand_words = torch.randint(N_SPECIAL_TOKENS, vocab_size, tokens.shape, generator=generator,
                               device=dev, dtype=tokens.dtype)
    replaced = torch.where(kind < 0.8, torch.full_like(tokens, mask_idx),
                           torch.where(kind < 0.9, rand_words, tokens))
    masked = torch.where(sel, replaced, tokens)
    labels = torch.where(sel, tokens, torch.full_like(tokens, -1))
    return masked, labels


def mask_regions(generator: Optional[torch.Generator], feats: torch.Tensor,
                 region_mask: torch.Tensor, p: float = 0.15) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask p of the valid regions by zeroing their features (the reference
    keeps 10% unchanged; the always-zero variant is the JAX package's
    documented deviation).  Returns (masked_feats, predict_mask)."""
    sel = ((torch.rand(feats.shape[:-1], generator=generator, device=feats.device) < p)
           & (region_mask > 0))
    return torch.where(sel[..., None], 0.0, feats), sel


class PretrainMasks(NamedTuple):
    masked_tokens: torch.Tensor  # [B, Lt]
    lm_labels: torch.Tensor      # [B, Lt], -1 = no prediction
    masked_feats: torch.Tensor   # [B, R, F]
    region_sel: torch.Tensor     # [B, R] bool, the regions to predict


def draw_pretrain_masks(generator: Optional[torch.Generator], tokens, feats, region_mask,
                        vocab_size: int, mask_idx: int, mask_p: float = 0.15,
                        region_p: float = 0.15) -> PretrainMasks:
    """The token masks, then the region masks, from ``generator``."""
    with span("pretrain.masks"):
        masked_tokens, lm_labels = mask_lm_tokens(generator, tokens, vocab_size, mask_idx,
                                                  mask_p)
        masked_feats, region_sel = mask_regions(generator, feats, region_mask, region_p)
        return PretrainMasks(masked_tokens, lm_labels, masked_feats, region_sel)


def pretrain_loss(params: dict, cfg: VilBertConfig, tokens, locs, region_mask, region_targets,
                  align_labels, masks: PretrainMasks, train: bool = True,
                  generator: Optional[torch.Generator] = None):
    """(loss, logs) given the masks (pretrain.py:70-115): masked-LM CE,
    masked-region KL(target || prediction) against ``region_targets`` [B,
    R, v_target] (uniform rows make it a constant), the alignment CE and
    the vil_logit alignment BCE, summed."""
    vil_logit, vision_pred, linguistic_pred, seq_rel = vlnbert_apply(
        params, cfg, masks.masked_tokens, masks.masked_feats, locs,
        attention_mask=(tokens != PAD_IDX).float(), image_attention_mask=region_mask.float(),
        train=train, generator=generator)

    with span("pretrain.loss"):
        # masked LM CE, the mean over the predicted positions (ref ignore_index = -1)
        logp = torch.log_softmax(linguistic_pred, dim=-1)
        tgt = masks.lm_labels.clamp(0, cfg.vocab_size - 1)
        ce = -logp.gather(-1, tgt[..., None])[..., 0]
        lm_mask = (masks.lm_labels >= 0).float()
        lm_loss = (ce * lm_mask).sum() / lm_mask.sum().clamp_min(1.0)

        # masked-region KL(target || prediction) over the masked regions
        vlogp = torch.log_softmax(vision_pred, dim=-1)
        kl = (region_targets * (torch.log(region_targets + 1e-9) - vlogp)).sum(-1)
        rg_mask = masks.region_sel.float()
        region_loss = (kl * rg_mask).sum() / rg_mask.sum().clamp_min(1.0)

        # alignment CE: is this instruction this path's?
        alogp = torch.log_softmax(seq_rel, dim=-1)
        align_loss = -alogp.gather(-1, align_labels[:, None].long()).mean()

        # the vil_logit alignment BCE: score_difficulty ranks by this head, which
        # no other term reaches
        vil = vil_logit[:, 0]
        lab = align_labels.float()
        vil_loss = (torch.clamp_min(vil, 0.0) - vil * lab
                    + torch.log1p(torch.exp(-vil.abs()))).mean()

        total = lm_loss + region_loss + align_loss + vil_loss
        logs = {"loss": total, "lm_loss": lm_loss, "region_loss": region_loss,
                "align_loss": align_loss, "vil_loss": vil_loss}
        return total, logs


@dataclasses.dataclass
class PretrainCounters:
    """What the pretrainer's steps trained, in all: steps and pairs; of the
    batches that carry their host-side lengths (``PretrainBatch``), the
    text positions and the padded ones among them, counted on the host
    from those lengths (no sync); and the masked tokens and regions,
    summed on the device (``masked`` reads them, one sync)."""

    steps: int = 0
    pairs: int = 0
    text_positions: int = 0
    pad_positions: int = 0
    masked_sums: Optional[torch.Tensor] = None  # [masked tokens, masked regions] on the device

    def add(self, batch: dict, masks: PretrainMasks) -> None:
        B, L = batch["tokens"].shape
        self.steps += 1
        self.pairs += B
        lengths = getattr(batch, "text_lengths", None)
        if lengths is not None:
            self.text_positions += B * L
            self.pad_positions += B * L - int(lengths.sum())
        sums = torch.stack([(masks.lm_labels >= 0).sum(), masks.region_sel.sum()])
        self.masked_sums = sums if self.masked_sums is None else self.masked_sums + sums

    def masked(self) -> Tuple[int, int]:
        """(masked tokens, masked regions) so far."""
        if self.masked_sums is None:
            return 0, 0
        tokens, regions = self.masked_sums.tolist()
        return int(tokens), int(regions)


class VLNBertPretrainer:
    """The multi-modal pretraining loop: Adam in optax's form, no clip."""

    def __init__(self, cfg: VilBertConfig, mask_idx: int, lr: float = 1e-4,
                 mask_p: float = 0.15, region_p: float = 0.15):
        self.cfg = cfg
        self.lr = lr
        self.mask_idx, self.mask_p, self.region_p = mask_idx, mask_p, region_p
        self.counters = PretrainCounters()

    def init(self, generator: torch.Generator, device=None) -> Tuple[dict, ClippedAdam]:
        """Seeded f32 parameters on ``device`` as trainable leaves, and the
        optimizer over them."""
        params = tree_map(lambda t: t.to(device).requires_grad_(True),
                          vlnbert_init(generator, self.cfg))
        return params, ClippedAdam(tree_leaves(params), self.lr, max_norm=None)

    def step(self, params: dict, optimizer: ClippedAdam, batch: dict,
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """One update, ``params`` changed in place, counted in
        ``counters``; the logs stay on the device."""
        with span("iter"):
            masks = draw_pretrain_masks(generator, batch["tokens"], batch["feats"],
                                        batch["region_mask"], self.cfg.vocab_size,
                                        self.mask_idx, self.mask_p, self.region_p)
            loss, logs = pretrain_loss(params, self.cfg, batch["tokens"], batch["locs"],
                                       batch["region_mask"], batch["region_targets"],
                                       batch["align_labels"], masks, True, generator)
            with span("update.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("update.optim"):
                optimizer.step()
            self.counters.add(batch, masks)
            return {k: v.detach() for k, v in logs.items()}

    def train(self, params: dict, optimizer: ClippedAdam, batches,
              generator: Optional[torch.Generator], log_every: int = 20):
        """Run through an iterable of batches, one generator drawing every
        step's masks and dropout; returns (params, optimizer, last logs)."""
        logs = None
        for i, batch in enumerate(batches):
            logs = self.step(params, optimizer, batch, generator)
            if log_every and (i + 1) % log_every == 0:
                logger.info("pretrain iter %d: %s", i + 1, {k: float(v) for k, v in logs.items()})
        return params, optimizer, logs


# ---------------------------------------------------------------------------
# Pretraining batches and CLR2R difficulty scoring over a compiled world
# ---------------------------------------------------------------------------

def views_along_path(world, global_nodes: Sequence[int]) -> List[int]:
    """The view index at each path node: the view toward the next node (the
    candidate table); the final node keeps the previous view."""
    views: List[int] = []
    for t in range(len(global_nodes) - 1):
        g, nxt = int(global_nodes[t]), int(global_nodes[t + 1])
        view = 12  # level default
        for j in range(int(world.n_cands[g])):
            if int(world.cand_next[g, j]) == nxt:
                view = int(world.cand_view[g, j])
                break
        views.append(view)
    views.append(views[-1] if views else 12)
    return views


class PathArrays(NamedTuple):
    """Host arrays of a list of expanded instruction items: what a batch
    holds but the features, which are gathered by (node, view)."""

    tokens: np.ndarray       # [n, Lt] int64
    nodes: np.ndarray        # [n, R] int64 global node ids, 0 past the path's end
    views: np.ndarray        # [n, R] int64
    locs: np.ndarray         # [n, R, 12] f32
    region_mask: np.ndarray  # [n, R] f32


def path_arrays(world, items: Sequence[dict], max_path_len: int) -> PathArrays:
    """The items' token ids, each path's nodes and views (``views_along_
    path``), locations and mask (``agents.vln_bert.path_locations``)."""
    from ..agents.vln_bert import path_locations

    n = len(items)
    tokens = np.zeros((n, len(items[0]["instr_encoding"])), np.int64)
    nodes = np.zeros((n, max_path_len), np.int64)
    views = np.zeros((n, max_path_len), np.int64)
    locs = np.zeros((n, max_path_len, 12), np.float32)
    region_mask = np.zeros((n, max_path_len), np.float32)
    for i, item in enumerate(items):
        tokens[i] = item["instr_encoding"]
        path = [world.global_id(item["scan"], vp) for vp in item["path"]][:max_path_len]
        path_views = views_along_path(world, path)
        nodes[i, :len(path)], views[i, :len(path)] = path, path_views
        locs[i], region_mask[i] = path_locations(world, path, path_views, max_path_len)
    return PathArrays(tokens, nodes, views, locs, region_mask)


def pretrain_arrays(world, items: Sequence[dict], tok, max_path_len: int, feat_dim: int,
                    region_classes: Optional[np.ndarray] = None,
                    n_region_classes: Optional[int] = None):
    """(tokens, feats, locs, region_mask, region_targets) numpy arrays of a
    list of expanded instruction items, the features gathered from the
    host's ``world.features``.  ``region_classes`` ([num_nodes] int, e.g.
    grounded room types) become one-hot region targets; without them the
    targets are uniform (the region loss inert, as the reference without
    region labels)."""
    a = path_arrays(world, items, max_path_len)
    valid = a.region_mask[..., None] > 0
    feats = np.where(valid, world.features[a.nodes, a.views, :feat_dim], 0.0).astype(np.float32)
    k = n_region_classes or (int(region_classes.max()) + 1 if region_classes is not None else 2)
    targets = np.full(a.region_mask.shape + (k,), 1.0 / k, np.float32)
    if region_classes is not None:
        targets = np.where(valid, np.eye(k, dtype=np.float32)[region_classes[a.nodes]], targets)
    return a.tokens, feats, a.locs, a.region_mask, targets


def gather_features(table: torch.Tensor, nodes: torch.Tensor, views: torch.Tensor,
                    region_mask: torch.Tensor, feat_dim: int) -> torch.Tensor:
    """[..., feat_dim] f32 rows of the feature table [N, V, >= feat_dim] at
    (nodes, views), on the table's device; zero where ``region_mask`` is 0."""
    rows = table[nodes, views, :feat_dim].float()
    return torch.where(region_mask[..., None] > 0, rows, 0.0)


class PretrainBatch(dict):
    """A batch dict of tensors that also holds its instructions' host-side
    lengths (``text_lengths``, the non-padding tokens), for
    ``PretrainCounters`` to count without a sync."""

    def __init__(self, tensors: dict, text_lengths: np.ndarray):
        super().__init__(tensors)
        self.text_lengths = text_lengths


def pretrain_batches(world, items: Sequence[dict], tok, batch_size: int, max_path_len: int,
                     feat_dim: int, node_targets: torch.Tensor, epochs: int = 1, seed: int = 0,
                     mismatch_p: float = 0.5, device=None,
                     features: Optional[torch.Tensor] = None):
    """Pretraining batches (``PretrainBatch``) of tensors on ``device``
    (default CUDA; raises without it), in the JAX package's order (a numpy
    generator of ``seed``); ``mismatch_p`` of the rows get another item's
    instruction (alignment label 0).

    The items' host arrays (``path_arrays``) go to the device once; a
    batch uploads its row numbers and gathers its rows there, the
    features by (node, view) from ``features`` ([num_nodes, views, D] on
    the device, any float type; default ``world.features``) and the
    region targets by node from ``node_targets`` ([num_nodes, K] on the
    device: one-hot region classes, or uniform rows where the world has
    none), uniform past a path's end."""
    from ..world.compiler import resolve_device

    device = resolve_device(device)
    a = path_arrays(world, items, max_path_len)
    n = len(items)
    rng = np.random.default_rng(seed)
    text_lengths = (a.tokens != PAD_IDX).sum(axis=1)
    on = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in a._asdict().items()}
    table = features if features is not None else torch.from_numpy(world.features).to(device)
    k = node_targets.shape[1]

    def upload(rows: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(rows)
        if device.type == "cuda":  # pinned, so that the copy does not wait for the stream
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)

    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n - batch_size + 1, batch_size):
            idx = order[s: s + batch_size]
            text_rows = idx.copy()
            labels = np.ones(batch_size, np.int64)
            swap = rng.random(batch_size) < mismatch_p
            for b in np.where(swap)[0]:
                j = int(rng.integers(n - 1))
                text_rows[b] = j + (j >= idx[b])  # any other item
                labels[b] = 0
            with span("pretrain.batch"):
                rows, t_rows, labels_d = upload(np.stack([idx, text_rows, labels])).unbind(0)
                mask = on["region_mask"][rows]
                nodes = on["nodes"][rows]
                targets = torch.where(mask[..., None] > 0, node_targets[nodes].float(),
                                      torch.full(mask.shape + (k,), 1.0 / k, device=device))
                batch = PretrainBatch(
                    {"tokens": on["tokens"][t_rows],
                     "feats": gather_features(table, nodes, on["views"][rows], mask, feat_dim),
                     "locs": on["locs"][rows], "region_mask": mask, "region_targets": targets,
                     "align_labels": labels_d},
                    text_lengths[text_rows])
            yield batch


def score_difficulty(scorer, params, world, items: Sequence[dict], tok, max_path_len: int,
                     feat_dim: int, batch_size: int = 32, mesh=None) -> np.ndarray:
    """The path-instruction compatibility logit of each item (higher =
    easier; the paper's CLR2R difficulty signal), in batches of
    ``batch_size`` (the last one padded) on the device of ``params``, the
    features gathered there by (node, view) from ``world.features``.

    Over a process group's ``mesh`` (parallel/mesh.py) each batch is padded
    to a multiple of the data axis (``pad_batch_to_devices``) and its rows
    split over it, the scorer's heads and FFN columns over the model axis
    (parallel/vilbert_sharding.py), and every rank gathers every score;
    without one, as above."""
    mesh = mesh if mesh is not None else M.make_mesh()
    tp = S.tensor_parallel(mesh)
    local = S.shard_vilbert_params(params, mesh) if tp is not None else params
    batch_size = M.pad_batch_to_devices(batch_size, mesh)
    mine = M.batch_rows(mesh, batch_size)
    a = path_arrays(world, items, max_path_len)
    device = tree_leaves(params)[0].device
    table = torch.from_numpy(world.features).to(device)
    out = np.zeros(len(items), np.float32)
    for s in range(0, len(items), batch_size):
        e = min(s + batch_size, len(items))
        pad = batch_size - (e - s)

        def rows(x):
            return torch.from_numpy(np.pad(x[s:e], [(0, pad)] + [(0, 0)] * (x.ndim - 1))[mine]
                                    ).to(device)

        t, nodes, views, l, m = (rows(x) for x in a)
        f = gather_features(table, nodes, views, m, feat_dim)
        vals = scorer.score_paths(local, t, f, l, (t != PAD_IDX).float(), m, tp=tp)
        with M.sharded_step(mesh):
            vals = M.gather_rows(vals.float())  # every data rank's rows, in order
        out[s:e] = vals.cpu().numpy()[: e - s]
    return out


def make_clr2r_rounds(items: Sequence[dict], scores: np.ndarray,
                      n_rounds: int = 5) -> Dict[str, List[dict]]:
    """Cut the items into difficulty rounds, the easiest (highest score)
    first: the CLR2R round files the reference consumes (ref:
    curriculum_env.py:44-62)."""
    order = np.argsort(-scores, kind="stable")
    rounds: Dict[str, List[dict]] = {}
    per = max(1, len(items) // n_rounds)
    for k in range(1, n_rounds + 1):
        lo = (k - 1) * per
        hi = k * per if k < n_rounds else len(items)
        rounds[f"round_{k}"] = [items[int(i)] for i in order[lo:hi]]
    return rounds
