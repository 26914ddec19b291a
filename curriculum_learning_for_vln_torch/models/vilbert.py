"""Two-stream ViLBERT with the VLN modifications: functions over parameter
dicts of tensors.

The port of ``curriculum_learning_for_vln_tpu/models/vilbert.py`` (ref:
tasks/R2R-judy/src/model/vilbert.py and the path-scoring head
src/agent/vln_bert.py:11-75), with the JAX package's parameter names and
layouts, so a JAX tree converts leaf for leaf (convert.py, tree kind
"VILBERT"):

* a text stream (BERT layers) and a vision stream (image BERT layers),
  erf-form GELU FFNs and post-LN residuals;
* co-attention connection layers (BertBiAttention + BertBiOutput + both
  streams' FFNs) interleaved at the configured biattention layer ids, the
  fixed-layer no-grad ranges as ``detach`` (vilbert.py:758-895);
* the VLN image embeddings: location (5) + orientation (4) + next
  orientation (2) + a sequence-position embedding of 32 (vilbert.py:
  1398-1428);
* additive -10000 attention masks in f32 and the co-attention mask scaled
  by 5.0 (vilbert.py:1340-1375);
* first-token (or masked-mean) ReLU poolers to bi_hidden, the pretraining
  heads with the LM decoder tied to the word embedding, and the vil_logit
  path-selection head with sum or mul fusion.

The precision contract is the JAX package's: LayerNorm statistics in f32
(eps 1e-12) with the output in the input's dtype; attention scores in
the activations' dtype plus the f32 mask, the softmax in f32 and its
probabilities back in the value dtype, so under bf16 parameters every
product stays bf16.  Attention is plain ``torch.einsum``: the JAX package
computes it outside any Pallas kernel, and ``scaled_dot_product_attention``
does not keep the f32-softmax, bf16-probability contract.  At train=True
every dropout site draws its mask from ``generator``.  With ``tp`` (a
``parallel.vilbert_sharding.TensorParallel`` over parameters cut by
``shard_vilbert_params``) a rank runs its share of the heads and of the
FFN columns, and sums each row-parallel product over the model group
before its bias (scoring, train=False).
``convert_torch_state_dict`` maps reference (HF-style) checkpoint tensors
onto the tree.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .core import dense, dropout


@dataclasses.dataclass
class VilBertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 768
    v_num_hidden_layers: int = 3
    v_num_attention_heads: int = 12
    v_intermediate_size: int = 3072
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 16
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_dropout_prob: float = 0.1
    v_biattention_id: Tuple[int, ...] = (0, 1)
    t_biattention_id: Tuple[int, ...] = (10, 11)
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    fusion_method: str = "mul"
    with_coattention: bool = True
    # "first" pools position 0 of each stream (reference parity,
    # vilbert.py:970-996); "mean" is the masked mean over the valid
    # positions, which small models pretrained from scratch need (position
    # 0 holds a constant [CLS]/<BOS> embedding there, a saddle).
    pool_method: str = "first"

    def __post_init__(self):
        assert len(self.v_biattention_id) == len(self.t_biattention_id)
        assert max(self.v_biattention_id) < self.v_num_hidden_layers
        assert max(self.t_biattention_id) < self.num_hidden_layers

    # -- (de)serialisation, the reference BertConfig contract
    # (ref: vilbert.py:129-272 from_dict/from_json_file/to_dict/to_json_string)
    @classmethod
    def from_dict(cls, json_object: dict) -> "VilBertConfig":
        """The config of a published ViLBERT JSON (vilbert_beta's
        ``config/*.json``) or of ``to_dict``.  The published keys the
        dataclass does not hold are read: ``pooling_method`` is
        ``fusion_method``; ``hidden_act`` / ``v_hidden_act`` must be "gelu"
        (the erf GELU every layer computes) and ``bi_attention_type`` 1 (the
        scaled dot-product co-attention), else it raises;
        ``bi_intermediate_size`` and ``v_initializer_range`` are read by no
        layer of the published code either (the connection layer runs each
        stream's own FFN width, the init reads ``initializer_range``).  Other
        keys (a Hugging Face file's extras) are left out."""
        d = dict(json_object)
        for key in ("hidden_act", "v_hidden_act"):
            if d.pop(key, "gelu") != "gelu":
                raise ValueError(f"{key} {json_object[key]!r}: the port computes the erf GELU "
                                 "alone ('gelu')")
        if d.pop("bi_attention_type", 1) != 1:
            raise ValueError(f"bi_attention_type {json_object['bi_attention_type']!r}: the port "
                             "computes the scaled dot-product co-attention alone (1)")
        if "pooling_method" in d:
            pooling = d.pop("pooling_method")
            if d.setdefault("fusion_method", pooling) != pooling:
                raise ValueError(f"pooling_method {pooling!r} and fusion_method "
                                 f"{d['fusion_method']!r} disagree")
        if d.get("fusion_method", "mul") not in ("sum", "mul"):
            raise ValueError(f"pooling_method / fusion_method {d['fusion_method']!r}: 'sum' or "
                             "'mul'")
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k in known:
                if k in ("v_biattention_id", "t_biattention_id"):
                    v = tuple(v)
                kwargs[k] = v
        return cls(**kwargs)

    @classmethod
    def from_json_file(cls, json_file: str) -> "VilBertConfig":
        import json

        with open(json_file, encoding="utf-8") as f:
            return cls.from_dict(json.loads(f.read()))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["v_biattention_id"] = list(d["v_biattention_id"])
        d["t_biattention_id"] = list(d["t_biattention_id"])
        return d

    def to_json_string(self) -> str:
        import json

        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"


def _normal_init(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def _linear_init(gen: torch.Generator, din: int, dout: int, std: float) -> dict:
    return {"w": _normal_init(gen, (din, dout), std), "b": torch.zeros(dout)}


def _ln_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Statistics in f32 whatever the dtype of x, the output back in it
    (vilbert.py:129-137); ``F.layer_norm`` on bf16 input is not this."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"].float()
    return (y + p["bias"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _attention_init(gen: torch.Generator, q_dim: int, kv_dim: int, std: float) -> dict:
    return {
        "query": _linear_init(gen, q_dim, q_dim, std),
        "key": _linear_init(gen, kv_dim, q_dim, std),
        "value": _linear_init(gen, kv_dim, q_dim, std),
    }


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, heads, D // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, h, L, hd = x.shape
    return x.transpose(1, 2).reshape(B, L, h * hd)


def _attend(q, k, v, masks, drop: float, train: bool, generator):
    """softmax(q k^T / sqrt(hd) + masks) v over heads [B, h, L, hd]: the
    scores in the activations' dtype plus the f32 additive masks, one
    after the other (the first promotes), the softmax in f32, the
    probabilities in v's dtype.  q and k meet in their promoted dtype, as
    jnp.einsum promotes (the co-attention pairs a bf16 text stream with a
    vision stream that f32 locations promoted)."""
    dtype = torch.promote_types(q.dtype, k.dtype)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(dtype), k.to(dtype)) / math.sqrt(q.shape[-1])
    for mask in masks:
        scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    probs = dropout(probs, drop, train, generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _row_dense(p: dict, x: torch.Tensor, tp) -> torch.Tensor:
    """``dense`` of a row-parallel layer: with ``tp``, this rank's input
    features times its rows of w, summed over the model group, then the
    bias, once."""
    if tp is None:
        return dense(p, x)
    dtype = torch.promote_types(x.dtype, p["w"].dtype)
    return tp.reduce(x.to(dtype) @ p["w"].to(dtype)) + p["b"].to(dtype)


def _mha(p: dict, q_x, kv_x, heads: int, mask, train: bool, drop: float, generator):
    """``heads``: this rank's heads (all of them without tensor parallelism)."""
    q = _split_heads(dense(p["query"], q_x), heads)
    k = _split_heads(dense(p["key"], kv_x), heads)
    v = _split_heads(dense(p["value"], kv_x), heads)
    return _merge_heads(_attend(q, k, v, () if mask is None else (mask,), drop, train,
                                generator))


def _bert_layer_init(gen: torch.Generator, hidden: int, inter: int, std: float) -> dict:
    return {
        "attn": _attention_init(gen, hidden, hidden, std),
        "attn_out": _linear_init(gen, hidden, hidden, std),
        "attn_ln": _ln_init(hidden),
        "inter": _linear_init(gen, hidden, inter, std),
        "out": _linear_init(gen, inter, hidden, std),
        "out_ln": _ln_init(hidden),
    }


def _bert_layer(p: dict, x, mask, heads: int, train: bool, drop_h: float, drop_a: float,
                generator, tp=None):
    ctx = _mha(p["attn"], x, x, heads // (tp.size if tp else 1), mask, train, drop_a, generator)
    ctx = dropout(_row_dense(p["attn_out"], ctx, tp), drop_h, train, generator)
    x = layer_norm(p["attn_ln"], x + ctx)
    h = gelu(dense(p["inter"], x))
    h = dropout(_row_dense(p["out"], h, tp), drop_h, train, generator)
    return layer_norm(p["out_ln"], x + h)


def _connection_layer_init(gen: torch.Generator, cfg: VilBertConfig) -> dict:
    std = cfg.initializer_range
    bi = cfg.bi_hidden_size
    return {
        # biattention (vilbert.py:589-700): stream 1 = vision, stream 2 = text
        "q1": _linear_init(gen, cfg.v_hidden_size, bi, std),
        "k1": _linear_init(gen, cfg.v_hidden_size, bi, std),
        "v1": _linear_init(gen, cfg.v_hidden_size, bi, std),
        "q2": _linear_init(gen, cfg.hidden_size, bi, std),
        "k2": _linear_init(gen, cfg.hidden_size, bi, std),
        "v2": _linear_init(gen, cfg.hidden_size, bi, std),
        # biOutput (vilbert.py:698-726)
        "dense1": _linear_init(gen, bi, cfg.v_hidden_size, std),
        "ln1": _ln_init(cfg.v_hidden_size),
        "dense2": _linear_init(gen, bi, cfg.hidden_size, std),
        "ln2": _ln_init(cfg.hidden_size),
        # per-stream FFNs
        "v_inter": _linear_init(gen, cfg.v_hidden_size, cfg.v_intermediate_size, std),
        "v_out": _linear_init(gen, cfg.v_intermediate_size, cfg.v_hidden_size, std),
        "v_ln": _ln_init(cfg.v_hidden_size),
        "t_inter": _linear_init(gen, cfg.hidden_size, cfg.intermediate_size, std),
        "t_out": _linear_init(gen, cfg.intermediate_size, cfg.hidden_size, std),
        "t_ln": _ln_init(cfg.hidden_size),
    }


def _connection_layer(p: dict, cfg: VilBertConfig, v_x, v_mask, t_x, t_mask, co_mask,
                      train: bool, generator, tp=None):
    heads = cfg.bi_num_attention_heads // (tp.size if tp else 1)
    q1, k1, v1 = (_split_heads(dense(p[n], v_x), heads) for n in ("q1", "k1", "v1"))
    q2, k2, v2 = (_split_heads(dense(p[n], t_x), heads) for n in ("q2", "k2", "v2"))

    # text queries attend to vision (ctx1), vision queries to text (ctx2)
    m1 = (v_mask,) if co_mask is None else (v_mask, co_mask.transpose(-1, -2))
    ctx1 = _merge_heads(_attend(q2, k1, v1, m1, cfg.v_attention_probs_dropout_prob, train,
                                generator))
    m2 = (t_mask,) if co_mask is None else (t_mask, co_mask)
    ctx2 = _merge_heads(_attend(q1, k2, v2, m2, cfg.attention_probs_dropout_prob, train,
                                generator))

    # biOutput: ctx2 (text-informed) to the vision stream, ctx1 to the text stream
    v_res = dropout(_row_dense(p["dense1"], ctx2, tp), cfg.v_hidden_dropout_prob, train,
                    generator)
    v_att = layer_norm(p["ln1"], v_res + v_x)
    t_res = dropout(_row_dense(p["dense2"], ctx1, tp), cfg.hidden_dropout_prob, train,
                    generator)
    t_att = layer_norm(p["ln2"], t_res + t_x)

    v_h = gelu(dense(p["v_inter"], v_att))
    v_h = dropout(_row_dense(p["v_out"], v_h, tp), cfg.v_hidden_dropout_prob, train, generator)
    v_out = layer_norm(p["v_ln"], v_att + v_h)
    t_h = gelu(dense(p["t_inter"], t_att))
    t_h = dropout(_row_dense(p["t_out"], t_h, tp), cfg.hidden_dropout_prob, train, generator)
    t_out = layer_norm(p["t_ln"], t_att + t_h)
    return v_out, t_out


# ---------------------------------------------------------------------------
# The full model
# ---------------------------------------------------------------------------

def vilbert_init(generator: torch.Generator, cfg: VilBertConfig) -> dict:
    """Seeded f32 parameters on the CPU: normal(0, initializer_range)
    weights, zero biases, unit LayerNorm scales."""
    std = cfg.initializer_range
    g = generator
    return {
        "embeddings": {
            "word": _normal_init(g, (cfg.vocab_size, cfg.hidden_size), std),
            "position": _normal_init(g, (cfg.max_position_embeddings, cfg.hidden_size), std),
            "token_type": _normal_init(g, (cfg.type_vocab_size, cfg.hidden_size), std),
            "ln": _ln_init(cfg.hidden_size),
        },
        "v_embeddings": {  # the VLN image embeddings (vilbert.py:1398-1428)
            "image": _linear_init(g, cfg.v_feature_size, cfg.v_hidden_size, std),
            "location": _linear_init(g, 5, cfg.v_hidden_size, std),
            "orientation": _linear_init(g, 4, cfg.v_hidden_size, std),
            "next_orientation": _linear_init(g, 2, cfg.v_hidden_size, std),
            "sequence": _normal_init(g, (32, cfg.v_hidden_size), std),
            "ln": _ln_init(cfg.v_hidden_size),
        },
        "t_layers": [_bert_layer_init(g, cfg.hidden_size, cfg.intermediate_size, std)
                     for _ in range(cfg.num_hidden_layers)],
        "v_layers": [_bert_layer_init(g, cfg.v_hidden_size, cfg.v_intermediate_size, std)
                     for _ in range(cfg.v_num_hidden_layers)],
        "c_layers": [_connection_layer_init(g, cfg) for _ in range(len(cfg.v_biattention_id))],
        "t_pooler": _linear_init(g, cfg.hidden_size, cfg.bi_hidden_size, std),
        "v_pooler": _linear_init(g, cfg.v_hidden_size, cfg.bi_hidden_size, std),
    }


def vilbert_apply(
    params: dict,
    cfg: VilBertConfig,
    input_txt: torch.Tensor,            # [B, Lt] int
    input_imgs: torch.Tensor,           # [B, Lv, v_feature_size]
    image_loc: torch.Tensor,            # [B, Lv, 12] (5 loc + 4 orient + 2 next + 1 seq-pos)
    token_type_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,        # [B, Lt] 1 = attend
    image_attention_mask: Optional[torch.Tensor] = None,  # [B, Lv]
    co_attention_mask: Optional[torch.Tensor] = None,     # [B, Lv, Lt]
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    tp=None,
):
    """Returns (seq_t, seq_v, pooled_t, pooled_v); with ``tp`` over this
    rank's slices of the parameters (tensor-parallel scoring)."""
    if tp is not None and train:
        raise ValueError("tensor-parallel ViLBERT scores (train=False); it trains replicated")
    B, Lt = input_txt.shape
    Lv = input_imgs.shape[1]
    dev = input_txt.device
    if attention_mask is None:
        attention_mask = torch.ones((B, Lt), device=dev)
    if token_type_ids is None:
        token_type_ids = torch.zeros((B, Lt), dtype=torch.long, device=dev)
    if image_attention_mask is None:
        image_attention_mask = torch.ones((B, Lv), device=dev)

    # additive masks in f32 (vilbert.py:1340-1362)
    t_mask = (1.0 - attention_mask[:, None, None, :].float()) * -10000.0
    v_mask = (1.0 - image_attention_mask[:, None, None, :].float()) * -10000.0
    co_mask = None
    if co_attention_mask is not None:
        co_mask = co_attention_mask[:, None].float() * 5.0  # (vilbert.py:1369)

    with span("vilbert.embed"):
        # every lookup through F.embedding: its backward sums an id's rows in
        # parallel, where indexing's walks them one by one (the padding id's
        # thousands; the one token type of every position)
        emb = params["embeddings"]
        t_x = (F.embedding(input_txt, emb["word"])
               + emb["position"][:Lt][None]
               + F.embedding(token_type_ids, emb["token_type"]))
        t_x = dropout(layer_norm(emb["ln"], t_x), cfg.hidden_dropout_prob, train, generator)

        ve = params["v_embeddings"]
        v_img = dense(ve["image"], input_imgs)
        v_loc = (dense(ve["location"], image_loc[..., :5])
                 + dense(ve["orientation"], image_loc[..., 5:9])
                 + dense(ve["next_orientation"], image_loc[..., 9:11])
                 + F.embedding(image_loc[..., 11].long(), ve["sequence"]))
        v_x = dropout(layer_norm(ve["ln"], v_img + v_loc), cfg.hidden_dropout_prob, train,
                      generator)

    def v_layer(idx, v_x):
        with span("vilbert.vision"):
            return _bert_layer(params["v_layers"][idx], v_x, v_mask, cfg.v_num_attention_heads,
                               train, cfg.v_hidden_dropout_prob,
                               cfg.v_attention_probs_dropout_prob, generator, tp)

    def t_layer(idx, t_x):
        with span("vilbert.text"):
            return _bert_layer(params["t_layers"][idx], t_x, t_mask, cfg.num_attention_heads,
                               train, cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob,
                               generator, tp)

    # the interleaved encoder (vilbert.py:758-895)
    v_start = t_start = 0
    for count, (v_end, t_end) in enumerate(zip(cfg.v_biattention_id, cfg.t_biattention_id)):
        for idx in range(v_start, v_end):
            v_x = v_layer(idx, v_x)
            if idx < cfg.fixed_v_layer:
                v_x = v_x.detach()
        for idx in range(t_start, t_end):
            t_x = t_layer(idx, t_x)
            if idx < cfg.fixed_t_layer:
                t_x = t_x.detach()
        if cfg.with_coattention:
            with span("vilbert.coattn"):
                v_x, t_x = _connection_layer(params["c_layers"][count], cfg, v_x, v_mask, t_x,
                                             t_mask, co_mask, train, generator, tp)
        v_start, t_start = v_end, t_end
    for idx in range(v_start, cfg.v_num_hidden_layers):
        v_x = v_layer(idx, v_x)
    for idx in range(t_start, cfg.num_hidden_layers):
        t_x = t_layer(idx, t_x)

    with span("vilbert.heads"):
        if cfg.pool_method == "mean":
            tm, vm = attention_mask.float(), image_attention_mask.float()
            t_in = (t_x * tm[..., None]).sum(1) / tm.sum(1, keepdim=True).clamp_min(1.0)
            v_in = (v_x * vm[..., None]).sum(1) / vm.sum(1, keepdim=True).clamp_min(1.0)
        else:  # "first": reference parity (vilbert.py:970-996)
            t_in, v_in = t_x[:, 0], v_x[:, 0]
        pooled_t = torch.relu(dense(params["t_pooler"], t_in))
        pooled_v = torch.relu(dense(params["v_pooler"], v_in))
    return t_x, v_x, pooled_t, pooled_v


# ---------------------------------------------------------------------------
# Heads and the VLNBert scorer (ref: vln_bert.py:11-75; vilbert.py:1007-1047)
# ---------------------------------------------------------------------------

def vlnbert_init(generator: torch.Generator, cfg: VilBertConfig) -> dict:
    std = cfg.initializer_range
    g = generator
    return {
        "bert": vilbert_init(g, cfg),
        "cls": {
            "transform": _linear_init(g, cfg.hidden_size, cfg.hidden_size, std),
            "transform_ln": _ln_init(cfg.hidden_size),
            "decoder_bias": torch.zeros(cfg.vocab_size),  # the decoder weight is the word emb
            "bi_seq_relationship": _linear_init(g, cfg.bi_hidden_size, 2, std),
            "v_transform": _linear_init(g, cfg.v_hidden_size, cfg.v_hidden_size, std),
            "v_transform_ln": _ln_init(cfg.v_hidden_size),
            "v_decoder": _linear_init(g, cfg.v_hidden_size, cfg.v_target_size, std),
        },
        "vil_logit": _linear_init(g, cfg.bi_hidden_size, 1, std),
    }


def vlnbert_apply(
    params: dict,
    cfg: VilBertConfig,
    instr_tokens: torch.Tensor,
    image_features: torch.Tensor,
    image_locations: torch.Tensor,
    token_type_ids=None,
    attention_mask=None,
    image_attention_mask=None,
    co_attention_mask=None,
    train: bool = False,
    dropout_prob: float = 0.1,
    compute_heads: bool = True,
    generator: Optional[torch.Generator] = None,
    tp=None,
):
    """Path-instruction compatibility scoring.  Returns (vil_logit [B, 1],
    vision_prediction, linguistic_prediction, seq_relationship [B, 2]).

    ``compute_heads=False`` skips the masked-LM and masked-region heads
    (both returned as None): difficulty scoring reads only vil_logit, and
    at reference width the tied LM decoder alone is about a quarter of the
    forward's operations."""
    seq_t, seq_v, pooled_t, pooled_v = vilbert_apply(
        params["bert"], cfg, instr_tokens, image_features, image_locations, token_type_ids,
        attention_mask, image_attention_mask, co_attention_mask, train=train,
        generator=generator, tp=tp)
    with span("vilbert.heads"):
        cls = params["cls"]
        linguistic_pred = vision_pred = None
        if compute_heads:
            # the LM head, its decoder tied to the word embedding
            h = layer_norm(cls["transform_ln"], gelu(dense(cls["transform"], seq_t)))
            word = params["bert"]["embeddings"]["word"]
            dtype = torch.promote_types(h.dtype, word.dtype)
            linguistic_pred = h.to(dtype) @ word.to(dtype).t() + cls["decoder_bias"].to(dtype)
            hv = layer_norm(cls["v_transform_ln"], gelu(dense(cls["v_transform"], seq_v)))
            vision_pred = dense(cls["v_decoder"], hv)
        # fusion and the path logit (vln_bert.py:60-69)
        if cfg.fusion_method == "sum":
            pooled = pooled_t + pooled_v
        elif cfg.fusion_method == "mul":
            pooled = pooled_t * pooled_v
        else:
            raise AssertionError(cfg.fusion_method)
        pooled = dropout(pooled, dropout_prob, train, generator)
        vil_logit = dense(params["vil_logit"], pooled)
        # the alignment (is-next-sentence analogue) head of pretraining
        # (ref: BertForMultiModalPreTraining, vilbert.py:1431-1513)
        seq_relationship = dense(cls["bi_seq_relationship"], pooled)
        return vil_logit, vision_pred, linguistic_pred, seq_relationship


# ---------------------------------------------------------------------------
# Reference (HF-style torch) checkpoint conversion
# ---------------------------------------------------------------------------

def vlnbert_from_pretrained(path_or_url: str, cfg: VilBertConfig,
                            generator: Optional[torch.Generator] = None,
                            cache_dir: Optional[str] = None) -> dict:
    """The reference ``from_pretrained`` (ref: vilbert.py:1049-1254):
    resolve through the cache layer (local path, file://, http(s), s3),
    load the torch state_dict (or an .npz of arrays), and lay it over a
    fresh parameter tree with ``convert_torch_state_dict``."""
    from .file_utils import cached_path

    resolved = cached_path(path_or_url, cache_dir)
    if resolved.endswith(".npz"):
        with np.load(resolved) as z:
            state_dict = {k: z[k] for k in z.files}
    else:
        sd = torch.load(resolved, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        state_dict = {k: v.numpy() for k, v in sd.items()}
    params = vlnbert_init(generator if generator is not None else torch.Generator().manual_seed(0),
                          cfg)
    return convert_torch_state_dict(state_dict, cfg, params)


_LAYER_MAP = {
    "attention.self.query": ("attn", "query"),
    "attention.self.key": ("attn", "key"),
    "attention.self.value": ("attn", "value"),
    "attention.output.dense": ("attn_out",),
    "attention.output.LayerNorm": ("attn_ln",),
    "intermediate.dense": ("inter",),
    "output.dense": ("out",),
    "output.LayerNorm": ("out_ln",),
}


def convert_torch_state_dict(state_dict: Dict[str, "np.ndarray"], cfg: VilBertConfig,
                             params: dict) -> dict:
    """Lay a torch ViLBERT state_dict (reference / HF naming) over a copy of
    a parameter tree; tensors it does not know are skipped (the reference's
    from_pretrained loads partially the same way)."""
    out = copy.deepcopy(params)

    def arr(v):
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return torch.from_numpy(np.array(a, copy=True))

    def set_linear(dst, prefix):
        if f"{prefix}.weight" in state_dict:
            dst["w"] = arr(state_dict[f"{prefix}.weight"]).t().contiguous()
        if f"{prefix}.bias" in state_dict:
            dst["b"] = arr(state_dict[f"{prefix}.bias"])

    def set_ln(dst, prefix):
        for torch_k, ours in (("weight", "scale"), ("gamma", "scale"),
                              ("bias", "bias"), ("beta", "bias")):
            if f"{prefix}.{torch_k}" in state_dict:
                dst[ours] = arr(state_dict[f"{prefix}.{torch_k}"])

    bert = out["bert"] if "bert" in out else out
    base = "bert." if any(k.startswith("bert.") for k in state_dict) else ""

    emb = bert["embeddings"]
    for name, key in (("word_embeddings", "word"), ("position_embeddings", "position"),
                      ("token_type_embeddings", "token_type")):
        k = f"{base}embeddings.{name}.weight"
        if k in state_dict:
            emb[key] = arr(state_dict[k])
    set_ln(emb["ln"], f"{base}embeddings.LayerNorm")

    ve = bert["v_embeddings"]
    set_linear(ve["image"], f"{base}v_embeddings.image_embeddings")
    set_linear(ve["location"], f"{base}v_embeddings.image_location_embeddings")
    set_linear(ve["orientation"], f"{base}v_embeddings.image_orientation_embeddings")
    set_linear(ve["next_orientation"], f"{base}v_embeddings.image_next_orientation_embeddings")
    k = f"{base}v_embeddings.image_sequence_embeddings.weight"
    if k in state_dict:
        ve["sequence"] = arr(state_dict[k])
    set_ln(ve["ln"], f"{base}v_embeddings.LayerNorm")

    for stream, count, torch_name in (("t_layers", cfg.num_hidden_layers, "encoder.layer"),
                                      ("v_layers", cfg.v_num_hidden_layers, "encoder.v_layer")):
        for i in range(count):
            for torch_sub, path in _LAYER_MAP.items():
                prefix = f"{base}{torch_name}.{i}.{torch_sub}"
                node = bert[stream][i]
                for pk in path[:-1]:
                    node = node[pk]
                leaf = node.get(path[-1])
                if leaf is None:
                    continue
                if "LayerNorm" in torch_sub or path[-1].endswith("ln"):
                    set_ln(leaf, prefix)
                else:
                    set_linear(leaf, prefix)

    # the biattention / connection layers
    cmap = {"biattention.query1": "q1", "biattention.key1": "k1", "biattention.value1": "v1",
            "biattention.query2": "q2", "biattention.key2": "k2", "biattention.value2": "v2",
            "biOutput.dense1": "dense1", "biOutput.dense2": "dense2",
            "v_intermediate.dense": "v_inter", "v_output.dense": "v_out",
            "t_intermediate.dense": "t_inter", "t_output.dense": "t_out"}
    lnmap = {"biOutput.LayerNorm1": "ln1", "biOutput.LayerNorm2": "ln2",
             "v_output.LayerNorm": "v_ln", "t_output.LayerNorm": "t_ln"}
    for i in range(len(cfg.v_biattention_id)):
        for torch_sub, ours in cmap.items():
            set_linear(bert["c_layers"][i][ours], f"{base}encoder.c_layer.{i}.{torch_sub}")
        for torch_sub, ours in lnmap.items():
            set_ln(bert["c_layers"][i][ours], f"{base}encoder.c_layer.{i}.{torch_sub}")

    set_linear(bert["t_pooler"], f"{base}t_pooler.dense")
    set_linear(bert["v_pooler"], f"{base}v_pooler.dense")

    if "cls" in out:
        cls = out["cls"]
        set_linear(cls["transform"], "cls.predictions.transform.dense")
        set_ln(cls["transform_ln"], "cls.predictions.transform.LayerNorm")
        if "cls.predictions.bias" in state_dict:
            cls["decoder_bias"] = arr(state_dict["cls.predictions.bias"])
        set_linear(cls["bi_seq_relationship"], "cls.bi_seq_relationship")
        set_linear(cls["v_transform"], "cls.imagePredictions.transform.dense")
        set_ln(cls["v_transform_ln"], "cls.imagePredictions.transform.LayerNorm")
        set_linear(cls["v_decoder"], "cls.imagePredictions.decoder")
    if "vil_logit" in out:
        set_linear(out["vil_logit"], "vil_logit")
    return out
