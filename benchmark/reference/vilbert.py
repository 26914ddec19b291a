"""ViLBERT multi-modal pretraining in plain float32: the forward, the loss
given the draws, the gradients by autograd, one Adam step.

The published model (Lu et al., "ViLBERT", NeurIPS 2019; the code of
github.com/jiasenlu/vilbert_beta, ``vilbert/vilbert.py``) as its
configuration file sets it: a BERT text stream, an image stream, and
co-attention layers interleaved at ``v_biattention_id`` /
``t_biattention_id``: before co-attention layer k, the vision layers from
the previous id up to ``v_biattention_id[k]`` and the text layers up to
``t_biattention_id[k]``; after the last, the rest of each stream.  A
co-attention layer (``BertConnectionLayer``): each stream's queries
against the other's keys and values at ``bi_hidden_size`` (text queries
first, their probabilities dropped at the image stream's rate), each
context projected back to the other stream with a residual and a
LayerNorm, then each stream's own FFN.  Post-LN residuals, LayerNorm eps
1e-12, the erf GELU, additive -10000 attention masks, first-token ReLU
poolers to ``bi_hidden_size``, the LM decoder tied to the word embedding.

Where this departs from vilbert_beta, it follows the program under test,
which follows the curriculum paper's repository (IMNearth/Curriculum-
Learning-For-VLN, ``src/model/vilbert.py`` and ``src/agent/vln_bert.py``):

* the image embeddings are the VLN ones (vilbert.py:1398-1428 there): the
  feature's linear map plus linear maps of the 5-d location, the 4-d
  orientation and the 2-d next orientation and a 32-row table of the
  step index, where vilbert_beta maps a 5-d box;
* the pooled streams are fused (``pooling_method`` "mul": their product)
  and dropped out once, and both the alignment head and VLN-BERT's
  ``vil_logit`` read the result; the loss adds ``vil_logit``'s alignment
  BCE to the masked LM CE, the masked-region KL and the alignment CE;
* masking: ids below 4 are never masked (the tokenizer's specials, where
  vilbert_beta's data loader skips [CLS] and [SEP]); a random replacement
  word is drawn from ids 4 and up; every masked region's feature is
  zeroed (vilbert_beta leaves 10% as they were);
* no token types but 0, no co-attention mask (the VLN data has none).

The parameters are a nested dict in the program's layout (its checkpoint
names: ``bert.t_layers[i].attn.query.w`` [in, out] and so on); nothing of
the program is imported.  Every matrix product goes through ``q`` (the
identity; a narrower type's round trip for the control, ``nets.
quantizer``).  The random draws (``Draws``) are the program's own, in its
order: the token masks' two uniforms and random words, the region
masks' uniform, then one uniform a dropout site, each taken by the site
of its shape.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

Q = Callable[[torch.Tensor], torch.Tensor]
N_SPECIAL = 4


class Draws:
    """The program's recorded draws, handed out in order; a site that gets
    a draw of another shape raises (the orders differ)."""

    def __init__(self, draws: List[torch.Tensor], device):
        self.draws, self.device, self.i = draws, device, 0

    def take(self, shape) -> torch.Tensor:
        if self.i >= len(self.draws):
            raise RuntimeError(f"no recorded draw left for a site of shape {tuple(shape)}")
        d = self.draws[self.i]
        if tuple(d.shape) != tuple(shape):
            raise RuntimeError(f"draw {self.i} has shape {tuple(d.shape)}, the site wants "
                               f"{tuple(shape)}")
        self.i += 1
        return d.to(self.device)

    def done(self) -> bool:
        return self.i == len(self.draws)


def dropout(x: torch.Tensor, rate: float, draws: Optional[Draws]) -> torch.Tensor:
    """Inverted dropout, kept where the site's uniform is below 1 - rate."""
    if draws is None or rate == 0.0:
        return x
    keep = draws.take(x.shape) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def linear(q: Q, p: dict, x: torch.Tensor) -> torch.Tensor:
    return q(x) @ q(p["w"]) + p["b"]


def layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], 1e-12)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, n, D // n).permute(0, 2, 1, 3)


def attend(q: Q, query, key, value, n: int, mask, rate: float, draws) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d) + mask) V over ``n`` heads, probabilities
    dropped out; [B, Lq, n d]."""
    qh, kh, vh = heads(query, n), heads(key, n), heads(value, n)
    scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(qh.shape[-1]) + mask
    probs = dropout(torch.softmax(scores, dim=-1), rate, draws)
    ctx = q(probs) @ q(vh)
    B, _, Lq, d = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(B, Lq, n * d)


def bert_layer(q: Q, p: dict, x, mask, n: int, rate_h: float, rate_a: float, draws):
    """BertLayer / BertImageLayer: self-attention, output, FFN."""
    a = p["attn"]
    ctx = attend(q, linear(q, a["query"], x), linear(q, a["key"], x), linear(q, a["value"], x),
                 n, mask, rate_a, draws)
    x = layer_norm(p["attn_ln"], x + dropout(linear(q, p["attn_out"], ctx), rate_h, draws))
    h = dropout(linear(q, p["out"], gelu(linear(q, p["inter"], x))), rate_h, draws)
    return layer_norm(p["out_ln"], x + h)


def connection_layer(q: Q, p: dict, c: dict, v, v_mask, t, t_mask, draws):
    """BertConnectionLayer: BertBiAttention, BertBiOutput, both FFNs."""
    n = c["bi_num_attention_heads"]
    # text queries against the image's keys and values, then image queries against text's
    ctx_t = attend(q, linear(q, p["q2"], t), linear(q, p["k1"], v), linear(q, p["v1"], v), n,
                   v_mask, c["v_attention_probs_dropout_prob"], draws)
    ctx_v = attend(q, linear(q, p["q1"], v), linear(q, p["k2"], t), linear(q, p["v2"], t), n,
                   t_mask, c["attention_probs_dropout_prob"], draws)
    v = layer_norm(p["ln1"], dropout(linear(q, p["dense1"], ctx_v), c["v_hidden_dropout_prob"],
                                     draws) + v)
    t = layer_norm(p["ln2"], dropout(linear(q, p["dense2"], ctx_t), c["hidden_dropout_prob"],
                                     draws) + t)
    vh = dropout(linear(q, p["v_out"], gelu(linear(q, p["v_inter"], v))),
                 c["v_hidden_dropout_prob"], draws)
    v = layer_norm(p["v_ln"], v + vh)
    th = dropout(linear(q, p["t_out"], gelu(linear(q, p["t_inter"], t))),
                 c["hidden_dropout_prob"], draws)
    return v, layer_norm(p["t_ln"], t + th)


def forward(q: Q, params: dict, c: dict, tokens, feats, locs, text_mask, region_mask,
            draws: Optional[Draws]):
    """(LM logits [B, Lt, vocab], region logits [B, R, targets], alignment
    logits [B, 2], vil_logit [B]) of the published model, ``c`` its
    configuration file's keys."""
    b = params["bert"]
    B, Lt = tokens.shape
    e = b["embeddings"]
    t = e["word"][tokens] + e["position"][:Lt][None] + e["token_type"][0]
    t = dropout(layer_norm(e["ln"], t), c["hidden_dropout_prob"], draws)
    ve = b["v_embeddings"]
    v = (linear(q, ve["image"], feats) + linear(q, ve["location"], locs[..., :5])
         + linear(q, ve["orientation"], locs[..., 5:9])
         + linear(q, ve["next_orientation"], locs[..., 9:11])
         + ve["sequence"][locs[..., 11].long()])
    v = dropout(layer_norm(ve["ln"], v), c["hidden_dropout_prob"], draws)
    t_mask = (1.0 - text_mask[:, None, None, :]) * -10000.0
    v_mask = (1.0 - region_mask[:, None, None, :]) * -10000.0

    def t_layer(i, t):
        return bert_layer(q, b["t_layers"][i], t, t_mask, c["num_attention_heads"],
                          c["hidden_dropout_prob"], c["attention_probs_dropout_prob"], draws)

    def v_layer(i, v):
        return bert_layer(q, b["v_layers"][i], v, v_mask, c["v_num_attention_heads"],
                          c["v_hidden_dropout_prob"], c["v_attention_probs_dropout_prob"], draws)

    vs = ts = 0
    for k, (ve_id, te_id) in enumerate(zip(c["v_biattention_id"], c["t_biattention_id"])):
        for i in range(vs, ve_id):
            v = v_layer(i, v)
        for i in range(ts, te_id):
            t = t_layer(i, t)
        v, t = connection_layer(q, b["c_layers"][k], c, v, v_mask, t, t_mask, draws)
        vs, ts = ve_id, te_id
    for i in range(vs, c["v_num_hidden_layers"]):
        v = v_layer(i, v)
    for i in range(ts, c["num_hidden_layers"]):
        t = t_layer(i, t)

    pooled_t = torch.relu(linear(q, b["t_pooler"], t[:, 0]))
    pooled_v = torch.relu(linear(q, b["v_pooler"], v[:, 0]))
    cls = params["cls"]
    h = layer_norm(cls["transform_ln"], gelu(linear(q, cls["transform"], t)))
    lm = q(h) @ q(e["word"]).t() + cls["decoder_bias"]
    hv = layer_norm(cls["v_transform_ln"], gelu(linear(q, cls["v_transform"], v)))
    region = linear(q, cls["v_decoder"], hv)
    fused = pooled_t * pooled_v if c["pooling_method"] == "mul" else pooled_t + pooled_v
    fused = dropout(fused, c["hidden_dropout_prob"], draws)
    return (lm, region, linear(q, cls["bi_seq_relationship"], fused),
            linear(q, params["vil_logit"], fused)[:, 0])


def masks(draws: Draws, tokens, feats, region_mask, vocab: int, mask_id: int, p_token: float,
          p_region: float):
    """(masked tokens, LM labels with -1 where none is asked, masked
    features, the regions to predict) from the masking draws."""
    shape = tokens.shape
    u_sel, u_kind, words = draws.take(shape), draws.take(shape), draws.take(shape)
    sel = (u_sel < p_token) & (tokens >= N_SPECIAL)
    replaced = torch.where(u_kind < 0.8, torch.full_like(tokens, mask_id),
                           torch.where(u_kind < 0.9, words.to(tokens.dtype), tokens))
    masked = torch.where(sel, replaced, tokens)
    labels = torch.where(sel, tokens, torch.full_like(tokens, -1))
    rsel = (draws.take(region_mask.shape) < p_region) & (region_mask > 0)
    return masked, labels, torch.where(rsel[..., None], 0.0, feats), rsel


def loss(q: Q, params: dict, c: dict, batch: dict, draws: Draws, mask_id: int, p_token: float,
         p_region: float, dropout_on: bool = True) -> Dict[str, torch.Tensor]:
    """The pretraining loss and its terms: the masked LM CE and the masked
    regions' KL(target || prediction), each a mean over what is masked;
    the alignment CE and vil_logit's BCE, means over the pairs.  Without
    ``dropout_on`` the draws hold the masks' alone."""
    tokens, region_mask = batch["tokens"], batch["region_mask"]
    masked, labels, feats, rsel = masks(draws, tokens, batch["feats"], region_mask,
                                        c["vocab_size"], mask_id, p_token, p_region)
    lm, region, align, vil = forward(q, params, c, masked, feats, batch["locs"],
                                     (tokens != 0).float(), region_mask.float(),
                                     draws if dropout_on else None)
    if not draws.done():
        raise RuntimeError(f"{len(draws.draws) - draws.i} recorded draws left unused")
    picked = labels >= 0
    lm_loss = torch.nn.functional.cross_entropy(lm[picked], labels[picked], reduction="sum")
    lm_loss = lm_loss / picked.sum().clamp_min(1)
    tgt = batch["region_targets"]
    kl = (tgt * (torch.log(tgt + 1e-9) - torch.log_softmax(region, dim=-1))).sum(-1)
    region_loss = kl[rsel].sum() / rsel.sum().clamp_min(1)
    y = batch["align_labels"]
    align_loss = torch.nn.functional.cross_entropy(align, y)
    vil_loss = torch.nn.functional.binary_cross_entropy_with_logits(vil, y.float())
    total = lm_loss + region_loss + align_loss + vil_loss
    return {"loss": total, "lm_loss": lm_loss, "region_loss": region_loss,
            "align_loss": align_loss, "vil_loss": vil_loss}


def adam(params: List[torch.Tensor], grads: List[torch.Tensor], m: List[torch.Tensor],
         v: List[torch.Tensor], step: int, lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> List[torch.Tensor]:
    """Each parameter after Adam's step number ``step`` (from 1), from its
    moments before it (Kingma and Ba, 2015; eps outside the root), rounded
    to f32 as the parameter is stored."""
    out = []
    for p, g, m0, v0 in zip(params, grads, m, v):
        m1 = b1 * m0 + (1 - b1) * g
        v1 = b2 * v0 + (1 - b2) * g * g
        m_hat, v_hat = m1 / (1 - b1 ** step), v1 / (1 - b2 ** step)
        out.append(p - lr * m_hat / (torch.sqrt(v_hat) + eps))
    return out
