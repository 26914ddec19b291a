"""Building blocks: plain functions over parameter dicts of tensors.

The port of ``curriculum_learning_for_vln_tpu/models/core.py``.  Models
are functions of explicit parameter dicts with the JAX package's names
and layouts (dense ``w`` [in, out]; LSTM ``w_ih`` [D, 4H], ``w_hh``
[H, 4H], ``b_ih``, ``b_hh``; gate order i, f, g, o), so a JAX parameter
tree converts one to one (convert.py).  Randomness is explicit: every
initializer and ``dropout`` take a ``torch.Generator``.

Initialization follows the reference models' effective init (PyTorch
defaults): Linear/LSTM weights ~ U(-1/sqrt(fan), 1/sqrt(fan)), embeddings
~ N(0, 1) with a zeroed padding row.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops import draws
from ..ops import rnn as rnn_ops
from ..parallel import mesh as M


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, bias: bool = True,
               device=None) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(gen, (in_dim, out_dim), bound, device)}
    if bias:
        p["b"] = _uniform(gen, (out_dim,), bound, device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) in the promoted dtype of x and w, as jnp promotion does:
    an f32 activation against bf16 compute weights runs in f32."""
    dtype = torch.promote_types(x.dtype, p["w"].dtype)
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def embedding_init(gen: torch.Generator, num: int, dim: int,
                   padding_idx: Optional[int] = None, device=None) -> dict:
    w = torch.randn((num, dim), generator=gen, device=device)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def embedding(p: dict, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``p["w"]`` at ``ids``.  Every position's gradient reaches
    its row, the padding row's too (no ``padding_idx``), as the JAX
    package's scatter-add does.  ``F.embedding``'s backward on the card
    sorts the ids, sums each id's gradient rows in f32 in parallel pieces
    and rounds a row once; advanced indexing's (``index_put_`` with
    accumulate) walks an id's duplicates one by one, rounding to the
    table's dtype at each, which the padding id's thousands make slow."""
    return torch.nn.functional.embedding(ids, p["w"])


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout by a boolean keep-mask, in the dtype of x: x divided
    by the keep probability rounded to that dtype, as core.py:91-94 divides
    (a bf16 x by bf16(1 - rate); torch would divide by a Python float in
    f32, one bf16 ulp off in a third of the elements at rate 0.1).

    The divisor is a 0-dim tensor of x's dtype filled on x's device: a
    ``torch.tensor`` of it is a blocking copy from pageable host memory
    (the host waits for the stream at every dropout), and on the card a
    CPU scalar divisor is applied as a multiply by its f32 reciprocal,
    which rounds differently from the division."""
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / keep, 0)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None, batch_dim=draws.UNSET) -> torch.Tensor:
    """Inverted dropout with a keep-mask drawn from ``generator`` (torch's
    Philox on the card; on the device of ``x``); identity when not
    training or rate == 0 (core.py:97-101).  ``batch_dim`` is the batch
    axis of x (ops/draws.py).  The JAX package's "rbg" fast masks
    (core.py:61-88) are a TPU-only stream and have no counterpart."""
    if not train or rate == 0.0:
        return x
    mask = draws.rand(x.shape, generator, x.device, batch_dim) < 1.0 - rate
    return apply_keep_mask(x, mask, rate)


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """A standalone inverted-dropout mask, keep-indicators over the keep
    probability in f32 (EnvDrop's shared feature-noise mask; core.py:104-109,
    ref: envdrop.py:106)."""
    keep = 1.0 - rate
    return (draws.rand(shape, generator, device, batch_dim=None) < keep).float() / keep


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

def lstm_cell_init(gen: torch.Generator, in_dim: int, hidden: int, device=None) -> dict:
    bound = 1.0 / math.sqrt(hidden)
    return {
        "w_ih": _uniform(gen, (in_dim, 4 * hidden), bound, device),
        "w_hh": _uniform(gen, (hidden, 4 * hidden), bound, device),
        "b_ih": _uniform(gen, (4 * hidden,), bound, device),
        "b_hh": _uniform(gen, (4 * hidden,), bound, device),
    }


def lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step (gate order i, f, g, o); the bias is b_ih + b_hh
    summed in the parameter dtype, as core.py:129 does."""
    return rnn_ops.lstm_cell(x, h, c, p["w_ih"], p["w_hh"], p["b_ih"] + p["b_hh"])


def masked_lstm(p: dict, xs: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Packed-sequence LSTM semantics (torch's pack_padded_sequence,
    ref: units.py:58-71): outputs at padded positions are zero; the final
    state is the state after the last *valid* token (forward) or after
    position 0 having processed tokens len-1..0 (reverse).  Kernel K3,
    which takes xs and the weights in one dtype: the promoted one, as jnp
    promotion gives (an f32 upper layer over bf16 weights runs in f32)."""
    dtype = torch.promote_types(xs.dtype, p["w_ih"].dtype)
    w_ih, w_hh, b = (t.to(dtype) for t in (p["w_ih"], p["w_hh"], p["b_ih"] + p["b_hh"]))
    return rnn_ops.masked_lstm(xs.to(dtype), lengths, w_ih, w_hh, b, reverse=reverse)


def bilstm_layer(p_fwd: dict, p_bwd: Optional[dict], xs: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One (bi)directional LSTM layer: concat outputs [B, L, H*dirs] and the
    final (h, c) concatenated over directions (ref: units.py:63-67)."""
    out_f, (h_f, c_f) = masked_lstm(p_fwd, xs, lengths, reverse=False)
    if p_bwd is None:
        return out_f, (h_f, c_f)
    out_b, (h_b, c_b) = masked_lstm(p_bwd, xs, lengths, reverse=True)
    return (torch.cat([out_f, out_b], dim=-1),
            (torch.cat([h_f, h_b], dim=-1), torch.cat([c_f, c_b], dim=-1)))


# ---------------------------------------------------------------------------
# BatchNorm (the Self-Monitor's MLP; ref: units.py:210-242)
# ---------------------------------------------------------------------------

def batchnorm_init(dim: int, device=None) -> Tuple[dict, dict]:
    """(params {scale, bias}, state {mean, var, count}), all f32."""
    params = {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}
    state = {"mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device),
             "count": torch.zeros((), device=device)}
    return params, state


def batchnorm(params: dict, state: dict, x: torch.Tensor, train: bool, momentum: float = 0.1,
              eps: float = 1e-5) -> Tuple[torch.Tensor, dict]:
    """BatchNorm1d over x [N, C] (core.py:180-203): the batch statistics in
    train, with the running mean, the unbiased running variance and
    ``count`` updated as a returned value (carrying no gradient), the
    running statistics in eval.  The state stays in its own dtype (f32);
    x and the statistics promote as jnp does.  In a data-parallel step
    the statistics are those of every rank's rows: sums reduced over the
    data axis, in the forward and the backward (parallel/mesh.py)."""
    if train:
        n = M.global_rows(x.shape[0])
        mean = M.differentiable_sum(x.sum(dim=0)) / n
        var = M.differentiable_sum(((x - mean) ** 2).sum(dim=0)) / n
        with torch.no_grad():
            unbiased = var.detach() * n / max(n - 1, 1)
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
                "count": state["count"] + 1,
            }
            new_state = {k: v.to(state[k].dtype) for k, v in new_state.items()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new_state


# ---------------------------------------------------------------------------
# Loss helpers (per-sample, SPCL-ready; ref: follower.py:63, envdrop.py:70)
# ---------------------------------------------------------------------------

def cross_entropy_per_sample(logits: torch.Tensor, targets: torch.Tensor,
                             ignore_id: int = -1) -> torch.Tensor:
    """CE with ignore_index semantics, per-sample vector [B] (core.py:206):
    masked logits (-1e30) carry zero probability, an ignored target 0."""
    logp = torch.log_softmax(logits, dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1)
    picked = logp.gather(-1, tgt[:, None])[:, 0]
    return torch.where(targets == ignore_id, 0.0, -picked)
