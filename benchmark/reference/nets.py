"""Plain building blocks of both agents, in float32.

Every matrix product goes through ``mm``, whose operands pass ``q``: the
identity for the reference; for the control that emulates a lower
precision, a round trip through a narrower float type (one-byte types
with one scale a tensor, as FP8 training recipes scale: Micikevicius et
al., "FP8 Formats for Deep Learning", 2022; operands in e4m3, their
gradients in e5m2).  Dropout masks come from a ``Draws`` in the order the
agents draw them; the env-dropout of the observation step comes from
per-sample Philox seeds (``philox``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import philox

NEG_INF = -1e30


def scaled_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to f32; for a one-byte type, with
    its largest magnitude scaled to the type's largest finite value."""
    if torch.finfo(dtype).bits > 8:
        return x.float().to(dtype).float()
    top = float(torch.finfo(dtype).max)
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).clamp(-top, top).to(dtype).float() / scale)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd: torch.dtype, bwd: torch.dtype):
        ctx.bwd = bwd
        return scaled_round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return scaled_round(g, ctx.bwd), None, None


GRAD_DTYPE = {torch.float8_e4m3fn: torch.float8_e5m2}


def quantizer(dtype: Optional[torch.dtype]) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> x in ``dtype``'s precision, its gradient in the type's gradient
    counterpart (None: x itself)."""
    if dtype is None:
        return lambda x: x
    return lambda x: _Round.apply(x, dtype, GRAD_DTYPE.get(dtype, dtype))


class Draws:
    """The random draws of a run from one generator, in the program's order:
    uniforms for dropout and Gumbel noise, int64 seeds for the
    observation step's env-dropout."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)

    def seeds(self, n: int) -> torch.Tensor:
        return torch.randint(-2 ** 63, 2 ** 63 - 1, (n,), dtype=torch.int64, generator=self.gen,
                             device=self.device)


def mm(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    return q(a) @ q(b)


def dense(p: dict, x: torch.Tensor, q) -> torch.Tensor:
    y = mm(x, p["w"], q)
    return y + p["b"] if "b" in p else y


def dropout(x: torch.Tensor, rate: float, draws: Optional[Draws]) -> torch.Tensor:
    """Inverted dropout (no draw without ``draws``)."""
    if draws is None or rate == 0.0:
        return x
    return x * (draws.rand(x.shape) < 1.0 - rate) / (1.0 - rate)


def cell(p: dict, gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor, q):
    """An LSTM step from the input's gate terms ``gx`` (x W_ih + b)."""
    g = gx + mm(h, p["w_hh"], q)
    i, f, gg, o = g.chunk(4, dim=-1)
    c1 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c1), c1


def lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, q):
    return cell(p, mm(x, p["w_ih"], q) + p["b_ih"] + p["b_hh"], h, c, q)


def lstm_seq(p: dict, xs: torch.Tensor, lengths: torch.Tensor, reverse: bool, q):
    """A packed sequence: steps past a sample's length leave its state and
    give zero outputs; ``reverse`` runs from its last token to its first.
    Returns (outputs [B, L, H], (h, c) after the last valid step)."""
    B, L, D = xs.shape
    H = p["w_hh"].shape[0]
    gx = (mm(xs.reshape(B * L, D), p["w_ih"], q) + p["b_ih"] + p["b_hh"]).reshape(B, L, 4 * H)
    h = c = xs.new_zeros((B, H))
    outs = [None] * L
    for t in range(L):
        idx = L - 1 - t if reverse else t
        valid = (idx < lengths)[:, None]
        h1, c1 = cell(p, gx[:, idx], h, c, q)
        h, c = torch.where(valid, h1, h), torch.where(valid, c1, c)
        outs[idx] = torch.where(valid, h1, 0.0)
    return torch.stack(outs, dim=1), (h, c)


def encoder(p: dict, tokens: torch.Tensor, lengths: torch.Tensor, rate: float,
            draws: Optional[Draws], q):
    """Embedding, dropout, the (bi)directional LSTM, dropout: (ctx, the
    decoder's initial h = tanh(W [h_f; h_b] + b), the final c)."""
    x = dropout(q(p["embedding"]["w"])[tokens], rate, draws)
    layer = p["layers"][0]
    out, (h, c) = lstm_seq(layer["fwd"], x, lengths, False, q)
    if layer["bwd"] is not None:
        out_b, (h_b, c_b) = lstm_seq(layer["bwd"], x, lengths, True, q)
        out, h, c = (torch.cat([out, out_b], -1), torch.cat([h, h_b], -1),
                     torch.cat([c, c_b], -1))
    return dropout(out, rate, draws), torch.tanh(dense(p["enc2dec"], h, q)), c


def masked_softmax(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        x = torch.where(mask, NEG_INF, x)
    return torch.softmax(x, dim=-1)


def attend(query: torch.Tensor, context: torch.Tensor, mask: Optional[torch.Tensor]):
    """(softmax-weighted context [B, C], weights [B, L]) of query [B, C]
    against context [B, L, C]."""
    attn = masked_softmax(torch.einsum("blc,bc->bl", context, query), mask)
    return torch.einsum("bl,blc->bc", attn, context), attn


def keep_drop(rows: torch.Tensor, seeds: Optional[torch.Tensor], keep: float) -> torch.Tensor:
    """rows [B, n, D] with the Philox keep-mask of ``seeds`` applied (kept
    elements divided by ``keep``); unchanged without seeds."""
    if seeds is None:
        return rows
    mask = philox.keep_mask(seeds, rows.shape[1:], keep)
    return torch.where(mask, rows / keep, 0.0)
