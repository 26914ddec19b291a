"""The weights of both agents, made from a seed on the device.

The layout is the agents' published one (EnvDrop: Tan et al., NAACL 2019;
the Self-Monitoring agent: Ma et al., ICLR 2019) in the parameter-tree
names the program takes: dense ``w`` [in, out] and ``b``; LSTM ``w_ih``
[D, 4H], ``w_hh`` [H, 4H], ``b_ih``, ``b_hh`` (gates i, f, g, o);
embeddings ``w`` [vocab, E] with a zero padding row.  Initialisation is
PyTorch's default, as the reference repository's modules have it:
dense and LSTM weights U(-1/sqrt(fan), 1/sqrt(fan)) (fan: the input
width, the hidden width for LSTMs), embeddings N(0, 1).  All uniform
leaves come from one ``torch.rand`` and all normal ones from one
``torch.randn``, on the device, in f32.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

PAD_IDX = 0


def _dense(i: int, o: int, bias: bool = True):
    leaf = ("u", 1.0 / math.sqrt(i))
    return {"w": ((i, o), leaf), **({"b": ((o,), leaf)} if bias else {})}


def _lstm(i: int, h: int):
    leaf = ("u", 1.0 / math.sqrt(h))
    return {"w_ih": ((i, 4 * h), leaf), "w_hh": ((h, 4 * h), leaf), "b_ih": ((4 * h,), leaf),
            "b_hh": ((4 * h,), leaf)}


def _encoder(vocab: int, emb: int, hidden: int, bidirectional: bool):
    dirs = 2 if bidirectional else 1
    H = hidden // dirs
    return {"embedding": {"w": ((vocab, emb), ("n", PAD_IDX))},
            "enc2dec": _dense(H * dirs, H * dirs),
            "layers": [{"fwd": _lstm(emb, H), "bwd": _lstm(emb, H) if bidirectional else None}]}


def envdrop_layout(w: dict, vocab: int):
    """EnvDrop's tree: the bidirectional encoder, the decoder (action
    embedding, LSTM over [action; attended panorama], text attention, the
    visual query and the candidate projection) and the critic."""
    H, F, A, act = w["hidden"], w["feature"] + w["angle"], w["angle"], w["action_emb"]
    return {
        "encoder": _encoder(vocab, w["word_emb"], H, True),
        "decoder": {
            "act_embed": _dense(A, act),
            "lstm": _lstm(act + F, H),
            "text_attn": {"linear_in": _dense(H, H, False), "linear_out": _dense(2 * H, H, False)},
            "visual_attn": {"linear_in": _dense(H, F, False)},
            "cand_attn": _dense(H, F, False),
        },
        "critic": {"fc1": _dense(H, H), "fc2": _dense(H, 1)},
    }


def monitor_layout(w: dict, vocab: int):
    """The Self-Monitoring agent's tree: the unidirectional encoder and the
    MonitorDecoder (BN-MLP candidate projection, positional encoding,
    text and candidate attention, LSTM, policy and progress heads)."""
    H, F, M, L = w["hidden"], w["feature"] + w["angle"], w["mlp_hidden"], w["max_enc_len"]
    return {
        "encoder": _encoder(vocab, w["word_emb"], H, False),
        "decoder": {
            "proj_navigable_mlp": {"layers": [_dense(F, M)],
                                   "bn_in": {"scale": ((F,), ("one",)), "bias": ((F,), ("zero",))},
                                   "bn_layers": [{"scale": ((M,), ("one",)),
                                                  "bias": ((M,), ("zero",))}]},
            "pe": ((L, H), ("pe",)),
            "text_attn": {"linear_in": _dense(H, H, False)},
            "visual_attn": {"linear_in_h": _dense(H, M)},
            "lstm": _lstm(2 * M + H, H),
            "action_linear": _dense(2 * H, M),
            "monitor_linear": _dense(H + M, H),
            "critic": _dense(L + H, 1),
        },
    }


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple, tuple]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree[0], tree[1])]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def positional_table(max_len: int, d_model: int, device) -> torch.Tensor:
    """The sinusoid table [max_len, d_model]: sin on even columns, cos on
    odd (Vaswani et al., 2017)."""
    pos = torch.arange(max_len, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def make_params(layout, seed: int, device) -> dict:
    """The f32 tree of ``layout`` from ``seed``: one uniform and one normal
    draw on ``device`` for all leaves."""
    leaves = _leaves(layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for _, s, k in leaves if k[0] == "u")
    n_n = sum(math.prod(s) for _, s, k in leaves if k[0] == "n")
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(n_n, generator=gen, device=device)
    tree = _skeleton(layout)
    ou = on = 0
    for path, shape, kind in leaves:
        n = math.prod(shape)
        if kind[0] == "u":
            t = (uni[ou:ou + n] * kind[1]).reshape(shape)
            ou += n
        elif kind[0] == "n":
            t = nor[on:on + n].reshape(shape).clone()
            t[kind[1]] = 0.0
            on += n
        elif kind[0] == "one":
            t = torch.ones(shape, device=device)
        elif kind[0] == "zero":
            t = torch.zeros(shape, device=device)
        else:
            t = positional_table(shape[0], shape[1], device)
        _set(tree, path, t.contiguous())
    return tree


def make_bn_state(w: dict, seed: int, device) -> dict:
    """Running BatchNorm statistics of the Self-Monitor's MLP, as a trained
    model holds them: the input's mean near the features' 0.5 (angle dims
    near 0) and variance near 0.25 (angle dims 0.5), the hidden layer's
    mean near 0 and variance near 1; drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    F, M, A = w["feature"] + w["angle"], w["mlp_hidden"], w["angle"]
    u = torch.rand(2 * F + 2 * M, generator=gen, device=device)
    mean_in = torch.cat([0.5 + 0.1 * (u[:F - A] - 0.5), 0.1 * (u[F - A:F] - 0.5)])
    var_in = torch.cat([0.25 * (0.8 + 0.4 * u[F:2 * F - A]),
                        0.5 * (0.8 + 0.4 * u[2 * F - A:2 * F])])
    mean_h = 0.2 * (u[2 * F:2 * F + M] - 0.5)
    var_h = 0.5 + u[2 * F + M:]
    count = torch.tensor(1000.0, device=device)
    layer = {"mean": mean_h, "var": var_h, "count": count.clone()}
    return {"decoder_bn": {"mlp": {"bn_in": {"mean": mean_in, "var": var_in, "count": count},
                                   "bns": [layer]}}}
