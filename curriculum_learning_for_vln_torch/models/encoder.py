"""Instruction encoder: (bi)directional multi-layer LSTM.

The port of ``curriculum_learning_for_vln_tpu/models/encoder.py`` (ref:
units.py:12-74): embedding -> dropout -> packed (bi)LSTM stack (per
direction kernel K3, or K1 forward and K2 backward under autograd) -> ctx
(dropout) plus a decoder init state tanh(W h_T).  At train=True the
dropout masks are drawn from ``generator`` in the order the JAX
package's fold_in indices name them (0 embeddings, 10+ between layers,
1 the context).  With a pretrained table (the Follower's GloVe,
encoder.py:29-37, 61-66) the embedding is that table, frozen: its
lookup is detached, so no gradient reaches it, and the embedding
dropout is skipped (ref: units.py:30-37, 55-56).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .core import bilstm_layer, dense, dense_init, dropout, embedding, embedding_init, lstm_cell_init


def encoder_init(gen: torch.Generator, vocab_size: int, embed_size: int, hidden_size: int,
                 padding_idx: int, bidirectional: bool = False, num_layers: int = 1,
                 device=None, glove: Optional[np.ndarray] = None) -> dict:
    """``glove``: a [vocab, embed] pretrained table that stands in for the
    drawn embedding (the other parameters are drawn as without it)."""
    dirs = 2 if bidirectional else 1
    H = hidden_size // dirs
    emb = embedding_init(gen, vocab_size, embed_size, padding_idx, device=device)
    if glove is not None:
        emb = {"w": torch.tensor(np.asarray(glove, np.float32), device=device)}
    p = {
        "embedding": emb,
        "enc2dec": dense_init(gen, H * dirs, H * dirs, bias=True, device=device),
        "layers": [],
    }
    in_dim = embed_size
    for _ in range(num_layers):
        fwd = lstm_cell_init(gen, in_dim, H, device=device)
        bwd = lstm_cell_init(gen, in_dim, H, device=device) if bidirectional else None
        p["layers"].append({"fwd": fwd, "bwd": bwd})
        in_dim = H * dirs
    return p


def encoder_apply(p: dict, tokens: torch.Tensor, lengths: torch.Tensor, train: bool,
                  drop_rate: float = 0.5, generator: Optional[torch.Generator] = None,
                  use_glove: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (ctx [B, L, H*dirs] f32, decoder_init_h [B, H*dirs], c_T);
    ``use_glove``: the embedding table is frozen (no gradient, no dropout)."""
    num_layers = len(p["layers"])
    if use_glove:
        x = embedding(p["embedding"], tokens).detach()
    else:
        x = dropout(embedding(p["embedding"], tokens), drop_rate, train, generator, batch_dim=0)
    h_t = c_t = None
    for li, layer in enumerate(p["layers"]):
        x, (h_t, c_t) = bilstm_layer(layer["fwd"], layer["bwd"], x, lengths)
        if li < num_layers - 1:
            # inter-layer dropout (torch LSTM dropout arg; ref units.py:41)
            x = dropout(x, drop_rate, train, generator, batch_dim=0)
    decoder_init = torch.tanh(dense(p["enc2dec"], h_t))
    ctx = dropout(x, drop_rate, train, generator, batch_dim=0)
    return ctx, decoder_init, c_t
