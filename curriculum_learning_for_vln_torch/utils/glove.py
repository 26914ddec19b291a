"""GloVe embedding tables for the Follower's encoder.

A copy of ``curriculum_learning_for_vln_tpu/utils/glove.py`` (numpy
only), kept in the port so that it imports nothing of the JAX package.
The reference initialises the instruction encoder from a precomputed
GloVe table (``MODEL.FOLLOWER.GLOVE_PATH``, ref: tasks/R2R-judy/src/
utils/config.py:70, consumed at src/model/units.py:30-37) and keeps it
frozen.  Two formats: a ``.npy`` matrix already aligned with the
vocabulary, or a GloVe text file (a word, then its floats, on each
line) aligned here against ``vocab``, with N(0, 0.1) rows from
``np.random.default_rng(seed)`` for the words it lacks and row 0
(<PAD>) zeroed.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def load_glove(path: str, vocab: Optional[List[str]] = None, dim: int = 300,
               seed: int = 0) -> np.ndarray:
    """The [len(vocab), dim] f32 table of the file at ``path``."""
    if path.endswith(".npy"):
        table = np.load(path).astype(np.float32)
        if vocab is not None and table.shape[0] != len(vocab):
            raise ValueError(f"GloVe rows {table.shape[0]} != vocab {len(vocab)}")
        return table
    if vocab is None:
        raise ValueError("a text-format GloVe file needs a vocab to align against")
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, 0.1, (len(vocab), dim)).astype(np.float32)
    index = {w: i for i, w in enumerate(vocab)}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            if parts[0] in index:
                table[index[parts[0]]] = np.asarray(parts[1:], dtype=np.float32)
    table[0] = 0.0  # <PAD>
    return table
