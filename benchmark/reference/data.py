"""Instructions to token ids, and the training batches of a seed.

Tokens: <BOS>, one id per word (the vocabulary's, else <UNK>), <EOS>,
padded with <PAD> to ``max_len``, or cut to it with <EOS> last (the
reference repository's ``Tokenizer.encode_sentence``).  The dataset is
every path's instructions, the CLR2R rounds in order (round 1 first),
each path's instructions in order; an epoch is a permutation of it drawn
from ``numpy.random.default_rng(seed)``, a new one when it runs out, and
a batch is the next ``batch`` items sorted by length, longest first, ties
in drawn order (the reference's ``R2RBatch``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

PAD, UNK, EOS, BOS = 0, 1, 2, 3


def encode(text: str, word_ids: Dict[str, int], max_len: int):
    """(ids [max_len], length) of a lower-case, space-separated instruction."""
    ids = [BOS] + [word_ids.get(w, UNK) for w in text.lower().split()] + [EOS]
    if len(ids) < max_len:
        return np.array(ids + [PAD] * (max_len - len(ids)), np.int64), len(ids)
    ids = ids[:max_len]
    ids[-1] = EOS
    return np.array(ids, np.int64), max_len


def expand(paths: List[dict], vocab: List[str], max_len: int, rounds: int) -> dict:
    """The dataset's arrays: tokens [n, max_len], lengths, path index,
    round (the SPCL difficulty), edges on the path (hops)."""
    word_ids = {w: i for i, w in enumerate(vocab)}
    tokens, lengths, path_ix, rnd = [], [], [], []
    for k in range(1, rounds + 1):
        for p, item in enumerate(paths):
            if item["round"] != k:
                continue
            for text in item["instructions"]:
                ids, n = encode(text, word_ids, max_len)
                tokens.append(ids)
                lengths.append(n)
                path_ix.append(p)
                rnd.append(k)
    path_ix = np.array(path_ix, np.int64)
    return {"tokens": np.stack(tokens), "lengths": np.array(lengths, np.int64),
            "path": path_ix, "round": np.array(rnd, np.float32),
            "hops": np.array([len(paths[p]["path"]) - 1 for p in path_ix], np.int64)}


class Batches:
    """The training batches of ``seed`` over ``n`` items of ``lengths``."""

    def __init__(self, lengths: np.ndarray, batch: int, seed: int):
        self.lengths, self.batch = lengths, batch
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(lengths))
        self.ix = 0

    def next(self) -> np.ndarray:
        n = len(self.lengths)
        idx = self.order[self.ix:self.ix + self.batch]
        if len(idx) < self.batch:
            self.order = self.rng.permutation(n)
            self.ix = self.batch - len(idx)
            idx = np.concatenate([idx, self.order[:self.ix]])
        else:
            self.ix += self.batch
        return idx[np.argsort(-self.lengths[idx], kind="stable")].astype(np.int64)


def spcl_weights(rounds: np.ndarray, weight_ctrl: float) -> np.ndarray:
    """SPCL's initial per-item weights (Jiang et al., AAAI 2015, as the CL
    paper's trainer starts them): ``weight_ctrl``, and 1 for rounds 1-2."""
    w = np.full(len(rounds), weight_ctrl, np.float32)
    w[rounds <= 2] = 1.0
    return w
