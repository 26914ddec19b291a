"""Instruction tokenizer and vocabulary IO.

Behaviorally matches the reference tokenizer
(`tasks/R2R-judy/src/utils/misc.py:94-218`): split on non-alphanumeric
runs, lowercase, explode punctuation-only tokens (except runs of '.'),
<BOS>/<EOS> wrapping, pad/truncate to a fixed encoding length with the
truncated tail terminated by <EOS>, and min-count-5 vocabulary built from
the train split with the 4-token base vocab.

The encoder output is a fixed-shape int32 array; no dynamic-length path
exists.  A copy of ``curriculum_learning_for_vln_tpu/utils/tokenizer.py``
so the PyTorch port imports nothing of the JAX package.
"""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Base vocabulary (ref: misc.py:21-25).
BASE_VOCAB = ["<PAD>", "<UNK>", "<EOS>", "<BOS>"]
PAD_IDX = 0
UNK_IDX = 1
EOS_IDX = 2
BOS_IDX = 3

_SPLIT_RE = re.compile(r"(\W+)")


def split_sentence(sentence: str) -> List[str]:
    """Break a sentence into words and punctuation (ref: misc.py:125-135)."""
    toks: List[str] = []
    for word in [s.strip().lower() for s in _SPLIT_RE.split(sentence.strip()) if s.strip()]:
        if all(c in string.punctuation for c in word) and not all(c == "." for c in word):
            toks.extend(list(word))
        else:
            toks.append(word)
    return toks


class Tokenizer:
    """Encode/decode instructions against a fixed vocabulary."""

    def __init__(self, vocab: Optional[Sequence[str]] = None, encoding_length: int = 20):
        self.vocab = list(vocab) if vocab is not None else []
        self.encoding_length = encoding_length
        self.word_to_index = {w: i for i, w in enumerate(self.vocab)}
        self.index_to_word = {i: w for w, i in self.word_to_index.items()}

    def vocab_size(self) -> int:
        return len(self.index_to_word)

    def add_word(self, word: str) -> None:
        assert word not in self.word_to_index
        idx = self.vocab_size()
        self.word_to_index[word] = idx
        self.index_to_word[idx] = word

    def _index(self, word: str) -> int:
        return self.word_to_index.get(word, UNK_IDX)

    def encode_sentence(
        self, sentence: str, tokens: Optional[List[str]] = None, max_length: Optional[int] = None
    ) -> Optional[Tuple[np.ndarray, int]]:
        """Encode to (ids[max_length], true_length) (ref: misc.py:137-157)."""
        if max_length is None:
            max_length = self.encoding_length
        if not self.word_to_index:
            raise RuntimeError("Tokenizer has no vocab")

        toks = tokens if tokens is not None else split_sentence(sentence)
        encoding = [BOS_IDX] + [self._index(w) for w in toks] + [EOS_IDX]
        if len(encoding) <= 2:
            return None
        if len(encoding) < max_length:
            length = len(encoding)
            encoding = encoding + [PAD_IDX] * (max_length - len(encoding))
        else:
            length = max_length
            encoding[max_length - 1] = EOS_IDX
        return np.array(encoding[:max_length], dtype=np.int32), length

    def decode_sentence(self, encoding: Sequence[int], length: Optional[int] = None) -> str:
        """Decode ids to a string, stopping at the first <PAD> (ref: misc.py:159-168)."""
        if length is not None:
            encoding = list(encoding)[:length]
        words = []
        for ix in encoding:
            ix = int(ix)
            if ix == PAD_IDX:
                break
            words.append(self.index_to_word.get(ix, "<UNK>"))
        return " ".join(words)

    def shrink(self, inst: Sequence[int]) -> List[int]:
        """Strip a leading <BOS> and everything from the first <EOS> (ref: misc.py:170-184)."""
        inst = list(inst)
        if not inst:
            return inst
        arr = np.array(inst)
        end = int(np.argmax(arr == EOS_IDX))  # 0 if no <EOS> → empty result
        start = 1 if len(inst) > 1 and inst[0] == BOS_IDX else 0
        return inst[start:end]


def build_vocab(data: Sequence[dict], min_count: int = 5, start_vocab: Sequence[str] = BASE_VOCAB) -> List[str]:
    """Build a vocab from dataset items' instruction lists (ref: misc.py:191-204)."""
    count: Counter = Counter()
    for item in data:
        instrs = item["instructions"]
        if isinstance(instrs, str):
            instrs = [instrs]
        for instr in instrs:
            count.update(split_sentence(instr))
    vocab = list(start_vocab)
    for word, num in count.most_common():
        if num >= min_count:
            vocab.append(word)
        else:
            break
    return vocab


def write_vocab(vocab: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        for word in vocab:
            f.write(f"{word}\n")


def read_vocab(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f.readlines()]
