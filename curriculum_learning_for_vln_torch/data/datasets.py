"""R2R / CLR2R dataset loading and instruction expansion.

A copy of the parts of ``curriculum_learning_for_vln_tpu/data/datasets.py``
that the port runs (numpy only), kept in the port so that it imports
nothing of the JAX package:

* ``load_datasets`` reads ``<data_dir>/<dataset>_<split>.json`` and
  concatenates splits (ref: tasks/R2R-judy/src/utils/misc.py:63-69).
* ``expand_r2r_items`` splits each path item into one entry per
  instruction with ``instr_id = "<path_id>_<j>"`` and pre-encoded tokens
  (ref: src/environ/common_env.py:130-141).
* CLR2R round splits are named ``train_round[<k>]_v3`` (k = 1..5), a
  partition of the R2R train set by curriculum difficulty
  (ref: src/environ/curriculum_env.py:44-62); ``load_clr2r_rounds`` reads
  all five, expanded, keyed "round_<k>".

The RxR and R4R loaders are not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..utils.tokenizer import Tokenizer

CLR2R_ROUNDS = 5


def clr2r_split_name(k: int) -> str:
    return f"train_round[{k}]_v3"


def load_datasets(splits: Sequence[str], dataset: str = "R2R", data_dir: str = "assets") -> List[dict]:
    data: List[dict] = []
    for split in splits:
        path = os.path.join(data_dir, f"{dataset}_{split}.json")
        with open(path) as f:
            data += json.load(f)
    return data


def expand_r2r_items(
    items: Sequence[dict],
    tokenizer: Tokenizer,
    allowed_scans: Optional[set] = None,
) -> List[dict]:
    """One entry per (path, instruction); drops scans without features."""
    out: List[dict] = []
    for item in items:
        if allowed_scans is not None and item["scan"] not in allowed_scans:
            continue
        for j, instr in enumerate(item["instructions"]):
            new_item = dict(item)
            new_item["instr_id"] = f"{item['path_id']}_{j}"
            new_item["instructions"] = instr
            enc = tokenizer.encode_sentence(instr)
            if enc is None:
                continue
            new_item["instr_encoding"], new_item["instr_length"] = enc
            out.append(new_item)
    return out


def load_clr2r_rounds(
    tokenizer: Tokenizer,
    data_dir: str,
    allowed_scans: Optional[set] = None,
) -> Dict[str, List[dict]]:
    """All 5 CLR2R rounds, expanded, keyed "round_<k>"."""
    rounds: Dict[str, List[dict]] = {}
    for k in range(1, CLR2R_ROUNDS + 1):
        items = load_datasets([clr2r_split_name(k)], dataset="CLR2R", data_dir=data_dir)
        rounds[f"round_{k}"] = expand_r2r_items(items, tokenizer, allowed_scans)
    return rounds
