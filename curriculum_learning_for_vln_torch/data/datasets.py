"""R2R / CLR2R / RxR / R4R dataset loading and instruction expansion.

A copy of the parts of ``curriculum_learning_for_vln_tpu/data/datasets.py``
that the port runs (numpy only), kept in the port so that it imports
nothing of the JAX package:

* ``load_datasets`` reads ``<data_dir>/<dataset>_<split>.json`` and
  concatenates splits (ref: tasks/R2R-judy/src/utils/misc.py:63-69).
* ``expand_r2r_items`` splits each path item into one entry per
  instruction with ``instr_id = "<path_id>_<j>"`` and pre-encoded tokens
  (ref: src/environ/common_env.py:130-141); ``expand_rxr_items`` keeps
  RxR's one instruction per item, keyed by its ``instruction_id`` (ref:
  common_env.py:384-394).
* CLR2R round splits are named ``train_round[<k>]_v3`` (k = 1..5), a
  partition of the R2R train set by curriculum difficulty
  (ref: src/environ/curriculum_env.py:44-62); ``load_clr2r_rounds`` reads
  all five, expanded, keyed "round_<k>".
* ``make_r4r_items`` builds R4R (Jain et al. '19) from R2R path items by
  joining pairs end to start, its joins drawn from
  ``np.random.default_rng(seed)`` as the JAX package draws them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

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


def expand_rxr_items(
    items: Sequence[dict],
    tokenizer: Tokenizer,
    allowed_scans: Optional[set] = None,
) -> List[dict]:
    """RxR-en: one instruction per item (ref: common_env.py:384-394)."""
    out: List[dict] = []
    for item in items:
        if allowed_scans is not None and item["scan"] not in allowed_scans:
            continue
        new_item = dict(item)
        new_item.pop("instruction", None)
        new_item.pop("instruction_id", None)
        new_item["instructions"] = item["instruction"]
        new_item["instr_id"] = item["instruction_id"]
        enc = tokenizer.encode_sentence(item["instruction"])
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


def dataset_scans(items: Sequence[dict]) -> List[str]:
    return sorted({item["scan"] for item in items})


def make_r4r_items(
    items: Sequence[dict],
    max_joins_per_anchor: int = 1,
    seed: int = 0,
) -> List[dict]:
    """R4R construction (Jain et al. '19, "Stay on the Path"): join R2R
    path pairs where the second path starts at the first path's goal,
    concatenating paths and instructions.  The joined routes are not
    shortest paths, which is what makes the fidelity metrics (CLS, nDTW,
    SDTW) discriminative.

    As in the JAX package (the evaluator wants exactly 3 instructions a
    path, evaluator.py:35): instruction k of the first path joins
    instruction k of the second, and ``max_joins_per_anchor`` caps the
    continuations of each anchor path, chosen without replacement from
    ``np.random.default_rng(seed)`` in the anchors' order.

    Joined item: path = a.path + b.path[1:], distance = a + b, heading =
    a.heading, path_id = "<a.path_id>j<b.path_id>".
    """
    rng = np.random.default_rng(seed)
    by_start: Dict[tuple, List[dict]] = {}
    for it in items:
        by_start.setdefault((it["scan"], it["path"][0]), []).append(it)

    out: List[dict] = []
    for a in items:
        tails = [b for b in by_start.get((a["scan"], a["path"][-1]), [])
                 if b["path_id"] != a["path_id"]]
        if not tails:
            continue
        if len(tails) > max_joins_per_anchor:
            idx = rng.choice(len(tails), size=max_joins_per_anchor, replace=False)
            tails = [tails[int(i)] for i in sorted(idx)]
        for b in tails:
            out.append({
                "scan": a["scan"],
                "path_id": f"{a['path_id']}j{b['path_id']}",
                "path": list(a["path"]) + list(b["path"])[1:],
                "heading": a["heading"],
                "distance": float(a["distance"]) + float(b["distance"]),
                "instructions": [f"{x.strip()} {y.strip()}"
                                 for x, y in zip(a["instructions"], b["instructions"])],
            })
    return out
