"""Cells cut to a size the CPU runs in seconds: the cells' own files with
narrow widths, a small world and a few episodes, the cells' limits."""
from __future__ import annotations

import json
import time

import torch

from benchmark.lib import harness as H


def _load(cell: str):
    _bench, _cell, config, traffic = H.load_cell(cell)
    return json.loads(json.dumps(config)), json.loads(json.dumps(traffic))


def train_cell():
    cfg, tr = _load("envdrop-spcl-train-b512")
    cfg.update({"MODEL.ENVDROP.WORD_EMB_SIZE": 16, "MODEL.ENVDROP.ACT_EMB_SIZE": 8,
                "MODEL.ENVDROP.HIDDEN_SIZE": 32, "TRAIN.BATCH_SIZE": 8,
                "AGENT.MAX_EPISODE_LEN": 6})
    cfg["widths"] = dict(cfg["widths"], word_emb=16, action_emb=8, hidden=32, feature=24)
    tr["world"] = {"scans": 4, "panoramas": 120, "train_scans": 3, "val_unseen_scans": 1}
    tr["data"] = dict(tr["data"], paths=30)
    tr["sample_from"] = 4
    return cfg, tr


def serve_cell():
    cfg, tr = _load("monitor-serve-b256-long")
    cfg.update({"MODEL.MONITOR.WORD_EMB_SIZE": 16, "MODEL.MONITOR.HIDDEN_SIZE": 32,
                "MODEL.MONITOR.MLP_HIDDEN": [24]})
    cfg["widths"] = dict(cfg["widths"], word_emb=16, hidden=32, mlp_hidden=24, feature=24)
    tr["world"] = {"scans": 4, "panoramas": 120, "train_scans": 3, "val_unseen_scans": 1}
    tr["requests"] = dict(tr["requests"], requests=24)
    tr.update(batch=8, sample_from=4, warmup_calls=1, trace_calls=3)
    return cfg, tr


def run_of(cfg, tr, seed: int, seconds: float = 0.5, trace: bool = False, control=None,
           device="cpu") -> H.Run:
    return H.Run("tiny", seed, seconds, trace, {"chips": 1}, cfg, tr, torch.device(device),
                 time.perf_counter(), control=control)
