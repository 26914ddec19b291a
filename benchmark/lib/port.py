"""The program under test: the PyTorch / CUDA port, built from a
configuration file's keys and the benchmark's inputs.

Only here and in the runners does the benchmark import the port.  The
world's graphs go through the port's compiler; the feature table the
benchmark made on the device takes the place of the compiled world's
(``WorldTables.features``), so the port never holds it on the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def cfg_of(config: dict):
    """The port's config: its defaults, then every dotted upper-case key of
    the configuration file."""
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    opts = []
    for key, value in config.items():
        if "." in key and key.split(".")[0].isupper():
            opts += [key, tuple(value) if isinstance(value, list) else value]
    cfg.merge_from_list(opts)
    return cfg


def world(graphs: Dict[str, dict], features: torch.Tensor, cfg, device):
    """(compiled world, device tables) with ``features`` as the table."""
    from curriculum_learning_for_vln_torch.world.compiler import compile_world
    from curriculum_learning_for_vln_torch.world.graph import ScanGraph

    scans = {s: ScanGraph(scan_id=s, node_ids=list(g["node_ids"]), pos=g["pos"],
                          edges=g["edges"].astype(np.int32)) for s, g in graphs.items()}
    compiled = compile_world(scans, max_candidates=cfg.TPU.MAX_CANDIDATES)
    compiled.features = np.zeros((compiled.num_nodes, features.shape[1], 1), np.float32)
    tables = compiled.device_tables(cfg.TPU.PRECISION, device)._replace(features=features)
    return compiled, tables


def tokenizer(vocab, cfg):
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer

    return Tokenizer(vocab, encoding_length=cfg.DATA.MAX_ENC_LEN)


def build_kernels() -> None:
    """Compile the port's CUDA sources not yet built, all at once."""
    from curriculum_learning_for_vln_torch.ops.cuda import build

    build.build()


def trainable(params: dict) -> dict:
    from curriculum_learning_for_vln_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
