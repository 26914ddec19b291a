"""Carry weights across from the JAX package, and back.

The port keeps the JAX package's parameter names and layouts (dense
``w`` [in, out]; LSTM ``w_ih`` [D, 4H], ``w_hh`` [H, 4H], ``b_ih``,
``b_hh``, gate order i, f, g, o), so an EnvDrop parameter tree converts
leaf for leaf and both packages compute the same function from it.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine.checkpoint import load_checkpoint, to_numpy
from .utils.tree import tree_map

# key paths every EnvDrop parameter tree holds
_ENVDROP_KEYS = (
    ("encoder", "embedding", "w"), ("encoder", "enc2dec", "w"), ("encoder", "layers"),
    ("decoder", "act_embed", "w"), ("decoder", "lstm", "w_ih"), ("decoder", "lstm", "w_hh"),
    ("decoder", "text_attn", "linear_in", "w"), ("decoder", "text_attn", "linear_out", "w"),
    ("decoder", "visual_attn", "linear_in", "w"), ("decoder", "cand_attn", "w"),
    ("critic", "fc1", "w"), ("critic", "fc2", "w"),
)


def _leaf_to_torch(x):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: dict) -> dict:
    """The port's EnvDrop parameters (CPU tensors, f32) from a JAX EnvDrop
    parameter tree of numpy arrays.  Raises on a tree without EnvDrop's
    structure."""
    for path in _ENVDROP_KEYS:
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise ValueError(f"not an EnvDrop parameter tree: missing {'/'.join(path)}")
            node = node[k]
    return tree_map(_leaf_to_torch, tree)


def params_to_jax(params: dict) -> dict:
    """The inverse of ``params_from_jax``: the tree of numpy f32 arrays in the
    JAX layout (what the JAX package's checkpoint bundle holds): the port
    keeps that layout, so only the array type changes."""
    return to_numpy(params)


def load_jax_checkpoint(path: str) -> dict:
    """{"params", "model_state"} of a JAX checkpoint bundle, read without
    jax or optax (engine/checkpoint.py), the parameters converted to the
    port's."""
    bundle = load_checkpoint(path)
    return {"params": params_from_jax(bundle["params"]),
            "model_state": bundle.get("model_state") or {}}
