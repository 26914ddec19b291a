"""Carry weights across from the JAX package, and back.

The port keeps the JAX package's parameter names and layouts (dense
``w`` [in, out]; LSTM ``w_ih`` [D, 4H], ``w_hh`` [H, 4H], ``b_ih``,
``b_hh``, gate order i, f, g, o; the Self-Monitor's positional table
``pe`` a leaf), so an EnvDrop, Follower, Self-Monitor or speaker
parameter tree (the speaker's: encoder ``lstm_fwd``, ``lstm_bwd``,
``attn``, ``post_fwd``, ``post_bwd``; decoder ``embedding``, ``lstm``,
``attn``, ``projection``, ``baseline_fc1``, ``baseline_fc2``) or a
VLN-BERT scorer's (``bert`` with its embeddings, ``t_layers``,
``v_layers``, ``c_layers`` and poolers; ``cls``; ``vil_logit``) converts
leaf for leaf and both packages compute the same function from it; so
does a model state (the Self-Monitor's BN statistics: mean, var
and count of each BatchNorm, under "decoder_bn").  Each tree is
recognised by the key paths it holds.
"""
from __future__ import annotations

import numpy as np
import torch

from .utils.tree import tree_map

_ENCODER_KEYS = (("encoder", "embedding", "w"), ("encoder", "enc2dec", "w"),
                 ("encoder", "layers"))
# key paths each agent's parameter tree holds
_TREE_KEYS = {
    "ENVDROP": _ENCODER_KEYS + (
        ("decoder", "act_embed", "w"), ("decoder", "lstm", "w_ih"), ("decoder", "lstm", "w_hh"),
        ("decoder", "text_attn", "linear_in", "w"), ("decoder", "text_attn", "linear_out", "w"),
        ("decoder", "visual_attn", "linear_in", "w"), ("decoder", "cand_attn", "w"),
        ("critic", "fc1", "w"), ("critic", "fc2", "w")),
    "FOLLOWER": _ENCODER_KEYS + (
        ("decoder", "lstm", "w_ih"), ("decoder", "text_attn", "linear_in", "w"),
        ("decoder", "text_attn", "linear_out", "w"),
        ("decoder", "visual_attn", "linear_in_h", "w"),
        ("decoder", "visual_attn", "linear_in_v", "w"),
        ("decoder", "decode_action", "linear_act", "w"),
        ("decoder", "decode_action", "linear_out", "w")),
    "SELF-MONITOR": _ENCODER_KEYS + (
        ("decoder", "proj_navigable_mlp", "layers"), ("decoder", "proj_navigable_mlp", "bn_in"),
        ("decoder", "pe"), ("decoder", "text_attn", "linear_in", "w"),
        ("decoder", "visual_attn", "linear_in_h", "w"), ("decoder", "lstm", "w_ih"),
        ("decoder", "action_linear", "w"), ("decoder", "monitor_linear", "w"),
        ("decoder", "critic", "w")),
    "SPEAKER": (
        ("encoder", "lstm_fwd", "w_ih"), ("encoder", "lstm_bwd"),
        ("encoder", "attn", "linear_in", "w"), ("encoder", "attn", "linear_out", "w"),
        ("encoder", "post_fwd", "w_ih"), ("encoder", "post_bwd"),
        ("decoder", "embedding", "w"), ("decoder", "lstm", "w_ih"),
        ("decoder", "attn", "linear_in", "w"), ("decoder", "projection", "w"),
        ("decoder", "baseline_fc1", "w"), ("decoder", "baseline_fc2", "w")),
    # the VLN-BERT scorer (models/vilbert.py: vlnbert_init)
    "VILBERT": (
        ("bert", "embeddings", "word"), ("bert", "embeddings", "ln", "scale"),
        ("bert", "v_embeddings", "image", "w"), ("bert", "v_embeddings", "sequence"),
        ("bert", "t_layers"), ("bert", "v_layers"), ("bert", "c_layers"),
        ("bert", "t_pooler", "w"), ("bert", "v_pooler", "w"),
        ("cls", "transform", "w"), ("cls", "decoder_bias"), ("cls", "v_decoder", "w"),
        ("vil_logit", "w")),
    # the sub-instruction family (models/subinstr.py), unused on the main path
    "SUB-MONITOR": (
        ("proj_navigable_mlp", "layers"), ("proj_navigable_mlp", "bn_in"), ("pe",),
        ("text_attn", "linear_in", "w"), ("visual_attn", "linear_in_h", "w"), ("lstm", "w_ih"),
        ("action_linear", "w")),
    "INSTR-SHIFTING": (("linear0", "w"), ("linear1", "w"), ("linear2", "w"), ("linear3", "w")),
}
_STATE_KEYS = (("decoder_bn", "mlp", "bn_in", "mean"), ("decoder_bn", "mlp", "bns"))


def _has(tree, path) -> bool:
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def tree_kind(tree: dict) -> str:
    """The model whose parameter tree this is ("ENVDROP", "FOLLOWER",
    "SELF-MONITOR", "SPEAKER", "VILBERT", or the sub-instruction decoder's
    or shifting head's); raises on a tree of none of them."""
    for kind, paths in _TREE_KEYS.items():
        if all(_has(tree, p) for p in paths):
            return kind
    raise ValueError("not an EnvDrop, Follower or Self-Monitor parameter tree, nor a speaker's, "
                     "a VLN-BERT scorer's or a sub-instruction module's")


def _leaf_to_torch(x):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: dict) -> dict:
    """The port's parameters (CPU tensors, f32) from a JAX EnvDrop, Follower,
    Self-Monitor, speaker, VLN-BERT or sub-instruction parameter tree of
    numpy arrays.  Raises on a tree of none of their structures."""
    tree_kind(tree)
    return tree_map(_leaf_to_torch, tree)


def params_to_jax(params: dict) -> dict:
    """The inverse of ``params_from_jax``: the tree of numpy f32 arrays in the
    JAX layout (what the JAX package's checkpoint bundle holds): the port
    keeps that layout, so only the array type changes."""
    from .engine.checkpoint import to_numpy  # engine's trainers import this module

    return to_numpy(params)


def model_state_from_jax(state: dict) -> dict:
    """The port's model state (CPU tensors, f32) from a JAX one: {} (EnvDrop,
    Follower) or the Self-Monitor's {"decoder_bn": {"mlp": {"bn_in": {mean,
    var, count}, "bns": [...]}}}."""
    if state and not all(_has(state, p) for p in _STATE_KEYS):
        raise ValueError(f"not a model state of a ported agent: keys {sorted(state)}")
    return tree_map(_leaf_to_torch, state or {})


def model_state_to_jax(state: dict) -> dict:
    """The inverse of ``model_state_from_jax``."""
    from .engine.checkpoint import to_numpy

    return to_numpy(state or {})


def load_jax_checkpoint(path: str) -> dict:
    """{"params", "model_state"} of a JAX checkpoint bundle, read without
    jax or optax (engine/checkpoint.py), both converted to the port's."""
    from .engine.checkpoint import load_checkpoint

    bundle = load_checkpoint(path)
    return {"params": params_from_jax(bundle["params"]),
            "model_state": model_state_from_jax(bundle.get("model_state") or {})}
