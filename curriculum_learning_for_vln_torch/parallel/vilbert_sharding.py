"""Tensor parallelism for the ViLBERT scorer over the mesh's 'model' axis.

The port of ``curriculum_learning_for_vln_tpu/parallel/vilbert_sharding.py``
(Megatron-style, as there):

* attention q / k / v and the bi-attention q1 ... v2: column-parallel
  (the heads split over 'model');
* the attention output, the biOutput ``dense1`` / ``dense2``: row-parallel;
* the FFNs' ``inter``, ``v_inter``, ``t_inter``: column-parallel; ``out``,
  ``v_out``, ``t_out``: row-parallel;
* embeddings, LayerNorms, poolers and heads: replicated.

XLA inserts the all-reduces after the row-parallel products for JAX; here
``models/vilbert.py`` makes them (``TensorParallel.reduce``, one after
each row-parallel product, the bias added once after it).  Scoring only:
``vilbert_apply`` refuses ``train=True`` with a tensor-parallel group
(its dropout would draw over a rank's heads), and ViLBERT trains
replicated.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..utils.tree import tree_map
from .mesh import Mesh


class P:
    """A leaf's partition (JAX's PartitionSpec): axes[i] == "model" splits
    dimension i over the model group; P() is replicated."""

    def __init__(self, *axes):
        self.axes = axes

    def __repr__(self) -> str:
        return f"P{self.axes}"


def _col():
    return {"w": P(None, "model"), "b": P("model")}


def _row():
    return {"w": P("model", None), "b": P()}


def _ln():
    return {"scale": P(), "bias": P()}


def _layer_spec() -> dict:
    return {"attn": {"query": _col(), "key": _col(), "value": _col()},
            "attn_out": _row(), "attn_ln": _ln(), "inter": _col(), "out": _row(),
            "out_ln": _ln()}


def _connection_spec() -> dict:
    return {"q1": _col(), "k1": _col(), "v1": _col(), "q2": _col(), "k2": _col(),
            "v2": _col(), "dense1": _row(), "ln1": _ln(), "dense2": _row(), "ln2": _ln(),
            "v_inter": _col(), "v_out": _row(), "v_ln": _ln(), "t_inter": _col(),
            "t_out": _row(), "t_ln": _ln()}


def vilbert_param_specs(params: dict) -> dict:
    """The P tree of a ViLBERT (``vilbert_init``) or VLNBert
    (``vlnbert_init``) parameter tree."""
    def rep_like(tree):
        return tree_map(lambda _: P(), tree)

    bert = params["bert"] if "bert" in params else params
    bert_spec = {
        "embeddings": rep_like(bert["embeddings"]),
        "v_embeddings": rep_like(bert["v_embeddings"]),
        "t_layers": [_layer_spec() for _ in bert["t_layers"]],
        "v_layers": [_layer_spec() for _ in bert["v_layers"]],
        "c_layers": [_connection_spec() for _ in bert["c_layers"]],
        "t_pooler": rep_like(bert["t_pooler"]),
        "v_pooler": rep_like(bert["v_pooler"]),
    }
    if "bert" not in params:
        return bert_spec
    return {"bert": bert_spec, **{k: rep_like(v) for k, v in params.items() if k != "bert"}}


def _zip_map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], spec[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, t, s) for t, s in zip(tree, spec, strict=True)]
    return fn(tree, spec)


def shard_vilbert_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slices of the scorer's parameters: each leaf's dimension
    marked "model" cut into ``mesh.model`` equal parts, part
    ``mesh.model_index`` kept; replicated leaves as they are."""
    def cut(t: torch.Tensor, spec: P) -> torch.Tensor:
        if "model" not in spec.axes:
            return t
        dim = spec.axes.index("model")
        n = t.shape[dim] // mesh.model
        if n * mesh.model != t.shape[dim]:
            raise ValueError(f"a dimension of {t.shape[dim]} does not split over "
                             f"model = {mesh.model}")
        return t.narrow(dim, mesh.model_index * n, n).contiguous()

    return _zip_map(cut, params, vilbert_param_specs(params))


class TensorParallel:
    """The model group of a tensor-parallel scorer (``size`` ranks);
    ``reduce`` sums a row-parallel product's partial sums."""

    def __init__(self, mesh: Mesh):
        self.size, self.group = mesh.model, mesh.model_group

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("tensor-parallel ViLBERT scores without autograd")
        out = x.contiguous()
        dist.all_reduce(out, group=self.group)
        return out


def tensor_parallel(mesh: Optional[Mesh]) -> Optional[TensorParallel]:
    """The scorer's tensor-parallel group of ``mesh`` (None: replicated)."""
    if mesh is None or mesh.model == 1 or not mesh.distributed:
        return None
    return TensorParallel(mesh)
