"""Checkpoints: the JAX package's pickle bundle, read and written.

``curriculum_learning_for_vln_tpu/engine/checkpoint.py`` writes one
pickled bundle of numpy pytrees: {"params", "opt_state", "model_state",
"rng", "epoch", "curriculum", "cfg_yaml", "extra"}.  Its ``opt_state``
holds optax classes, so a plain ``pickle.load`` would import optax and
jax.  ``load_checkpoint`` unpickles with a loader that admits numpy's
array reconstruction and plain builtin containers only, and stands an
inert stub in for every other class, so the bundle's arrays come back
without importing either.  (The orbax directory format is not read.)

``save_checkpoint`` writes the same layout from the port: ``params`` as
numpy arrays in the JAX layout (``convert.params_to_jax``), so either
package's loader reads them; ``opt_state`` the port's own optimizer state
(``torch.optim`` state dict, tensors as numpy); ``rng`` the state of the
port's generator; only numpy arrays and builtin containers, so
``load_checkpoint`` reads it back whole.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from ..utils.tree import tree_map

_NUMPY_MODULES = {"numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric", "numpy.dtypes"}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
             "bool", "str", "bytes", "bytearray", "slice", "range"}


class _Stub:
    """Inert stand-in for a class the loader does not admit."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _BundleUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _NUMPY_MODULES or (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": f"stub:{module}"})


def load_checkpoint(path: str) -> dict:
    """The bundle at ``path``, with anything that is not numpy or a plain
    builtin container (such as the optax optimizer state) stubbed out."""
    with open(path, "rb") as f:
        return _BundleUnpickler(f).load()


def _leaf_to_numpy(x: Any) -> Any:
    if not isinstance(x, torch.Tensor):
        return x
    t = x.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def to_numpy(tree: Any) -> Any:
    """A tree of tensors as the same tree of numpy arrays (f32 for floats);
    other leaves stay as they are."""
    return tree_map(_leaf_to_numpy, tree)


def save_checkpoint(path: str, params: dict, optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None, epoch: int = 0,
                    cfg_yaml: Optional[str] = None) -> None:
    """Write one bundle atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    bundle = {
        "params": to_numpy(params),  # the JAX layout (convert.params_to_jax)
        "opt_state": to_numpy(optimizer.state_dict()) if optimizer is not None else None,
        "model_state": {},
        "rng": generator.get_state().numpy().copy() if generator is not None else None,
        "epoch": int(epoch),
        "curriculum": None,
        "cfg_yaml": cfg_yaml,
        "extra": {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(bundle, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def restore_training_state(bundle: dict, optimizer: Optional[torch.optim.Optimizer] = None,
                           generator: Optional[torch.Generator] = None) -> int:
    """Load a port bundle's optimizer and generator state; returns its epoch."""
    if optimizer is not None and bundle.get("opt_state") is not None:
        optimizer.load_state_dict(tree_map(
            lambda x: torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x,
            bundle["opt_state"]))
    if generator is not None and bundle.get("rng") is not None:
        generator.set_state(torch.from_numpy(np.asarray(bundle["rng"], np.uint8).copy()))
    return int(bundle.get("epoch", 0))
