"""Checkpoint loader for the JAX package's pickle bundles.

``curriculum_learning_for_vln_tpu/engine/checkpoint.py`` writes one
pickled bundle of numpy pytrees: {"params", "opt_state", "model_state",
"rng", "epoch", "curriculum", "cfg_yaml", "extra"}.  Its ``opt_state``
holds optax classes, so a plain ``pickle.load`` would import optax and
jax.  ``load_checkpoint`` unpickles with a loader that admits numpy's
array reconstruction and plain builtin containers only, and stands an
inert stub in for every other class, so the bundle's arrays come back
without importing either.  (The orbax directory format is not read.)
"""
from __future__ import annotations

import pickle

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
