"""Checkpoints: the JAX package's pickle bundle, read and written.

``curriculum_learning_for_vln_tpu/engine/checkpoint.py`` writes one
pickled bundle of numpy pytrees: {"params", "opt_state", "model_state",
"rng", "epoch", "curriculum", "cfg_yaml", "extra"}.  Its ``opt_state``
holds optax classes, so a plain ``pickle.load`` would import optax and
jax.  ``load_checkpoint`` unpickles with a loader that admits numpy's
array reconstruction and plain builtin containers only, and stands an
inert stub in for every other class, so the bundle's arrays come back
without importing either.  The JAX package's orbax directory format
(TPU.CKPT_BACKEND orbax, checkpoint.py:123-188) keeps its tree structure
as a pickled JAX treedef, which only ``jax`` can read, and the port never
imports ``jax``: ``load_checkpoint`` refuses a directory with a
``ValueError`` that says so, and ``save_checkpoint`` writes its pickle
bundle for any backend but "pickle" after one logged warning.

``save_checkpoint`` writes the same layout from the port: ``params`` and
``model_state`` (the Self-Monitor's BN statistics) as numpy arrays in the
JAX layout (``convert.params_to_jax``, ``model_state_to_jax``), so either
package's loader reads them; ``opt_state`` the port's own optimizer state
(``torch.optim`` state dict, tensors as numpy); ``rng`` the state of the
port's generator; ``curriculum`` a curriculum trainer's state in the
JAX package's form (SPCL: {"weight", "lamb", "loss_for_item"}, numpy);
only numpy arrays and builtin containers, so ``load_checkpoint`` reads it
back whole.  ``restore_training_state`` takes the optimizer and generator
state of a port bundle only: a JAX bundle's optax state and PRNG key have
no counterpart in the port, so resuming one restarts both (its
parameters and curriculum state carry over).

``save_checkpoint(async_write=True)`` (TPU.CKPT_ASYNC, checkpoint.py:
30-59) hands the write to one background worker, so that it overlaps the
next epoch: the snapshot (every tensor copied to numpy) is taken on the
caller's thread, so the bundle is the state at the call; ``pre_tasks``
(the trainers' rotation deletes) run on the worker just before their
write, so deletes and writes keep the order of the calls.
``wait_for_checkpoints`` waits for every queued write and raises the
first writer exception again.
"""
from __future__ import annotations

import logging
import os
import pickle
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..utils.tree import tree_map

logger = logging.getLogger("main.checkpoint")

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
    builtin container (such as the optax optimizer state) stubbed out.
    Raises ``ValueError`` on a directory: the JAX package's orbax format."""
    if os.path.isdir(path) or (not os.path.exists(path) and os.path.isdir(path + ".orbax_old")):
        raise ValueError(
            f"{path} is a directory checkpoint, the JAX package's orbax format "
            "(TPU.CKPT_BACKEND orbax): its tree structure is a pickled JAX treedef, which the "
            "PyTorch port cannot read without jax; write the checkpoint with TPU.CKPT_BACKEND "
            "pickle")
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


# the writer of TPU.CKPT_ASYNC: one worker, so writes and rotation deletes
# run in the order of the calls
_ASYNC_LOCK = threading.Lock()
_ASYNC_EXEC: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []
_WARNED_BACKENDS = set()


def _executor() -> ThreadPoolExecutor:
    global _ASYNC_EXEC
    with _ASYNC_LOCK:
        if _ASYNC_EXEC is None:
            _ASYNC_EXEC = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-writer")
        return _ASYNC_EXEC


def wait_for_checkpoints() -> None:
    """Block until every queued checkpoint write has finished; raises the
    first writer exception again (checkpoint.py:52-59)."""
    with _ASYNC_LOCK:
        pending, _PENDING[:] = _PENDING[:], []
    for fut in pending:
        fut.result()


def save_checkpoint(path: str, params: dict, optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None, epoch: int = 0,
                    cfg_yaml: Optional[str] = None, curriculum: Optional[dict] = None,
                    model_state: Optional[dict] = None, backend: str = "pickle",
                    async_write: bool = False,
                    pre_tasks: Sequence[Callable[[], None]] = ()) -> None:
    """Write one bundle atomically (a temporary file, then a rename; a
    directory at ``path``, an orbax checkpoint of an earlier run, is
    removed first).  ``backend`` other than "pickle" (TPU.CKPT_BACKEND)
    writes the same file after one warning.  ``pre_tasks`` run just before
    the write; with ``async_write`` both run on the writer thread, from a
    snapshot taken here."""
    if backend != "pickle" and backend not in _WARNED_BACKENDS:
        _WARNED_BACKENDS.add(backend)
        logger.warning("TPU.CKPT_BACKEND %r: the JAX package's orbax directory format needs jax, "
                       "which the PyTorch port does not import; writing the pickle bundle",
                       backend)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    bundle = {
        "params": to_numpy(params),  # the JAX layout (convert.params_to_jax)
        "opt_state": to_numpy(optimizer.state_dict()) if optimizer is not None else None,
        "model_state": to_numpy(model_state) if model_state is not None else {},
        "rng": generator.get_state().numpy().copy() if generator is not None else None,
        "epoch": int(epoch),
        "curriculum": to_numpy(curriculum) if curriculum is not None else None,
        "cfg_yaml": cfg_yaml,
        "extra": {},
    }

    def write():
        for task in pre_tasks:  # e.g. the best-SR rotation's clean_dir
            task()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(bundle, f, protocol=pickle.HIGHEST_PROTOCOL)
        if os.path.isdir(path):  # an earlier run wrote the orbax format here
            shutil.rmtree(path)
        os.replace(tmp, path)

    if async_write:
        fut = _executor().submit(write)
        with _ASYNC_LOCK:
            _PENDING.append(fut)
        return
    write()


def restore_training_state(bundle: dict, optimizer: Optional[torch.optim.Optimizer] = None,
                           generator: Optional[torch.Generator] = None) -> int:
    """Load a port bundle's optimizer and generator state; returns its epoch.
    A JAX bundle's (an optax state, a uint32 PRNG key) is left out."""
    opt_state, rng = bundle.get("opt_state"), bundle.get("rng")
    if optimizer is not None and isinstance(opt_state, dict) and "param_groups" in opt_state:
        optimizer.load_state_dict(tree_map(
            lambda x: torch.from_numpy(x.copy()) if isinstance(x, np.ndarray) else x, opt_state))
    if generator is not None and isinstance(rng, np.ndarray) and rng.dtype == np.uint8:
        generator.set_state(torch.from_numpy(rng.copy()))
    return int(bundle.get("epoch", 0))
