"""Host-side episode batching: the R2RBatch facade.

The port of ``curriculum_learning_for_vln_tpu/env/host_env.py``'s
``R2RBatchEnv`` (ref: tasks/R2R-judy/src/environ/common_env.py:117-365).
The host only *selects episodes*: every per-item field is packed into
numpy arrays once and copied to the device, and a minibatch is one index
upload plus device gathers producing an ``EpisodeBatch``.

Kept from the JAX package, number for number:
* the infinite shuffled iterator with wraparound reshuffle, drawn from
  ``np.random.default_rng(seed)`` (host_env.py:76,118,173-187), so the
  batch order for a seed is the JAX package's;
* the stable sort by instruction length within a minibatch;
* exact-coverage evaluation batches, the tail padded with ``valid=False``
  slots (evaluator.py:124-126 asserts coverage);
* ``cur_batch_max_hops``, the IL episode-length bucketing key.

Not ported yet: the gt-route ("path") teacher tables, the mesh sharding
hooks, ``restart``/``inject_batch`` (back-translation) and the CLR2R
curriculum env (``CLR2RBatchEnv``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..utils.tokenizer import Tokenizer
from ..world.compiler import CompiledWorld, resolve_device
from .env import EpisodeBatch


class R2RBatchEnv:
    """Episode sampler over an expanded instruction dataset."""

    def __init__(self, world: CompiledWorld, data: Sequence[dict], batch_size: int,
                 tokenizer: Optional[Tokenizer] = None, seed: int = 0, name: str = "train",
                 sort_by_length: bool = True, teacher_mode: str = "goal", device=None):
        if teacher_mode != "goal":
            raise NotImplementedError(f"teacher_mode {teacher_mode!r} is not ported yet")
        self.world = world
        self.data: List[dict] = list(data)
        self.batch_size = batch_size
        self.tok = tokenizer
        self.name = name
        self.sort_by_length = sort_by_length
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)

        n = len(self.data)
        if n == 0:
            raise ValueError("Empty dataset")
        L = len(self.data[0]["instr_encoding"])
        self.instr_tokens = np.zeros((n, L), dtype=np.int64)
        self.instr_len = np.zeros(n, dtype=np.int64)
        self.start_node = np.zeros(n, dtype=np.int64)
        self.start_heading = np.zeros(n, dtype=np.float32)
        self.goal = np.zeros(n, dtype=np.int64)
        self.goal_local = np.zeros(n, dtype=np.int64)
        self.hops = np.zeros(n, dtype=np.int64)  # teacher-path edge count
        for i, item in enumerate(self.data):
            self.hops[i] = len(item["path"]) - 1
            self.instr_tokens[i] = item["instr_encoding"]
            self.instr_len[i] = item["instr_length"]
            start = world.global_id(item["scan"], item["path"][0])
            goal = world.global_id(item["scan"], item["path"][-1])
            self.start_node[i] = start
            self.goal[i] = goal
            self.goal_local[i] = world.node_local[goal]
            self.start_heading[i] = item["heading"]

        self._order = self._rng.permutation(n)
        self.ix = 0
        self._cur_indices: Optional[np.ndarray] = None
        self._cur_valid: Optional[np.ndarray] = None
        self._dev = {k: torch.from_numpy(getattr(self, k)).to(self.device)
                     for k in ("instr_tokens", "instr_len", "start_node", "start_heading",
                               "goal", "goal_local")}

    # -- core iteration ---------------------------------------------------
    def size(self) -> int:
        return len(self.data)

    def _next_indices(self) -> np.ndarray:
        n = len(self.data)
        idx = self._order[self.ix: self.ix + self.batch_size]
        if len(idx) < self.batch_size:
            self._order = self._rng.permutation(n)
            self.ix = self.batch_size - len(idx)
            idx = np.concatenate([idx, self._order[: self.ix]])
        else:
            self.ix += self.batch_size
        return idx.astype(np.int64)

    def _make_batch(self, idx: np.ndarray, valid: Optional[np.ndarray] = None) -> EpisodeBatch:
        if valid is None:
            valid = np.ones(len(idx), dtype=bool)
        if self.sort_by_length:
            order = np.argsort(-self.instr_len[idx], kind="stable")
            idx, valid = idx[order], valid[order]
        self._cur_indices, self._cur_valid = idx, valid
        ix = torch.from_numpy(idx).to(self.device)
        return EpisodeBatch(**{k: v[ix] for k, v in self._dev.items()}, item_idx=ix,
                            valid=torch.from_numpy(valid).to(self.device))

    def next_batch(self) -> EpisodeBatch:
        """The next training minibatch."""
        return self._make_batch(self._next_indices())

    @property
    def cur_batch_index(self) -> np.ndarray:
        """Dataset indices of the current batch rows."""
        assert self._cur_indices is not None
        return self._cur_indices

    @property
    def cur_batch_max_hops(self) -> int:
        """Longest teacher path (edges) in the current batch — the IL
        episode-length bucketing key (a teacher-forced episode needs
        exactly hops+1 steps incl. STOP)."""
        assert self._cur_indices is not None
        return int(self.hops[self._cur_indices].max())

    def eval_batches(self) -> Iterator[EpisodeBatch]:
        """Cover every item exactly once; tail padded with valid=False."""
        n = len(self.data)
        order = np.arange(n, dtype=np.int64)
        for s in range(0, n, self.batch_size):
            idx = order[s: s + self.batch_size]
            valid = np.ones(len(idx), dtype=bool)
            if len(idx) < self.batch_size:
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, np.zeros(pad, dtype=np.int64)])
                valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
            yield self._make_batch(idx, valid)
