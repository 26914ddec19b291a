"""Host-side episode batching: the R2RBatch / CLR2RBatch facades.

The port of ``curriculum_learning_for_vln_tpu/env/host_env.py``'s
``R2RBatchEnv`` and ``CLR2RBatchEnv`` (ref:
tasks/R2R-judy/src/environ/common_env.py:117-365, curriculum_env.py:26-102).
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
* ``cur_batch_max_hops``, the IL episode-length bucketing key;
* the teacher's waypoint table (host_env.py:100-116): ``teacher_mode``
  "goal" packs the goal alone (P = 1, the reference's goal-directed
  teacher), "path" the full gt route, P the longest route of the data,
  each row padded with the goal (env/env.py::_teacher_target);
* the CLR2R curriculum bookkeeping: the rounds concatenated in order,
  difficulty ``a`` (the round of each item), capacity ``c = sum(a) *
  c_rate`` and the item -> global index map of the SPCL solver.

``inject_batch`` (host_env.py:236-253) rebuilds the current batch with
instructions the speaker generated (back-translation).

``set_sharding(mesh)`` (host_env.py:126-147) makes ``next_batch`` emit
this rank's rows of each batch: every rank draws the same episode
selection from the same seed (the global batch, ``cur_full_batch``, its
``cur_batch_index`` and ``cur_batch_max_hops``) and keeps its rows.
Evaluation batches stay whole on every rank (the JAX package's multi-
process choice, trainer.py:66), so that scoring stays local.  Not
ported: ``restart``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as M
from ..utils.profiling import span
from ..utils.tokenizer import Tokenizer
from ..world.compiler import CompiledWorld, resolve_device
from .env import EpisodeBatch


class R2RBatchEnv:
    """Episode sampler over an expanded instruction dataset."""

    def __init__(self, world: CompiledWorld, data: Sequence[dict], batch_size: int,
                 tokenizer: Optional[Tokenizer] = None, seed: int = 0, name: str = "train",
                 sort_by_length: bool = True, teacher_mode: str = "goal", device=None):
        self.world = world
        self.data: List[dict] = list(data)
        self.batch_size = batch_size
        self.tok = tokenizer
        self.name = name
        self.teacher_mode = teacher_mode
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

        if teacher_mode == "path":
            P = max(len(item["path"]) for item in self.data)
        elif teacher_mode == "goal":
            P = 1
        else:
            raise ValueError(f"teacher_mode: {teacher_mode!r}")
        self.path_local = np.tile(self.goal_local[:, None], (1, P))
        self.path_len = np.ones(n, dtype=np.int64)
        if teacher_mode == "path":
            for i, item in enumerate(self.data):
                ids = [world.node_local[world.global_id(item["scan"], vp)] for vp in item["path"]]
                self.path_local[i, :len(ids)] = ids
                self.path_len[i] = len(ids)

        self._order = self._rng.permutation(n)
        self.ix = 0
        self._cur_indices: Optional[np.ndarray] = None
        self._cur_valid: Optional[np.ndarray] = None
        self.cur_full_batch: Optional[EpisodeBatch] = None
        self._mesh = None  # a data-parallel mesh whose rows next_batch emits
        self._dev = {k: torch.from_numpy(getattr(self, k)).to(self.device)
                     for k in ("instr_tokens", "instr_len", "start_node", "start_heading",
                               "goal", "goal_local", "path_local", "path_len")}

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

    def set_sharding(self, mesh) -> None:
        """Emit this rank's rows of every training batch of ``mesh`` (None:
        the whole batch)."""
        self._mesh = mesh if mesh is not None and mesh.data > 1 else None

    def _place(self, batch: EpisodeBatch) -> EpisodeBatch:
        return batch if self._mesh is None else M.shard_batch(batch, self._mesh)

    def next_batch(self) -> EpisodeBatch:
        """The next training minibatch (this rank's rows of it under
        ``set_sharding``; the whole of it is ``cur_full_batch``)."""
        with span("data.next_batch"):
            self.cur_full_batch = self._make_batch(self._next_indices())
            return self._place(self.cur_full_batch)

    def inject_batch(self, idx: np.ndarray, instr_tokens: np.ndarray,
                     instr_len: np.ndarray) -> EpisodeBatch:
        """The episodes ``idx`` (in this order, every slot valid) with their
        instructions replaced by ``instr_tokens`` [B, L] and ``instr_len``
        [B] (the back-translation path, host_env.py:236-253; ref:
        envdrop.py:105-121); they become the current batch."""
        idx = np.asarray(idx, dtype=np.int64)
        valid = np.ones(len(idx), dtype=bool)
        self._cur_indices, self._cur_valid = idx, valid
        ix = torch.from_numpy(idx).to(self.device)
        fields = {k: v[ix] for k, v in self._dev.items()}
        for name, value in (("instr_tokens", instr_tokens), ("instr_len", instr_len)):
            fields[name] = torch.from_numpy(np.asarray(value, np.int64)).to(self.device)
        return EpisodeBatch(**fields, item_idx=ix, valid=torch.from_numpy(valid).to(self.device))

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


class CLR2RBatchEnv(R2RBatchEnv):
    """Curriculum dataset: all 5 CLR2R rounds with SPCL bookkeeping."""

    def __init__(self, world: CompiledWorld, rounds: Dict[str, List[dict]], batch_size: int,
                 c_rate: float = 0.8, tokenizer: Optional[Tokenizer] = None, seed: int = 0,
                 teacher_mode: str = "goal", device=None):
        data: List[dict] = []
        difficulties: List[int] = []
        for k in range(1, len(rounds) + 1):
            round_items = rounds[f"round_{k}"]
            data.extend(round_items)
            difficulties.extend([k] * len(round_items))
        super().__init__(world, data, batch_size, tokenizer=tokenizer, seed=seed, name="train",
                         teacher_mode=teacher_mode, device=device)
        # a[i] = difficulty (round number); capacity c = sum(a) * c_rate
        # (ref: curriculum_env.py:81-92).  Item order *is* the global index.
        self.a = np.array(difficulties, dtype=np.float32)
        self.c = float(self.a.sum() * c_rate)
        self.item2idx = {item["instr_id"]: i for i, item in enumerate(self.data)}

    def __len__(self) -> int:
        return len(self.data)

    def index(self, item: dict) -> int:
        return self.item2idx[item["instr_id"]]
