"""Tracing and step timing.

The port of ``curriculum_learning_for_vln_tpu/utils/profiling.py``:
``trace(logdir)`` records a ``torch.profiler`` trace (the host's ops
and, on a GPU, the card's kernels) around any code region and writes it
as a Chrome trace (``trace_<pid>.json``, viewable in Perfetto or
chrome://tracing) under ``logdir``; ``StepTimer`` keeps named wall-clock
timers that synchronize the card on stop, and writes their means to the
scalar writer.  The trainers trace their second epoch with
``TPU.PROFILE_DIR`` (engine/trainer.py).

``span(name)`` marks a region of the program as ``vln.<name>`` in the
same trace, on the profiler's clock, so that the card's idle time can
be put down to what the host was doing; it records only while a
profiler records, and costs one flag read otherwise.  A span's layer is
its name up to the second dot (``vln.rollout.decode``: the rollout).
The spans: ``vln.iter`` (engine/loop.py's iterations) and ``vln.call``
(``Navigator.navigate_batch``); ``vln.data.next_batch``, ``.weights``,
``.record``, ``.episodes``, ``.assemble`` (the batch build, SPCL's
weights and loss record, serving's episode batch and trajectories);
``vln.rollout.encode``, ``.scan``, ``.packed``, ``.observe``,
``.decode``, ``.env``, ``.refill``, ``.loss`` (the encoder, the step
loops and each live step's parts, the losses); ``vln.update.backward``,
``.clip``, ``.optim``.  ViLBERT pretraining (engine/pretrain.py,
models/vilbert.py): ``vln.iter`` a step; ``vln.pretrain.batch``,
``.masks``, ``.loss`` (a batch's gather, the masks, the loss terms);
``vln.vilbert.embed``, ``.text``, ``.vision``, ``.coattn`` (each layer),
``.heads`` (the poolers; the heads and the fused logits).
``scripts/torch_span_table.py`` reads them; the benchmark's
``lib/program_spans.py`` puts device time under them, a backward's with
its forward.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("vln." + name)`` while a ``torch.profiler``
    records, else one shared null context (no ``record_function`` is
    made)."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function("vln." + name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region with ``torch.profiler`` and write its
    Chrome trace under ``logdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync(True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


def _sync(sync: bool) -> None:
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Named wall-clock timers; with ``sync`` the card is synchronized
    before a timer stops, so the time includes the work it queued."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str, sync: bool = True) -> float:
        _sync(sync)
        dt = time.perf_counter() - self._starts.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def write_scalars(self, writer, step: int, prefix: str = "perf") -> None:
        for name, s in self.summary().items():
            writer.add_scalar(f"{prefix}/{name}_mean_ms", s["mean_ms"], step)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self._starts.clear()
