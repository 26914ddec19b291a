"""Logging, metric summaries, and scalar event recording.

A copy of ``curriculum_learning_for_vln_tpu/utils/logging_utils.py`` (numpy only), kept
in the port so that it imports nothing of the JAX package.

Covers the reference's three observability channels
(`tasks/R2R-judy/src/utils/misc.py:398-467`, trainer tensorboardX usage):

1. ``get_main_logger`` — timestamped file logger under a log dir.
2. ``prettyprint`` — console table of PL/NE/SR/OSR/SPL/nDTW/SDTW/CLS
   (dependency-free text table instead of prettytable).
3. ``ScalarWriter`` — scalar/histogram event sink writing JSONL (always)
   and TensorBoard event files when the ``tensorboard`` package is
   installed.  The event files are written from tensorboard's protobuf
   messages and record framing alone: ``torch.utils.tensorboard`` and
   tensorboard's own file writer import TensorFlow where it is installed,
   and TensorFlow's Keras imports JAX, which the port never loads.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Optional

import numpy as np


def get_main_logger(log_dir: Optional[str] = None, model_name: str = "", save_mode: str = "dhm") -> logging.Logger:
    """File logger named "main" (ref: misc.py:398-435)."""
    logger = logging.getLogger("main")
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(
        fmt="%(asctime)s - %(levelname)s: %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    mode_str = {"dhm": "%Y-%m%d-%H:%M", "dh": "%Y-%m%d-%H", "d": "%Y-%m%d"}
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fname = time.strftime(mode_str[save_mode], time.localtime()) + "_" + model_name + ".log"
        handler = logging.FileHandler(os.path.join(log_dir, fname), mode="a", encoding="utf-8")
        handler.setLevel(logging.INFO)
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    return logger


_FIELDS = [" ", "PL(↓)", "NE(↓)", "SR(↑)", "OSR(↑)", "SPL(↑)", "nDTW(↑)", "SDTW(↑)", "CLS(↑)"]
_KEYS = ["lengths", "nav_error", "success_rate", "oracle_rate", "spl", "ndtw", "sdtw", "cls"]


def format_score_table(score_dict: dict) -> str:
    """Text table of evaluation outcomes (ref: misc.py:438-463)."""
    rows = [_FIELDS]
    for split_name, summary in score_dict.items():
        row = [str(split_name)]
        for k in _KEYS:
            v = summary.get(k, "-")
            row.append(f"{v:.4f}" if isinstance(v, (int, float, np.floating)) else str(v))
        rows.append(row)
    widths = [max(len(r[i]) for r in rows) for i in range(len(_FIELDS))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep]
    for r in rows:
        lines.append("| " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |")
        lines.append(sep)
    return "\n".join(lines)


def prettyprint(score_dict: dict) -> None:
    table = format_score_table(score_dict)
    print(table)
    logging.getLogger("main").info("\n" + table)


def pretty_json_dump(obj, fp) -> None:
    json.dump(obj, fp, sort_keys=True, indent=4, separators=(",", ":"))


class _EventFile:
    """A TensorBoard event file (``events.out.tfevents.*``): Event messages
    in TFRecord framing, from the ``tensorboard`` package's protobuf
    classes and record writer, neither of which imports TensorFlow."""

    def __init__(self, logdir: str):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = event_pb2.Event, summary_pb2
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._records = RecordWriter(open(os.path.join(logdir, name), "wb"))
        self._write(file_version="brain.Event:2")

    def _write(self, **fields) -> None:
        self._records.write(self._event(wall_time=time.time(), **fields).SerializeToString())
        self._records.flush()

    def _value(self, step: int, **value) -> None:
        summary = self._summary.Summary(value=[self._summary.Summary.Value(**value)])
        self._write(step=int(step), summary=summary)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._value(step, tag=tag, simple_value=float(value))

    def histogram(self, tag: str, arr: np.ndarray, step: int) -> None:
        if not arr.size:
            return
        counts, edges = np.histogram(arr, bins=30)
        histo = self._summary.HistogramProto(
            min=float(arr.min()), max=float(arr.max()), num=float(arr.size),
            sum=float(arr.sum()), sum_squares=float((arr * arr).sum()),
            bucket_limit=edges[1:].tolist(), bucket=counts.astype(np.float64).tolist())
        self._value(step, tag=tag, histo=histo)

    def close(self) -> None:
        self._records.close()


class ScalarWriter:
    """Scalar/histogram sink: JSONL events plus, where the ``tensorboard``
    package is installed, a TensorBoard event file."""

    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self._fp = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._fp = open(os.path.join(logdir, "events.jsonl"), "a")
            try:
                self._tb = _EventFile(logdir)
            except ImportError:
                self._tb = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._fp:
            self._fp.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n")
            self._fp.flush()
        if self._tb:
            self._tb.scalar(tag, float(value), step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        arr = np.asarray(values, dtype=np.float64)
        if self._fp:
            qs = np.percentile(arr, [0, 25, 50, 75, 100]).tolist() if arr.size else []
            self._fp.write(
                json.dumps({"tag": tag, "hist_quantiles": qs, "mean": float(arr.mean()) if arr.size else 0.0,
                            "step": int(step), "ts": time.time()}) + "\n")
            self._fp.flush()
        if self._tb:
            self._tb.histogram(tag, arr, step)

    def close(self) -> None:
        if self._fp:
            self._fp.close()
        if self._tb:
            self._tb.close()


def as_minutes(s: float) -> str:
    m = int(s // 60)
    return f"{m}m {int(s - m * 60)}s"


def time_since(since: float, percent: float) -> str:
    now = time.time()
    s = now - since
    es = s / percent
    return f"{as_minutes(s)} (- {as_minutes(es - s)})"


def clean_dir(save_dir: str, clean_key: str) -> None:
    """Delete checkpoints whose name contains ``clean_key``
    (ref: trainer.py:522-526).  Handles both file checkpoints (pickle) and
    directory checkpoints (TPU.CKPT_BACKEND=orbax)."""
    if not os.path.isdir(save_dir):
        return
    for fn in os.listdir(save_dir):
        if clean_key in fn:
            path = os.path.join(save_dir, fn)
            if os.path.isdir(path):
                import shutil

                shutil.rmtree(path)
            else:
                os.remove(path)
