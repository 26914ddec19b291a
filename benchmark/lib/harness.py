"""What every run shares: the cell's files, seeds, inputs, spans, checks.

A run reads ``BENCHMARK.json`` at the root of the checkout; its cell
names a configuration (a file listed there) and a traffic mix
(``traffic/<name>.json``), whose ``runner`` names the module in
``runners/`` that builds the program, drives the window and checks the
outputs.  Per-layer metrics are read by ``metrics/<family>.py``, the
family being a metric's name up to its first dot.
"""
from __future__ import annotations

import hashlib
import json
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CACHE = ROOT / "build" / "bench_cache"
BANNED = ("jax", "jaxlib", "flax", "curriculum_learning_for_vln_tpu")


def load_cell(workload: str, root: Path = ROOT) -> tuple:
    """(BENCHMARK.json, the cell, its configuration, its traffic)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def banned_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is a JAX package's or the JAX
    port's, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in BANNED)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def make_features(n: int, views: int, dim: int, seed: int, device, dtype):
    """The panoramas' feature table [n, views, dim]: N(0.5, 0.5) like
    post-ReLU ResNet means, drawn in f32 on the device in chunks, stored in
    ``dtype``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, views, dim), dtype=dtype, device=device)
    chunk = max(1, (1 << 26) // (views * dim))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[s:e] = (torch.randn((e - s, views, dim), generator=gen, device=device) * 0.5
                    + 0.5).to(dtype)
    return out


@contextmanager
def span(name: str):
    """A span of the benchmark's own, ``bench.<name>`` in the trace."""
    import torch

    with torch.profiler.record_function("bench." + name):
        yield


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device, reset: bool = False) -> int:
    """The card's peak of allocated bytes since the last reset (0 off it)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    out = torch.cuda.max_memory_allocated()
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return out


class TracedSteps:
    """With ``run.trace``, torch.profiler over the window's first ``steps``
    steps, inside the span ``bench.window``, and the observation step's
    launches recorded (``launches``, ``lib/launches.py``); ``done(n)``
    after step n, ``read()`` once the window has closed (None without a
    trace)."""

    def __init__(self, run: "Run", steps: int):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .launches import Recorder

        self.steps, self.device, self.prof, self.finished = steps, run.device, None, None
        self.recorder = Recorder()
        if run.trace:
            self.recorder.start()
            acts = [ProfilerActivity.CPU]
            if run.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.span = torch.profiler.record_function("bench.window")
            self.span.__enter__()

    @property
    def open(self) -> bool:
        return self.prof is not None

    def done(self, n: int) -> None:
        if self.prof is not None and n == self.steps:
            sync(self.device)
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.recorder.stop()
            self.finished, self.prof = self.prof, None

    @property
    def launches(self) -> list:
        return self.recorder.launches

    def read(self):
        from .trace import read

        return read(self.finished) if self.finished is not None else None


@dataclass
class Check:
    """A number compared beside its limit; it passes at or under it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN fails


@dataclass
class Outcome:
    """What a runner hands back: end-to-end metrics (untraced runs), the
    trace and the work of its traced steps (traced runs), the checks."""

    metrics: dict
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[object] = None
    work: dict = field(default_factory=dict)


@dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    device: object
    t0: float
    control: Optional[str] = None  # a narrower float type for the control, else None


def quartiles(xs) -> list:
    """[min, first quartile, median, third quartile, max] of ``xs``."""
    import statistics

    xs = sorted(float(x) for x in xs)
    if len(xs) < 2:
        return xs
    return [xs[0], *statistics.quantiles(xs, n=4), xs[-1]]


def log_phases(phases, t0: float) -> None:
    """Set-up's phases in seconds: ("start", seconds before the runner ran),
    then (name, clock reading at its end) each."""
    out, last = [f"{phases[0][0]} {phases[0][1]:.3f}"], t0 + phases[0][1]
    for name, t in phases[1:]:
        out.append(f"{name} {t - last:.3f}")
        last = t
    log("set-up phases (s): " + ", ".join(out))


def log(*args) -> None:
    """A line on standard error (the result line is standard output's)."""
    import sys

    print(*args, file=sys.stderr, flush=True)
