"""What a torch.profiler trace of the window says.

* device events: every kernel, copy and set the card ran (annotations
  left out), by name and as intervals;
* busy time: the union of those intervals (copied from the port's
  ``chip_smoke.profile``), idle gaps between them;
* the host: the benchmark's own spans (``record_function`` names that
  start with ``bench.``) and the top-level ATen ops, those that no other
  ATen op called;
* kernel names: a device event's name without namespace, template
  arguments and parameters (``chip_smoke.kernel_label``).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

SPAN_PREFIX = "bench."


def kernel_label(name: str) -> str:
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    base = base.split("(")[0].split("<")[0].rsplit("::", 1)[-1].strip()
    return base or name


def source_kernels(path: Path) -> set:
    """The ``__global__`` function names of a CUDA source."""
    text = re.sub(r"__\w+__\s*\([^)]*\)", " ", path.read_text())
    return set(re.findall(r"__global__\s+void\s+(\w+)\s*\(", text))


def union(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of intervals (start, end)."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def gaps(spans: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The intervals of [t0, t1] that no span covers."""
    out, reach = [], t0
    for start, end in sorted(spans):
        if start > reach:
            out.append((reach, min(start, t1)))
        reach = max(reach, end)
        if reach >= t1:
            break
    if reach < t1:
        out.append((reach, t1))
    return [(a, b) for a, b in out if b > a]


class Trace(NamedTuple):
    """Times in seconds from the profiler's clock."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float]]   # (kernel label, start, end)
    spans: List[Tuple[str, float, float]]    # the benchmark's spans
    host_ops: List[Tuple[str, float, float]]  # top-level ATen ops

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union([(a, b) for _, a, b in self.device])

    def device_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span and
        the top-level ATen op under way, if any."""
        span = [n for n, a, b in self.spans if a <= t < b]
        op = [n for n, a, b in self.host_ops if a <= t < b]
        name = span[-1][len(SPAN_PREFIX):] if span else "outside the spans"
        return f"{name} / {op[-1]}" if op else f"{name} / python"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(a, b) for _, a, b in self.device], *self.window),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a] for a, b in idle]}


def read(prof, window_span: str = SPAN_PREFIX + "window") -> Trace:
    """The trace of a finished ``torch.profiler.profile`` whose traced
    window is the span ``window_span``."""
    from torch.autograd import DeviceType

    device, spans, ops = [], [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((kernel_label(e.name), a, b))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name, a, b))
        elif e.name.startswith("aten::"):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("aten::"):
                parent = parent.cpu_parent
            if parent is None:
                ops.append((e.name, a, b))
    spans.sort(key=lambda s: s[1])
    window = [(a, b) for n, a, b in spans if n == window_span]
    if not window:
        raise ValueError(f"the trace holds no span {window_span!r}")
    return Trace(window[0], device, spans, ops)
