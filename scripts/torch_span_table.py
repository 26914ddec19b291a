#!/usr/bin/env python3
"""Where the card idles, by the port's own spans, on one H100.

    python3 scripts/torch_span_table.py --workload <cell> --seed N [--seconds S] [--out DIR]

The port marks its layers with ``vln.<layer>.<part>`` spans
(``utils/profiling.py::span``), which record only while a
``torch.profiler`` records, on the profiler's clock.

It runs one benchmark cell through its runner with ``--trace``
(``benchmark/runners/``: its set-up, window and check as
``benchmark/run.py`` runs them) and reads the profiler of the traced
steps: the share of the traced window in which the card is idle while the
host's innermost ``vln.`` span is of each layer (``vln.data``,
``vln.rollout``, ``vln.update``; idle time inside the benchmark's own
copies, ``bench.record``, left out), the host's blocking CUDA runtime
calls (``SYNCS``) inside the program, per step, and a table of every span
per step: its count, host ms, self ms, idle ms, the device ms of the
kernels launched under it, its syncs and their wait ms; then each sync
named by its span and the top-level ATen op under way, and two checks of
the shared clock: no kernel starts before the runtime call that launched
it (matched by correlation id), and every ``vln.rollout.decode`` span
holds the launch of a ``pano_kernel`` (K4).  The device's timestamps
drift against the host's within a trace (by a few ppm, once by 6,000):
they are mapped onto the host's clock by a fitted drift (``fit_drift``)
before anything is attributed, and the first check is reported before
and after.  An instant belongs to the
innermost span under way on any thread (the latest started), so that
autograd's backward, which runs on the card's worker thread, falls under
the main thread's ``vln.update.backward``.  The numbers go as JSON under
``--out`` (default ``build/span_table``), beside the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from bisect import bisect_left, bisect_right
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.lib.program_spans import innermost  # noqa: E402

PROGRAM_PREFIX = "vln."
LAYERS = ("vln.data", "vln.rollout", "vln.update")
# the runtime calls in which the host waits for the card
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy"))

Interval = Tuple[float, float]
Span = Tuple[str, float, float]


def layer(name: str) -> str:
    """A span's layer: its name up to the second dot."""
    return ".".join(name.split(".")[:2])


def merged(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted disjoint intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def subtract(keep: Sequence[Interval], cut: Sequence[Interval]) -> List[Interval]:
    """The sorted disjoint intervals ``keep`` less the union of ``cut``."""
    cut, out, j = merged(cut), [], 0
    for lo, hi in keep:
        while j < len(cut) and cut[j][1] <= lo:
            j += 1
        k, start = j, lo
        while k < len(cut) and cut[k][0] < hi:
            if cut[k][0] > start:
                out.append((start, cut[k][0]))
            start = max(start, cut[k][1])
            k += 1
        if start < hi:
            out.append((start, hi))
    return out


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """The length of the overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(window: Interval, device: Sequence[Interval],
                   record: Sequence[Interval]) -> List[Interval]:
    """The window's instants that no device interval covers, outside the
    benchmark's copies."""
    return subtract(subtract([window], device), record)


def idle_shares(window: Interval, device: Sequence[Interval], record: Sequence[Interval],
                program: Sequence[Span]) -> Optional[Dict[str, float]]:
    """Each layer's share of the window, in %, in which the card is idle
    and the host's innermost ``vln.`` span is of that layer, beside the
    whole idle share (``device_idle``, the benchmark's ``device_idle_pct``:
    the device intervals' union against the window); None without a
    ``vln.`` span."""
    if not program or window[1] <= window[0]:
        return None
    width = window[1] - window[0]
    idle = idle_intervals(window, device, record)
    pieces = innermost(program)
    out = {name: 100.0 * overlap(idle, [(a, b) for n, a, b in pieces if layer(n) == name])
           / width for name in LAYERS}
    out["device_idle"] = 100.0 * (1.0 - sum(b - a for a, b in merged(device)) / width)
    return out


def syncs_inside(program: Sequence[Span], syncs: Sequence[Span],
                 record: Sequence[Interval]) -> Optional[int]:
    """The syncs that start inside a ``vln.`` span and outside the
    benchmark's copies; None without a ``vln.`` span."""
    if not program:
        return None
    counted = subtract(merged([(a, b) for _, a, b in program]), record)
    starts = [a for a, _ in counted]
    n = 0
    for _, t, _end in syncs:
        i = bisect_right(starts, t) - 1
        n += i >= 0 and t < counted[i][1]
    return n


def fit_drift(leads: Sequence[Interval], bins: int = 20) -> Tuple[float, float]:
    """(slope, offset) of the device's clock against the host's, from
    (launch call's start, kernel start - launch call's start) pairs: the
    Theil-Sen slope through the least lead of each of ``bins`` equal spans
    of time, and an offset that leaves the least lead at the first call as
    it is, or moves it up to 0 where it is below.  A device time t on the
    host's clock is (t - offset) / (1 + slope); (0, 0) without pairs."""
    if not leads:
        return 0.0, 0.0
    t0, t1 = min(t for t, _ in leads), max(t for t, _ in leads)
    least: Dict[int, Interval] = {}
    for t, d in leads:
        i = min(bins - 1, int(bins * (t - t0) / (t1 - t0))) if t1 > t0 else 0
        if i not in least or d < least[i][1]:
            least[i] = (t, d)
    pts = sorted(least.values())
    slopes = [(d2 - d1) / (u2 - u1) for k, (u1, d1) in enumerate(pts) for u2, d2 in pts[k + 1:]
              if u2 > u1]
    slope = statistics.median(slopes) if slopes else 0.0
    first = min(d - slope * t for t, d in pts) + slope * t0  # the least lead, drift removed
    return slope, min(0.0, first) - slope * t0


def at(pieces: Sequence[Span], starts: Sequence[float], t: float) -> Optional[str]:
    i = bisect_right(starts, t) - 1
    return pieces[i][0] if i >= 0 and t < pieces[i][2] else None


# ---------------------------------------------------------------------------
# reading a finished torch.profiler
# ---------------------------------------------------------------------------

def events(prof) -> dict:
    """The lists the analysis reads, in seconds on the profiler's clock."""
    from torch.autograd import DeviceType

    from benchmark.lib.trace import kernel_label

    out = {"device": [], "program": [], "syncs": [], "bench": [], "ops": [], "launches": {}}
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                out["device"].append((kernel_label(e.name), a, b, e.id))
        elif e.name.startswith(PROGRAM_PREFIX):
            out["program"].append((e.name, a, b))
        elif e.name.startswith("bench."):
            out["bench"].append((e.name, a, b))
        elif e.name in SYNCS:
            out["syncs"].append((e.name, a, b))
        elif e.name.startswith("cu") and ("Launch" in e.name or "Memcpy" in e.name
                                           or "Memset" in e.name):  # cuda* and cu* calls
            out["launches"][e.id] = (e.name, a, b)
        elif e.name.startswith("aten::"):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith("aten::"):
                parent = parent.cpu_parent
            if parent is None:
                out["ops"].append((e.name, a, b))
    for k in ("device", "program", "syncs", "bench", "ops"):
        out[k].sort(key=lambda s: s[1])
    out["window"] = next((a, b) for n, a, b in out["bench"] if n == "bench.window")
    out["record"] = [(a, b) for n, a, b in out["bench"] if n == "bench.record"]
    return out


def clock_check(window: Interval, matched: list) -> dict:
    """Each kernel against the runtime call that launched it: how many
    start before it, and the least lead in each tenth of the window (us)."""
    lead = [(call[1], 1e6 * (a - call[1])) for call, (_k, a, _b) in matched]
    tenths = defaultdict(list)
    for t, d in lead:
        tenths[min(9, max(0, int(10 * (t - window[0]) / (window[1] - window[0]))))].append(d)
    return {"matched": len(matched), "kernel_before_its_launch": sum(d < 0 for _, d in lead),
            "launch_to_start_us": quartiles([d for _, d in lead]),
            "least_launch_to_start_us_by_tenth_of_window":
                [min(tenths[i]) if tenths[i] else None for i in range(10)]}


def analyse(ev: dict, steps: int) -> dict:
    """The shares, the syncs, the clock checks and the per-span table of one
    trace.  The device's clock may drift against the host's within a trace
    (kernels seen to start up to ms before their launch call): the device
    times are first mapped onto the host's clock by ``fit_drift``, and the
    clock check is reported before and after."""
    window, record, program = ev["window"], ev["record"], ev["program"]

    def matched_of(device):
        return [(ev["launches"][i], (k, a, b)) for k, a, b, i in device if i in ev["launches"]]

    raw = matched_of(ev["device"])
    slope, offset = fit_drift([(call[1], a - call[1]) for call, (_k, a, _b) in raw])
    dev = [(k, (a - offset) / (1 + slope), (b - offset) / (1 + slope), i)
           for k, a, b, i in ev["device"]]
    matched = matched_of(dev)
    device = [(a, b) for _, a, b, _i in dev]
    res = {"steps": steps, "shares_pct": idle_shares(window, device, record, program)}
    n = syncs_inside(program, ev["syncs"], record)
    res["syncs_per_step"] = None if n is None else n / steps
    res["clock"] = {"device_events": len(dev), "raw": clock_check(window, raw),
                    "drift_ppm": 1e6 * slope,
                    "shift_us": [1e6 * (t - (t - offset) / (1 + slope)) for t in window],
                    "after": clock_check(window, matched)}
    k4 = sorted(call[1] for call, (k, _a, _b) in matched if k == "pano_kernel")
    decodes = [(a, b) for n, a, b in program if n == "vln.rollout.decode"]
    res["k4"] = {"decode_spans": len(decodes), "k4_launches": len(k4),
                 "decode_spans_holding_a_k4_launch":
                     sum(bisect_left(k4, b) > bisect_left(k4, a) for a, b in decodes)}
    # the table, each instant and call by the innermost span
    pieces = innermost(program)
    starts = [a for _, a, _ in pieces]
    idle = idle_intervals(window, device, record)
    rows: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for name, a, b in program:
        rows[name]["count"] += 1
        rows[name]["host_ms"] += 1e3 * (b - a)
    idle_starts = [a for a, _ in idle]
    for name, a, b in pieces:
        rows[name]["self_ms"] += 1e3 * (b - a)
        first = max(0, bisect_right(idle_starts, a) - 1)
        rows[name]["idle_ms"] += 1e3 * overlap(idle[first:bisect_left(idle_starts, b)], [(a, b)])
    attributed = sum(r["idle_ms"] for r in rows.values())
    rows["(no vln span)"]["idle_ms"] = 1e3 * sum(b - a for a, b in idle) - attributed
    for call, (_k, a, b) in matched:
        if window[0] <= call[1] < window[1]:
            rows[at(pieces, starts, call[1]) or "(no vln span)"]["device_ms"] += 1e3 * (b - a)
    op_starts = [o[1] for o in ev["ops"]]
    named: Dict[str, int] = defaultdict(int)
    for sync, a, b in ev["syncs"]:
        if not window[0] <= a < window[1] or any(x <= a < y for x, y in record):
            continue
        where = at(pieces, starts, a) or "(no vln span)"
        rows[where]["syncs"] += 1
        rows[where]["sync_wait_ms"] += 1e3 * (b - a)
        i = bisect_right(op_starts, a) - 1
        op = ev["ops"][i][0] if i >= 0 and a < ev["ops"][i][2] else "python"
        named[f"{where} / {op} / {sync}"] += 1
    res["per_step"] = {n: {k: v / steps for k, v in r.items()} for n, r in sorted(rows.items())}
    res["syncs_named_per_step"] = {k: v / steps for k, v in
                                   sorted(named.items(), key=lambda kv: -kv[1])}
    return res


# ---------------------------------------------------------------------------
# one traced run of a cell
# ---------------------------------------------------------------------------

def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def cell_run(workload: str, seed: int, seconds: float):
    import torch

    from benchmark.lib import harness as H

    _bench, cell, config, traffic = H.load_cell(workload)
    H.set_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return H.Run(workload, seed, seconds, True, cell, config, traffic, torch.device("cuda"), T0)


def quartiles(xs) -> list:
    xs = sorted(xs)
    return xs if len(xs) < 2 else [xs[0], *statistics.quantiles(xs, n=4), xs[-1]]


def table(args) -> dict:
    from benchmark.lib import trace as TR

    kept = []
    read = TR.read

    def keep(prof, *a, **k):  # the runner's own read, with the profiler kept
        kept.append(prof)
        return read(prof, *a, **k)

    TR.read = keep
    run = cell_run(args.workload, args.seed, args.seconds)
    outcome = importlib.import_module(f"benchmark.runners.{run.traffic['runner']}").run(run)
    res = analyse(events(kept[0]), outcome.work["steps"])
    res.update(cell=args.workload, seed=args.seed, correct=all(c.ok for c in outcome.checks),
               busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    print(json.dumps({k: res[k] for k in ("cell", "seed", "correct", "shares_pct",
                                          "syncs_per_step", "clock", "k4")}))
    for name, row in res["per_step"].items():
        print(f"  {name:22s} " + " ".join(f"{k} {v:.3f}" for k, v in row.items()))
    for k, v in res["syncs_named_per_step"].items():
        print(f"  sync {v:7.2f} a step  {k}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="monitor-serve-b256-long")
    ap.add_argument("--seed", type=int, default=2147483901)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_table"))
    args = ap.parse_args(argv)
    res = table(args)
    res["card"] = card()
    print(res["card"])
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}_{args.seed}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
