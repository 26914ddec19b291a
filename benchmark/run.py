"""One run of one benchmark cell on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs from the seed, warms up, measures for
``--seconds``, checks the outputs against the plain reference, and prints
one JSON line as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
with its limit, also printed last on standard error).  Exits non-zero
without a result when CUDA or the cell's cards are missing.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import harness as H  # noqa: E402


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those that list it, or list no cells and move (or are) a
    metric it reports."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def per_layer(bench: dict, cell: str, outcome: H.Outcome) -> dict:
    got = {}
    for m in cell_metrics(bench, cell, "per_layer"):
        family = m["name"].split(".")[0]
        reader = importlib.import_module(f"benchmark.metrics.{family}")
        value = reader.read(outcome.trace, outcome.work)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def finite(x: float) -> float:
    """A number JSON can hold: a non-finite reading as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = H.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    H.set_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    run = H.Run(args.workload, args.seed, args.seconds, bool(args.trace), cell, config, traffic,
                torch.device("cuda"), T0)
    outcome = runner.run(run)
    banned = H.banned_modules(sys.modules)
    if banned:
        print(f"loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 4
    if args.trace:
        metrics = per_layer(bench, args.workload, outcome)
    else:
        names = [m["name"] for m in cell_metrics(bench, args.workload, "end_to_end")]
        metrics = {k: outcome.metrics[k] for k in names}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        result["breakdown"] = outcome.trace.breakdown()
    result["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit}
                        for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
