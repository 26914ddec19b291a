"""The upper readings of a cell's checks: its compared numbers when the
plain reference, computed in a narrower float type, takes the program's
place (the control), and when a fault is planted in the program.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--dtype float8_e4m3fn]
    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] --faults

EnvDrop training: the program runs as in a benchmark run with a short
window; in its place, the reference with every matrix product's operands
rounded to the type runs the checked iterations (the set-up's from the
start, the window's from the program's state before it), sampling its
own actions, judged by the f32 reference along those actions.  Serving: the program's calls
(a short window), and at every step of their trajectories the gap of the
action the narrow reference puts first.  Prints one JSON line of
readings a seed and control or fault (``lib/faults.py``, each planted
in the program for a run with a short window); the benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import harness as H  # noqa: E402


def readings(workload: str, seed: int, dtype=None, fault=None, seconds: float = 6.0,
             device=None) -> dict:
    """The checks' numbers of the control in ``dtype``, or of the program
    with ``fault`` planted."""
    import importlib

    import torch

    from benchmark.lib.faults import planted

    _bench, cell, config, traffic = H.load_cell(workload)
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    run = H.Run(workload, seed, seconds, False, cell, config, traffic,
                torch.device(device or "cuda"), time.perf_counter(), control=dtype)
    if fault is not None:
        with planted(runner.KIND, fault):
            checks = runner.run(run).checks
    else:
        checks = runner.run(run).checks
    return {c.name: c.value for c in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="float8_e4m3fn")
    ap.add_argument("--faults", action="store_true", help="each of the cell's faults")
    args = ap.parse_args(argv)
    H.set_cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib

    from benchmark.lib import faults

    _b, _c, _cfg, traffic = H.load_cell(args.workload)
    kind = importlib.import_module(f"benchmark.runners.{traffic['runner']}").KIND
    cases = ([("fault", f) for f in (faults.TRAIN if kind == "train" else faults.SERVE)]
             if args.faults else [("dtype", args.dtype)])
    for seed in args.seeds:
        for what, name in cases:
            got = readings(args.workload, seed, **{what: name})
            print(json.dumps({"workload": args.workload, "seed": seed, what: name,
                              "readings": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
