"""On the card: each cell's run is correct at its own size with a short
window (long enough for serving's checked calls, drawn among the first
40), and its control, the reference in FP8 in the program's place, is
not.  Run on a machine with a card:

    python3 -m pytest -q benchmark/tests/test_bench_card.py
"""
import json
import subprocess
import sys

import pytest

from benchmark.lib import harness as H

CELLS = [w["name"] for w in json.loads((H.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483901", "--seconds", "8", "--trace", "0"], cwd=H.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    from benchmark.control import readings

    _b, _c, _cfg, traffic = H.load_cell(cell)
    got = readings(cell, 2147483902, "float8_e4m3fn")
    limits = dict(traffic["limits"], episodes_done_diff=0.0, batches_differ=0.0,
                  calls_missing=0.0)
    if "action_gap" in limits:
        limits["control_gap"] = limits["action_gap"]
    assert any(v > limits[k] for k, v in got.items()), got
