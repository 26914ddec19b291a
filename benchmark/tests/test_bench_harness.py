"""The harness finds a cell by the names in BENCHMARK.json: a dummy cell
added as data alone (an entry and a traffic file for an existing
runner) is taken, with its metrics, and runs."""
import json
import shutil

from benchmark import run as R
from benchmark.runners import envdrop_spcl_train
from benchmark.lib import harness as H
from benchmark.tests import tiny


def test_dummy_cell_added_as_data(tmp_path):
    bench = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    cfg, tr = tiny.train_cell()
    (tmp_path / "benchmark" / "traffic").mkdir(parents=True)
    (tmp_path / "benchmark" / "configs").mkdir()
    (tmp_path / "benchmark" / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "dummy_mix.json").write_text(json.dumps(tr))
    shutil.copy(H.BENCH / "configs" / "train_vocab.txt", tmp_path / "benchmark" / "configs")
    bench["configs"].append({"name": "dummy", "source": "https://example.org", "reduced": [],
                             "file": "benchmark/configs/dummy.json", "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("dummy.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got_bench, cell, config, traffic = H.load_cell("dummy.cell", root=tmp_path)
    assert cell["traffic"] == "dummy_mix" and config == cfg and traffic == tr
    e2e = [m["name"] for m in R.cell_metrics(got_bench, "dummy.cell", "end_to_end")]
    assert e2e == ["setup_s", "train_episodes_per_s", "peak_mem_gib"]
    assert R.cell_metrics(got_bench, "dummy.cell", "per_layer") == []

    out = envdrop_spcl_train.run(tiny.run_of(config, traffic, 4))
    assert all(c.ok for c in out.checks)
    assert set(e2e) <= set(out.metrics)


def test_every_cell_and_metric_resolves():
    import importlib

    bench = json.loads((H.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        _b, cell, config, traffic = H.load_cell(w["name"])
        importlib.import_module(f"benchmark.runners.{traffic['runner']}")
        assert R.cell_metrics(bench, w["name"], "per_layer")
    for m in bench["per_layer"]:
        assert hasattr(importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}"),
                       "read")
