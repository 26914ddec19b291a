"""The plain reference against the port at a tiny size on the CPU: the
world's tables element for element, and whole runs of both cells' runners
(the port's kernels' plain twins on the CPU) passing the cells' checks."""
import numpy as np
import pytest
import torch

from benchmark.runners import envdrop_spcl_train, monitor_serve
from benchmark.lib import launches as L
from benchmark.lib import port
from benchmark.lib import world as W
from benchmark.reference import world as RW
from benchmark.tests import tiny


def test_world_tables_match_the_port():
    spec = {"scans": 3, "panoramas": 90, "train_scans": 2, "val_unseen_scans": 1}
    graphs = W.make_graphs(spec, 4)
    cfg = port.cfg_of({"TPU.MAX_CANDIDATES": 16})
    compiled, _ = port.world(graphs, torch.zeros((1, 36, 4)), cfg, "cpu")
    tab = RW.compile_tables(graphs, 16, "cpu")
    for key in ("cand_next", "cand_valid", "cand_view", "n_cands", "next_hop", "node_local"):
        assert np.array_equal(tab[key].numpy(), np.asarray(getattr(compiled, key))), key
    for key in ("cand_heading", "cand_elev", "dist"):
        np.testing.assert_allclose(tab[key].numpy(), getattr(compiled, key), rtol=1e-6, atol=1e-5)
    from curriculum_learning_for_vln_torch.utils.angles import all_loc_embeddings

    np.testing.assert_allclose(tab["loc_embed"].numpy(), all_loc_embeddings(), atol=1e-6)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 77])
def test_training_run_passes_its_checks(seed):
    cfg, tr = tiny.train_cell()
    out = envdrop_spcl_train.run(tiny.run_of(cfg, tr, seed))
    assert all(c.ok for c in out.checks), out.checks
    assert out.attempted >= 1
    assert out.metrics["train_episodes_per_s"]["value"] > 0


def test_serving_run_passes_its_checks():
    cfg, tr = tiny.serve_cell()
    out = monitor_serve.run(tiny.run_of(cfg, tr, 5))
    assert all(c.ok for c in out.checks), out.checks
    assert out.attempted % tr["batch"] == 0 and out.attempted > 0


@pytest.mark.parametrize("cell", ["train", "serve"])
def test_traced_runs_give_the_host_metrics(cell):
    from benchmark.metrics import host_ops, lstm_scan_roofline, mfu_pct

    cfg, tr = tiny.train_cell() if cell == "train" else tiny.serve_cell()
    runner = envdrop_spcl_train if cell == "train" else monitor_serve
    out = runner.run(tiny.run_of(cfg, tr, 6, trace=True))
    assert host_ops.read(out.trace, out.work) > 0
    assert out.work["steps"] == tr["trace_iterations" if cell == "train" else "trace_calls"]
    assert mfu_pct.read(out.trace, out.work) > 0
    assert lstm_scan_roofline.read(out.trace, out.work) is None  # no device events on the CPU
    assert out.trace.breakdown()["idle_gaps"]
    # the observation step's launches of the traced steps, counted where the port makes them
    obs = out.work["bounds_s"]["obs"]
    kinds = [x.kernel for x in out.work["launches"]]
    if cell == "train":
        steps = kinds.count("pano_bwd")
        assert steps > 0 and kinds.count("pano_fwd") == steps + tr["trace_iterations"]
        assert kinds.count("cand_fwd") == kinds.count("pano_fwd")
        assert kinds.count("cand_bwd") == steps
        assert min(obs.values()) > 0
    else:
        assert kinds == ["pano_fwd"] * (tr["trace_calls"] * cfg["AGENT.MAX_EPISODE_LEN"])
        assert set(obs) == {"pano"} and obs["pano"] > 0
    for x in out.work["launches"]:
        if x.nodes is not None:
            assert 1 <= L.distinct(x.nodes) <= x.B
