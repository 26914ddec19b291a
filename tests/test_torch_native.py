"""The port's native graph library (``world/native.py``) against the JAX
package's binding of the same C++ source (``native/graphworld.cpp``):

* ``native_shortest_paths``: JAX's distances and next hops exactly, on
  every scan of the synthetic world; scipy's distances within 1e-5 and,
  where the next hop differs from scipy's (an equal-cost tie), a hop that
  is still on a shortest path (as tests/test_world.py:92-108);
* ``compile_world(use_native=True)``: JAX's tables element for element
  on the synthetic world and on a universe written in the reference's
  connectivity format and read back by each package's loader;
  ``use_native=False`` gives JAX's scipy tables, and so does a library
  that cannot build, with one warning a process;
* ``GraphSim``: a seeded sequence of turns and moves gives JAX's states
  and navigable locations exactly, and moving to each candidate of the
  world's tables lands where the port's ``env.step`` lands, node and view.

Host code only: nothing here touches a card.  The library is built with
g++ on first use into the git-ignored ``build/native/``.
"""
import logging
import math

import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch.env import env as t_env
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_torch.world import graph as t_graph
from curriculum_learning_for_vln_torch.world import native as t_native
from curriculum_learning_for_vln_tpu.world import compiler as j_compiler
from curriculum_learning_for_vln_tpu.world import graph as j_graph
from curriculum_learning_for_vln_tpu.world import native as j_native
from curriculum_learning_for_vln_tpu.world import synthetic as j_synth

TABLES = ("scan_offset", "node_scan", "node_local", "pos", "cand_next", "cand_valid",
          "cand_heading", "cand_elev", "cand_view", "n_cands", "dist", "next_hop")


@pytest.fixture(scope="module")
def libs():
    if not j_native.native_available():
        pytest.fail("the JAX package's native library did not build (no g++?)")
    assert t_native.native_available(), "the port's native library did not build"
    assert t_native.library_path().parent.name == "native"
    assert t_native.library_path().parent.parent.name == "build"


def _equal_tables(a, b, names=TABLES):
    assert a.scan_ids == b.scan_ids and a.node_ids == b.node_ids
    for name in names:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_shortest_paths_equal_jax_and_scipy(libs, synth_graphs):
    for g in synth_graphs.values():
        dist, nh = t_native.native_shortest_paths(g)
        j_dist, j_nh = j_native.native_shortest_paths(g)
        np.testing.assert_array_equal(dist, j_dist)
        np.testing.assert_array_equal(nh, j_nh)
        s_dist, s_nh = t_graph.shortest_paths(g)
        np.testing.assert_allclose(dist, s_dist, rtol=0, atol=1e-5)
        for s, t in zip(*np.nonzero(nh != s_nh)):  # ties: the hop is on a shortest path
            h = nh[s, t]
            assert math.isclose(dist[s, t], np.linalg.norm(g.pos[s] - g.pos[h]) + s_dist[h, t],
                                abs_tol=1e-5)


def test_compile_world_equals_jax(libs, synth_graphs):
    native = t_compiler.compile_world(synth_graphs, max_candidates=16)
    _equal_tables(native, j_compiler.compile_world(synth_graphs, max_candidates=16))
    scipy = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    _equal_tables(scipy, j_compiler.compile_world(synth_graphs, max_candidates=16,
                                                  use_native=False))
    assert (native.solver, scipy.solver) == ("native", "scipy")


def test_compile_world_falls_back_to_scipy_with_a_warning(synth_graphs, monkeypatch, caplog):
    """Without the library the world takes scipy's tables, says so in its
    ``solver``, and the fallback is logged once a process."""
    monkeypatch.setattr(t_compiler, "native_available", lambda: False)
    monkeypatch.setattr(t_compiler, "native_build_error", lambda: "OSError: no g++")
    monkeypatch.setattr(t_compiler, "_fallback_warned", False)
    with caplog.at_level(logging.WARNING, logger=t_compiler.logger.name):
        worlds = [t_compiler.compile_world(synth_graphs, max_candidates=16) for _ in range(2)]
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "no g++" in warned[0] and "scipy" in warned[0]
    for w in worlds:
        assert w.solver == "scipy"
        _equal_tables(w, j_compiler.compile_world(synth_graphs, max_candidates=16,
                                                  use_native=False))


def test_compile_world_from_connectivity_files(libs, tmp_path):
    graphs = j_synth.make_world_graphs(num_scans=4, nodes_per_scan=30, seed=21)
    for g in graphs.values():
        j_graph.write_connectivity(g, str(tmp_path))
    scans = sorted(graphs)
    t_world = t_compiler.compile_world(t_graph.load_nav_graphs(scans, str(tmp_path)), 16)
    j_world = j_compiler.compile_world(j_graph.load_nav_graphs(scans, str(tmp_path)), 16)
    _equal_tables(t_world, j_world)
    assert t_world.num_nodes == sum(g.num_nodes for g in graphs.values())


def _state(sim) -> tuple:
    st = sim.get_state()
    nodes, rh, re = sim.navigable()
    return (st["node"], st["viewIndex"], st["heading"], st["elevation"], nodes.tolist(),
            rh.tolist(), re.tolist())


def test_graph_sim_follows_jax(libs, synth_graphs):
    rng = np.random.default_rng(5)
    for g in synth_graphs.values():
        sims = [m.GraphSim(m.NativeWorld(g)) for m in (t_native, j_native)]
        start = int(rng.integers(g.num_nodes))
        heading = float(rng.uniform(0, 2 * np.pi))
        for sim in sims:
            sim.new_episode(start, heading)
        assert _state(sims[0]) == _state(sims[1])
        moves = 0
        for _ in range(30):
            # turn right until the view shows a location, then move to one
            # of those the view shows (or stay), each call on both
            de = float(rng.integers(-1, 2)) * math.pi / 6
            for k in range(13):
                for sim in sims:
                    sim.make_action(0, math.pi / 6 if k else 0.0, 0.0 if k else de)
                assert _state(sims[0]) == _state(sims[1])
                if len(sims[0].navigable()[0]) > 1:
                    break
            index = int(rng.integers(len(sims[0].navigable()[0])))
            for sim in sims:
                sim.make_action(index, 0.0, 0.0)
            moves += index > 0
            assert _state(sims[0]) == _state(sims[1])
        assert moves >= 10
        for sim in sims:
            with pytest.raises(IndexError):
                sim.make_action(64, 0.0, 0.0)


def test_graph_sim_moves_as_env_step(libs, synth_graphs):
    """For every candidate slot of the compiled world: turn the simulator
    to the candidate's view, move to it, and compare with ``env.step``."""
    world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_compiler.attach_synthetic_features(world, feature_dim=8)
    tables = world.device_tables("f32", device="cpu")
    inc = math.pi / 6
    checked = 0
    for scan, g in synth_graphs.items():
        sim = t_native.GraphSim(t_native.NativeWorld(g))
        off = int(world.scan_offset[world.scan_ids.index(scan)])
        for local in range(g.num_nodes):
            node = off + local
            for a in range(int(world.n_cands[node])):
                view = int(world.cand_view[node, a])
                sim.new_episode(local, 0.0, 0.0)
                sim.make_action(0, (view % 12) * inc, (view // 12 - 1) * inc)
                nodes = sim.navigable()[0].tolist()
                target = int(world.cand_next[node, a]) - off
                sim.make_action(nodes.index(target), 0.0, 0.0)
                st = sim.get_state()

                idx = torch.tensor([node])
                state = t_env.EnvState(
                    node=idx, view_idx=torch.tensor([12]), heading=torch.zeros(1),
                    elevation=torch.zeros(1), goal=idx, goal_local=torch.tensor([local]),
                    ended=torch.tensor([False]))
                new = t_env.step(tables, state, torch.tensor([a]))
                assert (st["node"] + off, st["viewIndex"]) == (int(new.node), int(new.view_idx))
                assert math.isclose(st["heading"], float(new.heading), abs_tol=1e-6)
                assert math.isclose(st["elevation"], float(new.elevation), abs_tol=1e-6)
                checked += 1
    assert checked == int(world.n_cands.sum())
