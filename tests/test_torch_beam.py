"""The port's beam search (agents/beam.py, utils/floyd.py,
engine/beam_eval.py::_select_path) against the JAX package's, on the
shared synthetic world (3 scans x 24 nodes, 64-d features) and tiny
agents (EnvDrop H = 64, the Follower H = 64 with one encoder layer, the
Self-Monitor H = 32 with a BN-MLP of 48 whose running statistics are
moved off their initial values), JAX parameters carried across with
``convert.py``:

* ``FloydGraph``: the JAX test's cases, and a random graph against a dense
  Floyd-Warshall and against the JAX class (distances and paths, exact);
* ``_select_path``: the JAX cases, exact;
* one decode step of each agent over a random frontier: log-probs, the
  new carry, pano, cand_feat within 1e-5 x max(1, |ref|), the argmax
  exactly.  The beam decodes in f32 whatever TPU.PRECISION says (the JAX
  package observes in f32 and decodes with the f32 parameters, beam.py:
  74-106); with bf16 tables only the features are bf16-rounded, the same
  rounding on both sides, so the bound is the f32 one;
* ``dijkstra`` (B = 3, max_candidates 4, f32): equal ``dijk_path``,
  trajectories, actions and listener actions, listener scores within
  1e-5, and the recorded visual features gathered equal to JAX's arrays
  (within 1e-6: the angle features' sin and cos);
* the ``max_iters = 2`` truncation warning, and a full beam of 4 when the
  expansion completes.
"""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import convert
from curriculum_learning_for_vln_torch.agents import beam as t_beam
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent as TEnvDrop
from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent as TFollower
from curriculum_learning_for_vln_torch.agents.monitor import SelfMonitorAgent as TMonitor
from curriculum_learning_for_vln_torch.engine.beam_eval import _select_path as t_select
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv as TEnv
from curriculum_learning_for_vln_torch.utils import config as t_config
from curriculum_learning_for_vln_torch.utils.floyd import FloydGraph as TFloyd
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.agents import beam as j_beam
from curriculum_learning_for_vln_tpu.agents import EnvDropAgent as JEnvDrop
from curriculum_learning_for_vln_tpu.agents import FollowerAgent as JFollower
from curriculum_learning_for_vln_tpu.agents.monitor import SelfMonitorAgent as JMonitor
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine.beam_eval import _select_path as j_select
from curriculum_learning_for_vln_tpu.env.host_env import R2RBatchEnv as JEnv
from curriculum_learning_for_vln_tpu.utils import config as j_config
from curriculum_learning_for_vln_tpu.utils.floyd import FloydGraph as JFloyd

torch.set_num_threads(2)
FEAT_DIM, ENC_LEN, EP_LEN = 64, 24, 8
AGENTS = ("ENVDROP", "FOLLOWER", "SELF-MONITOR")


def _agents(name, vocab):
    """(JAX agent, port agent) of the tiny config of ``name``."""
    if name == "ENVDROP":
        ms = []
        for config in (j_config, t_config):
            m = config.get_cfg_defaults().MODEL.ENVDROP
            m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 32, 16, 64
            ms.append(m)
        return (JEnvDrop(ms[0], ENC_LEN, vocab, FEAT_DIM, episode_len=EP_LEN),
                TEnvDrop(ms[1], ENC_LEN, vocab, FEAT_DIM, EP_LEN))
    if name == "FOLLOWER":
        ms = []
        for config in (j_config, t_config):
            m = config.get_cfg_defaults().MODEL.FOLLOWER
            m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS = 32, 64, 1
            ms.append(m)
        return (JFollower(ms[0], vocab, FEAT_DIM, episode_len=EP_LEN),
                TFollower(ms[1], vocab, FEAT_DIM, EP_LEN))
    ms = []
    for config in (j_config, t_config):
        m = config.get_cfg_defaults().MODEL.MONITOR
        m.WORD_EMB_SIZE, m.HIDDEN_SIZE, m.ENC_LAYERS, m.ENC_BIDIRECTION = 16, 32, 1, False
        m.MLP_HIDDEN = (48,)
        ms.append(m)
    return (JMonitor(ms[0], ENC_LEN, vocab, FEAT_DIM, EP_LEN),
            TMonitor(ms[1], ENC_LEN, vocab, FEAT_DIM, EP_LEN))


def _moved_stats(tree, rng):
    """The BN state with its running means and variances moved off 0 and 1."""
    if isinstance(tree, dict):
        return {k: (tree[k] + rng.normal(0, 0.3, np.shape(tree[k])).astype(np.float32)
                    if k == "mean" else
                    tree[k] * rng.uniform(0.5, 2.0, np.shape(tree[k])).astype(np.float32)
                    if k == "var" else _moved_stats(tree[k], rng)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_moved_stats(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def ctx(synth_world, synth_graphs, synth_dataset, tokenizer):
    data = expand_r2r_items(synth_dataset, tokenizer)
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16)
    t_world.features = synth_world.features.copy()
    agents = {}
    for name in AGENTS:
        j_agent, t_agent = _agents(name, tokenizer.vocab_size())
        j_params, j_state = j_agent.init(jax.random.PRNGKey(0))
        j_state = jax.tree_util.tree_map(np.asarray, j_state)
        if j_state:
            j_state = _moved_stats(j_state, np.random.default_rng(3))
        np_params = jax.tree_util.tree_map(np.asarray, j_params)
        agents[name] = (j_agent, t_agent, j_params, j_state,
                        convert.params_from_jax(np_params), convert.model_state_from_jax(j_state))
    return synth_world, t_world, data, agents


def _episodes(world, t_world, data, tokenizer, seed=11):
    j_ep = JEnv(world, data, batch_size=3, tokenizer=tokenizer, seed=seed).next_batch()
    t_ep = TEnv(t_world, data, 3, tokenizer, seed=seed, device="cpu").next_batch()
    assert np.array_equal(t_ep.item_idx.numpy(), np.asarray(j_ep.item_idx))
    return j_ep, t_ep


# -- FloydGraph --------------------------------------------------------------

@pytest.mark.parametrize("cls", [TFloyd, JFloyd], ids=["port", "jax"])
def test_floyd_graph_cases(cls):
    g = cls()
    g.add_edge("a", "b", 1.0)
    g.add_edge("b", "c", 1.0)
    g.add_edge("a", "c", 5.0)
    assert g.distance("a", "c") == 5.0
    g.update("b")
    assert g.distance("a", "c") == 2.0
    assert g.path("a", "c") == ["b", "c"]
    assert g.path("a", "a") == []
    assert g.visited("b") and not g.visited("a")


@pytest.mark.parametrize("seed", [0, 1])
def test_floyd_graph_random_against_dense_and_jax(seed):
    rng = np.random.default_rng(seed)
    n = 14
    w = np.full((n, n), np.inf)
    np.fill_diagonal(w, 0.0)
    t, j = TFloyd(), JFloyd()
    for _ in range(30):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        d = float(rng.integers(1, 9))
        w[a, b] = w[b, a] = min(w[a, b], d)
        t.add_edge(a, b, d)
        j.add_edge(a, b, d)
    order = rng.permutation(n)
    for k in order:  # every pivot: the full Floyd-Warshall
        t.update(int(k))
        j.update(int(k))
    dense = w.copy()
    for k in order:
        dense = np.minimum(dense, dense[:, k:k + 1] + dense[k:k + 1, :])
    for a in range(n):
        for b in range(n):
            assert t.distance(a, b) == dense[a, b] == j.distance(a, b)
            assert t.path(a, b) == j.path(a, b)
            if a != b and math.isfinite(dense[a, b]):
                hops = [a] + t.path(a, b)
                assert hops[-1] == b
                assert sum(w[x, y] for x, y in zip(hops[:-1], hops[1:])) == dense[a, b]


# -- _select_path ------------------------------------------------------------

@pytest.mark.parametrize("select", [t_select, j_select], ids=["port", "jax"])
def test_select_path_length_normalization(select):
    short = {"name": "short", "listener_scores": [-0.3], "speaker_scores": [-0.5] * 4}
    long = {"name": "long", "listener_scores": [-0.1] * 6, "speaker_scores": [-0.5] * 4}
    paths = [short, long]
    assert select(paths, 0.0)["name"] == "short"          # sum: -0.3 > -0.6
    assert select(paths, 0.0, True)["name"] == "long"     # mean: -0.1 > -0.3
    short_spoken = dict(short, speaker_scores=[-0.01] * 4)
    assert select([short_spoken, long], 0.9, True)["name"] == "short"
    tie = [dict(short, name="first"), dict(short, name="second")]
    assert select(tie, 0.7)["name"] == "first"


# -- one decode step ---------------------------------------------------------

def _close(got, want, what, tol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: {err:.3g}"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", AGENTS)
def test_decode_step_matches_jax(ctx, name, precision):
    world, t_world, _, agents = ctx
    j_agent, t_agent, j_params, j_state, t_params, t_state = agents[name]
    rng = np.random.default_rng(4)
    B = 6
    nodes = rng.integers(0, world.num_nodes, B)
    views = rng.integers(0, 36, B)
    H = 32 if name == "SELF-MONITOR" else 64
    ctx_np = rng.standard_normal((B, ENC_LEN, H)).astype(np.float32)
    mask_np = np.arange(ENC_LEN)[None, :] >= rng.integers(3, ENC_LEN, B)[:, None]
    third = (rng.standard_normal((B, FEAT_DIM + 128)) if name != "ENVDROP"
             else rng.standard_normal((B, H))).astype(np.float32)
    carry = [rng.standard_normal((B, H)).astype(np.float32) * 0.5 for _ in range(2)] + [third]

    j_dec = j_beam.make_beam_decoder(j_agent, j_state)
    j_out = j_dec(world.device_tables(precision), j_params, jnp.asarray(ctx_np),
                  jnp.asarray(mask_np), jnp.asarray(nodes), jnp.asarray(views),
                  tuple(jnp.asarray(c) for c in carry))
    t_dec = t_beam.make_beam_decoder(t_agent, t_state)
    t_out = t_dec(t_world.device_tables(precision, device="cpu"), t_params,
                  torch.from_numpy(ctx_np), torch.from_numpy(mask_np), torch.from_numpy(nodes),
                  torch.from_numpy(views), tuple(torch.from_numpy(c) for c in carry))
    logp_t, logp_j = t_out[0], np.asarray(j_out[0])
    live = logp_j > -1e20
    assert np.array_equal(logp_t.numpy() > -1e20, live)
    _close(logp_t[torch.from_numpy(live)], logp_j[live], "log_probs")
    for i, (g, w) in enumerate(zip(t_out[1], j_out[1])):
        _close(g, w, f"carry[{i}]")
    _close(t_out[2], j_out[2], "pano")
    _close(t_out[3], j_out[3], "cand_feat")
    assert t_out[1][2].dtype == torch.float32  # a_t_prev / h_tilde carried in f32
    assert np.array_equal(t_out[4].numpy(), np.asarray(j_out[4]))


# -- dijkstra ----------------------------------------------------------------

@pytest.mark.parametrize("name", AGENTS)
def test_dijkstra_matches_jax(ctx, tokenizer, name):
    world, t_world, data, agents = ctx
    j_agent, t_agent, j_params, j_state, t_params, t_state = agents[name]
    j_ep, t_ep = _episodes(world, t_world, data, tokenizer)
    t_tables = t_world.device_tables("f32", device="cpu")
    want = j_beam.BeamSearch(j_agent, world, world.device_tables(), max_iters=60).dijkstra(
        j_params, j_state, j_ep, data, max_candidates=4)
    search = t_beam.BeamSearch(t_agent, t_world, t_tables, max_iters=60)
    got = search.dijkstra(t_params, t_state, t_ep, data, max_candidates=4)
    assert 1 <= search.iterations <= 60
    assert len(got) == len(want) == 3
    for r_t, r_j in zip(got, want):
        assert r_t["instr_id"] == r_j["instr_id"] and r_t["scan"] == r_j["scan"]
        np.testing.assert_array_equal(r_t["instr_encoding"], np.asarray(r_j["instr_encoding"]))
        assert r_t["dijk_path"] == r_j["dijk_path"]
        assert 1 <= len(r_t["paths"]) == len(r_j["paths"]) <= 4
        for p_t, p_j in zip(r_t["paths"], r_j["paths"]):
            assert p_t["trajectory"] == p_j["trajectory"]
            assert p_t["action"] == p_j["action"] and p_t["action"][-1] == -1
            assert p_t["listener_actions"] == p_j["listener_actions"]
            np.testing.assert_allclose(p_t["listener_scores"], p_j["listener_scores"], rtol=0,
                                       atol=1e-5)
            assert all(s <= 1e-6 for s in p_t["listener_scores"])
            T = len(p_j["visual_feature"])
            img, can = t_beam.path_features(t_tables, [p_t["visual_feature"]], T)
            for k, (f_img, f_can) in enumerate(p_j["visual_feature"]):
                np.testing.assert_allclose(img[0, k].numpy(), f_img, rtol=0, atol=1e-6)
                np.testing.assert_allclose(can[0, k].numpy(), f_can, rtol=0, atol=1e-6)
        # dijk_path is a connected walk over the graph
        for a, b in zip(r_t["dijk_path"][:-1], r_t["dijk_path"][1:]):
            ga, gb = t_world.global_id(r_t["scan"], a), t_world.global_id(r_t["scan"], b)
            assert gb in t_world.cand_next[ga][t_world.cand_valid[ga]] or ga == gb


def test_path_features_pad_with_zeros(ctx):
    _, t_world, _, _ = ctx
    tables = t_world.device_tables("f32", device="cpu")
    steps = [[(0, 12, 0), (1, 3, 16)], [(2, 30, 1)]]
    img, can = t_beam.path_features(tables, steps, 8)
    assert img.shape == (2, 8, 36, FEAT_DIM + 128) and can.shape == (2, 8, FEAT_DIM + 128)
    assert not bool(img[1, 1:].any()) and not bool(can[1, 1:].any())
    assert not bool(can[0, 1].any())  # slot MC: the STOP slot's zeros
    assert bool(img[1, 0].any())


def test_beam_truncation_is_logged(ctx, tokenizer, caplog):
    world, t_world, data, agents = ctx
    _, t_agent, _, _, t_params, t_state = agents["FOLLOWER"]
    _, t_ep = _episodes(world, t_world, data, tokenizer)
    search = t_beam.BeamSearch(t_agent, t_world, t_world.device_tables("f32", device="cpu"),
                               max_iters=2)
    with caplog.at_level(logging.WARNING, logger="main.beam"):
        search.dijkstra(t_params, t_state, t_ep, data, max_candidates=4)
    recs = [r for r in caplog.records if r.name == "main.beam"]
    assert any("truncated at max_iters=2" in r.getMessage() for r in recs)
    assert search.iterations == 2


def test_beam_collects_full_beam_when_expansion_completes(ctx, tokenizer):
    world, t_world, data, agents = ctx
    _, t_agent, _, _, t_params, t_state = agents["FOLLOWER"]
    _, t_ep = _episodes(world, t_world, data, tokenizer)
    search = t_beam.BeamSearch(t_agent, t_world, t_world.device_tables("f32", device="cpu"),
                               max_iters=500)
    for r in search.dijkstra(t_params, t_state, t_ep, data, max_candidates=4):
        assert len(r["paths"]) == 4, r["instr_id"]
