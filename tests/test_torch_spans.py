"""The port's spans (``utils/profiling.py::span``): a tiny EnvDrop SPCL
packed iteration and a tiny Self-Monitor ``Navigator.navigate_batch``
under ``torch.profiler`` on the CPU (the kernels' plain twins):

* every span of the table below appears, inside the span it names as
  its parent (the innermost enclosing ``vln.`` span on its thread, or
  none);
* ``vln.rollout.decode`` appears once per live decoder step;
* with no profiler, ``span`` hands back the one shared null context and
  builds no ``record_function``;
* the iteration's logs, parameters and RMSprop state, and the served
  trajectories, are bitwise the same with the spans on and off.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from curriculum_learning_for_vln_torch.agents import build_agent, init_agent
from curriculum_learning_for_vln_torch.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_torch.engine import loop
from curriculum_learning_for_vln_torch.engine.curriculum import SelfPacedCurriculum
from curriculum_learning_for_vln_torch.engine.trainer import il_bucket_fn
from curriculum_learning_for_vln_torch.env.host_env import CLR2RBatchEnv
from curriculum_learning_for_vln_torch.serve import Navigator
from curriculum_learning_for_vln_torch.utils import profiling
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, build_vocab
from curriculum_learning_for_vln_torch.utils.tree import tree_leaves, tree_map
from curriculum_learning_for_vln_torch.world import compiler, synthetic

torch.set_num_threads(2)

FEAT_DIM, ENC_LEN, EPISODE_LEN, B, PACKED = 32, 24, 10, 4, 3

# span -> the span it runs in (None: no program span around it)
TRAIN_PARENTS = {
    "vln.data.next_batch": None, "vln.data.weights": None, "vln.data.record": None,
    "vln.iter": None,
    "vln.rollout.encode": "vln.iter", "vln.rollout.scan": "vln.iter",
    "vln.rollout.packed": "vln.iter", "vln.rollout.loss": "vln.iter",
    "vln.rollout.observe": ("vln.rollout.scan", "vln.rollout.packed"),
    "vln.rollout.decode": ("vln.rollout.scan", "vln.rollout.packed"),
    "vln.rollout.env": ("vln.rollout.scan", "vln.rollout.packed"),
    "vln.rollout.refill": "vln.rollout.packed",
    "vln.update.backward": "vln.iter", "vln.update.clip": "vln.iter",
    "vln.update.optim": "vln.iter",
}
SERVE_PARENTS = {
    "vln.call": None, "vln.data.episodes": "vln.call", "vln.data.assemble": "vln.call",
    "vln.rollout.encode": "vln.call", "vln.rollout.scan": "vln.call",
    "vln.rollout.loss": "vln.call",
    "vln.rollout.observe": "vln.rollout.scan", "vln.rollout.decode": "vln.rollout.scan",
    "vln.rollout.env": "vln.rollout.scan",
}


@pytest.fixture(scope="module")
def world():
    graphs = synthetic.make_world_graphs(num_scans=3, nodes_per_scan=24, seed=7)
    w = compiler.compile_world(graphs, max_candidates=16, use_native=False)
    compiler.attach_synthetic_features(w, feature_dim=FEAT_DIM)
    data = synthetic.make_r2r_dataset(graphs, num_paths=40, seed=3)
    tok = Tokenizer(build_vocab(data, min_count=1), encoding_length=ENC_LEN)
    return w, data, tok


def _cfg(name: str):
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME = name
    cfg.DATA.MAX_ENC_LEN = ENC_LEN
    cfg.AGENT.MAX_EPISODE_LEN = EPISODE_LEN
    cfg.TPU.PRECISION = "f32"
    cfg.TPU.IL_BUCKETS = (8,)
    cfg.TPU.PACKED_RL = PACKED
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TRAIN.OPTIM = "rms"
    cfg.MODEL.ENVDROP.WORD_EMB_SIZE, cfg.MODEL.ENVDROP.ACT_EMB_SIZE = 16, 8
    cfg.MODEL.ENVDROP.HIDDEN_SIZE = 32
    cfg.MODEL.MONITOR.WORD_EMB_SIZE, cfg.MODEL.MONITOR.HIDDEN_SIZE = 16, 32
    cfg.MODEL.MONITOR.MLP_HIDDEN = (24,)
    return cfg


def _train_state(world):
    """A fresh SPCL trainer state, the same on every call."""
    w, data, tok = world
    cfg = _cfg("ENVDROP")
    items = expand_r2r_items(data, tok)
    rounds = {f"round_{k + 1}": items[k::5] for k in range(5)}
    env = CLR2RBatchEnv(w, rounds, B, tokenizer=tok, seed=5, device="cpu")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim=FEAT_DIM)
    loop.configure_runtime(cfg)
    params, _ = init_agent(agent, torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.requires_grad_(t.is_floating_point()), params)
    return {"cfg": cfg, "env": env, "agent": agent, "params": params,
            "curriculum": SelfPacedCurriculum(env, device="cpu"),
            "optimizer": loop.make_optimizer("rms", 1e-3, params),
            "tables": w.device_tables("f32", "cpu"),
            "generator": torch.Generator().manual_seed(11)}


def _iteration(s):
    """One iteration as the trainer runs it; (logs, IL length)."""
    env, spcl = s["env"], s["curriculum"]
    batch = env.next_batch()
    idx = env.cur_batch_index
    il_len = il_bucket_fn(s["cfg"], s["agent"])(env)
    raws, pool_idx = [env.cur_full_batch], [idx]
    for _ in range(PACKED - 1):
        env.next_batch()
        raws.append(env.cur_full_batch)
        pool_idx.append(env.cur_batch_index)
    logs = loop.packed_one_iter(s["agent"], s["optimizer"], s["tables"], s["params"], batch,
                                loop.concat_batches(raws), s["generator"],
                                spcl.batch_weights(idx),
                                spcl.batch_weights(np.concatenate(pool_idx)), il_len)
    spcl.record_losses(idx, logs["loss_per_sample"])
    return logs, il_len


def _navigator(world):
    w, data, tok = world
    cfg = _cfg("SELF-MONITOR")
    agent = build_agent(cfg, tok.vocab_size(), feat_dim=FEAT_DIM)
    params, state = init_agent(agent, torch.Generator().manual_seed(1))
    nav = Navigator(w, agent, params, tok, max_batch=B, precision="f32", device="cpu",
                    model_state=state)
    requests = [{"instruction": it["instructions"][0], "scan": it["scan"],
                 "start_viewpoint": it["path"][0], "heading": it["heading"]}
                for it in data[:B - 1]]
    return nav, requests


def _spans(prof):
    """(name, start, end, the innermost enclosing vln. span or None) of
    every vln. span, by their intervals on their thread."""
    ev = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
          if e.name.startswith("vln.")]
    out = []
    for name, a, b, th in ev:
        around = [(a2, n2) for n2, a2, b2, th2 in ev
                  if th2 == th and a2 <= a and b <= b2 and (a2, b2) != (a, b)]
        out.append((name, a, b, max(around)[1] if around else None))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _assert_nested(spans, parents):
    assert set(n for n, *_ in spans) == set(parents)
    for name, _a, _b, parent in spans:
        want = parents[name]
        assert parent in (want if isinstance(want, tuple) else (want,)), (name, parent)


def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function was built with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("rollout.decode") is profiling.span("iter")
    with profiling.span("iter") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler on"):
            profiling.span("iter")


def test_no_record_function_on_the_paths_without_a_profiler(world, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function was built with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _iteration(_train_state(world))
    nav, requests = _navigator(world)
    nav.navigate_batch(requests)


@pytest.fixture(scope="module")
def trained(world):
    """One iteration from the same state with no profiler and under one:
    (state off, logs off, state on, logs on, IL length, spans on)."""
    off, on = _train_state(world), _train_state(world)
    logs_off, _ = _iteration(off)
    (logs_on, il_len), spans = _profiled(lambda: _iteration(on))
    return off, logs_off, on, logs_on, il_len, spans


@pytest.fixture(scope="module")
def served(world):
    """One call with no profiler and one under it: (trajectories off,
    trajectories on, spans on)."""
    nav, requests = _navigator(world)
    off = nav.navigate_batch(requests)
    on, spans = _profiled(lambda: nav.navigate_batch(requests))
    return off, on, spans


def test_packed_iteration_spans(trained):
    *_, il_len, spans = trained
    _assert_nested(spans, TRAIN_PARENTS)
    count = Counter((n, p) for n, _a, _b, p in spans)
    assert count["vln.iter", None] == 1
    assert count["vln.rollout.encode", "vln.iter"] == 2      # the IL batch, the pool
    assert count["vln.rollout.scan", "vln.iter"] == 1
    assert count["vln.rollout.packed", "vln.iter"] == 1
    assert count["vln.data.next_batch", None] == PACKED
    assert count["vln.data.weights", None] == 2
    # one decode a live step: the IL rollout's bucketed length, the packed horizon
    assert il_len == 8
    assert count["vln.rollout.decode", "vln.rollout.scan"] == il_len
    assert count["vln.rollout.decode", "vln.rollout.packed"] == EPISODE_LEN
    for part in ("observe", "env"):
        assert count[f"vln.rollout.{part}", "vln.rollout.scan"] == il_len
        assert count[f"vln.rollout.{part}", "vln.rollout.packed"] == EPISODE_LEN
    assert count["vln.rollout.refill", "vln.rollout.packed"] == EPISODE_LEN
    for part in ("backward", "clip", "optim"):
        assert count[f"vln.update.{part}", "vln.iter"] == 1


def test_navigate_batch_spans(served):
    *_, spans = served
    _assert_nested(spans, SERVE_PARENTS)
    count = Counter(n for n, *_ in spans)
    assert count["vln.call"] == count["vln.data.episodes"] == count["vln.data.assemble"] == 1
    assert count["vln.rollout.decode"] == count["vln.rollout.observe"] == EPISODE_LEN


def test_spans_change_nothing(trained, served):
    off, logs_off, on, logs_on, *_ = trained
    assert set(logs_off) == set(logs_on)
    for k in logs_off:
        assert torch.equal(logs_off[k], logs_on[k]), k
    for a, b in zip(tree_leaves(off["params"]), tree_leaves(on["params"])):
        assert torch.equal(a, b)
    for a, b in zip(off["optimizer"].state.values(), on["optimizer"].state.values()):
        assert torch.equal(a["nu"], b["nu"])
    assert torch.equal(off["generator"].get_state(), on["generator"].get_state())
    assert torch.equal(off["curriculum"].loss_for_item, on["curriculum"].loss_for_item)
    served_off, served_on, _spans = served
    assert served_off == served_on
