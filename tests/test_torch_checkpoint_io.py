"""The port's last I/O pieces and its route switch, on the CPU.

* ``save_checkpoint(async_write=True)`` (TPU.CKPT_ASYNC): JAX's
  ``test_checkpoint_orbax.py::test_async_checkpoint_writes`` (the pickle
  case), here with an in-place change of the tensors after the call: the
  bundle is the state at the call, and a ``pre_task`` runs after the
  earlier write and before its own; a writer exception comes back at
  ``wait_for_checkpoints``;
* ``TPU.CKPT_BACKEND orbax``: one warning, then the pickle file;
  ``load_checkpoint`` refuses a directory (a real orbax checkpoint of the
  JAX package) with a ``ValueError`` naming the format; a pickle write onto
  that directory replaces it;
* ``ClassicTrainer.train`` with ``TPU.CKPT_ASYNC`` True and False: the
  same files and the same bundles, array by array;
* ``write_results`` byte for byte as JAX's on the same results, and JAX's
  ``test_trainer.py::test_write_results_and_score_from_file``;
  ``write_feature_tsv`` byte for byte as JAX's;
* every name of ``engine.__all__`` resolves;
* the route: ``configure_runtime`` and ``Navigator(use_pallas=...)`` set
  both backends in both directions (a plain run then a default run in one
  process calls the kernel ops as a default run alone does), ``main`` sets
  it before any mode, and the plain route and ``main``'s TPU/XLA knobs are
  logged.
"""
import logging
import os

import numpy as np
import pytest
import torch

from curriculum_learning_for_vln_torch import engine as t_engine
from curriculum_learning_for_vln_torch import main as t_main
from curriculum_learning_for_vln_torch import pipeline as t_pipeline
from curriculum_learning_for_vln_torch.agents import TestAgent
from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
from curriculum_learning_for_vln_torch.data import features as t_features
from curriculum_learning_for_vln_torch.engine import checkpoint as t_ckpt
from curriculum_learning_for_vln_torch.engine import loop as t_loop
from curriculum_learning_for_vln_torch.engine.curriculum import (NaiveCurriculum,
                                                                 SelfPacedCurriculum)
from curriculum_learning_for_vln_torch.engine.evaluator import Evaluation
from curriculum_learning_for_vln_torch.engine.trainer import ClassicTrainer, dedup_by_path
from curriculum_learning_for_vln_torch.env.host_env import R2RBatchEnv
from curriculum_learning_for_vln_torch.ops import fused_obs as t_fused
from curriculum_learning_for_vln_torch.ops import rnn as t_rnn
from curriculum_learning_for_vln_torch.serve import Navigator
from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer, read_vocab
from curriculum_learning_for_vln_torch.world import compiler as t_compiler
from curriculum_learning_for_vln_tpu.data import features as j_features
from curriculum_learning_for_vln_tpu.data.datasets import expand_r2r_items
from curriculum_learning_for_vln_tpu.engine import checkpoint as j_ckpt
from curriculum_learning_for_vln_tpu.engine import loop as j_loop
from test_torch_trainer import _tiny_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def restore_route():
    saved = (t_rnn.get_backend(), t_fused.get_backend())
    yield
    t_rnn.set_backend(saved[0])
    t_fused.set_backend(saved[1])


def _params():
    return {"encoder": {"w": torch.ones(3, 4), "b": torch.zeros(4)},
            "critic": {"fc": {"w": torch.full((2, 2), 0.5)}}}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_async_checkpoint_writes(tmp_path):
    params = _params()
    opt = t_loop.make_optimizer("rms", 1e-4, params)
    gen = torch.Generator().manual_seed(3)
    deleted = []
    p1, p2 = str(tmp_path / "latest_ep1.ckpt"), str(tmp_path / "latest_ep2.ckpt")
    t_ckpt.save_checkpoint(p1, params, opt, gen, 1, async_write=True)
    with torch.no_grad():
        params["encoder"]["w"].add_(100.0)  # in place: the snapshot must not see it
    t_ckpt.save_checkpoint(p2, params, opt, gen, 2, async_write=True,
                           pre_tasks=(lambda: deleted.append(os.path.exists(p1)),))
    t_ckpt.wait_for_checkpoints()
    assert deleted == [True]  # the pre_task ran after p1's write, before p2's
    b1, b2 = t_ckpt.load_checkpoint(p1), t_ckpt.load_checkpoint(p2)
    np.testing.assert_array_equal(b1["params"]["encoder"]["w"], np.ones((3, 4)))
    np.testing.assert_array_equal(b2["params"]["encoder"]["w"], np.ones((3, 4)) + 100.0)
    assert (b1["epoch"], b2["epoch"]) == (1, 2)
    np.testing.assert_array_equal(b1["rng"], gen.get_state().numpy())
    assert not os.path.exists(p1 + ".tmp") and not os.path.exists(p2 + ".tmp")


def test_async_writer_exception_surfaces(tmp_path):
    def boom():
        raise RuntimeError("disk full")

    t_ckpt.save_checkpoint(str(tmp_path / "x.ckpt"), _params(), async_write=True,
                           pre_tasks=(boom,))
    with pytest.raises(RuntimeError, match="disk full"):
        t_ckpt.wait_for_checkpoints()
    t_ckpt.wait_for_checkpoints()  # the queue is empty afterwards


def test_orbax_backend_warns_once_and_writes_pickle(tmp_path, caplog, monkeypatch):
    monkeypatch.setattr(t_ckpt, "_WARNED_BACKENDS", set())
    with caplog.at_level(logging.WARNING, logger="main.checkpoint"):
        for ep in (1, 2):
            t_ckpt.save_checkpoint(str(tmp_path / "o.ckpt"), _params(), epoch=ep,
                                   backend="orbax")
    warnings = [r for r in caplog.records if "CKPT_BACKEND" in r.getMessage()]
    assert len(warnings) == 1 and "jax" in warnings[0].getMessage()
    assert os.path.isfile(tmp_path / "o.ckpt")
    assert t_ckpt.load_checkpoint(str(tmp_path / "o.ckpt"))["epoch"] == 2


def test_orbax_directory_refused_then_replaced(tmp_path):
    """A real orbax checkpoint of the JAX package: the port's loader refuses
    it by name; the port's pickle write at its path replaces it."""
    import jax.numpy as jnp

    path = str(tmp_path / "latest.ckpt")
    j_ckpt.save_checkpoint(path, {"w": jnp.ones((2, 3))}, epoch=4, backend="orbax")
    assert os.path.isdir(path)
    with pytest.raises(ValueError, match="orbax.*without jax"):
        t_ckpt.load_checkpoint(path)
    t_ckpt.save_checkpoint(path, _params(), epoch=5)
    assert os.path.isfile(path)
    assert t_ckpt.load_checkpoint(path)["epoch"] == 5
    assert j_ckpt.load_checkpoint(path)["epoch"] == 5  # the JAX loader reads it too


@pytest.mark.parametrize("trainer", ["classic", "naive"])
def test_trainer_async_checkpoints_equal_sync(tmp_path, trainer):
    """TPU.CKPT_ASYNC through ``ClassicTrainer.train`` (and NAIVE, which
    inherits it): the same checkpoint files and bundles as a synchronous
    run from the same seed."""
    runs = {}
    for ckpt_async in (False, True):
        root = tmp_path / f"async_{ckpt_async}"
        cfg = _tiny_cfg(root)
        cfg.merge_from_list(["TPU.CKPT_ASYNC", ckpt_async])
        tok = t_pipeline.build_tokenizer(cfg)
        _, train_env, valid_env, feat_dim = t_pipeline.build_environments(cfg, tok, seed=3,
                                                                          device="cpu")
        agent = EnvDropAgent(cfg.MODEL.ENVDROP, cfg.DATA.MAX_ENC_LEN, tok.vocab_size(),
                             feat_dim, cfg.AGENT.MAX_EPISODE_LEN, compute_dtype=torch.bfloat16)
        if trainer == "naive":
            train_env = {"round_1": train_env, "round_2": train_env}
            NaiveCurriculum(switch_epoch=1).train(cfg, agent, "", train_env, valid_env, seed=3,
                                                  device="cpu")
        else:
            ClassicTrainer().train(cfg, agent, "", train_env, valid_env, seed=3, device="cpu")
        files = {}
        for d, _, names in os.walk(root / "ckpt"):
            for n in names:
                files[n] = t_ckpt.load_checkpoint(os.path.join(d, n))
        runs[ckpt_async] = files
    assert sorted(runs[True]) == sorted(runs[False])
    assert "latest.ckpt" in runs[True] and any(n.startswith("latest_ep2") for n in runs[True])
    assert not any(n.startswith("latest_ep1") for n in runs[True])  # the rotation ran
    for name, want in runs[False].items():
        got = runs[True][name]
        for key in ("params", "opt_state", "model_state", "rng", "curriculum", "epoch"):
            a, b = t_ckpt.to_numpy(got[key]), t_ckpt.to_numpy(want[key])
            _assert_trees_equal(a, b, f"{name}:{key}")
    assert SelfPacedCurriculum.async_checkpoints is False  # SPCL writes synchronously, as JAX


def _assert_trees_equal(a, b, where):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# results and feature files, exports
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host(synth_world, synth_graphs, synth_dataset, tokenizer):
    t_world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    t_world.features = synth_world.features.copy()
    items = expand_r2r_items(synth_dataset, tokenizer)  # 3 instructions per path
    return t_world, items


def test_write_results_matches_jax_bytes(host, tmp_path):
    t_world, items = host
    rng = np.random.default_rng(2)
    results = [{"instr_id": it["instr_id"],
                "trajectory": [(vp, np.float32(rng.uniform(0, 6.3)), float(rng.uniform(-1, 1)))
                               for vp in it["path"]]} for it in items[:12]]
    got = t_loop.write_results(results, str(tmp_path / "port"), split="val_seen")
    want = j_loop.write_results(results, str(tmp_path / "jax"), split="val_seen")
    assert os.path.basename(got) == os.path.basename(want) == "val_seen.json"
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


def test_write_results_and_score_from_file(host, tmp_path):
    """JAX's test_trainer.py::test_write_results_and_score_from_file: the
    teacher-follower's results written and scored from the file, as the
    in-memory results score."""
    t_world, items = host
    henv = R2RBatchEnv(t_world, items, 8, None, seed=0, name="val_seen", device="cpu")
    results = t_loop.run_eval(TestAgent(episode_len=10), {}, t_world.device_tables("f32", "cpu"),
                              henv)
    path = t_loop.write_results(results, str(tmp_path), split="val_seen")
    ev = Evaluation(t_world, dedup_by_path(items))
    from_file, _ = ev.score(path)
    in_memory, _ = ev.score(results)
    assert from_file == in_memory
    assert from_file["success_rate"] == 1.0


def test_write_feature_tsv_matches_jax_bytes(tmp_path):
    rng = np.random.default_rng(7)
    feats = {f"scan{i}_vp{j}": rng.standard_normal((36, 8)).astype(np.float32)
             for i in range(2) for j in range(3)}
    got, want = str(tmp_path / "port.tsv"), str(tmp_path / "jax.tsv")
    t_features.write_feature_tsv(got, feats)
    j_features.write_feature_tsv(want, feats)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    back = t_features.read_feature_tsv(got)
    assert sorted(back) == sorted(feats)
    for k, v in feats.items():
        np.testing.assert_array_equal(back[k], v)


def test_engine_exports_resolve():
    from curriculum_learning_for_vln_tpu import engine as j_engine

    for name in t_engine.__all__:
        assert callable(getattr(t_engine, name)), name
    missing = set(j_engine.__all__) - set(t_engine.__all__)
    # the jit-step builders, whose jobs one_iter and backtranslation_step do
    assert missing == {"build_train_step", "build_backtranslation_step"}


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.fixture()
def op_calls(monkeypatch):
    """Counts the calls of each kernel op's wrapper (on the CPU a call runs
    the plain twin and counts no launch)."""
    from curriculum_learning_for_vln_torch.ops.cuda import cand_score, lstm_scan, pano_fused

    calls = {}
    for mod, names in ((pano_fused, ("pano_attend", "pano_attend_bwd")),
                       (cand_score, ("cand_score", "cand_score_bwd")),
                       (lstm_scan, ("lstm_scan", "lstm_scan_train", "lstm_scan_bwd"))):
        for name in names:
            def counted(*args, _fn=getattr(mod, name), _name=name, **kwargs):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*args, **kwargs)

            monkeypatch.setattr(mod, name, counted)
    return calls


def _serve_setup(tokenizer, synth_graphs, synth_world, synth_dataset):
    world = t_compiler.compile_world(synth_graphs, max_candidates=16, use_native=False)
    world.features = synth_world.features.copy()
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 16, 8, 32
    tok = Tokenizer(read_vocab(os.path.join(REPO, "assets/train_vocab.txt")),
                    encoding_length=12)
    agent = EnvDropAgent(m, 12, tok.vocab_size(), synth_world.features.shape[-1], 5)
    params = agent.init(torch.Generator().manual_seed(0))
    reqs = [{"instruction": it["instructions"][0], "scan": it["scan"],
             "start_viewpoint": it["path"][0], "heading": it["heading"]}
            for it in synth_dataset[:3]]
    return world, agent, params, tok, reqs


def test_routes_set_in_both_directions(op_calls, synth_graphs, synth_world, synth_dataset,
                                       tokenizer, caplog):
    world, agent, params, tok, reqs = _serve_setup(tokenizer, synth_graphs, synth_world,
                                                   synth_dataset)

    def serve(nav):
        op_calls.clear()
        out = nav.navigate_batch(reqs)
        return out, dict(op_calls)

    default_out, default_calls = serve(Navigator(world, agent, params, tok, max_batch=4,
                                                 device="cpu"))
    assert default_calls == {"lstm_scan": 2, "pano_attend": 5, "cand_score": 5}
    plain = Navigator(world, agent, params, tok, max_batch=4, device="cpu", use_pallas=False)
    plain_out, plain_calls = serve(plain)
    assert plain_calls == {} and (t_rnn.get_backend(), t_fused.get_backend()) == ("plain",) * 2
    assert plain_out == default_out  # f32: the same trajectories on either route
    kernels = Navigator(world, agent, params, tok, max_batch=4, device="cpu", use_pallas=True)
    assert serve(kernels)[1] == default_calls
    assert serve(plain)[1] == {}  # each Navigator serves on its own route
    assert serve(kernels)[1] == default_calls

    # configure_runtime, as the trainers call it: plain, then the default
    cfg = get_cfg_defaults()
    cfg.merge_from_list(["TPU.USE_PALLAS", False])
    with caplog.at_level(logging.INFO, logger="main.loop"):
        t_loop.configure_runtime(cfg)
    assert any("K1-K8 not launched" in r.getMessage() and "OBS_MASKS" in r.getMessage()
               for r in caplog.records)
    assert (t_rnn.get_backend(), t_fused.get_backend()) == ("plain",) * 2
    t_loop.configure_runtime(get_cfg_defaults())
    assert (t_rnn.get_backend(), t_fused.get_backend()) == ("cuda", "cuda")


def test_main_logs_tpu_knobs(caplog):
    logger = logging.getLogger("main.test_knobs")
    cfg = get_cfg_defaults()
    cfg.merge_from_list(["TPU.SCAN_UNROLL", 4, "TPU.COMPILATION_CACHE", "/x",
                         "TPU.PARALLEL_WARMUP", True, "TPU.SCAN_ITERS", 2])
    with caplog.at_level(logging.INFO, logger="main.test_knobs"):
        t_main.log_tpu_knobs(cfg, logger)
    text = [r.getMessage() for r in caplog.records]
    for key in ("SCAN_UNROLL", "COMPILATION_CACHE", "PARALLEL_WARMUP", "SCAN_ITERS"):
        assert sum(key in t and "no effect here" in t for t in text) == 1, (key, text)
    caplog.clear()
    cfg.merge_from_list(["TPU.SCAN_UNROLL", 1, "TPU.COMPILATION_CACHE", "",
                         "TPU.PARALLEL_WARMUP", False, "TPU.SCAN_ITERS", 1])
    with caplog.at_level(logging.INFO, logger="main.test_knobs"):
        t_main.log_tpu_knobs(cfg, logger)
    assert not caplog.records


def test_main_sets_the_route_for_every_mode(caplog):
    """``main`` itself reads TPU.USE_PALLAS, before any mode runs (here
    ``--check-the-code``, which no trainer runs), and logs the plain route."""
    argv = ["--device", "cpu", "--check-the-code", "--config-file",
            os.path.join(REPO, "configs/follower/follower_config.yaml"), "TPU.USE_PALLAS", "False",
            "TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", "2", "TPU.SYNTHETIC_NODES", "16",
            "TPU.SYNTHETIC_TRAIN_PATHS", "6", "TPU.SYNTHETIC_VAL_PATHS", "4",
            "OUTPUT.LOG_DIR", "", "OUTPUT.TSBOARD_DIR", ""]
    with caplog.at_level(logging.INFO, logger="main"):
        t_main.main(*t_main.parse_args(argv))
    text = [r.getMessage() for r in caplog.records]
    assert (t_rnn.get_backend(), t_fused.get_backend()) == ("plain",) * 2
    assert any("K1-K8 not launched" in t for t in text)
    assert any("PARALLEL_WARMUP" in t and "no effect here" in t for t in text)  # the default
