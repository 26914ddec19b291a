"""The port's ``main`` in 2 processes against 1, as ``tests/test_multihost.py``
holds the JAX package's CLI.

Each run is ``python -m curriculum_learning_for_vln_torch.main --device
cpu`` on the Follower config (a tiny synthetic world, f32, teacher
feedback, SGD, 2 epochs x 2 iterations, an evaluation each epoch, and
``TPU.PROFILE_DIR``), in processes of its own.  The 2-process runs join
through ``VLN_COORDINATOR`` / ``VLN_NUM_PROCESSES`` / ``VLN_PROCESS_ID``
(tcp://) or through ``VLN_MULTIHOST=1`` and torchrun's variables
(env://), over gloo.  Held: rc 0, with neither JAX nor TensorFlow loaded
by the end of a run; the mesh and the backend in the log; every scalar
rank 0 logs within rtol / atol 1e-4 of the one process's (but the
``perf/`` timings, which rank 0 writes too); the checkpoints and the
traces written by rank 0 alone; the one-process run's trace of its
second epoch (``TPU.PROFILE_DIR``, utils/profiling.py) a Chrome trace of
the iterations' ops; utils/profiling.py's ``StepTimer``; and the scalar
writer's TensorBoard event file, read back.
"""
import glob
import json
import os
import socket
import struct
import subprocess
import sys

import pytest
import torch
import torch_dp_workers as W

from curriculum_learning_for_vln_torch.utils import profiling

# main as a user runs it; it must load neither JAX nor TensorFlow (whose
# Keras imports JAX), the scalar writer's TensorBoard files included
LAUNCH = ("import sys; from curriculum_learning_for_vln_torch import main; "
          "main.main(*main.parse_args(sys.argv[1:])); "
          "loaded = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'tensorflow'}); "
          "assert not loaded, loaded")

OVERRIDES = ["TPU.SYNTHETIC_WORLD", "True", "TPU.SYNTHETIC_SCANS", "2",
             "TPU.SYNTHETIC_NODES", "24", "TPU.PRECISION", "f32", "TRAIN.MAX_EPOCH", "2",
             "TRAIN.ITER_PER_EPOCH", "2", "TRAIN.BATCH_SIZE", "8", "TRAIN.EVAL_INTERVAL", "1",
             "TRAIN.OPTIM", "sgd", "TRAIN.LR", "0.005", "AGENT.MAX_EPISODE_LEN", "8",
             "AGENT.FEEDBACK", "teacher", "DATA.MAX_ENC_LEN", "16",
             "MODEL.FOLLOWER.WORD_EMB_SIZE", "30", "MODEL.FOLLOWER.HIDDEN_SIZE", "32"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out, env_extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **env_extra)
    cmd = [sys.executable, "-c", LAUNCH, "--device", "cpu", "--seed", "2020",
           "--config-file", "configs/follower/follower_config.yaml", *OVERRIDES,
           "OUTPUT.CKPT_DIR", str(out / "ckpt"), "OUTPUT.TSBOARD_DIR", str(out / "tb"),
           "OUTPUT.LOG_DIR", str(out / "logs"), "TPU.PROFILE_DIR", str(out / "trace")]
    return subprocess.Popen(cmd, cwd=W.REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _finish(procs):
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def _log(out):
    return "".join(open(f).read() for f in glob.glob(str(out / "logs" / "*.log")))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    out = tmp_path_factory.mktemp("one")
    _finish([_launch(out, {})])
    return out


def test_one_process_traces_its_second_epoch(one):
    (trace,) = glob.glob(str(one / "trace" / "trace_*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any(n.startswith("aten::") for n in names)
    assert "Capturing a torch.profiler trace of epoch 2" in _log(one)


@pytest.mark.parametrize("launch", ["tcp", "env"])
def test_two_processes_match_one(one, tmp_path, launch):
    port = str(_free_port())
    outs = [tmp_path / f"rank{r}" for r in range(2)]
    if launch == "tcp":
        envs = [{"VLN_COORDINATOR": f"127.0.0.1:{port}", "VLN_NUM_PROCESSES": "2",
                 "VLN_PROCESS_ID": str(r)} for r in range(2)]
    else:
        envs = [{"VLN_MULTIHOST": "1", "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                 "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
                for r in range(2)]
    _finish([_launch(out, env) for out, env in zip(outs, envs)])

    log0 = _log(outs[0])
    assert "Device mesh: data=2 model=1 (of 2 ranks)" in log0
    assert "backend gloo (ranks on the CPU), rank 0 of 2" in log0
    want, got = W.read_events(str(one / "tb")), W.read_events(str(outs[0] / "tb"))
    assert set(got) == set(want) and ("train/ml_epoch", 2) in want
    timed = {tag for tag, _ in W.read_events(str(outs[0] / "tb"), timings=True)}
    assert {"perf/train_epoch_mean_ms", "perf/eval_mean_ms"} <= timed
    for key in sorted(want):
        assert W.close(got[key], want[key]), (key, got[key], want[key])
    assert os.path.exists(outs[0] / "ckpt" / "latest.ckpt")
    assert glob.glob(str(outs[0] / "trace" / "trace_*.json"))
    assert not os.path.exists(outs[1] / "ckpt" / "latest.ckpt")
    assert not os.path.exists(outs[1] / "tb") and not os.path.exists(outs[1] / "trace")


def test_step_timer_times_and_writes_means(monkeypatch):
    """utils/profiling.py's StepTimer: named timers (the card synchronized
    before each stops), their means, and the scalars they write."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: synced.append(1))
    timer = profiling.StepTimer()
    for _ in range(2):
        with timer.time("step"):
            sum(range(1000))
    timer.start("eval")
    assert timer.stop("eval", sync=False) >= 0.0
    summary = timer.summary()
    assert summary["step"]["count"] == 2 and summary["eval"]["count"] == 1 and len(synced) == 2
    scalars = []
    timer.write_scalars(type("W", (), {"add_scalar": lambda self, *a: scalars.append(a)})(), 3)
    assert {a[0] for a in scalars} == {"perf/step_mean_ms", "perf/eval_mean_ms"}
    timer.reset()
    assert timer.summary() == {}


def _records(path):
    """The Event messages of a TensorBoard event file (TFRecord framing)."""
    from tensorboard.compat.proto import event_pb2

    events, data = [], open(path, "rb").read()
    while data:
        (n,) = struct.unpack("<Q", data[:8])
        events.append(event_pb2.Event.FromString(data[12: 12 + n]))
        data = data[16 + n:]
    return events


def test_scalar_writer_writes_tensorboard_files_without_tensorflow(tmp_path):
    """utils/logging_utils.py's ScalarWriter: the JSON lines and a
    TensorBoard event file with its scalars and histograms, written in a
    process that then holds neither TensorFlow nor JAX."""
    code = ("import sys, numpy as np; "
            "from curriculum_learning_for_vln_torch.utils.logging_utils import ScalarWriter; "
            f"w = ScalarWriter({str(tmp_path)!r}); w.add_scalar('train/loss', 2.5, 3); "
            "w.add_histogram('sample_weight', np.arange(10.0), 3); w.close(); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'tensorflow'}))")
    run = subprocess.run([sys.executable, "-c", code], cwd=W.REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "[]", run.stdout + run.stderr
    (tb,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    events = _records(tb)
    assert events[0].file_version == "brain.Event:2"
    values = {v.tag: (e.step, v) for e in events[1:] for v in e.summary.value}
    assert values["train/loss"][0] == 3 and values["train/loss"][1].simple_value == 2.5
    histo = values["sample_weight"][1].histo
    assert (histo.num, histo.min, histo.max, sum(histo.bucket)) == (10, 0.0, 9.0, 10)
    with open(tmp_path / "events.jsonl") as f:
        assert [json.loads(ln)["tag"] for ln in f] == ["train/loss", "sample_weight"]
