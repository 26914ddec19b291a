"""The port stands alone: neither it nor its card tests
(``tests/test_torch_card_*.py``, ``tests/test_torch_keep_mask_card.py``,
``tests/torch_card_world.py``) import JAX
or the JAX package, and its entry points run on the card unless the caller
asks for the CPU."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
PORT = os.path.join(REPO, "curriculum_learning_for_vln_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "curriculum_learning_for_vln_tpu")


def _port_files():
    files = [os.path.join(TESTS, "torch_card_world.py"),
             os.path.join(TESTS, "test_torch_keep_mask_card.py"),
             *sorted(glob.glob(os.path.join(TESTS, "test_torch_card_*.py")))]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_import():
    files = _port_files()
    assert len(files) > 30
    bad = {os.path.relpath(path, REPO): mods for path in files
           if (mods := [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN])}
    assert not bad, f"imports of JAX or the JAX package: {bad}"


# the Follower and Self-Monitor slice's modules, among the files scanned above
AGENT_MODULES = ("agents/__init__.py", "agents/follower.py", "agents/monitor.py",
                 "agents/test_agent.py", "models/attention.py", "models/decoders.py",
                 "models/core.py", "ops/fused_obs.py", "engine/loop.py", "engine/trainer.py",
                 "convert.py", "serve.py", "main.py")


def test_agent_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(AGENT_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     .removesuffix(".__init__") for m in AGENT_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# the speaker and back-translation slice's modules
SPEAKER_MODULES = ("agents/speaker.py", "models/speaker_model.py", "engine/self_train.py",
                   "engine/__init__.py", "env/host_env.py", "agents/envdrop.py", "main.py")


def test_speaker_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(SPEAKER_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     .removesuffix(".__init__") for m in SPEAKER_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_package_import_leaves_jax_out():
    code = (f"import sys; sys.path.insert(0, {TESTS!r});"
            "import curriculum_learning_for_vln_torch.serve, torch_card_world;"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_navigator_defaults_to_cuda():
    from curriculum_learning_for_vln_torch.agents.envdrop import EnvDropAgent
    from curriculum_learning_for_vln_torch.serve import Navigator
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    world = compiler.compile_world(synthetic.make_world_graphs(1, 8, seed=0), 16)
    compiler.attach_synthetic_features(world, feature_dim=16)
    m = get_cfg_defaults().MODEL.ENVDROP
    m.WORD_EMB_SIZE, m.ACT_EMB_SIZE, m.HIDDEN_SIZE = 8, 8, 16
    agent = EnvDropAgent(m, 6, 10, 16, 4)
    tok = Tokenizer(["<PAD>", "<UNK>", "<EOS>", "go"], encoding_length=6)
    params = agent.init(torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert Navigator(world, agent, params, tok).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Navigator(world, agent, params, tok)


# the beam search and ViLBERT slices' modules
BEAM_VILBERT_MODULES = ("utils/floyd.py", "agents/beam.py", "engine/beam_eval.py",
                        "models/vilbert.py", "models/file_utils.py", "agents/vln_bert.py",
                        "engine/pretrain.py", "build_clr2r.py", "convert.py", "main.py")


def test_beam_and_vilbert_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(BEAM_VILBERT_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     for m in BEAM_VILBERT_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_build_clr2r_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():  # on a GPU host it would build the rounds there
        pytest.skip("needs a host without CUDA to see the refusal")
    run = subprocess.run([sys.executable, "-m", "curriculum_learning_for_vln_torch.build_clr2r",
                          "--out", str(tmp_path / "out"), "--steps", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "CUDA is not available" in run.stderr
    assert not (tmp_path / "out").exists()


def test_run_beam_eval_defaults_to_cuda(tmp_path):
    from curriculum_learning_for_vln_torch.agents.follower import FollowerAgent
    from curriculum_learning_for_vln_torch.engine.beam_eval import run_beam_eval
    from curriculum_learning_for_vln_torch.utils.config import get_cfg_defaults
    from curriculum_learning_for_vln_torch.utils.tokenizer import Tokenizer
    from curriculum_learning_for_vln_torch.world import compiler, synthetic

    if torch.cuda.is_available():  # on a GPU host it would search there
        pytest.skip("needs a host without CUDA to see the refusal")
    world = compiler.compile_world(synthetic.make_world_graphs(1, 8, seed=0), 16)
    compiler.attach_synthetic_features(world, feature_dim=16)
    cfg = get_cfg_defaults()
    cfg.OUTPUT.RESULT_DIR = str(tmp_path / "results")
    m = cfg.MODEL.FOLLOWER
    m.WORD_EMB_SIZE, m.HIDDEN_SIZE = 8, 16
    tok = Tokenizer(["<PAD>", "<UNK>", "<EOS>", "<BOS>", "go"], encoding_length=6)
    agent = FollowerAgent(m, tok.vocab_size(), 16, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_beam_eval(cfg, agent, world, {}, tok, beam_size=2)
    assert not (tmp_path / "results").exists()


# the Exp3.S curriculum, datasets, gt-route teacher, early exit and GloVe slice's modules
SLICE9_MODULES = ("engine/auto_curriculum.py", "utils/glove.py", "ops/draws.py",
                  "data/datasets.py", "env/env.py", "env/host_env.py", "agents/common.py",
                  "agents/packed.py", "models/encoder.py", "pipeline.py", "main.py")


def test_curriculum_and_data_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(SLICE9_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     for m in SLICE9_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_main_auto_defaults_to_cuda():
    if torch.cuda.is_available():  # on a GPU host it would train there
        pytest.skip("needs a host without CUDA to see the refusal")
    cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--config-file",
           "configs/envdrop/envdrop_cl_config.yaml", "TRAIN.CLMODE", "AUTO",
           "TPU.SCAN_EARLY_EXIT", "True", "TPU.SYNTHETIC_WORLD", "True"]
    run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "CUDA is not available" in run.stderr


# the data-parallel slice's modules
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py", "parallel/vilbert_sharding.py",
                    "utils/profiling.py", "engine/trainer.py", "engine/self_train.py",
                    "models/vilbert.py", "ops/philox.py", "main.py")


def test_parallel_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(PARALLEL_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     .removesuffix(".__init__") for m in PARALLEL_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_multi_process_main_defaults_to_cuda(tmp_path):
    """With the VLN_* variables and no --device, each rank asks for its GPU
    and raises without one: no rank falls back to the CPU or to gloo."""
    if torch.cuda.is_available():  # on a GPU host it would train there
        pytest.skip("needs a host without CUDA to see the refusal")
    env = dict(os.environ, VLN_COORDINATOR="127.0.0.1:1", VLN_NUM_PROCESSES="2",
               VLN_PROCESS_ID="0")
    cmd = [sys.executable, "-m", "curriculum_learning_for_vln_torch.main", "--config-file",
           "configs/follower/follower_config.yaml", "TPU.SYNTHETIC_WORLD", "True",
           "OUTPUT.LOG_DIR", str(tmp_path)]
    run = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "CUDA is not available" in run.stderr


def test_backend_rule(monkeypatch):
    """NCCL when every rank of a host owns its GPU, gloo when they share one
    or run on the CPU."""
    from curriculum_learning_for_vln_torch.parallel import mesh as M

    assert M.backend_for(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert M.backend_for(torch.device("cuda", 0), 1) == "nccl"
    assert M.backend_for(torch.device("cuda", 1), 2) == "nccl"
    assert M.backend_for(torch.device("cuda", 0), 4) == "gloo"


# slice 11's modules: the rollout BPTT, the native graph library, the
# sub-instruction models, the region labels and the roofline model
SLICE11_MODULES = ("ops/bptt.py", "world/native.py", "world/compiler.py", "models/subinstr.py",
                   "utils/region_label.py", "utils/roofline.py", "utils/__init__.py",
                   "agents/common.py")


def test_slice11_modules_are_scanned_and_import_without_jax():
    files = {os.path.relpath(p, PORT) for p in _port_files()}
    assert set(SLICE11_MODULES) <= files
    mods = ", ".join("curriculum_learning_for_vln_torch." + m[:-3].replace("/", ".")
                     .removesuffix(".__init__") for m in SLICE11_MODULES)
    code = (f"import sys, {mods};"
            f"bad = {{m.split('.')[0] for m in sys.modules}} & {set(FORBIDDEN)!r};"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
