"""The port stands alone: neither it nor ``chip_smoke.py`` imports JAX or
the JAX package, and its entry points run on the card unless the caller
asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "curriculum_learning_for_vln_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "curriculum_learning_for_vln_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
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
    code = ("import sys, curriculum_learning_for_vln_torch.serve, chip_smoke;"
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
