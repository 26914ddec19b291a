"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port: each import's top-level name,
compared whole, from every module's source."""
import ast
from pathlib import Path

from benchmark.lib.harness import BANNED, BENCH

PORT = "curriculum_learning_for_vln_torch"


def imports(path: Path):
    """(top-level name, level) of every import in a module."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = [(p.name, n) for p in modules() for n, level in imports(p)
             if level == 0 and n in BANNED]
    assert found == []
    assert len(modules()) > 10


def test_reference_imports_nothing_of_the_port_or_the_harness():
    for p in sorted((BENCH / "reference").glob("*.py")):
        for name, level in imports(p):
            assert name != PORT, p
            assert level <= 1, p  # only its own modules, never ..lib or ..runners
            assert level == 1 or name in ("__future__", "math", "typing", "numpy", "scipy",
                                          "torch"), (p, name)


def test_whole_names_are_compared():
    from benchmark.lib.harness import banned_modules

    assert banned_modules(["jax.numpy", "jaxlib", "flax.linen",
                           "curriculum_learning_for_vln_tpu.ops"]) == [
        "curriculum_learning_for_vln_tpu.ops", "flax.linen", "jax.numpy", "jaxlib"]
    assert banned_modules([PORT, PORT + ".ops", "jaxtyping", "flaxen"]) == []
