"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os

from benchmark import nojax, spec


def test_offenders_compare_whole_top_level_names():
    assert nojax.offenders(["deeprl_network_tpu_torch",
                            "deeprl_network_tpu_torch.utils.rollout",
                            "torch", "numpy"]) == []
    assert nojax.offenders(["jax.numpy", "jaxlib", "flax.linen",
                            "deeprl_network_tpu.envs"]) == [
        "deeprl_network_tpu", "flax", "jax", "jaxlib"]
    assert nojax.offenders(["jaxtyping", "flaxen"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for base, _, files in os.walk(os.path.join(spec.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_benchmark_source_imports_jax():
    for path in _sources():
        assert not nojax.offenders(list(_imports(path))), path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        mods = set(_imports(path))
        assert "deeprl_network_tpu_torch" not in mods, path
        assert mods <= {"__future__", "benchmark", "contextlib", "importlib",
                        "math", "numpy", "torch", "typing"}, (path, mods)
