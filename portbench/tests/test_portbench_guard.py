"""The import guard compares whole top-level names."""

from conftest_util import ROOT  # noqa: F401
from portbench.harness.guard import forbidden_modules


def test_guard_passes_the_port_and_fails_the_jax_package():
    assert forbidden_modules(["platypus_tpu_torch", "platypus_tpu_torch.ops",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["platypus_tpu", "platypus_tpu.io.bam",
                              "jax.numpy", "jaxlib", "flax.linen",
                              "torch"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                            "platypus_tpu",
                                            "platypus_tpu.io.bam"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    import ast
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for dirpath, _dirs, files in os.walk(here):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                else:
                    continue
                assert not forbidden_modules(names), (f, names)
