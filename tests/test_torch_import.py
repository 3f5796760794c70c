"""Import hygiene of the torch port: it never imports jax, and its CUDA
wrapper imports on a machine with no nvcc, no triton and no card."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import platypus_tpu_torch
from platypus_tpu_torch.ops import align_cuda
from platypus_tpu_torch.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(platypus_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="platypus_tpu_torch."))


def _run(code, env_drop=(), **env_set):
    env = {k: v for k, v in os.environ.items() if k not in env_drop}
    env.update(env_set)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_every_module_leaves_jax_unloaded():
    mods = _modules()
    assert "platypus_tpu_torch.cli" in mods
    assert "platypus_tpu_torch.ops.align_cuda" in mods
    assert "platypus_tpu_torch.engine.hla" in mods
    proc = _run("import importlib, sys\n"
                f"for m in {mods!r}: importlib.import_module(m)\n"
                "assert 'jax' not in sys.modules, 'jax was imported'\n",
                env_drop=("PLATYPUS_TPU_PLATFORM", "JAX_PLATFORMS"))
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_jax_import_in_package_source():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    sources = []
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                sources.append(path)
                with open(path) as fh:
                    assert not pattern.search(fh.read()), path
    assert len(sources) >= 10


def test_cuda_wrapper_imports_without_nvcc_or_triton(tmp_path):
    """No nvcc on PATH or under CUDA_HOME, and `import triton` fails: the
    module still imports, and only asking for the compiler raises."""
    code = """
import importlib.abc, sys

class BlockTriton(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "triton" or name.startswith("triton."):
            raise ImportError("triton is blocked in this process")
        return None

sys.meta_path.insert(0, BlockTriton())
from platypus_tpu_torch.ops import align_cuda
try:
    align_cuda._nvcc()
except RuntimeError as exc:
    assert "nvcc" in str(exc)
else:
    raise AssertionError("nvcc was found")
"""
    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                           if not os.path.exists(os.path.join(p, "nvcc")))
    proc = _run(code, PATH=path, CUDA_HOME=str(tmp_path / "no_cuda"))
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_require_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.require_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_fetch_returns_every_tensor_in_its_shape():
    ts = [torch.arange(6, dtype=torch.int32).reshape(2, 3),
          torch.arange(4, dtype=torch.int32)[:2],
          torch.zeros((0, 5), dtype=torch.int32)]
    got = backend.fetch(ts)
    assert [g.shape for g in got] == [(2, 3), (2,), (0, 5)]
    for g, t in zip(got, ts):
        assert (g == t.numpy()).all()
    assert backend.fetch([]) == []


def test_kernel_wrapper_rejects_other_devices():
    t = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        align_cuda.band_align_padded(t, t, t, t, t[0])


def test_traceback_wrapper_rejects_other_devices():
    t = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        align_cuda.band_align_traceback_padded(t, t, t, t, t[0])


def test_kernel_build_names_every_source():
    """Each kernel library has its source in the package, and its build
    path is keyed by that source and the flags."""
    paths = {name: align_cuda.library_path(name) for name in align_cuda.KERNELS}
    assert set(paths) == {"band_align", "band_align_tb"}
    for name, path in paths.items():
        assert os.path.exists(align_cuda.source(name))
        assert os.path.basename(path).startswith(f"lib{name}_")
    assert len(set(paths.values())) == 2


def test_kernel_table_names_the_tpu_kernels():
    """Each kernel library's `replaces` is the def line of a Pallas kernel."""
    for name, kernel in align_cuda.KERNELS.items():
        path, line = kernel.replaces.split(":")
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read().splitlines()[int(line) - 1]
        assert re.match(r"def _band_align\w*_kernel\(", text), (name, text)


def test_chip_smoke_imports_no_jax_package():
    """chip_smoke.py imports neither jax nor the JAX package; it reaches
    the JAX package's host code only through the port and child processes."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    modules = [alias.name for node in ast.walk(tree)
               if isinstance(node, ast.Import) for alias in node.names]
    modules += [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module]
    assert "platypus_tpu_torch.ops" in modules
    for mod in modules:
        root = mod.split(".")[0]
        assert root not in ("jax", "platypus_tpu", "synth", "scaling_bench"), mod
