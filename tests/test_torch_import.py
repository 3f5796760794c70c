"""Import hygiene of the torch port: it never imports jax or the JAX
package `platypus_tpu` (not even a module of it that imports no jax), and
its CUDA wrapper imports on a machine with no nvcc, no triton and no
card."""

import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import platypus_tpu_torch
from platypus_tpu.cli import main as jax_cli
from platypus_tpu_torch.ops import align_cuda
from platypus_tpu_torch.utils import backend
from torch_pool_util import (cli_args, data_lines, fresh_env, importers,
                             make_dataset, pool_summary)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(platypus_tpu_torch.__file__)
BLOCKED = ("jax", "platypus_tpu")


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
    for mod in ("parallel.mesh", "parallel.distributed", "graft_entry"):
        assert f"platypus_tpu_torch.{mod}" in mods
    proc = _run("import importlib, sys\n"
                f"for m in {mods!r}: importlib.import_module(m)\n"
                "assert 'jax' not in sys.modules, 'jax was imported'\n",
                env_drop=("PLATYPUS_TPU_PLATFORM", "JAX_PLATFORMS"))
    assert proc.returncode == 0, proc.stderr[-3000:]


def _sources():
    """Every .py file of the port."""
    return sorted(os.path.join(root, f) for root, _dirs, files in os.walk(PKG_DIR)
                  for f in files if f.endswith(".py"))


def _module_name(path):
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[: -len(".__init__")] if rel.endswith(".__init__") else rel


def _imports(path):
    """(line, absolute module name) of every import statement in `path`,
    relative imports resolved, and of every importlib.import_module /
    __import__ call whose first argument is a string."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    name = _module_name(path)
    package = name if path.endswith("__init__.py") else name.rpartition(".")[0]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, alias.name) for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[: len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.append((node.lineno, base))
            out += [(node.lineno, f"{base}.{alias.name}") for alias in node.names]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            out.append((node.lineno, node.args[0].value))
    return out


def _blocked(mod):
    return mod.split(".")[0] in BLOCKED


def import_closure(roots):
    """The modules of the repository that the files `roots` reach through
    their imports, transitively: an AST walk, no module is imported.
    Returns the set of dotted names of repository modules reached."""
    seen, todo = set(), list(roots)
    while todo:
        path = todo.pop()
        for _line, mod in _imports(path):
            for cand in (os.path.join(REPO, *mod.split(".")) + ".py",
                         os.path.join(REPO, *mod.split("."), "__init__.py")):
                if os.path.exists(cand) and mod not in seen:
                    seen.add(mod)
                    todo.append(cand)
    return seen


def test_no_jax_import_in_package_source():
    """No import statement of the port, top level or indented, and no
    import_module / __import__ call names jax or the JAX package."""
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    sources = _sources()
    for path in sources:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path
        bad = [(line, mod) for line, mod in _imports(path) if _blocked(mod)]
        assert not bad, (path, bad)
    assert len(sources) >= 50


def test_import_closure_holds_no_jax_package_module():
    """The closure tool: every port module and chip_smoke.py reach, through
    their imports, port modules only -- zero modules of platypus_tpu."""
    reached = import_closure(_sources() + [os.path.join(REPO, "chip_smoke.py")])
    assert "platypus_tpu_torch.engine.score" in reached
    assert "platypus_tpu_torch.native" in reached
    assert sorted(m for m in reached if _blocked(m)) == []
    # The tool does find the JAX package where it is imported.
    jax_reached = import_closure([os.path.join(REPO, "platypus_tpu", "cli.py")])
    assert "platypus_tpu.engine.runner" in jax_reached


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
    """chip_smoke.py imports neither jax nor the JAX package (nor through
    import_module / __import__); it runs the reference only as a child
    process."""
    modules = [mod for _line, mod in _imports(os.path.join(REPO, "chip_smoke.py"))]
    assert "platypus_tpu_torch.ops" in modules
    for mod in modules:
        root = mod.split(".")[0]
        assert root not in ("jax", "platypus_tpu", "synth", "scaling_bench"), mod


@pytest.fixture(scope="module")
def small_region(tmp_path_factory):
    """test_device_service.py's 30 kb dataset, called over 12 kb in 3 kb
    regions, and the JAX CLI's data lines for it (run in this process)."""
    workdir = str(tmp_path_factory.mktemp("torch_import"))
    ref_path = make_dataset(workdir)
    extra = ["--bufferSize=3000"]
    region = "--regions=chr20:1000-13000"
    out = os.path.join(workdir, "jax.vcf")
    assert jax_cli(cli_args(workdir, ref_path, out,
                            ["--deviceInference=0", *extra], region)) == 0
    return workdir, ref_path, extra, region, data_lines(out)


def test_port_runs_with_jax_package_blocked(tmp_path, small_region):
    """A fresh interpreter whose meta-path finder (the test sitecustomize,
    loaded by every process it spawns too) blocks jax and platypus_tpu:
    every port module imports, and the port's CLI -- one process, then a
    --nCPU=2 pool with its device worker -- writes the JAX CLI's data
    lines."""
    workdir, ref_path, extra, region, want = small_region
    assert want
    outs = [str(tmp_path / "one.vcf"), str(tmp_path / "pool.vcf")]
    runs = [cli_args(workdir, ref_path, outs[0], extra, region),
            cli_args(workdir, ref_path, outs[1],
                     [*extra, "--nCPU=2", "--tpuWorkers=1"], region)]
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "from platypus_tpu_torch.cli import main\n"
        f"for argv in {runs!r}:\n"
        "    assert main(argv, device='cpu') == 0\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'platypus_tpu')]\n")
    env, import_log = fresh_env(tmp_path, PTT_TEST_BLOCK_JAX_PACKAGE="1",
                                PLATYPUS_TPU_DEVICE_SETTLE="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    imports = import_log.read_text().splitlines()
    assert not importers(imports, "jax") and not importers(imports, "platypus_tpu")
    assert not [name for name in importers(imports, "torch")
                if name.startswith("ptpu-host")], imports
    assert pool_summary(f"{outs[1]}.log")["host"] >= 1
    for out in outs:
        assert data_lines(out) == want
