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
    assert "platypus_tpu_torch.ops.likelihood_cuda" in mods
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


def test_pair_wrapper_rejects_other_devices():
    m = torch.zeros((4, 2), dtype=torch.uint8, device="meta")
    t = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        align_cuda.band_align_pairs(m, m, m, m, t, t, t, t)


def test_traceback_wrapper_rejects_other_devices():
    m = torch.zeros((4, 2), dtype=torch.uint8, device="meta")
    t = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        align_cuda.band_align_traceback_pairs(m, m, m, m, t, t, t, t)


def test_kernel_build_names_every_source():
    """Each kernel library has its source in the package, and its build
    path is keyed by that source and the flags."""
    paths = {name: align_cuda.library_path(name) for name in align_cuda.KERNELS}
    assert set(paths) == {"band_align", "band_align_tb", "infer_window"}
    for name, path in paths.items():
        assert os.path.exists(align_cuda.source(name))
        assert os.path.basename(path).startswith(f"lib{name}_")
    assert len(set(paths.values())) == 3


def test_kernel_build_is_keyed_by_the_shared_headers(tmp_path, monkeypatch):
    """A library's build path changes with any csrc/*.cuh header, not only
    with its own source, so a header edit rebuilds both kernels."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(align_cuda, "source",
                        lambda name: str(tmp_path / f"{name}.cu"))
    first = align_cuda.library_path("k")
    assert align_cuda.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert align_cuda.library_path("k") != first


def test_kernel_table_names_the_tpu_kernels():
    """Each kernel library's `replaces` starts with the def line of a
    Pallas kernel, or for the fused inference that of the XLA program it
    replaces, which it names as such."""
    for name, kernel in align_cuda.KERNELS.items():
        path, line = re.match(r"(\S+):(\d+)", kernel.replaces).groups()
        with open(os.path.join(REPO, path)) as fh:
            text = fh.read().splitlines()[int(line) - 1]
        if name == "infer_window":
            assert text.startswith("def infer_window_batch("), text
            assert "XLA program, not a Pallas kernel" in kernel.replaces
        else:
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


# Modules of the JAX package that the port carries under another name.
RENAMED = {
    "ops/align_jax.py": ["ops/align_torch.py", "ops/align_cuda.py"],
    "ops/align_pallas.py": ["csrc/band_align.cu", "csrc/band_align_tb.cu"],
    "ops/likelihood_jax.py": ["ops/likelihood_torch.py",
                              "csrc/infer_window.cu"],
}
# Modules of the port with no module of the JAX package at their path or
# in RENAMED: module -> what it is.
PORT_ONLY = {
    "graft_entry.py": "the twin of the repository's __graft_entry__.py, "
                      "which lies outside the JAX package",
    "ops/likelihood_cuda.py": "the card route of "
                              "likelihood_jax.infer_window_batch: the wrapper "
                              "of csrc/infer_window.cu (the plain version "
                              "stays likelihood_torch.infer_window_batch)",
}
# PLATYPUS_TPU_* variables the JAX package reads and the port does not:
# variable -> (the JAX package's file that reads it, why the port has no
# use for it).  Each is TPU-tunnel or backend-routing machinery that the
# port's explicit device replaces.
NOT_PORTED = {
    "PLATYPUS_TPU_HYBRID_PROBE": (
        "engine/runner.py", "the 1 MB upload health probe of a device worker "
        "on a tunnelled TPU; the port's device worker owns its card with one "
        "allocation before it claims"),
    "PLATYPUS_TPU_NATIVE_ALIGN": (
        "engine/score.py", "native or XLA alignment by the JAX backend; the "
        "port aligns natively on the host path (device None) and with K1 on "
        "a torch device"),
    "PLATYPUS_TPU_DEVICE_FLANK": (
        "engine/score.py", "the Pallas traceback kernel only on the TPU "
        "backend; the port's flank path follows its device: K2 on a torch "
        "device, the scalar path on the host"),
    "PLATYPUS_TPU_PLATFORM": (
        "cli.py", "pins the JAX backend; the port's entry points take an "
        "explicit torch device"),
    "PLATYPUS_TPU_NO_REEXEC": (
        "cli.py", "opts out of the CPU re-exec that strips the TPU plugin's "
        "trigger; the port loads no plugin and never re-executes"),
    "_PLATYPUS_TPU_REEXECED": (
        "cli.py", "marks the re-executed CPU process; as above"),
    "PLATYPUS_TPU_SERVICE_PLATFORM": (
        "engine/device_service.py", "forces the JAX service's backend; the "
        "port's service runs on the run's torch device"),
    "PLATYPUS_TPU_JAX_CACHE": (
        "ops/align_jax.py", "XLA's persistent compile cache; the port "
        "compiles no XLA program (its kernels build once into _build/)"),
    "PLATYPUS_TPU_NATIVE_LIB": (
        "native/__init__.py", "names a prebuilt native library of the JAX "
        "package; the port's own is named by PLATYPUS_TPU_TORCH_NATIVE_LIB"),
    "PLATYPUS_TPU_MESH_TIMERS": (
        "parallel/mesh.py", "prints the mesh's three [mesh] timer lines; "
        "the port times them as the spans mesh_pack_launch, mesh_fetch and "
        "mesh_unpack, logged with the engine's other spans"),
    "PLATYPUS_TPU_INFER_THREAD": (
        "engine/runner.py", "runs begin and finish on a helper thread; on "
        "the H100 it lost to inline, thread / inline wall 1.0951 and 1.1706, "
        "so the port runs them inline on the pipeline thread"),
    "PLATYPUS_TPU_NATIVE_GT": (
        "vcfout/records.py", "turns the native genotype call off; the port "
        "calls genotypes natively whenever its library loads, held to the "
        "Python body by its tests"),
    "PLATYPUS_TPU_NATIVE_EM": (
        "native/__init__.py", "turns the native host EM off; the port uses "
        "it whenever its library loads and the EM passes its self-check"),
    "PLATYPUS_TPU_NATIVE_GL": (
        "native/__init__.py", "turns the native genotype likelihoods off; "
        "the port uses them whenever its library loads"),
    "PLATYPUS_TPU_NATIVE_INFER": (
        "native/__init__.py", "turns the native host inference batch off; "
        "the port uses it whenever its library loads and the EM passes its "
        "self-check"),
    "PLATYPUS_TPU_NATIVE_LOGLIK": (
        "native/__init__.py", "turns the native read log-likelihoods off; "
        "the port uses them whenever its library loads"),
    "PLATYPUS_TPU_NATIVE_POSTERIOR": (
        "native/__init__.py", "turns the native variant posteriors off; the "
        "port uses them whenever its library loads"),
}
_ENV = re.compile(r"(?<![A-Za-z0-9_])_?PLATYPUS_TPU_[A-Z0-9_]+")


def _tree(root, suffix=".py"):
    """Paths under `root`, relative to it, of its files ending in suffix."""
    return sorted(os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
                  for d, _dirs, files in os.walk(root) for f in files
                  if f.endswith(suffix))


def _env_vars(root):
    """The PLATYPUS_TPU_* names in each .py file under `root`."""
    found = {}
    for rel in _tree(root):
        with open(os.path.join(root, rel)) as fh:
            for name in _ENV.findall(fh.read()):
                found.setdefault(name, set()).add(rel)
    return found


def test_every_jax_package_module_has_a_port_counterpart():
    """Every module of platypus_tpu has a file of the port at the same
    relative path, or its counterparts in RENAMED."""
    jax_dir = os.path.join(REPO, "platypus_tpu")
    missing = []
    for rel in _tree(jax_dir):
        targets = RENAMED.get(rel, [rel])
        if not all(os.path.exists(os.path.join(PKG_DIR, t)) for t in targets):
            missing.append((rel, targets))
    assert not missing, missing
    assert all(os.path.exists(os.path.join(jax_dir, rel)) for rel in RENAMED)


def test_every_port_module_maps_to_the_jax_package():
    """Every module of the port sits at a path of the JAX package, is a
    counterpart in RENAMED, or is listed in PORT_ONLY with what it is."""
    jax_dir = os.path.join(REPO, "platypus_tpu")
    known = set(_tree(jax_dir)) | {t for ts in RENAMED.values() for t in ts}
    unmapped = [rel for rel in _tree(PKG_DIR)
                if rel not in known and rel not in PORT_ONLY]
    assert not unmapped, unmapped
    for rel, what in PORT_ONLY.items():
        assert os.path.exists(os.path.join(PKG_DIR, rel)) and what, rel
        assert rel not in known, rel


def test_every_jax_package_variable_is_read_or_listed():
    """Every PLATYPUS_TPU_* variable of the JAX package is read by the port
    or listed in NOT_PORTED, whose entries the JAX package reads where
    they say and the port does not read."""
    jax_vars = _env_vars(os.path.join(REPO, "platypus_tpu"))
    port_vars = _env_vars(PKG_DIR)
    unported = sorted(set(jax_vars) - set(port_vars) - set(NOT_PORTED))
    assert not unported, unported
    for name, (path, reason) in NOT_PORTED.items():
        assert path in jax_vars.get(name, ()), (name, path)
        assert name not in port_vars, (name, port_vars[name])
        assert reason
    assert "PLATYPUS_TPU_TRACE_DIR" in port_vars
