"""The banded-alignment DP kernels (csrc/*.cu) and their wrappers.

`band_align_padded` is the port of
platypus_tpu/ops/align_pallas.py::band_align_padded_pallas (K1, the main
path), `band_align_traceback_padded` that of
band_align_traceback_padded_pallas (K2, --calculateFlankScore).  A tensor
on the CPU goes to the plain torch version (align_torch); a CUDA tensor
launches the hand-written sm_90a kernel or raises.  Nothing falls back.

Each kernel is compiled with nvcc into a shared library with a plain C
interface and bound through ctypes.  The build runs at first use, into
platypus_tpu_torch/_build/, keyed by a hash of the source and flags, so a
fresh checkout builds it on its first call.  This module imports no CUDA
tool: it imports on a machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, NamedTuple

import torch

from .align_torch import (band_align_padded_reference,
                          band_align_traceback_padded_reference)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Kernel(NamedTuple):
    symbol: str       # C entry point of csrc/<library name>.cu
    argtypes: list
    replaces: str     # the TPU kernel it ports


_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS: Dict[str, Kernel] = {
    "band_align": Kernel("ptt_band_align", [_P] * 6 + [_I] * 4 + [_P],
                         "platypus_tpu/ops/align_pallas.py:48"),
    "band_align_tb": Kernel("ptt_band_align_tb", [_P] * 8 + [_I] * 4 + [_P],
                            "platypus_tpu/ops/align_pallas.py:145"),
}

# Launches per kernel library since the last reset (chip_smoke.py reads
# and resets them); a wrapper counts where it launches, and nowhere else.
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str) -> str:
    return os.path.join(_PKG_DIR, "csrc", f"{name}.cu")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the "
                           "band_align CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    with open(source(name), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile a kernel library unless its build for the current source
    exists; returns its path.  Raises when nvcc is missing or fails."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source(name)}:\n{proc.stdout}")
    with open(f"{path}.log", "w") as fh:
        fh.write(proc.stdout)
    os.replace(tmp, path)
    return path


def build_log(name: str) -> str:
    """nvcc's output (the ptxas register and spill report) of the build of
    a kernel library for its current source; empty before the build."""
    path = f"{library_path(name)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """A kernel library, built and bound on first use."""
    if name not in _libs:
        lib = ctypes.CDLL(build(name))
        kernel = KERNELS[name]
        fn = getattr(lib, kernel.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = kernel.argtypes
        _libs[name] = lib
    return _libs[name]


def _check_inputs(what, hap_cols, go4_cols, read_cols, qual4_cols, read_len):
    """int32, contiguous, on the CUDA device of read_cols, in the padded
    shapes: [L2+16, B] hap / 4*gap-open, [L2+8, B] read / 4*qual, [B]."""
    dev = read_cols.device
    n_steps, B = read_cols.shape
    args = (hap_cols, go4_cols, read_cols, qual4_cols, read_len)
    shapes = ((n_steps + 8, B), (n_steps + 8, B), (n_steps, B), (n_steps, B),
              (B,))
    for name, t, shape in zip(("hap_cols", "go4_cols", "read_cols",
                               "qual4_cols", "read_len"), args, shapes):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{shape} tensor, got {tuple(t.shape)}")
    return n_steps, B


def _launch(dev: torch.device, name: str, fn, *args) -> None:
    """Launch a kernel library's entry point on `dev`'s current stream,
    with `dev` the current device: the runtime API of a ctypes call
    launches into the current device's context, which is cuda:0 unless
    something set it.  Raises on a refused launch; counts the launch."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def band_align_padded(hap_cols: torch.Tensor, go4_cols: torch.Tensor,
                      read_cols: torch.Tensor, qual4_cols: torch.Tensor,
                      read_len: torch.Tensor, gapextend: int = 3,
                      nucprior: int = 2) -> torch.Tensor:
    """[L2+16, B] hap / 4*gap-open columns, [L2+8, B] read / 4*qual
    columns and [B] read_len (int32, contiguous) -> [B] int32 phred."""
    dev = read_cols.device
    if dev.type == "cpu":
        return band_align_padded_reference(hap_cols, go4_cols, read_cols,
                                           qual4_cols, read_len,
                                           gapextend=gapextend,
                                           nucprior=nucprior)
    if dev.type != "cuda":
        raise ValueError(f"band_align_padded: unsupported device {dev}")
    args = (hap_cols, go4_cols, read_cols, qual4_cols, read_len)
    n_steps, B = _check_inputs("band_align_padded", *args)
    lib = load("band_align")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    _launch(dev, "band_align", lib.ptt_band_align,
            *(t.data_ptr() for t in args), out.data_ptr(), B, n_steps,
            int(gapextend), int(nucprior))
    return out


def band_align_traceback_padded(hap_cols: torch.Tensor, go4_cols: torch.Tensor,
                                read_cols: torch.Tensor, qual4_cols: torch.Tensor,
                                read_len: torch.Tensor, gapextend: int = 3,
                                nucprior: int = 2):
    """Traceback mode on the inputs of band_align_padded -> (score [B],
    exit index [B], label words [(L2+8)*8, B]), all int32; see
    align_torch.band_align_traceback_padded_reference."""
    dev = read_cols.device
    if dev.type == "cpu":
        return band_align_traceback_padded_reference(
            hap_cols, go4_cols, read_cols, qual4_cols, read_len,
            gapextend=gapextend, nucprior=nucprior)
    if dev.type != "cuda":
        raise ValueError(f"band_align_traceback_padded: unsupported device {dev}")
    args = (hap_cols, go4_cols, read_cols, qual4_cols, read_len)
    n_steps, B = _check_inputs("band_align_traceback_padded", *args)
    lib = load("band_align_tb")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    bp = torch.empty((n_steps * 8, B), dtype=torch.int32, device=dev)
    if B == 0:
        return score, idx, bp
    _launch(dev, "band_align_tb", lib.ptt_band_align_tb,
            *(t.data_ptr() for t in args), score.data_ptr(), idx.data_ptr(),
            bp.data_ptr(), B, n_steps, int(gapextend), int(nucprior))
    return score, idx, bp
