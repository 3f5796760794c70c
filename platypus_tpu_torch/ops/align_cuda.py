"""The banded-alignment DP kernel (csrc/band_align.cu) and its wrapper.

`band_align_padded` is the port of
platypus_tpu/ops/align_pallas.py::band_align_padded_pallas.  A tensor on
the CPU goes to the plain torch version
(align_torch.band_align_padded_reference); a CUDA tensor launches the
hand-written sm_90a kernel or raises.  Nothing falls back.

The kernel is compiled with nvcc into a shared library with a plain C
interface and bound through ctypes.  The build runs at first use, into
platypus_tpu_torch/_build/, keyed by a hash of the source, so a fresh
checkout builds it on its first call.  This module imports no CUDA tool:
it imports on a machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from .align_torch import band_align_padded_reference

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "band_align.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches since the last reset (chip_smoke.py reads and resets it).
LAUNCHES = 0

_lib = None
BUILD_LOG = ""  # nvcc's output of the last build (ptxas register report)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the "
                           "band_align CUDA kernel cannot be built")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libband_align_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernel library unless the build for this source exists;
    returns its path.  Raises when nvcc is missing or fails."""
    global BUILD_LOG
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.ptt_band_align.restype = ctypes.c_int
        lib.ptt_band_align.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        _lib = lib
    return _lib


def band_align_padded(hap_cols: torch.Tensor, go4_cols: torch.Tensor,
                      read_cols: torch.Tensor, qual4_cols: torch.Tensor,
                      read_len: torch.Tensor, gapextend: int = 3,
                      nucprior: int = 2) -> torch.Tensor:
    """[L2+16, B] hap / 4*gap-open columns, [L2+8, B] read / 4*qual
    columns and [B] read_len (int32, contiguous) -> [B] int32 phred."""
    global LAUNCHES
    dev = read_cols.device
    if dev.type == "cpu":
        return band_align_padded_reference(hap_cols, go4_cols, read_cols,
                                           qual4_cols, read_len,
                                           gapextend=gapextend,
                                           nucprior=nucprior)
    if dev.type != "cuda":
        raise ValueError(f"band_align_padded: unsupported device {dev}")
    n_steps, B = read_cols.shape
    args = (hap_cols, go4_cols, read_cols, qual4_cols, read_len)
    shapes = ((n_steps + 8, B), (n_steps + 8, B), (n_steps, B), (n_steps, B),
              (B,))
    for name, t, shape in zip(("hap_cols", "go4_cols", "read_cols",
                               "qual4_cols", "read_len"), args, shapes):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"band_align_padded: {name} must be int32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"band_align_padded: {name} must be a contiguous "
                             f"{shape} tensor, got {tuple(t.shape)}")
    lib = load()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ptt_band_align(*(t.data_ptr() for t in args), out.data_ptr(),
                            B, n_steps, int(gapextend), int(nucprior), stream)
    if rc != 0:
        raise RuntimeError(f"band_align kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
