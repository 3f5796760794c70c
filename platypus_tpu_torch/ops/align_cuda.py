"""The banded-alignment DP kernels (csrc/*.cu) and their wrappers.

K1 (csrc/band_align.cu) is the port of
platypus_tpu/ops/align_pallas.py::band_align_padded_pallas, the main path;
its library has two entries over one DP body: `band_align_pairs`, which
gathers and pads each pair from the deduplicated matrices itself (the
main path's dispatch and the mesh's lane step), and `band_align_padded`,
on gather/pad's column tensors (the graft entry, the mesh's demo step).
K2 (csrc/band_align_tb.cu) is the port of
band_align_traceback_padded_pallas (--calculateFlankScore); its one entry,
`band_align_traceback_pairs`, gathers and pads its pairs as K1's pair
entry does and writes 16-bit label words.  Both pair entries share
csrc/pair_loader.cuh.  A tensor on the CPU goes to the plain torch version
(align_torch); a CUDA tensor launches the hand-written sm_90a kernel or
raises.  Nothing falls back.

The same machinery builds, binds and counts the fused window inference
(csrc/infer_window.cu, KERNELS["infer_window"]), whose wrapper is
ops/likelihood_cuda.py.

Each kernel library is compiled with nvcc into a shared library with a
plain C interface and bound through ctypes.  The build runs at first use,
into platypus_tpu_torch/_build/, keyed by a hash of the source, the
headers it may include (csrc/*.cuh) and the flags, so a fresh checkout
builds it on its first call.  This module imports no CUDA tool: it
imports on a machine without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, NamedTuple

import torch

from ..utils.observability import GLOBAL_METRICS
from .align_torch import (band_align_padded_reference,
                          band_align_pairs_reference,
                          band_align_traceback_pairs_reference)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class Kernel(NamedTuple):
    entries: Dict[str, list]  # C entry points of csrc/<library name>.cu
    replaces: str             # the TPU kernel (or XLA program) it ports


_P, _I = ctypes.c_void_p, ctypes.c_int
KERNELS: Dict[str, Kernel] = {
    "band_align": Kernel({"ptt_band_align_pairs": [_P] * 9 + [_I] * 5 + [_P],
                          "ptt_band_align": [_P] * 6 + [_I] * 4 + [_P]},
                         "platypus_tpu/ops/align_pallas.py:48"),
    "band_align_tb": Kernel({"ptt_band_align_tb_pairs": [_P] * 11 + [_I] * 5
                                                        + [_P]},
                            "platypus_tpu/ops/align_pallas.py:145"),
    "infer_window": Kernel({"ptt_infer_window_batch": [_P] * 16 + [_I] * 6
                                                      + [ctypes.c_float, _I,
                                                         _P]},
                           "platypus_tpu/ops/likelihood_jax.py:310 (an XLA "
                           "program, not a Pallas kernel)"),
}

# GLOBAL_METRICS counts each library's launches under this prefix.
LAUNCH_COUNTER = "launches."

_libs: Dict[str, ctypes.CDLL] = {}


def launches() -> Dict[str, int]:
    """Launches per kernel library since GLOBAL_METRICS' last reset: its
    counters launches.<library>, which _launch counts, and nothing else."""
    counters = GLOBAL_METRICS.counters
    return {name: counters.get(LAUNCH_COUNTER + name, 0) for name in KERNELS}


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
                           "CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """The build of kernel library `name`, keyed by its source, every
    csrc/*.cuh header and the flags: a header edit rebuilds every library."""
    csrc = os.path.dirname(source(name))
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for path in [source(name)] + [os.path.join(csrc, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
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
        for symbol, argtypes in KERNELS[name].entries.items():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
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
    GLOBAL_METRICS.count(LAUNCH_COUNTER + name)


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


def _check_pair_inputs(what, mats, index):
    """uint8 [H, L1B] hap / gap-open and [A, L2] read / quality matrices and
    int32 [B] pair hap / read / segment / read-length rows, contiguous and
    on one device.  Returns (B, L1B, L2)."""
    dev = index[3].device
    hap_shape, seq_shape = tuple(mats[0].shape), tuple(mats[2].shape)
    if len(hap_shape) != 2 or len(seq_shape) != 2 or len(index[3].shape) != 1:
        raise ValueError(f"{what}: the matrices must be 2-d and the pair "
                         "rows 1-d")
    B = index[3].shape[0]
    names = ("hap_mat", "go_mat", "seq_mat", "qual_mat", "pair_hap",
             "pair_read", "pair_seg", "read_len")
    shapes = (hap_shape, hap_shape, seq_shape, seq_shape) + ((B,),) * 4
    dtypes = (torch.uint8,) * 4 + (torch.int32,) * 4
    for name, t, dtype, shape in zip(names, (*mats, *index), dtypes, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {shape} "
                             f"tensor, got {tuple(t.shape)}")
    return B, hap_shape[1], seq_shape[1]


def band_align_pairs(hap_mat: torch.Tensor, go_mat: torch.Tensor,
                     seq_mat: torch.Tensor, qual_mat: torch.Tensor,
                     pair_hap: torch.Tensor, pair_read: torch.Tensor,
                     pair_seg: torch.Tensor, read_len: torch.Tensor,
                     gapextend: int = 3, nucprior: int = 2) -> torch.Tensor:
    """K1's pair entry: the deduplicated uint8 matrices (hap and gap-open
    [H, L1B], read and quality [A, L2]) and int32 [B] pair rows (hap row,
    read row, segment start >= 0, read length <= L2) -> [B] int32 phred,
    each pair gathered and sentinel-padded as align_torch.gather_pad does.
    Launches exactly B pairs.  The kernel does not bound-check the pair
    rows: callers check them on the host before the upload
    (engine/score.check_pair_rows)."""
    mats = (hap_mat, go_mat, seq_mat, qual_mat)
    index = (pair_hap, pair_read, pair_seg, read_len)
    dev = read_len.device
    if dev.type == "cpu":
        return band_align_pairs_reference(*mats, *index, gapextend=gapextend,
                                          nucprior=nucprior)
    if dev.type != "cuda":
        raise ValueError(f"band_align_pairs: unsupported device {dev}")
    B, L1B, L2 = _check_pair_inputs("band_align_pairs", mats, index)
    lib = load("band_align")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    _launch(dev, "band_align", lib.ptt_band_align_pairs,
            *(t.data_ptr() for t in (*mats, *index)), out.data_ptr(), B, L1B,
            L2, int(gapextend), int(nucprior))
    return out


def band_align_traceback_pairs(hap_mat: torch.Tensor, go_mat: torch.Tensor,
                               seq_mat: torch.Tensor, qual_mat: torch.Tensor,
                               pair_hap: torch.Tensor, pair_read: torch.Tensor,
                               pair_seg: torch.Tensor, read_len: torch.Tensor,
                               gapextend: int = 3, nucprior: int = 2):
    """K2's pair entry: traceback mode on the inputs of band_align_pairs ->
    (score [B] int32, exit index [B] int32, label words [(L2+8)*8, B]
    int16); see align_torch.band_align_traceback_pairs_reference.
    Launches exactly B pairs.  The kernel does not bound-check the pair
    rows: callers check them on the host before the upload
    (engine/score.check_pair_rows)."""
    mats = (hap_mat, go_mat, seq_mat, qual_mat)
    index = (pair_hap, pair_read, pair_seg, read_len)
    dev = read_len.device
    if dev.type == "cpu":
        return band_align_traceback_pairs_reference(
            *mats, *index, gapextend=gapextend, nucprior=nucprior)
    if dev.type != "cuda":
        raise ValueError(f"band_align_traceback_pairs: unsupported device {dev}")
    B, L1B, L2 = _check_pair_inputs("band_align_traceback_pairs", mats, index)
    lib = load("band_align_tb")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    bp = torch.empty(((L2 + 8) * 8, B), dtype=torch.int16, device=dev)
    if B == 0:
        return score, idx, bp
    _launch(dev, "band_align_tb", lib.ptt_band_align_tb_pairs,
            *(t.data_ptr() for t in (*mats, *index)), score.data_ptr(),
            idx.data_ptr(), bp.data_ptr(), B, L1B, L2, int(gapextend),
            int(nucprior))
    return score, idx, bp
