"""ctypes bindings for the port's native host runtime.

The C++ sources under native/src/ build at first use into
platypus_tpu_torch/_build/libplatypus_native_<hash>.so, with the flags of
native/Makefile (-O3 -march=native -ffp-contract=off, -lz -pthread); the
hash covers the sources and the Makefile, so a fresh checkout or an edited
source builds anew.  The build compiles to a temporary name and renames it
into place, so processes that build at once each load a whole library.
PLATYPUS_TPU_TORCH_NATIVE_LIB names a prebuilt library instead.  `load()`
returns None when the library cannot be built, and callers fall back to
the pure Python implementations in platypus_tpu_torch/io/.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_load_lock = threading.Lock()


def _sources():
    src = os.path.join(_DIR, "src")
    return ["Makefile"] + sorted(os.path.join("src", f) for f in os.listdir(src)
                                 if f.endswith((".cpp", ".h")))


def library_path() -> str:
    """Where the library for the current sources is (or will be) built;
    PLATYPUS_TPU_TORCH_NATIVE_LIB overrides it."""
    override = os.environ.get("PLATYPUS_TPU_TORCH_NATIVE_LIB")
    if override:
        return override
    digest = hashlib.sha256()
    for rel in _sources():
        with open(os.path.join(_DIR, rel), "rb") as fh:
            digest.update(rel.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR,
                        f"libplatypus_native_{digest.hexdigest()[:16]}.so")


def build() -> bool:
    """Build the library for the current sources unless it exists: make
    into a temporary file, then an atomic rename."""
    path = library_path()
    if os.path.exists(path):
        return True
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["make", "-C", _DIR, f"LIB={tmp}"], check=True,
                       capture_output=True)
        os.replace(tmp, path)
        return True
    except Exception:  # noqa: BLE001
        with contextlib.suppress(OSError):
            os.remove(tmp)
        return False


def load(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _load_lock:  # a second thread waits for the first one's build
        if _load_attempted:
            return _lib
        path = library_path()
        if not os.path.exists(path) and auto_build:
            build()
        if os.path.exists(path):
            try:
                _lib = _load_and_bind(path)
            except (OSError, AttributeError):
                _lib = None
        if _lib is None:
            import logging

            logging.getLogger("platypus_tpu").warning(
                "Native library %s is unloadable or could not be built; "
                "using the pure-Python fallbacks", path)
        _load_attempted = True
    return _lib


def _load_and_bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)

    lib.ptpu_bam_fetch.restype = ctypes.c_void_p
    lib.ptpu_bam_fetch.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.ptpu_batch_dims.restype = None
    lib.ptpu_batch_dims.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ptpu_batch_fill.restype = None
    lib.ptpu_batch_fill.argtypes = [ctypes.c_void_p] * 14
    lib.ptpu_batch_free.restype = None
    lib.ptpu_batch_free.argtypes = [ctypes.c_void_p]
    lib.ptpu_bam_index.restype = ctypes.c_int32
    lib.ptpu_bam_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ptpu_trim_reads.restype = None
    lib.ptpu_trim_reads.argtypes = (
        [ctypes.c_int64, ctypes.c_int32] + [ctypes.c_void_p] * 7
        + [ctypes.c_int32] * 4
    )
    lib.ptpu_tandem_annotate.restype = None
    lib.ptpu_tandem_annotate.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ptpu_kmer_segments.restype = ctypes.c_int32
    lib.ptpu_kmer_segments.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.ptpu_kmer_segments_multi.restype = ctypes.c_int32
    lib.ptpu_kmer_segments_multi.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.ptpu_kmer_segments_batch.restype = None
    lib.ptpu_kmer_segments_batch.argtypes = (
        [ctypes.c_void_p] * 15 + [ctypes.c_int32] * 2
    )
    lib.ptpu_kmer_segments_strided.restype = ctypes.c_int32
    lib.ptpu_kmer_segments_strided.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.ptpu_scan_indel_walk.restype = ctypes.c_void_p
    lib.ptpu_scan_indel_walk.argtypes = (
        [ctypes.c_void_p, ctypes.c_int32]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_void_p] * 2
        + [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_int32] * 3
        + [ctypes.POINTER(ctypes.c_int64)] * 4
    )
    lib.ptpu_indel_fill.restype = None
    lib.ptpu_indel_fill.argtypes = [ctypes.c_void_p] * 12
    lib.ptpu_indel_free.restype = None
    lib.ptpu_indel_free.argtypes = [ctypes.c_void_p]
    lib.ptpu_scan_m_segments.restype = ctypes.c_void_p
    lib.ptpu_scan_m_segments.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.ptpu_scan_fill.restype = None
    lib.ptpu_scan_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
    lib.ptpu_scan_free.restype = None
    lib.ptpu_scan_free.argtypes = [ctypes.c_void_p]
    lib.ptpu_variant_supported.restype = None
    lib.ptpu_variant_supported.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.ptpu_info_accumulate.restype = None
    lib.ptpu_info_accumulate.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        + [ctypes.c_void_p] * 9
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
        + [ctypes.c_int32] * 5
        + [ctypes.c_void_p] * 6
    )
    lib.ptpu_em_f64.restype = ctypes.c_int32
    lib.ptpu_em_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ptpu_gl_batch.restype = None
    lib.ptpu_gl_batch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int32]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int32]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int32]
    )
    lib.ptpu_infer_batch.restype = None
    lib.ptpu_infer_batch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int32]           # ll/bounds/ngood
        + [ctypes.c_void_p] * 4                            # h1/h2/h_off/G
        + [ctypes.c_void_p] * 3                            # vih/vih_off/V
        + [ctypes.c_void_p, ctypes.c_int32]                # eps, max_iters
        + [ctypes.c_void_p] * 3 + [ctypes.c_int32]         # offs, n_windows
        + [ctypes.c_void_p] * 8 + [ctypes.c_int32]         # outputs, threads
    )
    lib.ptpu_loglik_batch.restype = None
    lib.ptpu_loglik_batch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int32, ctypes.c_double]
        + [ctypes.c_int32] * 2
    )
    lib.ptpu_posteriors_batch.restype = None
    lib.ptpu_posteriors_batch.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_int32] * 2
    )
    lib.ptpu_gap_open.restype = None
    lib.ptpu_gap_open.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.ptpu_em_f64_batch.restype = None
    lib.ptpu_em_f64_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,        # lik_flat, lik_off
        ctypes.c_void_p, ctypes.c_void_p,        # nd_arr, G_arr
        ctypes.c_void_p, ctypes.c_void_p,        # h1_flat, h2_flat
        ctypes.c_void_p, ctypes.c_void_p,        # h_off, H_arr
        ctypes.c_void_p, ctypes.c_int32,         # freq_off, n_windows
        ctypes.c_void_p, ctypes.c_int32,         # eps_arr, max_iters
        ctypes.c_void_p, ctypes.c_void_p,        # freq_out, w_out
        ctypes.c_void_p, ctypes.c_int32,         # iters_out, n_threads
    ]
    lib.ptpu_genotype_call.restype = None
    lib.ptpu_genotype_call.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def native_tandem_annotate(seq: bytes, annotate_all: bool):
    """Per-base (tract length, unit size) via the C++ annotator; None when
    the library is unavailable (callers fall back to the Python oracle)."""
    lib = load()
    if lib is None:
        return None
    n = len(seq)
    sizes = np.ones(n, np.int32)
    disps = np.ones(n, np.int32)
    if n:
        lib.ptpu_tandem_annotate(seq, n, int(annotate_all),
                                 _np_ptr(sizes), _np_ptr(disps))
    return sizes, disps


def _np_ptr(arr: np.ndarray):
    # Plain int address: ctypes converts int -> c_void_p for argtype
    # c_void_p, and skipping the data_as() cast halves the per-call cost
    # (~6us -> ~3us; tens of thousands of native calls per Mb).  Callers
    # hold the array reference for the duration of the call.
    return arr.ctypes.data


_KMER_BUFS: list = [None, None]


def native_kmer_segments(hap_seq: bytes, read_seq: np.ndarray,
                         read_len: np.ndarray, read_start: np.ndarray,
                         hap_start: int):
    """Anchor (read, segment) pairs for one haplotype via the C++ voter;
    None when the library is unavailable (callers fall back to the numpy
    oracle in ops/kmer.py)."""
    lib = load()
    if lib is None:
        return None
    seq = np.ascontiguousarray(read_seq, np.uint8)
    R, L = seq.shape
    rl = np.ascontiguousarray(read_len, np.int32)
    rs = np.ascontiguousarray(read_start, np.int64)
    # Reusable output buffers (called per (window, hap); allocation noise
    # would dominate the ~10us of C work).
    bufs = _KMER_BUFS
    cap = max(16, 8 * R)
    while True:
        if bufs[0] is None or len(bufs[0]) < cap:
            bufs[0] = np.zeros(max(cap, 4096), np.int32)
            bufs[1] = np.zeros(max(cap, 4096), np.int32)
        out_read, out_seg = bufs[0], bufs[1]
        n = lib.ptpu_kmer_segments(
            hap_seq, len(hap_seq), _np_ptr(seq), R, L, _np_ptr(rl), _np_ptr(rs),
            int(hap_start), _np_ptr(out_read), _np_ptr(out_seg), len(out_read),
        )
        if n <= len(out_read):
            return out_read[:n].astype(np.int64), out_seg[:n].astype(np.int64)
        cap = n


def native_kmer_segments_window(hap_seqs, hap_starts, read_seq: np.ndarray,
                                read_len: np.ndarray, read_start: np.ndarray):
    """Anchor (read, segment) pairs for EVERY haplotype of a window in one
    native call (per-hap blocks identical to native_kmer_segments); None
    when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    H = len(hap_seqs)
    flat = b"".join(hap_seqs)
    offs = np.zeros(H + 1, np.int64)
    np.cumsum([len(h) for h in hap_seqs], out=offs[1:])
    starts = np.ascontiguousarray(hap_starts, np.int64)
    seq = np.ascontiguousarray(read_seq, np.uint8)
    R, L = seq.shape
    rl = np.ascontiguousarray(read_len, np.int32)
    rs = np.ascontiguousarray(read_start, np.int64)
    counts = np.zeros(H, np.int32)
    bufs = _KMER_BUFS
    cap = max(16, 8 * R * max(1, H))
    while True:
        if bufs[0] is None or len(bufs[0]) < cap:
            bufs[0] = np.zeros(max(cap, 4096), np.int32)
            bufs[1] = np.zeros(max(cap, 4096), np.int32)
        out_read, out_seg = bufs[0], bufs[1]
        n = lib.ptpu_kmer_segments_multi(
            flat, _np_ptr(offs), _np_ptr(starts), H,
            _np_ptr(seq), R, L, _np_ptr(rl), _np_ptr(rs),
            _np_ptr(out_read), _np_ptr(out_seg), _np_ptr(counts), len(out_read),
        )
        if n <= len(out_read):
            return out_read[:n].astype(np.int64), out_seg[:n].astype(np.int64), counts
        cap = n


def native_kmer_segments_strided(hap_matrix: np.ndarray, hap_len: np.ndarray,
                                 hap_starts: np.ndarray, read_seq: np.ndarray,
                                 read_len: np.ndarray, read_start: np.ndarray):
    """Anchor (read, segment) pairs for every haplotype of a window from the
    ALREADY-PACKED [H, stride] haplotype matrix (per-hap blocks identical
    to native_kmer_segments); None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    H = hap_matrix.shape[0]
    if not read_seq.flags["C_CONTIGUOUS"]:
        read_seq = np.ascontiguousarray(read_seq)
    R, L = read_seq.shape
    counts = np.zeros(H, np.int32)
    bufs = _KMER_BUFS
    cap = max(16, 8 * R * max(1, H))
    while True:
        if bufs[0] is None or len(bufs[0]) < cap:
            bufs[0] = np.zeros(max(cap, 4096), np.int32)
            bufs[1] = np.zeros(max(cap, 4096), np.int32)
        out_read, out_seg = bufs[0], bufs[1]
        n = lib.ptpu_kmer_segments_strided(
            _np_ptr(hap_matrix), hap_matrix.shape[1], _np_ptr(hap_len),
            _np_ptr(hap_starts), H,
            _np_ptr(read_seq), R, L, _np_ptr(read_len), _np_ptr(read_start),
            _np_ptr(out_read), _np_ptr(out_seg), _np_ptr(counts), len(out_read),
        )
        if n <= len(out_read):
            return out_read[:n].astype(np.int64), out_seg[:n].astype(np.int64), counts
        cap = n


def native_kmer_segments_batch(entries, n_threads: int = 0):
    """Every window of a region voted in ONE threaded native call.

    entries: [(hap_matrix [H, stride] u8, hap_len [H] i32, hap_starts [H]
    i64, read_seq [R, L] u8 contiguous, read_len [R] i32, read_start [R]
    i64)].  Returns [(pair_read, pair_seg, counts)] per entry (per-hap
    blocks identical to native_kmer_segments), or None when the library
    is unavailable."""
    lib = load()
    if lib is None or not entries:
        return None
    W = len(entries)
    ptr_cols = np.zeros((10, W), np.uint64)
    strides = np.zeros(W, np.int64)
    H_arr = np.zeros(W, np.int32)
    R_arr = np.zeros(W, np.int32)
    L_arr = np.zeros(W, np.int32)
    caps = np.zeros(W, np.int32)
    totals = np.zeros(W, np.int32)
    keep = []  # keeps output buffers (and any contiguity copies) alive
    for w, (hap_mat, hap_len, hap_starts, seq, rlen, rstart) in enumerate(entries):
        if not seq.flags["C_CONTIGUOUS"]:
            seq = np.ascontiguousarray(seq)
        H = hap_mat.shape[0]
        R, L = seq.shape
        cap = max(16, 8 * R * max(1, H))
        out_read = np.empty(cap, np.int32)
        out_seg = np.empty(cap, np.int32)
        out_counts = np.zeros(H, np.int32)
        keep.append((seq, out_read, out_seg, out_counts))
        ptr_cols[0, w] = hap_mat.ctypes.data
        strides[w] = hap_mat.shape[1]
        ptr_cols[1, w] = hap_len.ctypes.data
        ptr_cols[2, w] = hap_starts.ctypes.data
        H_arr[w] = H
        ptr_cols[3, w] = seq.ctypes.data
        R_arr[w] = R
        L_arr[w] = L
        ptr_cols[4, w] = rlen.ctypes.data
        ptr_cols[5, w] = rstart.ctypes.data
        ptr_cols[6, w] = out_read.ctypes.data
        ptr_cols[7, w] = out_seg.ctypes.data
        ptr_cols[8, w] = out_counts.ctypes.data
        caps[w] = cap
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_kmer_segments_batch(
        _np_ptr(ptr_cols[0]), _np_ptr(strides), _np_ptr(ptr_cols[1]),
        _np_ptr(ptr_cols[2]), _np_ptr(H_arr),
        _np_ptr(ptr_cols[3]), _np_ptr(R_arr), _np_ptr(L_arr),
        _np_ptr(ptr_cols[4]), _np_ptr(ptr_cols[5]),
        _np_ptr(ptr_cols[6]), _np_ptr(ptr_cols[7]), _np_ptr(ptr_cols[8]),
        _np_ptr(caps), _np_ptr(totals), W, n_threads)
    results = []
    for w, (hap_mat, hap_len, hap_starts, seq, rlen, rstart) in enumerate(entries):
        _seq, out_read, out_seg, out_counts = keep[w]
        n = int(totals[w])
        if n > caps[w]:
            # Overflow (rare): redo this window through the growable entry.
            results.append(native_kmer_segments_strided(
                hap_mat, hap_len, hap_starts, _seq, rlen, rstart))
        else:
            results.append((out_read[:n].astype(np.int64),
                            out_seg[:n].astype(np.int64), out_counts))
    return results


def native_bam_index(bam_path: str, bai_path: str) -> bool:
    """Build a standard .bai for a coordinate-sorted BAM via the C++
    streaming pass; False when the library is unavailable or the build
    fails (callers fall back to the Python builder in io/bam.py)."""
    lib = load()
    if lib is None:
        return False
    return lib.ptpu_bam_index(bam_path.encode(), bai_path.encode()) == 0


def native_fetch(bam_path: str, bai_path: str, ref_id: int, start: int, end: int,
                 first_record_voffset: int):
    """Fetch a region into a ReadSet via the native decoder; None if the
    library is unavailable or the fetch fails."""
    lib = load()
    if lib is None:
        return None
    handle = lib.ptpu_bam_fetch(
        bam_path.encode(), bai_path.encode(), ref_id, start, end, first_record_voffset
    )
    if not handle:
        return None
    try:
        n = ctypes.c_int64()
        max_len = ctypes.c_int32()
        n_cigar = ctypes.c_int64()
        lib.ptpu_batch_dims(handle, ctypes.byref(n), ctypes.byref(max_len),
                            ctypes.byref(n_cigar))
        n_reads = n.value
        # Match the Python parser's empty-fetch shape ((0, 0), not (0, 1)).
        L = max(1, max_len.value) if n_reads else 0
        seq = np.zeros((n_reads, L), np.uint8)
        qual = np.zeros((n_reads, L), np.uint8)
        rlen = np.zeros(n_reads, np.int32)
        pos = np.zeros(n_reads, np.int64)
        end_a = np.zeros(n_reads, np.int64)
        mapq = np.zeros(n_reads, np.int32)
        flag = np.zeros(n_reads, np.int32)
        chrom_id = np.zeros(n_reads, np.int32)
        mate_chrom_id = np.zeros(n_reads, np.int32)
        mate_pos = np.zeros(n_reads, np.int64)
        insert_size = np.zeros(n_reads, np.int32)
        cigar_flat = np.zeros(max(1, n_cigar.value), np.uint32)
        cigar_off = np.zeros(n_reads + 1, np.int64)
        if n_reads:
            lib.ptpu_batch_fill(
                handle, _np_ptr(seq), _np_ptr(qual), _np_ptr(rlen), _np_ptr(pos),
                _np_ptr(end_a), _np_ptr(mapq), _np_ptr(flag), _np_ptr(chrom_id),
                _np_ptr(mate_chrom_id), _np_ptr(mate_pos), _np_ptr(insert_size),
                _np_ptr(cigar_flat), _np_ptr(cigar_off),
            )
        from ..io.bam import ReadSet

        return ReadSet(
            seq=seq, qual=qual, rlen=rlen, pos=pos, end=end_a, mapq=mapq,
            flag=flag, chrom_id=chrom_id, mate_chrom_id=mate_chrom_id,
            mate_pos=mate_pos, insert_size=insert_size,
            cigar_flat=cigar_flat[: n_cigar.value], cigar_off=cigar_off,
            qc_fail=np.zeros(n_reads, bool), rg_id=None,
        )
    finally:
        lib.ptpu_batch_free(handle)


def native_scan_indel_reads(read_set, rows: np.ndarray, ref_seq: bytes,
                            ref_start: int, min_flank: int, gen_snps: bool,
                            gen_indels: bool):
    """CIGAR walk of indel/clipped reads via C++: returns
    (candidates [(pos, removed, added, count)], m_segments (4 arrays),
    python_fallback_rows); None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    seq = np.ascontiguousarray(read_set.seq, np.uint8)
    rows64 = np.ascontiguousarray(rows, np.int64)
    pos = np.ascontiguousarray(read_set.pos, np.int64)
    rlen = np.ascontiguousarray(read_set.rlen, np.int32)
    cf = np.ascontiguousarray(read_set.cigar_flat, np.uint32)
    co = np.ascontiguousarray(read_set.cigar_off, np.int64)
    out_n = ctypes.c_int64()
    out_blob = ctypes.c_int64()
    out_msegs = ctypes.c_int64()
    out_py = ctypes.c_int64()
    handle = lib.ptpu_scan_indel_walk(
        _np_ptr(seq), seq.shape[1], _np_ptr(cf), _np_ptr(co),
        _np_ptr(rows64), len(rows64), _np_ptr(pos), _np_ptr(rlen),
        ref_seq, len(ref_seq), ref_start,
        min_flank, int(gen_snps), int(gen_indels),
        ctypes.byref(out_n), ctypes.byref(out_blob),
        ctypes.byref(out_msegs), ctypes.byref(out_py),
    )
    try:
        n, n_m, n_py = out_n.value, out_msegs.value, out_py.value
        vpos = np.zeros(n, np.int64)
        count = np.zeros(n, np.int32)
        n_rem = np.zeros(n, np.int32)
        n_add = np.zeros(n, np.int32)
        blob_off = np.zeros(n + 1, np.int64)
        blob = ctypes.create_string_buffer(max(1, int(out_blob.value)))
        mseg_row = np.zeros(n_m, np.int64)
        mseg_len = np.zeros(n_m, np.int64)
        mseg_roff = np.zeros(n_m, np.int64)
        mseg_goff = np.zeros(n_m, np.int64)
        py_rows = np.zeros(n_py, np.int64)
        lib.ptpu_indel_fill(handle, _np_ptr(vpos), _np_ptr(count),
                            _np_ptr(n_rem), _np_ptr(n_add), _np_ptr(blob_off),
                            blob, _np_ptr(mseg_row), _np_ptr(mseg_len),
                            _np_ptr(mseg_roff), _np_ptr(mseg_goff),
                            _np_ptr(py_rows))
        raw = blob.raw
        cands = [
            (p, raw[o : o + nr], raw[o + nr : o + nr + na], c)
            for p, o, nr, na, c in zip(
                vpos.tolist(), blob_off[:-1].tolist(), n_rem.tolist(),
                n_add.tolist(), count.tolist())
        ]
        return cands, (mseg_row, mseg_len, mseg_roff, mseg_goff), py_rows
    finally:
        lib.ptpu_indel_free(handle)


def native_scan_m_segments(read_set, rows: np.ndarray, mlens: np.ndarray,
                           read_offs, ref_offs,
                           ref_seq: bytes, ref_start: int, min_flank: int,
                           min_base_qual: int):
    """Deduped SNP/MNP candidates from M segments via the C++ scanner;
    None when the library is unavailable (callers fall back to the numpy
    batch / scalar walk in candidates/cigar_gen.py).  Each item is one M
    segment (row id, length, read offset, ref offset) — single-M reads pass
    offsets 0/0.  Returns a list of (pos, removed, added, count)."""
    lib = load()
    if lib is None:
        return None
    seq = np.ascontiguousarray(read_set.seq, np.uint8)
    qual = np.ascontiguousarray(read_set.qual, np.uint8)
    rows64 = np.ascontiguousarray(rows, np.int64)
    mlen64 = np.ascontiguousarray(mlens, np.int64)
    roff64 = np.ascontiguousarray(read_offs, np.int64)
    goff64 = np.ascontiguousarray(ref_offs, np.int64)
    pos = np.ascontiguousarray(read_set.pos, np.int64)
    rlen = np.ascontiguousarray(read_set.rlen, np.int32)
    out_n = ctypes.c_int64()
    out_blob = ctypes.c_int64()
    handle = lib.ptpu_scan_m_segments(
        _np_ptr(seq), _np_ptr(qual), seq.shape[1], _np_ptr(rows64), len(rows64),
        _np_ptr(pos), _np_ptr(rlen), _np_ptr(mlen64), _np_ptr(roff64),
        _np_ptr(goff64),
        ref_seq, len(ref_seq), ref_start, min_flank, min_base_qual,
        ctypes.byref(out_n), ctypes.byref(out_blob),
        min(4, int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0"))
            or (os.cpu_count() or 1)),
    )
    try:
        n = out_n.value
        if n == 0:
            return []
        vpos = np.zeros(n, np.int64)
        count = np.zeros(n, np.int32)
        n_rem = np.zeros(n, np.int32)
        n_add = np.zeros(n, np.int32)
        blob_off = np.zeros(n + 1, np.int64)
        blob = ctypes.create_string_buffer(int(out_blob.value))
        lib.ptpu_scan_fill(handle, _np_ptr(vpos), _np_ptr(count), _np_ptr(n_rem),
                           _np_ptr(n_add), _np_ptr(blob_off), blob)
        raw = blob.raw
        return [
            (p, raw[o : o + nr], raw[o + nr : o + nr + na], c)
            for p, o, nr, na, c in zip(
                vpos.tolist(), blob_off[:-1].tolist(), n_rem.tolist(),
                n_add.tolist(), count.tolist())
        ]
    finally:
        lib.ptpu_scan_free(handle)


def native_variant_supported(cigar_flat: np.ndarray, cigar_off: np.ndarray,
                             win_seq: np.ndarray, win_rlen: np.ndarray,
                             win_pos: np.ndarray, rs_rows: np.ndarray,
                             win_rows: np.ndarray, var_pos: int, added: bytes,
                             n_removed: int, exact: bool):
    """Batched variant_supported_by_read over one CigarRefs segment's rows;
    None when the library is unavailable (callers fall back to the Python
    walk in vcfout/records.py)."""
    lib = load()
    if lib is None:
        return None
    n = len(rs_rows)
    out = np.zeros(n, np.uint8)
    if n:
        # Bind any dtype/contiguity copies to locals: _np_ptr returns a bare
        # address, so a temporary would be freed before the C call runs.
        cf = np.ascontiguousarray(cigar_flat, np.uint32)
        co = np.ascontiguousarray(cigar_off, np.int64)
        rl = np.ascontiguousarray(win_rlen, np.int32)
        wp = np.ascontiguousarray(win_pos, np.int64)
        rr = np.ascontiguousarray(rs_rows, np.int64)
        wr = np.ascontiguousarray(win_rows, np.int64)
        lib.ptpu_variant_supported(
            _np_ptr(cf), _np_ptr(co),
            _np_ptr(win_seq), win_seq.shape[1],
            _np_ptr(rl), _np_ptr(wp), _np_ptr(rr), _np_ptr(wr),
            n, var_pos, added, len(added), n_removed, int(exact), _np_ptr(out),
        )
    return out.astype(bool)


def native_info_context(reads, nsm_idx: np.ndarray, nsm_flat: np.ndarray,
                        nsm_off: np.ndarray):
    """Per-window prepared arrays for native_info_accumulate (keeps the
    contiguous copies + pointer conversions out of the per-variant loop).
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    arrs = (
        reads.seq, reads.qual,
        np.ascontiguousarray(reads.pos, np.int64),
        np.ascontiguousarray(reads.end, np.int64),
        np.ascontiguousarray(reads.rlen, np.int32),
        np.ascontiguousarray(reads.mapq, np.int32),
        np.ascontiguousarray(reads.strand_reverse).view(np.uint8),
        np.ascontiguousarray(reads.single_m()).view(np.uint8),
        nsm_idx, nsm_flat, nsm_off,
    )
    ptrs = tuple(_np_ptr(a) for a in arrs)
    return (lib, arrs, ptrs, reads.seq.shape[1])


def native_info_accumulate(ctx, good_rows: np.ndarray, bad_rows: np.ndarray,
                           var_min: int, var_max: int, var_pos: int,
                           added: bytes, n_removed: int, exact: bool,
                           var_in_genotype: bool, bad_reads_window: int):
    """One (variant, individual) INFO accounting pass in C++ over a
    native_info_context.  Returns (counters[13] int64, rmsmq float,
    min_quals, alt_dists, ref_dists)."""
    lib, arrs, p, L = ctx
    cap = max(1, len(good_rows))
    counters = np.zeros(13, np.int64)
    rmsmq = ctypes.c_double()
    min_quals = np.zeros(cap, np.int32)
    alt_dists = np.zeros(cap, np.int32)
    ref_dists = np.zeros(cap, np.int32)
    out_counts = np.zeros(3, np.int64)
    good64 = np.ascontiguousarray(good_rows, np.int64)
    bad64 = np.ascontiguousarray(bad_rows, np.int64)
    lib.ptpu_info_accumulate(
        p[0], p[1], L, p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10],
        _np_ptr(good64), len(good64), _np_ptr(bad64), len(bad64),
        var_min, var_max, var_pos, added, len(added), n_removed, int(exact),
        int(var_in_genotype), bad_reads_window,
        _np_ptr(counters), ctypes.byref(rmsmq), _np_ptr(min_quals),
        _np_ptr(alt_dists), _np_ptr(ref_dists), _np_ptr(out_counts),
    )
    n_minq, n_alt, n_ref = out_counts.tolist()
    return (counters, rmsmq.value, min_quals[:n_minq].tolist(),
            alt_dists[:n_alt].tolist(), ref_dists[:n_ref].tolist())


def native_trim_reads(reads, good_mask: np.ndarray, trim_read_flank: int,
                      trim_overlapping: int, trim_adapter: int,
                      trim_soft_clipped: int) -> bool:
    """In-place QC trimming over a ReadSet; False if unavailable."""
    lib = load()
    if lib is None:
        return False
    n = len(reads)
    if n == 0:
        return True
    gm = np.ascontiguousarray(good_mask.astype(np.uint8))
    # Bind contiguity copies to locals: _np_ptr returns a bare address, so a
    # temporary would be freed before the C call runs.
    rl = np.ascontiguousarray(reads.rlen)
    fl = np.ascontiguousarray(reads.flag)
    ins = np.ascontiguousarray(reads.insert_size)
    cf = np.ascontiguousarray(reads.cigar_flat)
    co = np.ascontiguousarray(reads.cigar_off)
    lib.ptpu_trim_reads(
        ctypes.c_int64(n), ctypes.c_int32(reads.seq.shape[1]), _np_ptr(reads.qual),
        _np_ptr(rl), _np_ptr(fl), _np_ptr(ins), _np_ptr(cf), _np_ptr(co),
        _np_ptr(gm),
        ctypes.c_int32(trim_read_flank), ctypes.c_int32(trim_overlapping),
        ctypes.c_int32(trim_adapter), ctypes.c_int32(trim_soft_clipped),
    )
    return True


# ---------------------------------------------------------------------------
# Assembler bindings
# ---------------------------------------------------------------------------

def _setup_align(lib) -> bool:
    """Bind the alignment-kernel symbols; False when the loaded library
    predates them (stale .so) so callers fall back to the device path."""
    if getattr(lib, "_align_setup", None) is not None:
        return lib._align_setup
    try:
        fn = lib.ptpu_band_align_pairs
    except AttributeError:
        lib._align_setup = False
        return False
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib._align_setup = True
    return True


def native_band_align_pairs(hap_mat: np.ndarray, go_mat: np.ndarray,
                            seq_mat: np.ndarray, qual_mat: np.ndarray,
                            pair_hap: np.ndarray, pair_read: np.ndarray,
                            pair_seg: np.ndarray, rlen: np.ndarray,
                            gapextend: int, nucprior: int,
                            n_threads: int) -> Optional[np.ndarray]:
    """Score every (hap row, read row, segment) pair with the C++ banded
    kernel (bit-identical to ops/align_core.band_align_single).  Returns
    int64 [n_pairs] scores, or None when the native lib is absent or
    predates the kernel."""
    lib = load()
    if lib is None or not _setup_align(lib):
        return None
    hap_mat = np.ascontiguousarray(hap_mat, np.uint8)
    go_mat = np.ascontiguousarray(go_mat, np.uint8)
    seq_mat = np.ascontiguousarray(seq_mat, np.uint8)
    qual_mat = np.ascontiguousarray(qual_mat, np.uint8)
    ph = np.ascontiguousarray(pair_hap, np.int64)
    pr = np.ascontiguousarray(pair_read, np.int64)
    ps = np.ascontiguousarray(pair_seg, np.int64)
    rl = np.ascontiguousarray(rlen, np.int32)
    out = np.zeros(len(ph), np.int64)
    lib.ptpu_band_align_pairs(
        _np_ptr(hap_mat), _np_ptr(go_mat), hap_mat.shape[1],
        _np_ptr(seq_mat), _np_ptr(qual_mat), seq_mat.shape[1],
        _np_ptr(ph), _np_ptr(pr), _np_ptr(ps), _np_ptr(rl),
        len(ph), gapextend, nucprior, n_threads, _np_ptr(out),
    )
    return out


def _setup_asm(lib) -> None:
    if getattr(lib, "_asm_setup", False):
        return
    lib.ptpu_asm_create.restype = ctypes.c_void_p
    lib.ptpu_asm_create.argtypes = [ctypes.c_int]
    lib.ptpu_asm_free.argtypes = [ctypes.c_void_p]
    lib.ptpu_asm_load_reference.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.ptpu_asm_load_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ptpu_asm_detect_cycles.restype = ctypes.c_int32
    lib.ptpu_asm_detect_cycles.argtypes = [ctypes.c_void_p]
    lib.ptpu_asm_find_bubbles.restype = ctypes.c_int64
    lib.ptpu_asm_find_bubbles.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.ptpu_asm_packed_size.restype = ctypes.c_int64
    lib.ptpu_asm_packed_size.argtypes = [ctypes.c_void_p]
    lib.ptpu_asm_load_reads.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.ptpu_asm_results.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib._asm_setup = True


def _setup_asm_region(lib) -> bool:
    """Bind the one-call region symbols; False on a stale .so that
    predates them (callers fall back to the per-tile path)."""
    if getattr(lib, "_asm_region_setup", None) is not None:
        return lib._asm_region_setup
    try:
        region_fn = lib.ptpu_asm_region
    except AttributeError:
        lib._asm_region_setup = False
        return False
    region_fn.restype = ctypes.c_void_p
    region_fn.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.ptpu_asm_region_packed_size.restype = ctypes.c_int64
    lib.ptpu_asm_region_packed_size.argtypes = [ctypes.c_void_p]
    lib.ptpu_asm_region_results.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ptpu_asm_region_free.argtypes = [ctypes.c_void_p]
    lib._asm_region_setup = True
    return True


def native_assemble_region(tiles, piles, kmer_size: int, min_qual: int,
                           min_weight: float, no_cycles: int, n_threads: int,
                           region_ref: bytes, slices: np.ndarray):
    """Run the whole assembly tile loop in one native call.

    tiles: list of (assem_start, assem_end, ref_start_coord, ref_off, ref_len)
    piles: list of ReadSet-like objects (seq [N,L] u8, qual [N,L] u8,
           rlen i32-able, qc_fail bool [N])
    slices: int64 [n_tiles, n_piles, 2] row bounds per (tile, pile)
    Returns a list of per-tile lists of (pos, removed, added), in tile order
    (discovery order within a tile), or None when the native lib is absent
    or predates the region entry (stale .so).
    """
    lib = load()
    if lib is None or not _setup_asm_region(lib):
        return None
    n_tiles = len(tiles)
    n_piles = len(piles)
    ta = np.asarray([t[0] for t in tiles], np.int64)
    tb = np.asarray([t[1] for t in tiles], np.int64)
    trs = np.asarray([t[2] for t in tiles], np.int64)
    toff = np.asarray([t[3] for t in tiles], np.int64)
    tlen = np.asarray([t[4] for t in tiles], np.int64)
    keep = []  # pin array lifetimes across the call
    seq_ptrs = np.zeros(n_piles, np.uint64)
    qual_ptrs = np.zeros(n_piles, np.uint64)
    strides = np.zeros(n_piles, np.int64)
    rlen_ptrs = np.zeros(n_piles, np.uint64)
    qc_ptrs = np.zeros(n_piles, np.uint64)
    for p, rs in enumerate(piles):
        seq = np.ascontiguousarray(rs.seq)
        qual = np.ascontiguousarray(rs.qual)
        rlen = np.ascontiguousarray(rs.rlen, dtype=np.int32)
        qc = np.ascontiguousarray(rs.qc_fail, dtype=np.uint8)
        keep.extend((seq, qual, rlen, qc))
        seq_ptrs[p] = seq.ctypes.data
        qual_ptrs[p] = qual.ctypes.data
        strides[p] = seq.shape[1] if seq.ndim == 2 else 0
        rlen_ptrs[p] = rlen.ctypes.data
        qc_ptrs[p] = qc.ctypes.data
    slices = np.ascontiguousarray(slices, dtype=np.int64)
    counts = np.zeros(n_tiles, np.int64)
    h = lib.ptpu_asm_region(
        kmer_size, min_qual, ctypes.c_double(min_weight), no_cycles,
        n_threads, region_ref, n_tiles,
        _np_ptr(ta), _np_ptr(tb), _np_ptr(trs), _np_ptr(toff), _np_ptr(tlen),
        n_piles, _np_ptr(seq_ptrs), _np_ptr(qual_ptrs), _np_ptr(strides),
        _np_ptr(rlen_ptrs), _np_ptr(qc_ptrs), _np_ptr(slices), _np_ptr(counts),
    )
    del keep
    try:
        total = int(counts.sum())
        out = [[] for _ in range(n_tiles)]
        if total:
            packed_size = lib.ptpu_asm_region_packed_size(h)
            pos = np.zeros(total, np.int64)
            offsets = np.zeros(total + 1, np.int64)
            packed = ctypes.create_string_buffer(int(packed_size))
            lib.ptpu_asm_region_results(h, _np_ptr(pos), _np_ptr(offsets), packed)
            raw = packed.raw
            i = 0
            for t in range(n_tiles):
                for _ in range(int(counts[t])):
                    blob = raw[offsets[i] : offsets[i + 1]]
                    removed, added = blob.split(b"\x00")[:2]
                    out[t].append((int(pos[i]), removed, added))
                    i += 1
        return out
    finally:
        lib.ptpu_asm_region_free(h)


class NativeAssembler:
    """ctypes wrapper over the C++ colored de Bruijn graph; None-able via
    NativeAssembler.available()."""

    @staticmethod
    def available() -> bool:
        return load() is not None

    def __init__(self, kmer_size: int):
        self._lib = load()
        _setup_asm(self._lib)
        self._h = self._lib.ptpu_asm_create(kmer_size)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ptpu_asm_free(self._h)
            self._h = None

    def load_reference(self, ref_seq: bytes, ref_start: int) -> None:
        self._lib.ptpu_asm_load_reference(self._h, ref_seq, len(ref_seq), ref_start)

    def load_reads_batch(self, read_set, rows: np.ndarray, min_qual: int) -> None:
        """Load many reads from a ReadSet's SoA arrays in one C call."""
        if len(rows) == 0:
            return
        seq = np.ascontiguousarray(read_set.seq)
        qual = np.ascontiguousarray(read_set.qual)
        rlen = np.ascontiguousarray(read_set.rlen, dtype=np.int32)
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        self._lib.ptpu_asm_load_reads(
            self._h, _np_ptr(seq), _np_ptr(qual), seq.shape[1], _np_ptr(rlen),
            _np_ptr(rows), len(rows), min_qual,
        )

    def load_read(self, seq: np.ndarray, qual: np.ndarray, rlen: int,
                  min_qual: int) -> None:
        s = np.ascontiguousarray(seq[:rlen], np.uint8)
        q = np.ascontiguousarray(qual[:rlen], np.uint8)
        self._lib.ptpu_asm_load_read(self._h, _np_ptr(s), _np_ptr(q), rlen, min_qual)

    def detect_cycles(self) -> bool:
        return bool(self._lib.ptpu_asm_detect_cycles(self._h))

    def find_bubbles(self, min_weight: float, ref_seq: bytes, ref_start: int,
                     assem_start: int, assem_end: int):
        n = self._lib.ptpu_asm_find_bubbles(
            self._h, ctypes.c_double(min_weight), ref_seq, len(ref_seq),
            ref_start, assem_start, assem_end,
        )
        if n == 0:
            return []
        packed_size = self._lib.ptpu_asm_packed_size(self._h)
        pos = np.zeros(n, np.int64)
        offsets = np.zeros(n + 1, np.int64)
        packed = ctypes.create_string_buffer(int(packed_size))
        self._lib.ptpu_asm_results(self._h, _np_ptr(pos), _np_ptr(offsets), packed)
        raw = packed.raw
        out = []
        for i in range(n):
            blob = raw[offsets[i] : offsets[i + 1]]
            removed, added = blob.split(b"\x00")[:2]
            out.append((int(pos[i]), removed, added))
        return out


# ---------------------------------------------------------------------------
# Haplotype-frequency EM (src/em.cpp) — bit-exact twin of the numpy oracle
# ---------------------------------------------------------------------------

_EM_VERIFIED: Optional[bool] = None


def _verify_native_em(lib) -> bool:
    """One-time battery: the C++ EM must match the numpy oracle BITWISE
    over randomized shapes (including G > 128 pairwise-summation blocks and
    multi-sample outer-axis reductions).  Any mismatch disables the native
    path for the process — numpy remains the authority."""
    from ..ops.likelihood import em_haplotype_frequencies, genotype_index_pairs

    rng = np.random.default_rng(20260819)
    for trial in range(24):
        H = int(rng.integers(2, 20)) if trial % 3 else int(rng.integers(2, 5))
        h1, h2 = genotype_index_pairs(H)
        G = len(h1)
        I = int(rng.integers(1, 14))
        lik = np.maximum(1e-12, rng.random((I, G)))
        lik[rng.random((I, G)) < 0.2] = 1e-300
        n_reads = rng.integers(0, 40, I)
        want = em_haplotype_frequencies(lik, h1, h2, H, n_reads,
                                        max_iters=100, _allow_native=False)
        got = native_em(lik, h1, h2, H, n_reads, 100, lib=lib)
        if got is None:
            return False
        for a, b in zip(want[:2], got[:2]):
            if a.shape != b.shape or not np.array_equal(
                    a.view(np.uint64), b.view(np.uint64)):
                return False
        if want[2] != got[2]:
            return False
    return True


def native_genotype_call(lik_row: np.ndarray, freqs: np.ndarray,
                         h1: np.ndarray, h2: np.ndarray,
                         hap_is_ref: np.ndarray, var_in_hap: np.ndarray,
                         gof: np.ndarray, gof_off: int,
                         n_individuals: int):
    """Per-sample genotype call + marginal class likelihoods via C++
    (genotype.cpp); None when the library is unavailable.  Bit-exactness
    vs the Python oracle is verified at first use by the dispatcher in
    vcfout/records.py.

    Returns (lik_out [n_classes] f64, phased [2] i32, scalars [5] f64 =
    best_likelihood, non_ref_post, ref_post, sum_lik, best_gof)."""
    lib = load()
    if lib is None:
        return None
    G = len(h1)
    n_vars = var_in_hap.shape[1]
    n_classes = (n_vars + 1) * (n_vars + 2) // 2
    lik_out = np.empty(n_classes, np.float64)
    phased = np.empty(2, np.int32)
    scalars = np.empty(5, np.float64)
    # All inputs are built contiguous with these dtypes by the caller; the
    # conversions below are no-ops then (and correctness guards otherwise).
    lr = np.ascontiguousarray(lik_row, np.float64)
    fq = np.ascontiguousarray(freqs, np.float64)
    h1c = np.ascontiguousarray(h1, np.int64)
    h2c = np.ascontiguousarray(h2, np.int64)
    hr = np.ascontiguousarray(hap_is_ref, np.int64)
    vih = np.ascontiguousarray(var_in_hap).view(np.uint8)
    gf = np.ascontiguousarray(gof, np.float64)
    # .ctypes.data inlined (= _np_ptr): ~10 pointer fetches per emitted
    # record make the extra frame visible.
    lib.ptpu_genotype_call(
        lr.ctypes.data, fq.ctypes.data, h1c.ctypes.data, h2c.ctypes.data, G,
        hr.ctypes.data, vih.ctypes.data, n_vars,
        gf.ctypes.data, gf.shape[1], gof_off, n_individuals,
        lik_out.ctypes.data, phased.ctypes.data, scalars.ctypes.data)
    return lik_out, phased, scalars


def native_em(likelihoods: np.ndarray, h1: np.ndarray, h2: np.ndarray,
              n_haps: int, n_reads: np.ndarray, max_iters: int = 100,
              lib=None):
    """EM frequencies + responsibilities via C++; None when the library is
    unavailable or failed its bit-exactness self-check (callers fall back
    to the numpy oracle in ops/likelihood.py)."""
    global _EM_VERIFIED
    if lib is None:
        if os.environ.get("PLATYPUS_TPU_NATIVE_EM", "1") == "0":
            return None
        lib = load()
        if lib is None:
            return None
        if _EM_VERIFIED is None:
            _EM_VERIFIED = _verify_native_em(lib)
            if not _EM_VERIFIED:
                import logging

                logging.getLogger("platypus_tpu").warning(
                    "native EM failed the bit-exactness self-check; "
                    "using the numpy oracle")
        if not _EM_VERIFIED:
            return None
    I, G = likelihoods.shape
    has_data = n_reads > 0
    nd = int(has_data.sum())
    csr = np.zeros_like(likelihoods)
    if nd == 0:
        return np.full(n_haps, 1.0 / n_haps), csr, 0
    lik = np.ascontiguousarray(likelihoods[has_data], np.float64)
    h1c = np.ascontiguousarray(h1, np.int64)
    h2c = np.ascontiguousarray(h2, np.int64)
    eps = min(1e-3, 1.0 / (I * 4))
    freq = np.empty(n_haps, np.float64)
    w = np.empty((nd, G), np.float64)
    iters = lib.ptpu_em_f64(_np_ptr(lik), nd, G, _np_ptr(h1c), _np_ptr(h2c),
                            n_haps, eps, max_iters, _np_ptr(freq), _np_ptr(w))
    if iters < 0:
        return None
    csr[has_data] = w
    return freq, csr, int(iters)


def native_gl_batch(entries, n_threads: int = 0):
    """Genotype log-likelihoods + GOF sums + rescaled likelihoods for MANY
    windows in one threaded native call, replicating the reference's
    SEQUENTIAL per-read accumulation (cgenotype.pyx:131-189) — the byte
    contract the numpy pairwise twin misses on near-symmetric windows.

    entries: [(loglik [H, R] f64 C-contig, bounds [I+1] i64,
               n_good [I] i64, h1, h2)] with one shared I.
    Returns [(gl [I, G], gof_sum [I, G], lik [I, G])] or None when the
    library is unavailable."""
    if os.environ.get("PLATYPUS_TPU_NATIVE_GL", "1") == "0":
        return None
    lib = load()
    if lib is None or not entries:
        return None
    W = len(entries)
    I = len(entries[0][2])
    H_arr = np.empty(W, np.int32)
    R_arr = np.empty(W, np.int32)
    G_arr = np.empty(W, np.int32)
    ll_off = np.zeros(W + 1, np.int64)
    out_off = np.zeros(W + 1, np.int64)
    bounds_flat = np.empty(W * (I + 1), np.int64)
    n_good_flat = np.empty(W * I, np.int64)
    h_tables: dict = {}
    blocks1, blocks2 = [], []
    h_off = np.empty(W, np.int64)
    pos = 0
    lls = []
    for k, (ll, bounds, n_good, h1, h2) in enumerate(entries):
        H, R = ll.shape
        G = len(h1)
        H_arr[k], R_arr[k], G_arr[k] = H, R, G
        ll_off[k + 1] = ll_off[k] + H * R
        out_off[k + 1] = out_off[k] + I * G
        bounds_flat[k * (I + 1) : (k + 1) * (I + 1)] = bounds
        n_good_flat[k * I : (k + 1) * I] = n_good
        lls.append(np.ascontiguousarray(ll, np.float64).ravel())
        if H not in h_tables:
            h_tables[H] = pos
            blocks1.append(np.ascontiguousarray(h1, np.int64))
            blocks2.append(np.ascontiguousarray(h2, np.int64))
            pos += len(h1)
        h_off[k] = h_tables[H]
    ll_flat = np.concatenate(lls) if lls else np.zeros(1, np.float64)
    if len(ll_flat) == 0:
        ll_flat = np.zeros(1, np.float64)
    h1_flat = np.concatenate(blocks1)
    h2_flat = np.concatenate(blocks2)
    total = max(1, int(out_off[-1]))
    gl_out = np.empty(total, np.float64)
    gof_out = np.empty(total, np.float64)
    lik_out = np.empty(total, np.float64)
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_gl_batch(
        _np_ptr(ll_flat), _np_ptr(ll_off), _np_ptr(H_arr), _np_ptr(R_arr),
        _np_ptr(bounds_flat), _np_ptr(n_good_flat), I,
        _np_ptr(h1_flat), _np_ptr(h2_flat), _np_ptr(h_off), _np_ptr(G_arr),
        _np_ptr(out_off), W,
        _np_ptr(gl_out), _np_ptr(gof_out), _np_ptr(lik_out), n_threads)
    out = []
    for k in range(W):
        G = int(G_arr[k])
        sl = slice(int(out_off[k]), int(out_off[k + 1]))
        out.append((gl_out[sl].reshape(I, G), gof_out[sl].reshape(I, G),
                    lik_out[sl].reshape(I, G)))
    return out


def native_infer_batch(entries, max_iters: int = 100, n_threads: int = 0):
    """Fused GL -> GOF -> rescale -> argmax -> EM -> posterior pass for
    MANY windows in one threaded native call (ptpu_infer_batch; each
    stage is the verified single-window kernel, so results match the
    separate stage batches bit-for-bit).

    entries: [(loglik [H, R] f64, bounds [I+1] i64, n_good [I] i64,
               h1, h2, vih [V, H] u8)] with one shared I.
    Returns [(gl [I, G], gof_div [G, I], lik [I, G], freq [H],
              csr [I, G], iters, argmax [I], ratios [V])] or None."""
    if os.environ.get("PLATYPUS_TPU_NATIVE_INFER", "1") == "0":
        return None
    lib = load()
    if lib is None or not entries:
        return None
    global _EM_VERIFIED
    if _EM_VERIFIED is None:
        _EM_VERIFIED = _verify_native_em(lib)
    if not _EM_VERIFIED:
        return None
    W = len(entries)
    I = len(entries[0][2])
    H_arr = np.empty(W, np.int32)
    R_arr = np.empty(W, np.int32)
    G_arr = np.empty(W, np.int32)
    V_arr = np.empty(W, np.int32)
    ll_off = np.zeros(W + 1, np.int64)
    out_off = np.zeros(W + 1, np.int64)
    freq_off = np.zeros(W + 1, np.int64)
    ratio_off = np.zeros(W + 1, np.int64)
    vih_off = np.zeros(W + 1, np.int64)
    bounds_flat = np.empty(W * (I + 1), np.int64)
    n_good_flat = np.empty(W * I, np.int64)
    eps_arr = np.full(W, min(1e-3, 1.0 / (I * 4)), np.float64)
    h_tables: dict = {}
    blocks1, blocks2 = [], []
    h_off = np.empty(W, np.int64)
    pos = 0
    lls, vihs = [], []
    for k, (ll, bounds, n_good, h1, h2, vih) in enumerate(entries):
        H, R = ll.shape
        G = len(h1)
        V = vih.shape[0]
        H_arr[k], R_arr[k], G_arr[k], V_arr[k] = H, R, G, V
        ll_off[k + 1] = ll_off[k] + H * R
        out_off[k + 1] = out_off[k] + I * G
        freq_off[k + 1] = freq_off[k] + H
        ratio_off[k + 1] = ratio_off[k] + V
        vih_off[k + 1] = vih_off[k] + V * H
        bounds_flat[k * (I + 1) : (k + 1) * (I + 1)] = bounds
        n_good_flat[k * I : (k + 1) * I] = n_good
        lls.append(np.ascontiguousarray(ll, np.float64).ravel())
        vihs.append(np.ascontiguousarray(vih, np.uint8).ravel())
        if H not in h_tables:
            h_tables[H] = pos
            blocks1.append(np.ascontiguousarray(h1, np.int64))
            blocks2.append(np.ascontiguousarray(h2, np.int64))
            pos += len(h1)
        h_off[k] = h_tables[H]
    ll_flat = np.concatenate(lls) if lls else np.zeros(1, np.float64)
    if len(ll_flat) == 0:
        ll_flat = np.zeros(1, np.float64)
    vih_flat = np.concatenate(vihs) if vihs else np.zeros(1, np.uint8)
    if len(vih_flat) == 0:
        vih_flat = np.zeros(1, np.uint8)
    h1_flat = np.concatenate(blocks1)
    h2_flat = np.concatenate(blocks2)
    total = max(1, int(out_off[-1]))
    gl_out = np.empty(total, np.float64)
    gof_out = np.empty(total, np.float64)
    lik_out = np.empty(total, np.float64)
    csr_out = np.empty(total, np.float64)
    freq_out = np.empty(max(1, int(freq_off[-1])), np.float64)
    iters_out = np.empty(W, np.int32)
    argmax_out = np.empty(W * I, np.int32)
    ratios_out = np.empty(max(1, int(ratio_off[-1])), np.float64)
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_infer_batch(
        _np_ptr(ll_flat), _np_ptr(ll_off), _np_ptr(H_arr), _np_ptr(R_arr),
        _np_ptr(bounds_flat), _np_ptr(n_good_flat), I,
        _np_ptr(h1_flat), _np_ptr(h2_flat), _np_ptr(h_off), _np_ptr(G_arr),
        _np_ptr(vih_flat), _np_ptr(vih_off), _np_ptr(V_arr),
        _np_ptr(eps_arr), max_iters,
        _np_ptr(out_off), _np_ptr(freq_off), _np_ptr(ratio_off), W,
        _np_ptr(gl_out), _np_ptr(gof_out), _np_ptr(lik_out),
        _np_ptr(freq_out), _np_ptr(csr_out), _np_ptr(iters_out),
        _np_ptr(argmax_out), _np_ptr(ratios_out), n_threads)
    out = []
    for k in range(W):
        G = int(G_arr[k])
        H = int(H_arr[k])
        V = int(V_arr[k])
        sl = slice(int(out_off[k]), int(out_off[k + 1]))
        out.append((
            gl_out[sl].reshape(I, G),
            gof_out[sl].reshape(G, I),
            lik_out[sl].reshape(I, G),
            freq_out[freq_off[k] : freq_off[k] + H].copy(),
            csr_out[sl].reshape(I, G),
            int(iters_out[k]),
            argmax_out[k * I : (k + 1) * I],
            ratios_out[ratio_off[k] : ratio_off[k + 1]],
        ))
    return out


def native_loglik_batch(entries, hash_nucs: int, mltot: float,
                        n_threads: int = 0):
    """Pair scores -> [H, R] log-likelihood matrices for MANY windows in
    one threaded native call (engine/score.py::window_loglik_from_pair_
    scores semantics; the caller precomputes the per-read mapq term with
    the same numpy ops as the fallback, so the C side is exact).

    entries: [(pair_scores [P] i64, pair_hap [P] i64, pair_read [P] i64,
               sub_len [A] i32, term [A] f64, align_rows [A] i64, H, R)]
    Returns [loglik [H, R] f64] or None when the library is unavailable."""
    if os.environ.get("PLATYPUS_TPU_NATIVE_LOGLIK", "1") == "0":
        return None
    lib = load()
    if lib is None or not entries:
        return None
    W = len(entries)
    ptrs = np.zeros((7, W), np.uint64)
    P_arr = np.empty(W, np.int32)
    A_arr = np.empty(W, np.int32)
    H_arr = np.empty(W, np.int32)
    R_arr = np.empty(W, np.int32)
    keep = []
    outs = []
    for w, (ps, ph, pr, sub_len, term, rows, H, R) in enumerate(entries):
        ps = np.ascontiguousarray(ps, np.int64)
        ph = np.ascontiguousarray(ph, np.int64)
        pr = np.ascontiguousarray(pr, np.int64)
        sl = np.ascontiguousarray(sub_len, np.int32)
        tm = np.ascontiguousarray(term, np.float64)
        rw = np.ascontiguousarray(rows, np.int64)
        out = np.empty((H, R), np.float64)
        keep.append((ps, ph, pr, sl, tm, rw))
        outs.append(out)
        ptrs[0, w] = ps.ctypes.data
        ptrs[1, w] = ph.ctypes.data
        ptrs[2, w] = pr.ctypes.data
        ptrs[3, w] = sl.ctypes.data
        ptrs[4, w] = tm.ctypes.data
        ptrs[5, w] = rw.ctypes.data
        ptrs[6, w] = out.ctypes.data
        P_arr[w] = len(ps)
        A_arr[w] = len(sl)
        H_arr[w] = H
        R_arr[w] = R
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_loglik_batch(
        _np_ptr(ptrs[0]), _np_ptr(ptrs[1]), _np_ptr(ptrs[2]),
        _np_ptr(ptrs[3]), _np_ptr(ptrs[4]), _np_ptr(ptrs[5]),
        _np_ptr(ptrs[6]),
        _np_ptr(P_arr), _np_ptr(A_arr), _np_ptr(H_arr), _np_ptr(R_arr),
        hash_nucs, mltot, W, n_threads)
    return outs


def native_posteriors_batch(entries, n_threads: int = 0):
    """Variant-posterior log-ratios for MANY windows in one threaded native
    call (ptpu_posteriors_batch; sequential per-genotype dots — the
    reference's own summation order).

    entries: [(likelihoods [I, G] f64, freq [H] f64, h1, h2,
               rows [n_rows] int64, var_in_hap [V, H] uint8)]
    Returns [ratios [V] f64] aligned with entries, or None when the
    library is unavailable."""
    if os.environ.get("PLATYPUS_TPU_NATIVE_POSTERIOR", "1") == "0":
        return None
    lib = load()
    if lib is None:
        return None
    W = len(entries)
    I_arr = np.empty(W, np.int32)
    G_arr = np.empty(W, np.int32)
    H_arr = np.empty(W, np.int32)
    V_arr = np.empty(W, np.int32)
    lik_off = np.zeros(W + 1, np.int64)
    freq_off = np.zeros(W + 1, np.int64)
    rows_off = np.zeros(W + 1, np.int64)
    vih_off = np.zeros(W + 1, np.int64)
    ratio_off = np.zeros(W + 1, np.int64)
    h_tables: dict = {}
    blocks1, blocks2 = [], []
    h_off = np.empty(W, np.int64)
    pos = 0
    liks, freqs, rows_parts, vihs = [], [], [], []
    for k, (lik, freq, h1, h2, rows, vih) in enumerate(entries):
        I, G = lik.shape
        H = len(freq)
        V = vih.shape[0]
        I_arr[k], G_arr[k], H_arr[k], V_arr[k] = I, G, H, V
        lik_off[k + 1] = lik_off[k] + I * G
        freq_off[k + 1] = freq_off[k] + H
        rows_off[k + 1] = rows_off[k] + len(rows)
        vih_off[k + 1] = vih_off[k] + V * H
        ratio_off[k + 1] = ratio_off[k] + V
        liks.append(np.ascontiguousarray(lik, np.float64).ravel())
        freqs.append(np.ascontiguousarray(freq, np.float64))
        rows_parts.append(np.ascontiguousarray(rows, np.int64))
        vihs.append(np.ascontiguousarray(vih, np.uint8).ravel())
        if H not in h_tables:
            h_tables[H] = pos
            blocks1.append(np.ascontiguousarray(h1, np.int64))
            blocks2.append(np.ascontiguousarray(h2, np.int64))
            pos += len(h1)
        h_off[k] = h_tables[H]
    lik_flat = np.concatenate(liks) if liks else np.zeros(1, np.float64)
    freq_flat = np.concatenate(freqs) if freqs else np.zeros(1, np.float64)
    rows_flat = (np.concatenate(rows_parts) if rows_parts
                 else np.zeros(1, np.int64))
    if len(rows_flat) == 0:
        rows_flat = np.zeros(1, np.int64)
    vih_flat = np.concatenate(vihs) if vihs else np.zeros(1, np.uint8)
    if len(vih_flat) == 0:
        vih_flat = np.zeros(1, np.uint8)
    h1_flat = np.concatenate(blocks1) if blocks1 else np.zeros(1, np.int64)
    h2_flat = np.concatenate(blocks2) if blocks2 else np.zeros(1, np.int64)
    ratios_out = np.empty(max(1, int(ratio_off[-1])), np.float64)
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_posteriors_batch(
        _np_ptr(lik_flat), _np_ptr(lik_off), _np_ptr(I_arr), _np_ptr(G_arr),
        _np_ptr(freq_flat), _np_ptr(freq_off), _np_ptr(H_arr),
        _np_ptr(h1_flat), _np_ptr(h2_flat), _np_ptr(h_off),
        _np_ptr(rows_flat), _np_ptr(rows_off),
        _np_ptr(vih_flat), _np_ptr(vih_off), _np_ptr(V_arr),
        _np_ptr(ratio_off), _np_ptr(ratios_out), W, n_threads)
    return [ratios_out[ratio_off[k] : ratio_off[k + 1]] for k in range(W)]


def native_gap_open(hap_seq: bytes, table: np.ndarray):
    """Per-base gap-open phred array via the C++ single pass; None when the
    library is unavailable (callers fall back to the numpy oracle)."""
    lib = load()
    if lib is None:
        return None
    n = len(hap_seq)
    out = np.empty(n, np.int32)
    lib.ptpu_gap_open(hap_seq, n, _np_ptr(table), len(table), _np_ptr(out))
    return out


def native_em_batch(entries, max_iters: int = 100, n_threads: int = 0):
    """EM for MANY independent windows in one native call (threaded across
    windows; per-window arithmetic identical to native_em, which is
    bit-exact vs the numpy oracle).

    entries: [(likelihoods [I, G] f64, h1, h2, n_haps, n_reads [I])]
    Returns [(freq, csr, iters)] aligned with entries, or None when the
    library is unavailable / unverified (callers fall back per window)."""
    global _EM_VERIFIED
    if os.environ.get("PLATYPUS_TPU_NATIVE_EM", "1") == "0":
        return None
    lib = load()
    if lib is None:
        return None
    if _EM_VERIFIED is None:
        _EM_VERIFIED = _verify_native_em(lib)
    if not _EM_VERIFIED:
        return None

    results: list = [None] * len(entries)
    live = []          # (entry index, lik_block, h1, h2, H, has_data, I, G)
    for idx, (likelihoods, h1, h2, n_haps, n_reads) in enumerate(entries):
        I, G = likelihoods.shape
        has_data = n_reads > 0
        nd = int(has_data.sum())
        if nd == 0:
            results[idx] = (np.full(n_haps, 1.0 / n_haps),
                            np.zeros_like(likelihoods), 0)
            continue
        lik = likelihoods if nd == I else likelihoods[has_data]
        live.append((idx, np.ascontiguousarray(lik, np.float64),
                     h1, h2, n_haps, has_data, I, G, nd))
    if not live:
        return results

    W = len(live)
    nd_arr = np.fromiter((e[8] for e in live), np.int32, count=W)
    G_arr = np.fromiter((e[7] for e in live), np.int32, count=W)
    H_arr = np.fromiter((e[4] for e in live), np.int32, count=W)
    lik_off = np.zeros(W + 1, np.int64)
    np.cumsum(nd_arr.astype(np.int64) * G_arr, out=lik_off[1:])
    freq_off = np.zeros(W + 1, np.int64)
    np.cumsum(H_arr, out=freq_off[1:])
    lik_flat = np.concatenate([e[1].ravel() for e in live])
    # Shared h1/h2 tables: one block per distinct H.
    h_tables: dict = {}
    blocks1, blocks2 = [], []
    pos = 0
    for _idx, _lik, h1, h2, H, *_ in live:
        if H not in h_tables:
            h_tables[H] = pos
            blocks1.append(np.ascontiguousarray(h1, np.int64))
            blocks2.append(np.ascontiguousarray(h2, np.int64))
            pos += len(h1)
    h1_flat = np.concatenate(blocks1)
    h2_flat = np.concatenate(blocks2)
    h_off = np.fromiter((h_tables[e[4]] for e in live), np.int64, count=W)
    eps_arr = np.fromiter((min(1e-3, 1.0 / (e[6] * 4)) for e in live),
                          np.float64, count=W)
    freq_out = np.empty(int(freq_off[-1]), np.float64)
    w_out = np.empty(int(lik_off[-1]), np.float64)
    iters_out = np.empty(W, np.int32)
    if not n_threads:
        budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) \
            or (os.cpu_count() or 1)
        n_threads = min(4, budget)
    lib.ptpu_em_f64_batch(
        _np_ptr(lik_flat), _np_ptr(lik_off), _np_ptr(nd_arr), _np_ptr(G_arr),
        _np_ptr(h1_flat), _np_ptr(h2_flat), _np_ptr(h_off), _np_ptr(H_arr),
        _np_ptr(freq_off), W, _np_ptr(eps_arr), max_iters,
        _np_ptr(freq_out), _np_ptr(w_out), _np_ptr(iters_out), n_threads)
    for k, (idx, _lik, _h1, _h2, H, has_data, I, G, nd) in enumerate(live):
        freq = freq_out[freq_off[k] : freq_off[k] + H].copy()
        w = w_out[lik_off[k] : lik_off[k + 1]].reshape(nd, G)
        if nd == I:
            csr = w.copy()
        else:
            csr = np.zeros((I, G), np.float64)
            csr[has_data] = w
        it = int(iters_out[k])
        results[idx] = None if it < 0 else (freq, csr, it)
    return results
