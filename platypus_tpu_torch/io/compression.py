"""Read compression: reference-based sequence RLE and quality RLE with
optional lossy binning.

Mirrors the reference's --compressReads subsystem
(Platypus src/cython/htslibWrapper.pyx:441-644):

* sequence: bases matching the reference encode as run-length counts
  (<= 40, unambiguous because base characters are > 40), mismatching bases
  are stored verbatim — exact round trip;
* quality: run-length (value+33, count) pairs, optionally pre-binned with
  q = (q // qualBinSize) * qualBinSize when qualBinSize > 1 — the binning
  is LOSSY and changes downstream likelihoods, so the engine applies it
  whenever compressReads is on, matching the reference's observable
  behaviour.

In the SoA engine reads live as dense arrays and regions stream, so the
memory win is optional; the subsystem exists for parity and for the
qualBinSize semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


def compress_seq(seq: np.ndarray, ref_window: np.ndarray) -> bytes:
    """RLE-compress one read's bases against the aligned reference window."""
    out = bytearray()
    n_matches = 0
    for i in range(len(seq)):
        if i < len(ref_window) and seq[i] == ref_window[i]:
            if n_matches == 40:
                out.append(n_matches)
                n_matches = 0
            n_matches += 1
        else:
            if n_matches > 0:
                out.append(n_matches)
                n_matches = 0
            out.append(int(seq[i]))
    if n_matches > 0:
        out.append(n_matches)
    return bytes(out)


def uncompress_seq(blob: bytes, ref_window: np.ndarray, rlen: int) -> np.ndarray:
    out = np.zeros(rlen, np.uint8)
    ref_index = 0
    oi = 0
    for b in blob:
        if b <= 40:
            out[oi : oi + b] = ref_window[ref_index : ref_index + b]
            oi += b
            ref_index += b
        else:
            out[oi] = b
            oi += 1
            ref_index += 1
    return out


def bin_quals(qual: np.ndarray, qual_bin_size: int) -> np.ndarray:
    """Lossy coarse binning (htslibWrapper.pyx:505-507)."""
    if qual_bin_size <= 1:
        return qual
    return (qual // qual_bin_size) * qual_bin_size


def compress_qual(qual: np.ndarray, qual_bin_size: int) -> bytes:
    q = bin_quals(qual.astype(np.int64), qual_bin_size)
    out = bytearray()
    last = None
    count = 0
    for v in q:
        v = int(v)
        if last is None:
            out.append(v + 33)
            last, count = v, 1
        elif v == last:
            count += 1
        else:
            out.append(count)
            out.append(v + 33)
            last, count = v, 1
    if count > 0:
        out.append(count)
    return bytes(out)


def uncompress_qual(blob: bytes, rlen: int) -> np.ndarray:
    out = np.zeros(rlen, np.uint8)
    oi = 0
    for i in range(0, len(blob) - 1, 2):
        val = blob[i] - 33
        count = blob[i + 1]
        out[oi : oi + count] = val
        oi += count
    return out


@dataclass
class CompressedReads:
    """Compressed per-read blobs for one ReadSet (seq/qual columns only)."""

    seq_blobs: List[bytes]
    qual_blobs: List[bytes]
    rlen: np.ndarray
    pos: np.ndarray
    ref_start: int

    def nbytes(self) -> int:
        return sum(map(len, self.seq_blobs)) + sum(map(len, self.qual_blobs))


def compress_read_set(rs, ref_seq: bytes, ref_start: int, qual_bin_size: int = 1
                      ) -> CompressedReads:
    ref_arr = np.frombuffer(ref_seq, np.uint8)
    seq_blobs = []
    qual_blobs = []
    for i in range(len(rs)):
        rl = int(rs.rlen[i])
        off = int(rs.pos[i]) - ref_start
        window = ref_arr[max(0, off) : off + rl] if off >= 0 else np.zeros(0, np.uint8)
        seq_blobs.append(compress_seq(rs.seq[i, :rl], window))
        qual_blobs.append(compress_qual(rs.qual[i, :rl], qual_bin_size))
    return CompressedReads(seq_blobs, qual_blobs, rs.rlen.copy(), rs.pos.copy(), ref_start)


def uncompress_into_read_set(comp: CompressedReads, rs, ref_seq: bytes) -> None:
    """Restore seq/qual columns in place (quals reflect any binning)."""
    ref_arr = np.frombuffer(ref_seq, np.uint8)
    for i in range(len(comp.seq_blobs)):
        rl = int(comp.rlen[i])
        off = int(comp.pos[i]) - comp.ref_start
        window = ref_arr[max(0, off) : off + rl] if off >= 0 else np.zeros(0, np.uint8)
        rs.seq[i, :rl] = uncompress_seq(comp.seq_blobs[i], window, rl)
        rs.qual[i, :rl] = uncompress_qual(comp.qual_blobs[i], rl)


def apply_qual_binning(rs, qual_bin_size: int) -> None:
    """The lossy observable effect of --compressReads on the whole pile."""
    if qual_bin_size > 1:
        rs.qual[:] = (rs.qual // qual_bin_size) * qual_bin_size
