"""BAM reader: binary record parsing, BAI index random access, and
fixed-shape structure-of-arrays read batches.

Replaces the reference's htslib binding layer
(Platypus src/cython/htslibWrapper.pyx):

* record decode mirrors ReadIterator.get (htslibWrapper.pyx:328-406):
  reads with zero-length sequence or absent quality are skipped, the 4-bit
  packed sequence decodes through "=ACMGRSVTWYHKDBN", the mapping position is
  shifted left by any leading soft-clip so `pos` addresses the first base of
  the stored sequence, and `end` is the htslib bam_endpos (reference-consuming
  CIGAR span from the *unadjusted* position).
* the output is a NumPy SoA (`ReadSet`) rather than malloc'd C structs —
  downstream QC/trim and batch building are vectorised, and the arrays ship
  straight into device tensors.

A small BAM writer is included for synthetic test data.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .bgzf import BGZFReader, BGZFWriter

logger = logging.getLogger("platypus_tpu")

# BAM flag bits (standard).
FLAG_PAIRED = 1
FLAG_PROPER_PAIR = 2
FLAG_UNMAP = 4
FLAG_MUNMAP = 8
FLAG_REVERSE = 16
FLAG_MREVERSE = 32
FLAG_READ1 = 64
FLAG_READ2 = 128
FLAG_SECONDARY = 256
FLAG_QCFAIL = 512
FLAG_DUP = 1024
FLAG_SUPPLEMENTARY = 2048

_SEQ_LOOKUP = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)

# CIGAR op codes.
CIGAR_M, CIGAR_I, CIGAR_D, CIGAR_N, CIGAR_S, CIGAR_H, CIGAR_P, CIGAR_EQ, CIGAR_X = range(9)
_CONSUMES_REF = {CIGAR_M, CIGAR_D, CIGAR_N, CIGAR_EQ, CIGAR_X}
# 16-entry bool LUT: per-record np.isin over a Python set costs ~10x more
# on the whole-file hot loops (fetch fallback, build_bai).
_CONSUMES_REF_LUT = np.zeros(16, bool)
for _op in _CONSUMES_REF:
    _CONSUMES_REF_LUT[_op] = True


@dataclass
class ReadSet:
    """Structure-of-arrays read batch for one (sample, region).

    CONTRACT — zero padding: ``seq[i, rlen[i]:]`` and ``qual[i, rlen[i]:]``
    MUST be zero for every row.  Hot paths rely on it: the
    ``minBaseQual >= 1`` fast path in ``readbuffer.apply_read_qc`` counts
    good bases as ``(qual >= t).sum(axis=1)`` with NO ``j < rlen`` mask,
    so any nonzero byte past ``rlen`` would silently inflate the count
    and change QC triage.  Every producer (BAM python/native decoders,
    CRAM, synth) zero-fills; anything that writes quals in place (trims,
    decompression) must preserve zeros past ``rlen``.  Call
    ``check_padding()`` (debug) to assert it.
    """

    seq: np.ndarray          # uint8 [N, L] ASCII bases, zero-padded
    qual: np.ndarray         # uint8 [N, L] phred (0..93), zero-padded
    rlen: np.ndarray         # int32 [N]
    pos: np.ndarray          # int64 [N] leftmost base of stored sequence
    end: np.ndarray          # int64 [N] reference end (exclusive)
    mapq: np.ndarray         # int32 [N]
    flag: np.ndarray         # int32 [N]
    chrom_id: np.ndarray     # int32 [N]
    mate_chrom_id: np.ndarray  # int32 [N]
    mate_pos: np.ndarray     # int64 [N]
    insert_size: np.ndarray  # int32 [N]
    cigar_flat: np.ndarray   # uint32 [sum n_cigar] raw BAM cigar words
    cigar_off: np.ndarray    # int64 [N+1] CSR offsets into cigar_flat
    qc_fail: np.ndarray      # bool [N] set by QC (reference's software flag)
    rg_id: Optional[List[Optional[bytes]]] = None

    def __len__(self) -> int:
        return int(self.rlen.shape[0])

    def check_padding(self) -> None:
        """Assert the zero-padding contract (see class docstring).

        Debug aid — O(N*L); not called on the hot path.  Used by the
        producer-side tests in tests/test_io.py.
        """
        if len(self) == 0:
            return
        L = self.qual.shape[1]
        cols = np.arange(L, dtype=np.int32)[None, :]
        pad = cols >= self.rlen[:, None]
        if self.qual[pad].any() or self.seq[pad].any():
            raise AssertionError("ReadSet padding contract violated: "
                                 "nonzero seq/qual bytes past rlen")

    # -- in-memory compressed mode (--compressReads) ---------------------
    # The reference keeps reads compressed between windows and lazily
    # uncompresses the slice a window needs (htslibWrapper.pyx:603-644,
    # cwindow.pyx:655-689).  Here the seq/qual columns are replaced by
    # per-read RLE blobs against the reference; positional columns stay
    # dense so windowing/coverage logic is untouched.

    @property
    def is_compressed(self) -> bool:
        return getattr(self, "_comp", None) is not None

    @property
    def width(self) -> int:
        """Padded row length of the seq/qual columns (valid either mode)."""
        if self.is_compressed:
            return self._comp_width
        return int(self.seq.shape[1])

    def compress_in_memory(self, ref_seq: bytes, ref_start: int) -> None:
        """Swap the dense seq/qual columns for compressed blobs."""
        from .compression import compress_read_set

        if self.is_compressed or len(self) == 0 or self.seq.size == 0:
            return
        # Quality binning (the lossy part) has already been applied by QC,
        # so blobs round-trip exactly.
        self._comp = compress_read_set(self, ref_seq, ref_start)
        self._comp_ref = np.frombuffer(ref_seq, np.uint8)
        self._comp_width = int(self.seq.shape[1])
        self.seq = None
        self.qual = None

    def seq_qual_rows(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Dense [n, width] seq/qual for a row slice/index array, lazily
        decompressing in compressed mode."""
        if not self.is_compressed:
            return self.seq[rows], self.qual[rows]
        from .compression import uncompress_qual, uncompress_seq

        if isinstance(rows, slice):
            start, stop, step = rows.indices(len(self.rlen))
            rows = np.arange(start, stop, step)
        rows = np.asarray(rows, np.int64)
        comp = self._comp
        L = self._comp_width
        seq = np.zeros((len(rows), L), np.uint8)
        qual = np.zeros((len(rows), L), np.uint8)
        for out_i, i in enumerate(rows):
            i = int(i)
            rl = int(comp.rlen[i])
            off = int(comp.pos[i]) - comp.ref_start
            window = (self._comp_ref[max(0, off): off + rl]
                      if off >= 0 else np.zeros(0, np.uint8))
            seq[out_i, :rl] = uncompress_seq(comp.seq_blobs[i], window, rl)
            qual[out_i, :rl] = uncompress_qual(comp.qual_blobs[i], rl)
        return seq, qual

    def compressed_nbytes(self) -> int:
        return self._comp.nbytes() if self.is_compressed else -1

    def cigar_ops(self, i: int) -> np.ndarray:
        """CIGAR for read i as an [k, 2] array of (op, length)."""
        words = self.cigar_flat[self.cigar_off[i] : self.cigar_off[i + 1]]
        return np.stack([words & 0xF, words >> 4], axis=1).astype(np.int64)

    def take(self, idx: np.ndarray) -> "ReadSet":
        if self.is_compressed:
            raise ValueError(
                "ReadSet.take on a compressed ReadSet (seq/qual replaced "
                "by per-read blobs); subset before compress_in_memory")
        idx = np.asarray(idx)
        starts = self.cigar_off[idx]
        lens = self.cigar_off[idx + 1] - starts
        off = np.concatenate([[0], np.cumsum(lens)])
        total = int(off[-1])
        # Vectorised CSR gather: flat source index for every kept word.
        flat_idx = np.repeat(starts, lens) + (
            np.arange(total) - np.repeat(off[:-1], lens)
        )
        return ReadSet(
            seq=self.seq[idx],
            qual=self.qual[idx],
            rlen=self.rlen[idx],
            pos=self.pos[idx],
            end=self.end[idx],
            mapq=self.mapq[idx],
            flag=self.flag[idx],
            chrom_id=self.chrom_id[idx],
            mate_chrom_id=self.mate_chrom_id[idx],
            mate_pos=self.mate_pos[idx],
            insert_size=self.insert_size[idx],
            cigar_flat=self.cigar_flat[flat_idx],
            cigar_off=off,
            qc_fail=self.qc_fail[idx],
            rg_id=[self.rg_id[i] for i in idx] if self.rg_id is not None else None,
        )


def empty_read_set(max_len: int = 0) -> ReadSet:
    z = np.zeros
    return ReadSet(
        seq=z((0, max_len), np.uint8),
        qual=z((0, max_len), np.uint8),
        rlen=z(0, np.int32),
        pos=z(0, np.int64),
        end=z(0, np.int64),
        mapq=z(0, np.int32),
        flag=z(0, np.int32),
        chrom_id=z(0, np.int32),
        mate_chrom_id=z(0, np.int32),
        mate_pos=z(0, np.int64),
        insert_size=z(0, np.int32),
        cigar_flat=z(0, np.uint32),
        cigar_off=z(1, np.int64),
        qc_fail=z(0, bool),
        rg_id=[],
    )


# ----------------------------------------------------------------------------
# BAI index
# ----------------------------------------------------------------------------

def _reg2bins(beg: int, end: int) -> List[int]:
    """All index bins overlapping [beg, end) in the standard 6-level scheme."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def _reg2bin(beg: int, end: int) -> int:
    """The single smallest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def build_bai(bam_path: str, bai_path: str) -> None:
    """Build a standard .bai for a coordinate-sorted BAM (one streaming
    pass).  Python oracle for native/src/bgzf_bam.cpp:ptpu_bam_index; used
    directly when the native library is unavailable."""
    bg = BGZFReader(bam_path)
    try:
        if bg.read(4) != b"BAM\x01":
            raise ValueError(f"{bam_path}: not a BAM file")
        (l_text,) = struct.unpack("<i", bg.read(4))
        bg.read(l_text)
        (n_ref,) = struct.unpack("<i", bg.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", bg.read(4))
            bg.read(l_name + 4)

        bins: List[Dict[int, List[List[int]]]] = [{} for _ in range(n_ref)]
        linear: List[List[int]] = [[] for _ in range(n_ref)]
        last_ref, last_pos = -1, -1
        while True:
            u = bg.virtual_offset
            size_bytes = bg.read(4)
            if len(size_bytes) < 4:
                break
            (block_size,) = struct.unpack("<i", size_bytes)
            if block_size <= 0:
                break
            rec = bg.read(block_size)
            if len(rec) < block_size:
                break
            v = bg.virtual_offset
            ref_id, pos, l_read_name = struct.unpack_from("<iiB", rec, 0)
            if ref_id < 0 or ref_id >= n_ref or pos < 0:
                continue
            if ref_id < last_ref or (ref_id == last_ref and pos < last_pos):
                # A BAI is only meaningful for a coordinate-sorted file;
                # refuse to index disorder (the fetch early-exit would
                # silently drop reads otherwise).
                raise ValueError(f"{bam_path} is not coordinate-sorted")
            last_ref, last_pos = ref_id, pos
            (n_cigar,) = struct.unpack_from("<H", rec, 12)
            cigar = np.frombuffer(rec, dtype="<u4", count=n_cigar,
                                  offset=32 + l_read_name)
            ops = cigar & 0xF
            span = int((cigar >> 4)[_CONSUMES_REF_LUT[ops]].sum())
            rend = pos + max(span, 1)

            chunk_list = bins[ref_id].setdefault(_reg2bin(pos, rend), [])
            if chunk_list and chunk_list[-1][1] == u:
                chunk_list[-1][1] = v
            else:
                chunk_list.append([u, v])
            lin = linear[ref_id]
            wend = (rend - 1) >> 14
            if len(lin) <= wend:
                lin.extend([0] * (wend + 1 - len(lin)))
            for w in range(pos >> 14, wend + 1):
                if lin[w] == 0:
                    lin[w] = u
    finally:
        bg.close()

    with open(bai_path, "wb") as out:
        out.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for r in range(n_ref):
            out.write(struct.pack("<i", len(bins[r])))
            for bin_id in sorted(bins[r]):
                chunks = bins[r][bin_id]
                out.write(struct.pack("<Ii", bin_id, len(chunks)))
                for u, v in chunks:
                    out.write(struct.pack("<QQ", u, v))
            lin = linear[r]
            last = 0  # forward-fill readless windows with the previous offset
            for w in range(len(lin)):
                if lin[w] == 0:
                    lin[w] = last
                else:
                    last = lin[w]
            out.write(struct.pack("<i", len(lin)))
            out.write(struct.pack(f"<{len(lin)}Q", *lin))


class BaiIndex:
    def __init__(self, filename: str):
        with open(filename, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{filename}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            ref_bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cbeg, cend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cbeg, cend))
                ref_bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioffs = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off).copy()
            off += 8 * n_intv
            self.bins.append(ref_bins)
            self.linear.append(ioffs)

    def chunks_for_region(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if ref_id < 0 or ref_id >= len(self.bins):
            return []
        ref_bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        min_off = 0
        widx = beg >> 14
        if len(linear):
            widx = min(widx, len(linear) - 1)
            min_off = int(linear[widx])
        chunks = []
        for b in _reg2bins(beg, end):
            if b == 37450:  # pseudo-bin with metadata
                continue
            for cbeg, cend in ref_bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


# ----------------------------------------------------------------------------
# BAM reader
# ----------------------------------------------------------------------------

def open_alignment_file(filename: str, ref_file=None,
                        index_filename: Optional[str] = None):
    """BamFile or CramFile by extension (the reference opens either
    transparently through htslib, htslibWrapper.pyx:143-173).  CRAM decode
    needs `ref_file` (path or FastaFile) for sequence reconstruction."""
    if filename.lower().endswith(".cram"):
        from .cram import CramFile

        return CramFile(filename, ref_file=ref_file, index_filename=index_filename)
    return BamFile(filename, index_filename=index_filename)


class BamFile:
    def __init__(self, filename: str, index_filename: Optional[str] = None):
        self.filename = filename
        if filename.lower().endswith(".cram"):
            raise ValueError(
                f"{filename}: BamFile speaks BAM only; use open_alignment_file"
                " / io.cram.CramFile for CRAM"
            )
        self._bgzf = BGZFReader(filename)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{filename}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        self.header_text = self._bgzf.read(l_text).decode("latin-1")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            self.references.append((name, l_ref))
        self.ref_id: Dict[str, int] = {n: i for i, (n, _) in enumerate(self.references)}
        self._first_record_voffset = self._bgzf.virtual_offset
        # Sort order: the caller (like the reference, which requires an
        # htslib index) assumes coordinate order.  A header explicitly
        # declaring otherwise turns off the sorted-scan early exit, the
        # native fetch, and auto-indexing (a missing SO tag — common for
        # coordinate-sorted files — is treated as coordinate).
        self.coordinate_sorted = True
        for line in self.header_text.splitlines():
            if line.startswith("@HD") and "\tSO:" in line:
                so = line.split("\tSO:", 1)[1].split("\t", 1)[0].strip()
                if so not in ("coordinate", "unknown", ""):
                    self.coordinate_sorted = False
                    logger.warning(
                        "%s declares SO:%s; using order-agnostic full scans "
                        "(coordinate-sort the BAM for indexed access)",
                        filename, so)
        self.index: Optional[BaiIndex] = None
        index_filename = index_filename or filename + ".bai"
        self.index_path = index_filename
        try:
            self.index = BaiIndex(index_filename)
        except (FileNotFoundError, ValueError, struct.error):
            self.index = None
        if self.index is not None:
            try:
                if os.path.getmtime(index_filename) < os.path.getmtime(filename):
                    logger.warning("Index %s is older than %s — regenerate it "
                                   "if the BAM changed", index_filename, filename)
            except OSError:
                pass  # mtime unavailable; keep the loaded index
        if (self.index is None and self.coordinate_sorted
                and os.environ.get("PLATYPUS_TPU_AUTOINDEX", "1") != "0"):
            # The reference refuses unindexed BAMs outright (htslib index
            # load failure); we go one better and build the .bai in one
            # streaming pass — without it every region fetch scans the file
            # from the first record (quadratic over a whole-genome run).
            built = self._build_index(index_filename)
            if built is not None:
                try:
                    self.index = BaiIndex(built)
                    self.index_path = built
                except (FileNotFoundError, ValueError, struct.error):
                    self.index = None
            else:
                # Build failed — most likely the file is not actually
                # coordinate-sorted despite its header; stay safe with
                # order-agnostic full scans.
                self.coordinate_sorted = False

    def _build_index(self, index_filename: str) -> Optional[str]:
        """Build a .bai next to the BAM (atomic rename), or at a
        deterministic temp-dir path when the BAM's directory is not
        writable (keyed by the BAM's identity+mtime+size so later opens —
        including sibling worker processes — reuse it instead of
        re-streaming the file, and stale copies are not picked up).
        Returns the index path, or None when the build failed."""
        import hashlib
        import tempfile

        from ..native import native_bam_index

        target = index_filename
        d = os.path.dirname(os.path.abspath(target)) or "."
        try:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".bai.tmp")
            os.close(fd)
        except OSError:
            # Unwritable input directory: deterministic private path keyed
            # by the BAM's identity so later opens (and sibling workers)
            # reuse it instead of re-streaming the file.
            st = os.stat(self.filename)
            key = hashlib.sha1(
                f"{os.path.abspath(self.filename)}:{st.st_mtime_ns}:{st.st_size}"
                .encode()).hexdigest()[:16]
            target = os.path.join(tempfile.gettempdir(),
                                  f"platypus_tpu_{key}.bai")
            if os.path.exists(target):
                return target  # built by an earlier open / another worker
            fd, tmp = tempfile.mkstemp(suffix=".bai.tmp")
            os.close(fd)
        try:
            if not native_bam_index(self.filename, tmp):
                build_bai(self.filename, tmp)
            os.replace(tmp, target)
            return target
        except Exception:  # noqa: BLE001 — unindexed operation still works
            logger.warning("Could not build index for %s", self.filename)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- header -------------------------------------------------------------
    def header_dict(self) -> Dict[str, List[Dict[str, str]]]:
        """Parse @-lines of the SAM header into a tag dict (RG/SQ/...)."""
        out: Dict[str, List[Dict[str, str]]] = {}
        for line in self.header_text.splitlines():
            if not line.startswith("@"):
                continue
            cols = line[1:].split("\t")
            tag = cols[0]
            entry = {}
            for col in cols[1:]:
                if ":" in col:
                    k, v = col.split(":", 1)
                    entry[k] = v
            out.setdefault(tag, []).append(entry)
        return out

    def sample_names(self) -> List[str]:
        """Samples from RG:SM tags; falls back to the file stem
        (reference platypusutils.pyx:92-156 semantics)."""
        header = self.header_dict()
        rgs = header.get("RG", [])
        samples = sorted({rg["SM"] for rg in rgs if "SM" in rg})
        if samples:
            return samples
        stem = self.filename.split("/")[-1]
        if stem.lower().endswith(".cram"):
            stem = stem[:-5]
        elif stem.lower().endswith(".bam"):
            stem = stem[:-4]
        return [stem]

    # -- record iteration ----------------------------------------------------
    def _iter_raw_records(self, chunks: Sequence[Tuple[int, int]]) -> Iterator[bytes]:
        for cbeg, cend in chunks:
            self._bgzf.seek_virtual(cbeg)
            while self._bgzf.virtual_offset < cend:
                size_bytes = self._bgzf.read(4)
                if len(size_bytes) < 4:
                    return
                (block_size,) = struct.unpack("<i", size_bytes)
                if block_size <= 0:
                    raise ValueError(
                        f"corrupt BAM: record size {block_size}")
                record = self._bgzf.read(block_size)
                if len(record) < block_size:
                    return
                yield record

    def _iter_all_records(self) -> Iterator[bytes]:
        self._bgzf.seek_virtual(self._first_record_voffset)
        while True:
            size_bytes = self._bgzf.read(4)
            if len(size_bytes) < 4:
                return
            (block_size,) = struct.unpack("<i", size_bytes)
            if block_size <= 0:
                raise ValueError(f"corrupt BAM: record size {block_size}")
            record = self._bgzf.read(block_size)
            if len(record) < block_size:
                return
            yield record

    def fetch(self, chrom: str, start: int, end: int, store_rg: bool = False,
              use_native: bool = True) -> ReadSet:
        """All mapped records overlapping [start, end) on `chrom` as a ReadSet.

        Overlap test is on the *original* alignment span (before the
        soft-clip pos adjustment), matching htslib's iterator semantics.
        Uses the native C++ decoder when built (same contract; the Python
        parser below is the fallback and semantics oracle).
        """
        ref_id = self.ref_id.get(chrom)
        if ref_id is None:
            return empty_read_set()
        # A negative start (e.g. from an out-of-contract "chr:0-..." region
        # string) breaks the BAI bin computation and returns nothing;
        # clamp like htslib does.
        start = max(0, start)
        if use_native and not store_rg and self.coordinate_sorted:
            from ..native import native_fetch

            rs = native_fetch(
                self.filename,
                self.index_path if self.index is not None else "",
                ref_id, start, end, self._first_record_voffset,
            )
            if rs is not None:
                return rs
        if self.index is not None:
            records = self._iter_raw_records(self.index.chunks_for_region(ref_id, start, end))
        else:
            records = self._iter_all_records()
        return _parse_records(records, ref_id, start, end, store_rg,
                              sorted_input=self.coordinate_sorted)


def _parse_records(
    records: Iterator[bytes], want_ref: int, start: int, end: int, store_rg: bool,
    sorted_input: bool = True,
) -> ReadSet:
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    cigars: List[np.ndarray] = []
    scal: List[Tuple[int, int, int, int, int, int, int, int, int]] = []
    rgs: List[Optional[bytes]] = []

    for rec in records:
        ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, next_ref, next_pos, tlen = (
            struct.unpack_from("<iiBBHHHiiii", rec, 0)
        )
        if sorted_input and (ref_id < 0 or ref_id > want_ref
                             or (ref_id == want_ref and pos >= end)):
            # Coordinate-sorted early exit: a later chromosome, the
            # unplaced-unmapped tail, or a start at/after `end` means no
            # later record can overlap the query.
            break
        if ref_id != want_ref:
            continue
        if l_seq == 0:
            continue
        off = 32 + l_read_name
        cigar = np.frombuffer(rec, dtype="<u4", count=n_cigar, offset=off)
        off += 4 * n_cigar
        n_seq_bytes = (l_seq + 1) // 2
        packed = np.frombuffer(rec, dtype=np.uint8, count=n_seq_bytes, offset=off)
        off += n_seq_bytes
        qual = np.frombuffer(rec, dtype=np.uint8, count=l_seq, offset=off)
        off += l_seq
        if qual[0] == 0xFF:  # missing quality string (htslibWrapper.pyx:337)
            continue

        ops = cigar & 0xF
        lens = (cigar >> 4).astype(np.int64)
        ref_span = int(lens[_CONSUMES_REF_LUT[ops]].sum())
        # htslib bam_endpos: a zero-reference-span record (placed-unmapped
        # mate, fully soft-clipped read) still occupies one base, so it is
        # fetched when pos == start and overlaps the [pos, pos+1) window.
        rec_end = pos + max(ref_span, 1)
        if rec_end <= start or pos >= end:
            continue

        # Decode 4-bit packed sequence to ASCII.
        nibbles = np.empty(n_seq_bytes * 2, dtype=np.uint8)
        nibbles[0::2] = packed >> 4
        nibbles[1::2] = packed & 0xF
        seq = _SEQ_LOOKUP[nibbles[:l_seq]]

        # Shift pos left over a leading soft clip (htslibWrapper.pyx:386-387).
        adj_pos = pos
        if n_cigar > 0 and ops[0] == CIGAR_S:
            adj_pos -= int(lens[0])

        rg: Optional[bytes] = None
        if store_rg:
            rg = _find_rg_tag(rec, off)

        seqs.append(seq)
        quals.append(qual.copy())
        cigars.append(cigar.astype(np.uint32))
        scal.append((l_seq, adj_pos, rec_end, mapq, flag, ref_id, next_ref, next_pos, tlen))
        rgs.append(rg)

    if not scal:
        return empty_read_set()

    n = len(scal)
    max_len = max(s[0] for s in scal)
    seq_arr = np.zeros((n, max_len), np.uint8)
    qual_arr = np.zeros((n, max_len), np.uint8)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        seq_arr[i, : len(s)] = s
        qual_arr[i, : len(q)] = q
    arr = np.array(scal, dtype=np.int64)
    lens = np.array([len(c) for c in cigars], dtype=np.int64)
    return ReadSet(
        seq=seq_arr,
        qual=qual_arr,
        rlen=arr[:, 0].astype(np.int32),
        pos=arr[:, 1],
        end=arr[:, 2],
        mapq=arr[:, 3].astype(np.int32),
        flag=arr[:, 4].astype(np.int32),
        chrom_id=arr[:, 5].astype(np.int32),
        mate_chrom_id=arr[:, 6].astype(np.int32),
        mate_pos=arr[:, 7],
        insert_size=arr[:, 8].astype(np.int32),
        cigar_flat=np.concatenate(cigars) if cigars else np.zeros(0, np.uint32),
        cigar_off=np.concatenate([[0], np.cumsum(lens)]),
        qc_fail=np.zeros(n, bool),
        rg_id=rgs if store_rg else None,
    )


def _find_rg_tag(rec: bytes, aux_off: int) -> Optional[bytes]:
    """Scan the aux fields for the RG:Z tag."""
    off = aux_off
    n = len(rec)
    while off + 3 <= n:
        tag = rec[off : off + 2]
        typ = rec[off + 2 : off + 3]
        off += 3
        if typ == b"Z" or typ == b"H":
            endz = rec.index(b"\x00", off)
            if tag == b"RG" and typ == b"Z":
                return rec[off:endz]
            off = endz + 1
        elif typ in b"cC":
            off += 1
        elif typ in b"sS":
            off += 2
        elif typ in b"iIf":
            off += 4
        elif typ == b"A":
            off += 1
        elif typ == b"B":
            sub = rec[off : off + 1]
            (cnt,) = struct.unpack_from("<i", rec, off + 1)
            width = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
            off += 5 + cnt * width
        else:
            break
    return None


# ----------------------------------------------------------------------------
# BAM writer (tests / tooling)
# ----------------------------------------------------------------------------

_SEQ_ENCODE = {b: i for i, b in enumerate(b"=ACMGRSVTWYHKDBN")}
_SEQ_ENCODE_LUT = np.full(256, 15, np.uint16)
for _b, _i in _SEQ_ENCODE.items():
    _SEQ_ENCODE_LUT[_b] = _i


def write_bam(
    filename: str,
    references: Sequence[Tuple[str, int]],
    reads: Sequence[dict],
    sample: str = "SAMPLE1",
    extra_header: str = "",
) -> None:
    """Write a minimal coordinate-sorted BAM (no index).

    Each read dict: name, ref_id, pos, mapq, flag, cigar [(op, len)...],
    seq (bytes), qual (bytes of phred ints), mate_ref_id, mate_pos, tlen.
    """
    header_text = "@HD\tVN:1.6\tSO:coordinate\n"
    for name, length in references:
        header_text += f"@SQ\tSN:{name}\tLN:{length}\n"
    header_text += f"@RG\tID:rg1\tSM:{sample}\n" + extra_header

    with BGZFWriter(filename) as out:
        out.write(b"BAM\x01")
        ht = header_text.encode()
        out.write(struct.pack("<i", len(ht)) + ht)
        out.write(struct.pack("<i", len(references)))
        for name, length in references:
            nb = name.encode() + b"\x00"
            out.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))
        for rd in reads:
            name = rd["name"].encode() + b"\x00"
            cigar_words = [(ln << 4) | op for op, ln in rd["cigar"]]
            seq = rd["seq"]
            l_seq = len(seq)
            codes = _SEQ_ENCODE_LUT[np.frombuffer(seq, np.uint8)]
            if l_seq % 2:
                codes = np.append(codes, 0)
            packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
            qual = bytes(rd["qual"])
            aux = b"RGZrg1\x00"
            body = struct.pack(
                "<iiBBHHHiiii",
                rd["ref_id"],
                rd["pos"],
                len(name),
                rd.get("mapq", 60),
                0,
                len(cigar_words),
                rd.get("flag", 0),
                l_seq,
                rd.get("mate_ref_id", -1),
                rd.get("mate_pos", -1),
                rd.get("tlen", 0),
            )
            body += name + b"".join(struct.pack("<I", w) for w in cigar_words)
            body += bytes(packed) + qual + aux
            out.write(struct.pack("<i", len(body)) + body)
