"""Tabix (.tbi) indexed access to bgzipped text files (VCF).

Replaces the reference's vendored pysam ctabix layer
(Platypus src/pysam/ctabix.pyx + src/tabix/*).  A .tbi index uses the
same binning scheme as BAI; records are filtered by the coordinate columns
declared in the index header.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .bgzf import BGZFReader


def _reg2bins(beg: int, end: int) -> List[int]:
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class TabixIndex:
    def __init__(self, filename: str):
        with BGZFReader(filename) as bg:
            data = bg.read_all()
        if data[:4] != b"TBI\x01":
            raise ValueError(f"{filename}: not a tabix index")
        (n_ref, self.format, self.col_seq, self.col_beg, self.col_end,
         self.meta_char, self.skip) = struct.unpack_from("<7i", data, 4)
        (l_nm,) = struct.unpack_from("<i", data, 32)
        off = 36
        names = data[off : off + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        self.ref_id = {n: i for i, n in enumerate(self.names)}
        off += l_nm
        self.bins: List[dict] = []
        self.linear: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            ref_bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    u, v = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((u, v))
                ref_bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            self.linear.append(np.frombuffer(data, "<u8", n_intv, off).copy())
            off += 8 * n_intv
            self.bins.append(ref_bins)

    def chunks_for_region(self, name: str, beg: int, end: int) -> List[Tuple[int, int]]:
        rid = self.ref_id.get(name)
        if rid is None:
            return []
        linear = self.linear[rid]
        min_off = 0
        if len(linear):
            widx = min(beg >> 14, len(linear) - 1)
            min_off = int(linear[widx])
        chunks = []
        for b in _reg2bins(beg, end):
            for u, v in self.bins[rid].get(b, ()):
                if v > min_off:
                    chunks.append((max(u, min_off), v))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for u, v in chunks:
            if merged and u <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], v))
            else:
                merged.append((u, v))
        return merged


class TabixFile:
    """Random access over a bgzipped, tabix-indexed text file."""

    def __init__(self, filename: str, index_filename: Optional[str] = None):
        self.filename = filename
        self.bgzf = BGZFReader(filename)
        self.index = TabixIndex(index_filename or filename + ".tbi")

    def close(self) -> None:
        self.bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def fetch(self, chrom: str, start: int, end: int) -> Iterator[List[str]]:
        """Yield tab-split records whose [col_beg, col_end) span overlaps
        [start, end) (0-based half-open).

        Seeks to the first index chunk for the region and streams lines
        forward; records are sorted by position within a chromosome, so
        iteration stops at the first record starting at/after `end` (or a
        record on a later chromosome).
        """
        chunks = self.index.chunks_for_region(chrom, start, end)
        if not chunks:
            return
        self.bgzf.seek_virtual(chunks[0][0])
        buf = b""
        seen_target = False
        while True:
            while b"\n" not in buf:
                chunk = self.bgzf.read(1 << 14)
                if not chunk:
                    break
                buf += chunk
            if b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
            elif buf:
                line, buf = buf, b""
            else:
                return
            rec = self._check_line(line, chrom, start, end)
            if rec == "past":
                return
            if rec == "other_chrom":
                if seen_target:
                    return
                continue
            if rec is not None:
                seen_target = True
                yield rec

    def _check_line(self, line: bytes, chrom: str, start: int, end: int):
        if not line or line.startswith(self.index.meta_char.to_bytes(1, "little")):
            return None
        cols = line.decode().rstrip("\r").split("\t")
        if cols[self.index.col_seq - 1] != chrom:
            return "other_chrom"
        beg = int(cols[self.index.col_beg - 1]) - (0 if self.index.format & 0x10000 else 1)
        # For VCF (col_end == 0) the end is beg + len(ref).
        if self.index.col_end == 0 or self.index.col_end == self.index.col_beg:
            rec_end = beg + (len(cols[3]) if len(cols) > 3 else 1)
        else:
            rec_end = int(cols[self.index.col_end - 1])
        if beg >= end:
            return "past"
        if rec_end <= start:
            return None
        return cols


# ---------------------------------------------------------------------------
# Tabix writing (test fixtures / bgzip output)
# ---------------------------------------------------------------------------

def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def write_tabix_vcf(vcf_lines, out_path: str) -> None:
    """Write VCF text lines as bgzip (one block per line, so virtual offsets
    are trivially known) plus a .tbi index."""
    from .bgzf import BGZFWriter, _BGZF_MAGIC
    import zlib as _zlib

    # Write each line as an independent BGZF block, recording offsets.
    records = []  # (ref_name, beg, end, voffset_start, voffset_end)
    file_off = 0
    with open(out_path, "wb") as fh:
        def write_block(data: bytes) -> int:
            nonlocal file_off
            co = _zlib.compressobj(6, _zlib.DEFLATED, -15)
            cdata = co.compress(data) + co.flush()
            crc = _zlib.crc32(data) & 0xFFFFFFFF
            bsize = len(cdata) + 26
            header = (_BGZF_MAGIC + b"\x00\x00\x00\x00\x00\xff\x06\x00"
                      + b"BC\x02\x00" + struct.pack("<H", bsize - 1))
            blk = header + cdata + struct.pack("<II", crc, len(data) & 0xFFFFFFFF)
            start = file_off
            fh.write(blk)
            file_off += len(blk)
            return start

        for line in vcf_lines:
            if not line.endswith("\n"):
                line += "\n"
            blk_off = write_block(line.encode())
            if not line.startswith("#"):
                cols = line.split("\t")
                beg = int(cols[1]) - 1
                end = beg + len(cols[3])
                records.append((cols[0], beg, end, blk_off << 16,
                                (blk_off << 16) | len(line)))
        from .bgzf import EOF_MARKER
        fh.write(EOF_MARKER)

    # Build the index.
    names = []
    for name, *_ in records:
        if name not in names:
            names.append(name)
    name_id = {n: i for i, n in enumerate(names)}

    per_ref_bins = [dict() for _ in names]
    per_ref_linear = [dict() for _ in names]
    next_voffs = []
    # voffset_end must point past the record; use the next block's start.
    for i, (name, beg, end, vs, ve) in enumerate(records):
        rid = name_id[name]
        b = _reg2bin(beg, end)
        per_ref_bins[rid].setdefault(b, []).append((vs, vs + (1 << 16)))
        w = beg >> 14
        lin = per_ref_linear[rid]
        if w not in lin or vs < lin[w]:
            lin[w] = vs

    out = bytearray()
    out += b"TBI\x01"
    out += struct.pack("<7i", len(names), 2, 1, 2, 0, ord("#"), 0)
    name_blob = b"".join(n.encode() + b"\x00" for n in names)
    out += struct.pack("<i", len(name_blob)) + name_blob
    for rid in range(len(names)):
        bins = per_ref_bins[rid]
        out += struct.pack("<i", len(bins))
        for b, chunks in bins.items():
            out += struct.pack("<Ii", b, len(chunks))
            for u, v in chunks:
                out += struct.pack("<QQ", u, v)
        lin = per_ref_linear[rid]
        n_intv = (max(lin) + 1) if lin else 0
        out += struct.pack("<i", n_intv)
        prev = 0
        for w in range(n_intv):
            if w in lin:
                prev = lin[w]
            out += struct.pack("<Q", prev if prev else (min(lin.values()) if lin else 0))

    from .bgzf import BGZFWriter
    with BGZFWriter(out_path + ".tbi") as w:
        w.write(bytes(out))
