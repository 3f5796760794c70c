"""A coordinate-sorted paired-end BAM writer, in plain numpy and zlib, on
harness/bamio.py's BGZF and index writers (imported, not copied).

bamio.write_bam writes single-end records (flag 0, no mate, TLEN 0).  This
writer takes every field a paired record carries: FLAG, the mate's
reference and position, TLEN and MAPQ per record, records without a CIGAR
(an unmapped mate placed at its partner's position), and one query name
per fragment, shared by both mates.  Its .bai comes from bamio.bai_bytes
over the record offsets it lays out.
"""

from __future__ import annotations

import struct

import numpy as np

from portbench.harness import bamio

_AUX = b"RGZrg1\x00"
_NAME_LEN = 11  # 'p' + 9 digits + NUL
_CONSUMES_REF = np.zeros(16, bool)
_CONSUMES_REF[[0, 2, 3, 7, 8]] = True


def ref_ends(pos: np.ndarray, lengths: np.ndarray, cigars: dict) -> np.ndarray:
    """Each record's reference end: pos + the reference bases of its CIGAR
    (rows absent from `cigars` are lengths[r] M); a record with no
    reference bases (an empty CIGAR) ends at pos + 1, as htslib's
    bam_endpos reads it."""
    end = pos + lengths
    for r, cig in cigars.items():
        span = sum(ln for op, ln in cig if _CONSUMES_REF[op])
        end[r] = pos[r] + max(span, 1)
    return end


def write_bam(path: str, contig: str, contig_len: int, pos: np.ndarray,
              flag: np.ndarray, mapq: np.ndarray, mate_pos: np.ndarray,
              tlen: np.ndarray, name_id: np.ndarray, seq: np.ndarray,
              cigars: dict, qual: int, sample: str) -> None:
    """Records pos[n] (0-based leftmost aligned base, sorted), FLAG, MAPQ,
    the mate's position (the mate's reference is the contig for every
    record), TLEN and query name 'p<name_id>' per record, sequences seq[n,
    L] (uint8 ASCII, every record L bases) at base quality `qual`, read
    group rg1 of `sample`; rows absent from `cigars` are L M, and a row
    mapped to [] has no CIGAR (an unmapped record).  Writes the BAM and
    its .bai."""
    n, L = seq.shape
    if n and np.any(np.diff(pos) < 0):
        raise ValueError("records must be sorted by position")
    header_text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:"
                   f"{contig_len}\n@RG\tID:rg1\tSM:{sample}\n").encode()
    name = contig.encode() + b"\x00"
    head = (b"BAM\x01" + struct.pack("<i", len(header_text)) + header_text
            + struct.pack("<ii", 1, len(name)) + name
            + struct.pack("<i", contig_len))
    rec_sz = 32 + _NAME_LEN + 4 + (L + 1) // 2 + L + len(_AUX)
    name_off = 4 + 32
    cigar_off = name_off + _NAME_LEN
    seq_off = cigar_off + 4
    qual_off = seq_off + (L + 1) // 2
    template = np.zeros(4 + rec_sz, np.uint8)
    struct.pack_into("<i", template, 0, rec_sz)
    template[12] = _NAME_LEN
    struct.pack_into("<H", template, 16, 1)
    struct.pack_into("<i", template, 20, L)
    template[name_off] = ord("p")
    struct.pack_into("<I", template, cigar_off, L << 4)
    template[qual_off:qual_off + L] = qual
    template[qual_off + L:] = np.frombuffer(_AUX, np.uint8)

    codes = bamio._SEQ_LUT[seq]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    spec_rows = np.array(sorted(cigars), np.int64)
    sizes = np.full(n, 4 + rec_sz, np.int64)
    lengths = np.full(n, L, np.int64)
    for r in spec_rows:
        sizes[r] += 4 * (len(cigars[int(r)]) - 1)
    end = ref_ends(pos.astype(np.int64), lengths, cigars)
    bins = bamio._reg2bin(pos.astype(np.int64), end)
    pieces = [head]
    chunk = 65536
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = np.broadcast_to(template, (hi - lo, len(template))).copy()

        def put(col, values, dtype, width):
            block[:, col:col + width] = np.ascontiguousarray(
                values[lo:hi].astype(dtype)).view(np.uint8).reshape(-1, width)

        put(8, pos, "<i4", 4)
        block[:, 13] = mapq[lo:hi].astype(np.uint8)
        put(14, bins, "<u2", 2)
        put(18, flag, "<u2", 2)
        block[:, 24:28] = 0                      # the mate's reference: 0
        put(28, mate_pos, "<i4", 4)
        put(32, tlen, "<i4", 4)
        for d in range(9):
            block[:, name_off + 1 + d] = (name_id[lo:hi] // 10 ** (8 - d)) % 10 + 48
        block[:, seq_off:qual_off] = packed[lo:hi]
        prev = lo
        for r in spec_rows[np.searchsorted(spec_rows, lo):
                           np.searchsorted(spec_rows, hi)]:
            r = int(r)
            if r > prev:
                pieces.append(block[prev - lo:r - lo].tobytes())
            row = block[r - lo]
            cig = cigars[r]
            words = b"".join(struct.pack("<I", (ln << 4) | op)
                             for op, ln in cig)
            body = (struct.pack("<i", int(sizes[r]) - 4) + row[4:16].tobytes()
                    + struct.pack("<H", len(cig)) + row[18:cigar_off].tobytes()
                    + words + row[seq_off:].tobytes())
            pieces.append(body)
            prev = r + 1
        if hi > prev:
            pieces.append(block[prev - lo:hi - lo].tobytes())
    stream = b"".join(pieces)
    rec_start = len(head) + np.concatenate([[0], np.cumsum(sizes)[:-1]])
    coffsets = bamio.write_bgzf(path, stream)
    with open(path + ".bai", "wb") as fh:
        fh.write(bamio.bai_bytes(pos.astype(np.int64), end, rec_start,
                                 rec_start + sizes, coffsets, len(stream)))
