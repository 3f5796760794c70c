"""Writers for the benchmark's inputs, in plain numpy and zlib: BGZF, a
coordinate-sorted single-end BAM with its .bai, and FASTA with its .fai.

The BAM layout is tools/scaling_bench.py's (via tests/synth.py
write_bam_bulk): single-M records packed as one numpy matrix, multi-op
records packed one by one.  The .bai is computed from the record offsets
the writer itself lays out, and equals what a streaming indexer
(platypus_tpu_torch/io/bam.py build_bai) writes for the same file.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK = 0xFF00  # uncompressed bytes per BGZF block, as htslib writes
THREADS = 8     # zlib releases the GIL: blocks compress in parallel
_BGZF_HEAD = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_SEQ_LUT = np.zeros(256, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_LUT[_b] = _i
_AUX = b"RGZrg1\x00"
_NAME_LEN = 11  # 'r' + 9 digits + NUL
_CONSUMES_REF = np.zeros(16, bool)
_CONSUMES_REF[[0, 2, 3, 7, 8]] = True


def _deflate(piece) -> bytes:
    data = bytes(piece)
    cdata = zlib.compress(data, 1, wbits=-15)
    return (_BGZF_HEAD + struct.pack("<H", len(cdata) + 25) + cdata
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)))


def write_bgzf(path: str, stream: bytes) -> np.ndarray:
    """Write `stream` as BGZF blocks of BLOCK bytes (compressed on THREADS
    threads; the bytes do not depend on their number) and the EOF block.
    Returns each block's compressed offset, plus the EOF block's as the
    last entry."""
    view = memoryview(stream)
    pieces = [view[i:i + BLOCK] for i in range(0, len(stream), BLOCK)]
    with ThreadPoolExecutor(max_workers=THREADS) as pool:
        blocks = list(pool.map(_deflate, pieces))
    offsets = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([len(b) for b in blocks], out=offsets[1:])
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(EOF_BLOCK)
    return offsets


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec 5.3 reg2bin, vectorised over [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    todo = np.ones(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = todo & ((beg >> shift) == (end >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        todo &= ~hit
    return out


def bai_bytes(pos: np.ndarray, ref_end: np.ndarray, rec_start: np.ndarray,
              rec_end: np.ndarray, block_coffsets: np.ndarray,
              stream_len: int) -> bytes:
    """A .bai for one reference holding every record: leftmost positions
    `pos`, reference ends `ref_end`, and each record's start and end as
    offsets into the uncompressed stream of `stream_len` bytes, which was
    cut into BLOCK-byte blocks at `block_coffsets`.  The stream's end is
    the EOF block's start, as a reader's cursor there reads."""
    def voff(u):
        v = (block_coffsets[u // BLOCK] << 16) | (u % BLOCK)
        return np.where(u == stream_len, block_coffsets[-1] << 16, v)

    u, v = voff(rec_start), voff(rec_end)
    n = len(pos)
    bins = _reg2bin(pos, ref_end)
    order = np.lexsort((np.arange(n), bins))
    b_sorted = bins[order]
    brk = np.ones(n, bool)
    brk[1:] = (b_sorted[1:] != b_sorted[:-1]) | (np.diff(order) != 1)
    starts = np.nonzero(brk)[0]
    ends = np.append(starts[1:], n) - 1
    out = [b"BAI\x01", struct.pack("<i", 1)]
    uniq, first = np.unique(b_sorted[starts], return_index=True)
    out.append(struct.pack("<i", len(uniq)))
    bounds = np.append(first, len(starts))
    for k, bin_id in enumerate(uniq):
        cs = range(bounds[k], bounds[k + 1])
        out.append(struct.pack("<Ii", int(bin_id), len(cs)))
        chunk = np.empty((len(cs), 2), "<u8")
        chunk[:, 0] = u[order[starts[cs.start:cs.stop]]]
        chunk[:, 1] = v[order[ends[cs.start:cs.stop]]]
        out.append(chunk.tobytes())
    # Linear index: each 16 kb window's first record in file order.
    w_lo, w_hi = pos >> 14, (ref_end - 1) >> 14
    n_win = int(w_hi.max()) + 1 if n else 0
    first_rec = np.full(n_win, n, np.int64)
    idx = np.arange(n)
    for k in range(int((w_hi - w_lo).max()) + 1 if n else 0):
        sel = w_lo + k <= w_hi
        np.minimum.at(first_rec, w_lo[sel] + k, idx[sel])
    lin = np.zeros(n_win, np.uint64)
    have = first_rec < n
    lin[have] = u[first_rec[have]]
    last = np.maximum.accumulate(np.where(have, np.arange(n_win), -1))
    lin = np.where(last >= 0, lin[np.maximum(last, 0)], 0).astype("<u8")
    out.append(struct.pack("<i", n_win))
    out.append(lin.tobytes())
    return b"".join(out)


def write_bam(path: str, contig: str, contig_len: int, pos: np.ndarray,
              seq: np.ndarray, special: dict, qual: int, mapq: int,
              sample: str) -> None:
    """A coordinate-sorted single-end BAM of reads pos[n] / seq[n, L]
    (uint8 ASCII), all at base quality `qual` and mapping quality `mapq`,
    with read group rg1 of `sample`, and its .bai beside it.  Rows absent
    from `special` are single-M; special maps a row to its cigar
    [(op, length), ...]."""
    n, L = seq.shape
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
    template[12], template[13] = _NAME_LEN, mapq
    struct.pack_into("<H", template, 16, 1)
    struct.pack_into("<iii", template, 20, L, -1, -1)
    template[name_off] = ord("r")
    struct.pack_into("<I", template, cigar_off, L << 4)
    template[qual_off:qual_off + L] = qual
    template[qual_off + L:] = np.frombuffer(_AUX, np.uint8)

    codes = _SEQ_LUT[seq]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    ids = np.arange(n, dtype=np.int64)
    spec_rows = np.array(sorted(special), np.int64)
    sizes = np.full(n, 4 + rec_sz, np.int64)
    ref_end = pos + L
    for r in spec_rows:
        cig = special[int(r)]
        sizes[r] += 4 * (len(cig) - 1)
        ref_end[r] = pos[r] + sum(ln for op, ln in cig if _CONSUMES_REF[op])
    pieces = [head]
    chunk = 65536
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = np.broadcast_to(template, (hi - lo, len(template))).copy()
        block[:, 8:12] = pos[lo:hi].astype("<i4").view(np.uint8).reshape(-1, 4)
        block[:, 14:16] = _reg2bin(pos[lo:hi], ref_end[lo:hi]).astype(
            "<u2").view(np.uint8).reshape(-1, 2)
        for d in range(9):
            block[:, name_off + 1 + d] = (ids[lo:hi] // 10 ** (8 - d)) % 10 + 48
        block[:, seq_off:qual_off] = packed[lo:hi]
        prev = lo
        for r in spec_rows[np.searchsorted(spec_rows, lo):
                           np.searchsorted(spec_rows, hi)]:
            r = int(r)
            if r > prev:
                pieces.append(block[prev - lo:r - lo].tobytes())
            row = block[r - lo]
            cig = special[r]
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
    coffsets = write_bgzf(path, stream)
    with open(path + ".bai", "wb") as fh:
        fh.write(bai_bytes(pos, ref_end, rec_start, rec_start + sizes,
                           coffsets, len(stream)))


def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 60) -> None:
    """FASTA of one contig (uint8 ASCII), `width` bases a line, and its .fai."""
    n = len(seq)
    full = n // width * width
    body = np.concatenate([seq[:full].reshape(-1, width),
                           np.full((n // width, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as fh:
        head = f">{name}\n".encode()
        fh.write(head)
        fh.write(body.tobytes())
        if n > full:
            fh.write(seq[full:].tobytes() + b"\n")
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{n}\t{len(head)}\t{width}\t{width + 1}\n")
