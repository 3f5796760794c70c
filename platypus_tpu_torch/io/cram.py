"""CRAM 3.0 reader + writer.

The reference opens CRAM transparently through htslib
(htslibWrapper.pyx:143-173); this module is an own implementation of the
container format so `--bamFiles` accepts `.cram` with no htslib
dependency: ITF8/LTF8 varints, block compression (raw/gzip/bzip2/lzma/
rANS-4x8 via io/rans.py), the CRAM encoding set (EXTERNAL, HUFFMAN,
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA, GAMMA, SUBEXP), slice/record
decode with reference-based sequence reconstruction, and `.crai` index
queries.  Decoded records are re-packed as raw BAM record blobs and fed
through bam._parse_records so fetch semantics (overlap test, soft-clip
pos adjustment, missing-qual skip, RG lookup) are byte-identical to the
BAM path.

The writer emits spec-compliant CRAM 3.0 (single slice per container,
external-only encodings, gzip/rANS block compression, `.crai` sidecar)
and exists for fixtures/tooling — the reference itself never writes CRAM.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import rans
from .bam import ReadSet, _parse_records, empty_read_set

CRAM_MAGIC = b"CRAM"

# Block compression methods.
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
# Block content types.
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, EXTERNAL_DATA, CORE_DATA = 0, 1, 2, 4, 5
# Encoding codec ids.
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP = 0, 1, 2, 3, 4, 5
E_BETA, E_SUBEXP, E_GOLOMB_RICE, E_GAMMA = 6, 7, 8, 9

# CRAM record flags (CF).
CF_QUAL_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_UNKNOWN_BASES = 0x8
# Mate flags (MF).
MF_MATE_REVERSE = 0x1
MF_MATE_UNMAPPED = 0x2

# BAM flag bits restored from mate info.
BAM_FUNMAP = 0x4
BAM_FMUNMAP = 0x8
BAM_FREVERSE = 0x10
BAM_FMREVERSE = 0x20

_EOF_V3 = bytes.fromhex(
    "0f000000ffffffff0fe0454f460000000001000" "5bdd94f0001000606010001000100ee63014b"
)

_BASES = b"ACGTN"


# ---------------------------------------------------------------------------
# Varints
# ---------------------------------------------------------------------------

class ByteStream:
    __slots__ = ("data", "p")

    def __init__(self, data: bytes, p: int = 0):
        self.data = data
        self.p = p

    def read(self, n: int) -> bytes:
        b = self.data[self.p : self.p + n]
        if len(b) < n:
            raise EOFError("truncated CRAM stream")
        self.p += n
        return b

    def byte(self) -> int:
        b = self.data[self.p]
        self.p += 1
        return b

    def itf8(self) -> int:
        d = self.data
        p = self.p
        b0 = d[p]
        if b0 < 0x80:
            self.p = p + 1
            v = b0
        elif b0 < 0xC0:
            self.p = p + 2
            v = ((b0 & 0x3F) << 8) | d[p + 1]
        elif b0 < 0xE0:
            self.p = p + 3
            v = ((b0 & 0x1F) << 16) | (d[p + 1] << 8) | d[p + 2]
        elif b0 < 0xF0:
            self.p = p + 4
            v = ((b0 & 0x0F) << 24) | (d[p + 1] << 16) | (d[p + 2] << 8) | d[p + 3]
        else:
            self.p = p + 5
            v = (
                ((b0 & 0x0F) << 28)
                | (d[p + 1] << 20)
                | (d[p + 2] << 12)
                | (d[p + 3] << 4)
                | (d[p + 4] & 0x0F)
            )
        # ITF8 is a 32-bit two's-complement value.
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        d = self.data
        p = self.p
        b0 = d[p]
        n_extra = 0
        mask = 0x80
        while n_extra < 8 and (b0 & mask):
            n_extra += 1
            mask >>= 1
        if n_extra < 8:
            v = b0 & (0xFF >> n_extra)
        else:
            v = 0
        for i in range(n_extra):
            v = (v << 8) | d[p + 1 + i]
        self.p = p + 1 + n_extra
        return v - (1 << 64) if v >= (1 << 63) else v

    def array(self) -> List[int]:
        n = self.itf8()
        return [self.itf8() for _ in range(n)]


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes(
        [
            0xF0 | ((v >> 28) & 0x0F),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def ltf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    # n extra bytes hold (7 - n) + 8n value bits (n leading ones + a zero
    # separator in the head byte).
    for n in range(1, 9):
        bits = (8 - (n + 1)) + 8 * n if n < 8 else 64
        if v < (1 << bits):
            prefix = (0xFF << (8 - n)) & 0xFF
            if n < 8:
                head = prefix | (v >> (8 * n))
                body = [(v >> (8 * (n - 1 - i))) & 0xFF for i in range(n)]
            else:
                head = 0xFF
                body = [(v >> (8 * (7 - i))) & 0xFF for i in range(8)]
            return bytes([head] + body)
    raise ValueError("LTF8 overflow")


# ---------------------------------------------------------------------------
# Core bit stream
# ---------------------------------------------------------------------------

class BitReader:
    __slots__ = ("data", "p", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.p = 0
        self.bit = 7

    def read_bit(self) -> int:
        b = (self.data[self.p] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.p += 1
        else:
            self.bit -= 1
        return b

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


# ---------------------------------------------------------------------------
# Block (de)compression
# ---------------------------------------------------------------------------

def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return gzip.decompress(data)
    if method == BZIP2:
        return bz2.decompress(data)
    if method == LZMA:
        return lzma.decompress(data)
    if method == RANS:
        return rans.decode(data)
    raise ValueError(f"unsupported CRAM block compression method {method}")


def _compress(method: int, data: bytes) -> bytes:
    if method == RAW:
        return data
    if method == GZIP:
        return gzip.compress(data, 6)
    if method == RANS:
        return rans.encode_order0(data)
    raise ValueError(f"writer does not emit method {method}")


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # uncompressed

    @classmethod
    def parse(cls, s: ByteStream) -> "Block":
        method = s.byte()
        content_type = s.byte()
        content_id = s.itf8()
        comp_size = s.itf8()
        raw_size = s.itf8()
        payload = s.read(comp_size)
        s.read(4)  # CRC32 (unchecked on read)
        data = _decompress(method, payload, raw_size)
        if method != RAW and len(data) != raw_size:
            # A truncated/corrupt stream must fail loudly — the rANS
            # decoder in particular would otherwise return plausible
            # garbage (its renorm loop just stops consuming at EOF).
            raise ValueError(
                f"CRAM block decompressed to {len(data)} bytes, header "
                f"says {raw_size}")
        return cls(method, content_type, content_id, data)

    def serialise(self) -> bytes:
        comp = _compress(self.method, self.data)
        head = (
            bytes([self.method, self.content_type])
            + itf8_encode(self.content_id)
            + itf8_encode(len(comp))
            + itf8_encode(len(self.data))
        )
        body = head + comp
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: List[int]
    header_size: int  # bytes consumed by this header


def _parse_container_header(s: ByteStream) -> ContainerHeader:
    p0 = s.p
    (length,) = struct.unpack_from("<i", s.data, s.p)
    s.p += 4
    ref_id = s.itf8()
    start = s.itf8()
    span = s.itf8()
    n_records = s.itf8()
    record_counter = s.ltf8()
    bases = s.ltf8()
    n_blocks = s.itf8()
    landmarks = s.array()
    s.read(4)  # CRC32
    return ContainerHeader(length, ref_id, start, span, n_records,
                           record_counter, bases, n_blocks, landmarks,
                           s.p - p0)


def _container_bytes(ref_id: int, start: int, span: int, n_records: int,
                     record_counter: int, bases: int,
                     block_bytes: List[bytes],
                     landmarks: Optional[List[int]] = None) -> bytes:
    if landmarks is None:
        landmarks = []
    blob = b"".join(block_bytes)
    head = (
        struct.pack("<i", len(blob))
        + itf8_encode(ref_id)
        + itf8_encode(start)
        + itf8_encode(span)
        + itf8_encode(n_records)
        + ltf8_encode(record_counter)
        + ltf8_encode(bases)
        + itf8_encode(len(block_bytes))
        + itf8_encode(len(landmarks))
        + b"".join(itf8_encode(x) for x in landmarks)
    )
    head += struct.pack("<I", zlib.crc32(head) & 0xFFFFFFFF)
    return head + blob


# ---------------------------------------------------------------------------
# Encodings
# ---------------------------------------------------------------------------

def _parse_encoding(s: ByteStream):
    """Encoding spec -> (codec_id, params tuple)."""
    codec = s.itf8()
    n = s.itf8()
    sub = ByteStream(s.read(n))
    if codec == E_NULL:
        return (E_NULL,)
    if codec == E_EXTERNAL:
        return (E_EXTERNAL, sub.itf8())
    if codec == E_HUFFMAN:
        symbols = sub.array()
        lengths = sub.array()
        return (E_HUFFMAN, symbols, lengths)
    if codec == E_BYTE_ARRAY_LEN:
        len_enc = _parse_encoding(sub)
        val_enc = _parse_encoding(sub)
        return (E_BYTE_ARRAY_LEN, len_enc, val_enc)
    if codec == E_BYTE_ARRAY_STOP:
        stop = sub.byte()
        cid = sub.itf8()
        return (E_BYTE_ARRAY_STOP, stop, cid)
    if codec == E_BETA:
        offset = sub.itf8()
        nbits = sub.itf8()
        return (E_BETA, offset, nbits)
    if codec == E_GAMMA:
        return (E_GAMMA, sub.itf8())
    if codec == E_SUBEXP:
        offset = sub.itf8()
        k = sub.itf8()
        return (E_SUBEXP, offset, k)
    raise ValueError(f"unsupported CRAM encoding codec {codec}")


class _Huffman:
    """Canonical Huffman decoder over the core bit stream.  The ubiquitous
    single-symbol/zero-bit case reads nothing."""

    def __init__(self, symbols: List[int], lengths: List[int]):
        if len(symbols) == 1 and lengths[0] == 0:
            self.single: Optional[int] = symbols[0]
            return
        self.single = None
        order = sorted(range(len(symbols)), key=lambda i: (lengths[i], symbols[i]))
        code = 0
        prev_len = 0
        # (length, code) -> symbol
        self.table: Dict[Tuple[int, int], int] = {}
        for i in order:
            L = lengths[i]
            code <<= L - prev_len
            prev_len = L
            self.table[(L, code)] = symbols[i]
            code += 1
        self.max_len = max(lengths)

    def read(self, core: BitReader) -> int:
        if self.single is not None:
            return self.single
        code = 0
        for L in range(1, self.max_len + 1):
            code = (code << 1) | core.read_bit()
            hit = self.table.get((L, code))
            if hit is not None:
                return hit
        raise ValueError("invalid Huffman code in CRAM core stream")


class Codec:
    """Reader for one data series, bound to the slice's streams."""

    def __init__(self, spec, external: Dict[int, ByteStream], core: BitReader):
        self.spec = spec
        self.external = external
        self.core = core
        if spec[0] == E_HUFFMAN:
            self.huff = _Huffman(spec[1], spec[2])
        elif spec[0] == E_BYTE_ARRAY_LEN:
            self.len_codec = Codec(spec[1], external, core)
            self.val_codec = Codec(spec[2], external, core)

    def _ext(self, cid: int) -> ByteStream:
        try:
            return self.external[cid]
        except KeyError:
            raise ValueError(f"CRAM slice lacks external block {cid}") from None

    def read_int(self) -> int:
        t = self.spec[0]
        if t == E_EXTERNAL:
            return self._ext(self.spec[1]).itf8()
        if t == E_HUFFMAN:
            return self.huff.read(self.core)
        if t == E_BETA:
            return self.core.read_bits(self.spec[2]) - self.spec[1]
        if t == E_GAMMA:
            n = 0
            while self.core.read_bit() == 0:
                n += 1
            v = (1 << n) | self.core.read_bits(n)
            return v - self.spec[1]
        if t == E_SUBEXP:
            offset, k = self.spec[1], self.spec[2]
            n = 0
            while self.core.read_bit() == 1:
                n += 1
            b = k if n == 0 else n + k - 1
            u = self.core.read_bits(b)
            v = u if n == 0 else (1 << b) | u
            return v - offset
        raise ValueError(f"encoding {t} cannot produce ints")

    def read_byte(self) -> int:
        t = self.spec[0]
        if t == E_EXTERNAL:
            return self._ext(self.spec[1]).byte()
        if t == E_HUFFMAN:
            return self.huff.read(self.core)
        if t == E_BETA:
            return self.core.read_bits(self.spec[2]) - self.spec[1]
        raise ValueError(f"encoding {t} cannot produce bytes")

    def read_bytes(self) -> bytes:
        t = self.spec[0]
        if t == E_BYTE_ARRAY_LEN:
            n = self.len_codec.read_int()
            return self.val_codec.read_array(n)
        if t == E_BYTE_ARRAY_STOP:
            stop, cid = self.spec[1], self.spec[2]
            s = self._ext(cid)
            end = s.data.index(bytes([stop]), s.p)
            out = s.data[s.p : end]
            s.p = end + 1
            return out
        raise ValueError(f"encoding {t} cannot produce byte arrays")

    def read_array(self, n: int) -> bytes:
        t = self.spec[0]
        if t == E_EXTERNAL:
            return self._ext(self.spec[1]).read(n)
        return bytes(self.read_byte() for _ in range(n))


# ---------------------------------------------------------------------------
# Compression header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    ref_required: bool = True
    subst_matrix: bytes = b"\x1b\x1b\x1b\x1b\x1b"
    tag_lines: List[List[bytes]] = field(default_factory=lambda: [[]])
    data_series: Dict[bytes, tuple] = field(default_factory=dict)
    tag_encodings: Dict[int, tuple] = field(default_factory=dict)

    @classmethod
    def parse(cls, data: bytes) -> "CompressionHeader":
        s = ByteStream(data)
        hdr = cls(data_series={}, tag_encodings={})
        # Preservation map.
        _size = s.itf8()
        n = s.itf8()
        for _ in range(n):
            key = bytes(s.read(2))
            if key == b"RN":
                hdr.rn_preserved = bool(s.byte())
            elif key == b"AP":
                hdr.ap_delta = bool(s.byte())
            elif key == b"RR":
                hdr.ref_required = bool(s.byte())
            elif key == b"SM":
                hdr.subst_matrix = bytes(s.read(5))
            elif key == b"TD":
                blob = bytes(s.read(s.itf8()))
                lines = blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00")
                hdr.tag_lines = [
                    [line[i : i + 3] for i in range(0, len(line), 3)] for line in lines
                ] or [[]]
            else:
                raise ValueError(f"unknown preservation key {key!r}")
        # Data series encodings.
        _size = s.itf8()
        n = s.itf8()
        for _ in range(n):
            key = bytes(s.read(2))
            hdr.data_series[key] = _parse_encoding(s)
        # Tag encodings.
        _size = s.itf8()
        n = s.itf8()
        for _ in range(n):
            key = s.itf8()
            hdr.tag_encodings[key] = _parse_encoding(s)
        return hdr

    # Substitution decode LUT: ref base index (in ACGTN) x code -> base.
    def subst_lut(self) -> List[List[int]]:
        lut = [[ord("N")] * 4 for _ in range(5)]
        for r in range(5):
            byte = self.subst_matrix[r]
            alts = [b for i, b in enumerate(_BASES) if i != r]
            for slot, base in enumerate(alts):
                code = (byte >> (6 - 2 * slot)) & 3
                lut[r][code] = base
        return lut


@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int

    @classmethod
    def parse(cls, data: bytes) -> "SliceHeader":
        s = ByteStream(data)
        ref_id = s.itf8()
        start = s.itf8()
        span = s.itf8()
        n_records = s.itf8()
        record_counter = s.ltf8()
        n_blocks = s.itf8()
        content_ids = s.array()
        embedded_ref_id = s.itf8()
        # 16-byte MD5 + optional tags follow; unchecked.
        return cls(ref_id, start, span, n_records, record_counter, n_blocks,
                   content_ids, embedded_ref_id)


# ---------------------------------------------------------------------------
# Record decode
# ---------------------------------------------------------------------------

_BASE_TO_IDX = np.full(256, 4, np.uint8)
for _i, _b in enumerate(_BASES):
    _BASE_TO_IDX[_b] = _i

# CIGAR op codes (BAM numbering).
_OP_M, _OP_I, _OP_D, _OP_N, _OP_S, _OP_H, _OP_P = 0, 1, 2, 3, 4, 5, 6


@dataclass
class CramRecord:
    bam_flag: int = 0
    cram_flag: int = 0
    ref_id: int = -1
    read_len: int = 0
    pos: int = 0  # 1-based alignment start
    group: int = -1
    name: bytes = b""
    mate_flags: int = 0
    mate_ref_id: int = -1
    mate_pos: int = 0
    tlen: int = 0
    next_frag: int = -1
    tags: List[Tuple[bytes, bytes]] = field(default_factory=list)
    mapq: int = 0
    seq: bytes = b""
    qual: bytes = b""
    cigar: List[Tuple[int, int]] = field(default_factory=list)
    qual_over: Dict[int, int] = field(default_factory=dict)


def _decode_slice_records(
    comp: CompressionHeader,
    slc: SliceHeader,
    core: BitReader,
    external: Dict[int, ByteStream],
    ref_getter,
) -> List[CramRecord]:
    def codec(key: bytes) -> Optional[Codec]:
        spec = comp.data_series.get(key)
        return None if spec is None else Codec(spec, external, core)

    BF, CF, RI, RL, AP, RG = (codec(k) for k in (b"BF", b"CF", b"RI", b"RL", b"AP", b"RG"))
    RN, MF, NS, NP, TS, NF = (codec(k) for k in (b"RN", b"MF", b"NS", b"NP", b"TS", b"NF"))
    TL, FN, FC, FP, DL, BB = (codec(k) for k in (b"TL", b"FN", b"FC", b"FP", b"DL", b"BB"))
    QQ, BS, IN, SC, PD, HC = (codec(k) for k in (b"QQ", b"BS", b"IN", b"SC", b"PD", b"HC"))
    RS, MQ, BA, QS = (codec(k) for k in (b"RS", b"MQ", b"BA", b"QS"))
    tag_codecs = {k: Codec(v, external, core) for k, v in comp.tag_encodings.items()}
    slut = comp.subst_lut()

    records: List[CramRecord] = []
    prev_pos = slc.start  # AP delta baseline
    for _ in range(slc.n_records):
        r = CramRecord()
        r.bam_flag = BF.read_int()
        r.cram_flag = CF.read_int()
        r.ref_id = RI.read_int() if slc.ref_id == -2 else slc.ref_id
        r.read_len = RL.read_int()
        ap = AP.read_int()
        if comp.ap_delta:
            r.pos = prev_pos + ap
            prev_pos = r.pos
        else:
            r.pos = ap
        r.group = RG.read_int() if RG is not None else -1

        if comp.rn_preserved and RN is not None:
            r.name = RN.read_bytes()

        if r.cram_flag & CF_DETACHED:
            r.mate_flags = MF.read_int() if MF is not None else 0
            if not comp.rn_preserved and RN is not None:
                r.name = RN.read_bytes()
            r.mate_ref_id = NS.read_int()
            r.mate_pos = NP.read_int()
            r.tlen = TS.read_int()
            if r.mate_flags & MF_MATE_REVERSE:
                r.bam_flag |= BAM_FMREVERSE
            if r.mate_flags & MF_MATE_UNMAPPED:
                r.bam_flag |= BAM_FMUNMAP
        elif r.cram_flag & CF_MATE_DOWNSTREAM:
            r.next_frag = NF.read_int()

        tl = TL.read_int() if TL is not None else 0
        if 0 <= tl < len(comp.tag_lines):
            for tag3 in comp.tag_lines[tl]:
                key = (tag3[0] << 16) | (tag3[1] << 8) | tag3[2]
                r.tags.append((tag3, tag_codecs[key].read_bytes()))

        if not (r.bam_flag & BAM_FUNMAP):
            _decode_mapped(r, comp, slut, FN, FC, FP, DL, BB, QQ, BS, IN, SC,
                           PD, HC, RS, BA, ref_getter)
            r.mapq = MQ.read_int()
            if r.cram_flag & CF_QUAL_STORED:
                r.qual = QS.read_array(r.read_len)
            else:
                qual = bytearray(b"\xff" * r.read_len)
                for k, q in r.qual_over.items():
                    qual[k] = q
                r.qual = bytes(qual)
        else:
            if r.cram_flag & CF_UNKNOWN_BASES:
                r.seq = b"N" * r.read_len
            else:
                r.seq = BA.read_array(r.read_len)
            if r.cram_flag & CF_QUAL_STORED:
                r.qual = QS.read_array(r.read_len)
            else:
                r.qual = b"\xff" * r.read_len
        records.append(r)

    # Attach downstream mates (NF chains): restore mate info + flags.
    for i, r in enumerate(records):
        if r.next_frag >= 0:
            j = i + r.next_frag + 1
            if j < len(records):
                m = records[j]
                r.mate_ref_id, r.mate_pos = m.ref_id, m.pos
                m.mate_ref_id, m.mate_pos = r.ref_id, r.pos
                for a, b in ((r, m), (m, r)):
                    if b.bam_flag & BAM_FREVERSE:
                        a.bam_flag |= BAM_FMREVERSE
                    if b.bam_flag & BAM_FUNMAP:
                        a.bam_flag |= BAM_FMUNMAP
                # Template span: leftmost start to rightmost end.  The
                # one-base clamp matches htslib's bam_endpos for a
                # zero-reference-span mate (fully soft-clipped).
                r_end = r.pos + max(_ref_span(r.cigar), 1) - 1
                m_end = m.pos + max(_ref_span(m.cigar), 1) - 1
                left, right = min(r.pos, m.pos), max(r_end, m_end)
                span = right - left + 1
                if r.pos <= m.pos:
                    r.tlen, m.tlen = span, -span
                else:
                    r.tlen, m.tlen = -span, span
    return records


def _ref_span(cigar: List[Tuple[int, int]]) -> int:
    return sum(ln for op, ln in cigar if op in (_OP_M, _OP_D, _OP_N))


def _decode_mapped(r: CramRecord, comp, slut, FN, FC, FP, DL, BB, QQ, BS, IN,
                   SC, PD, HC, RS, BA, ref_getter) -> None:
    n_feat = FN.read_int()
    seq = bytearray(r.read_len)
    qual_over = {}
    cigar: List[Tuple[int, int]] = []
    read_i = 0  # 0-based position in read of next un-emitted base
    ref_i = r.pos  # 1-based reference position tracking read_i
    fpos = 0  # 1-based in-read feature position

    def emit(op: int, length: int) -> None:
        if length <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    def fill_match(upto: int) -> None:
        """Copy reference bases into read positions [read_i, upto)."""
        nonlocal read_i, ref_i
        n = upto - read_i
        if n <= 0:
            return
        chunk = ref_getter(r.ref_id, ref_i - 1, ref_i - 1 + n)
        seq[read_i : read_i + n] = chunk
        emit(_OP_M, n)
        read_i += n
        ref_i += n

    for _ in range(n_feat):
        code = FC.read_byte()
        fpos += FP.read_int()
        pos0 = fpos - 1  # 0-based read offset of this feature
        fill_match(pos0)
        ch = chr(code)
        if ch == "B":
            seq[pos0] = BA.read_byte()
            qual_over[pos0] = QS.read_byte() if QS is not None else 0xFF
            emit(_OP_M, 1)
            read_i += 1
            ref_i += 1
        elif ch == "X":
            sub_code = BS.read_byte()
            ref_base = ref_getter(r.ref_id, ref_i - 1, ref_i)[0]
            seq[pos0] = slut[_BASE_TO_IDX[ref_base]][sub_code]
            emit(_OP_M, 1)
            read_i += 1
            ref_i += 1
        elif ch == "I":
            ins = IN.read_bytes()
            seq[pos0 : pos0 + len(ins)] = ins
            emit(_OP_I, len(ins))
            read_i += len(ins)
        elif ch == "i":
            seq[pos0] = BA.read_byte()
            emit(_OP_I, 1)
            read_i += 1
        elif ch == "D":
            n = DL.read_int()
            emit(_OP_D, n)
            ref_i += n
        elif ch == "N":
            n = RS.read_int()
            emit(_OP_N, n)
            ref_i += n
        elif ch == "S":
            clip = SC.read_bytes()
            seq[pos0 : pos0 + len(clip)] = clip
            emit(_OP_S, len(clip))
            read_i += len(clip)
        elif ch == "H":
            emit(_OP_H, HC.read_int())
        elif ch == "P":
            emit(_OP_P, PD.read_int())
        elif ch == "b":
            stretch = BB.read_bytes()
            seq[pos0 : pos0 + len(stretch)] = stretch
            emit(_OP_M, len(stretch))
            read_i += len(stretch)
            ref_i += len(stretch)
        elif ch == "q":
            quals = QQ.read_bytes()
            for k, q in enumerate(quals):
                qual_over[pos0 + k] = q
        elif ch == "Q":
            qual_over[pos0] = QS.read_byte()
        else:
            raise ValueError(f"unknown CRAM feature code {ch!r}")
    fill_match(r.read_len)
    r.seq = bytes(seq)
    r.cigar = cigar
    r.qual_over = qual_over  # merged by the caller when quals not stored


# ---------------------------------------------------------------------------
# BAM record repack (feeds bam._parse_records for fetch-semantics parity)
# ---------------------------------------------------------------------------

_SEQ_NIBBLE = np.full(256, 15, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _SEQ_NIBBLE[_b] = _i


def _pack_bam_record(r: CramRecord, rg_name: Optional[bytes]) -> bytes:
    name = (r.name or b"*") + b"\x00"
    cigar_words = [(ln << 4) | op for op, ln in r.cigar]
    l_seq = len(r.seq)
    codes = _SEQ_NIBBLE[np.frombuffer(r.seq, np.uint8)]
    if l_seq % 2:
        codes = np.append(codes, 0)
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    body = struct.pack(
        "<iiBBHHHiiii",
        r.ref_id,
        r.pos - 1,
        len(name),
        r.mapq,
        0,
        len(cigar_words),
        r.bam_flag,
        l_seq,
        r.mate_ref_id,
        r.mate_pos - 1 if r.mate_pos > 0 else -1,
        r.tlen,
    )
    body += name + b"".join(struct.pack("<I", w) for w in cigar_words)
    body += packed + bytes(r.qual)
    if rg_name:
        body += b"RGZ" + rg_name + b"\x00"
    return body


# ---------------------------------------------------------------------------
# CRAI index
# ---------------------------------------------------------------------------

@dataclass
class CraiEntry:
    ref_id: int
    start: int  # 1-based alignment start of the slice
    span: int
    container_offset: int  # absolute byte offset of the container
    slice_offset: int  # landmark: offset of the slice header block
    slice_size: int


class CraiIndex:
    def __init__(self, filename: str):
        self.entries: List[CraiEntry] = []
        with gzip.open(filename, "rt") as fh:
            for line in fh:
                cols = line.split()
                if len(cols) >= 6:
                    self.entries.append(CraiEntry(*(int(c) for c in cols[:6])))

    def slices_for_region(self, ref_id: int, beg: int, end: int) -> List[CraiEntry]:
        """Entries whose slice overlaps 0-based [beg, end)."""
        return [
            e for e in self.entries
            if e.ref_id == ref_id and e.start - 1 < end and e.start - 1 + e.span > beg
        ]


def write_crai(filename: str, entries: Sequence[CraiEntry]) -> None:
    with gzip.open(filename, "wt") as fh:
        for e in entries:
            fh.write(f"{e.ref_id}\t{e.start}\t{e.span}\t{e.container_offset}"
                     f"\t{e.slice_offset}\t{e.slice_size}\n")


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class CramFile:
    """Random-access CRAM 3.0 reader with the BamFile fetch contract.

    `ref_file` (a FastaFile or path) supplies the reference for sequence
    reconstruction; slices with embedded references decode without it."""

    def __init__(self, filename: str, ref_file=None,
                 index_filename: Optional[str] = None):
        self.filename = filename
        # mmap, not read(): production CRAMs are tens of GB and the crai
        # path only needs ranged access; the page cache does the rest.
        import mmap as _mmap

        self._fh = open(filename, "rb")
        try:
            self._data = _mmap.mmap(self._fh.fileno(), 0,
                                    access=_mmap.ACCESS_READ)
        except (ValueError, OSError):  # zero-length or mmap-less FS
            self._data = self._fh.read()
        s = ByteStream(self._data)
        if s.read(4) != CRAM_MAGIC:
            raise ValueError(f"{filename}: not a CRAM file")
        self.major, self.minor = s.byte(), s.byte()
        if self.major != 3:
            raise ValueError(f"{filename}: unsupported CRAM version {self.major}.{self.minor}")
        s.read(20)  # file id
        # First container: SAM header block.
        ch = _parse_container_header(s)
        hs = ByteStream(self._data, s.p)
        hdr_block = Block.parse(hs)
        if hdr_block.content_type != FILE_HEADER:
            raise ValueError(f"{filename}: missing CRAM file-header block")
        hb = ByteStream(hdr_block.data)
        (text_len,) = struct.unpack_from("<i", hb.data, 0)
        self.header_text = hdr_block.data[4 : 4 + text_len].decode("latin-1")
        self._first_container = s.p + ch.length
        s.p = self._first_container

        self.references: List[Tuple[str, int]] = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                d = dict(c.split(":", 1) for c in line.split("\t")[1:] if ":" in c)
                self.references.append((d.get("SN", "?"), int(d.get("LN", 0))))
        self.ref_id: Dict[str, int] = {n: i for i, (n, _) in enumerate(self.references)}
        self.coordinate_sorted = True
        for line in self.header_text.splitlines():
            if line.startswith("@HD") and "\tSO:" in line:
                so = line.split("\tSO:", 1)[1].split("\t", 1)[0].strip()
                if so not in ("coordinate", "unknown", ""):
                    self.coordinate_sorted = False
        self._rg_ids: List[bytes] = [
            dict(c.split(":", 1) for c in line.split("\t")[1:] if ":" in c)
            .get("ID", "").encode()
            for line in self.header_text.splitlines() if line.startswith("@RG")
        ]

        self._ref_file = ref_file
        self._ref_cache: Dict[int, bytes] = {}
        self.index: Optional[CraiIndex] = None
        index_filename = index_filename or filename + ".crai"
        try:
            self.index = CraiIndex(index_filename)
        except (FileNotFoundError, OSError, ValueError):
            self.index = None

    # -- shared header helpers (same contract as BamFile) -------------------
    def close(self) -> None:
        if hasattr(self._data, "close"):
            try:
                self._data.close()
            except (BufferError, ValueError):
                pass
        self._data = b""
        fh = getattr(self, "_fh", None)
        if fh is not None:
            fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def header_dict(self) -> Dict[str, List[Dict[str, str]]]:
        out: Dict[str, List[Dict[str, str]]] = {}
        for line in self.header_text.splitlines():
            if not line.startswith("@"):
                continue
            cols = line[1:].split("\t")
            entry = {}
            for col in cols[1:]:
                if ":" in col:
                    k, v = col.split(":", 1)
                    entry[k] = v
            out.setdefault(cols[0], []).append(entry)
        return out

    def sample_names(self) -> List[str]:
        header = self.header_dict()
        samples = sorted({rg["SM"] for rg in header.get("RG", []) if "SM" in rg})
        if samples:
            return samples
        stem = self.filename.split("/")[-1]
        if stem.lower().endswith((".bam", ".cram")):
            stem = stem[:-5] if stem.lower().endswith(".cram") else stem[:-4]
        return [stem]

    # -- reference access ----------------------------------------------------
    def _ref_bases(self, ref_id: int, beg: int, end: int) -> bytes:
        """Uppercase reference bases for 0-based [beg, end)."""
        if ref_id < 0 or beg >= end:
            return b"N" * max(0, end - beg)
        seq = self._ref_cache.get(ref_id)
        if seq is None:
            if self._ref_file is None:
                raise ValueError(
                    f"{self.filename}: CRAM decode requires the reference FASTA"
                )
            ref = self._ref_file
            opened = False
            if isinstance(ref, str):
                from .fasta import FastaFile

                ref = FastaFile(ref)
                opened = True
            name, length = self.references[ref_id]
            seq = ref.get_sequence(name, 0, length).upper()
            self._ref_cache[ref_id] = seq
            if opened:
                ref.close()
        chunk = seq[beg:end]
        if len(chunk) < end - beg:
            chunk += b"N" * (end - beg - len(chunk))
        return chunk

    # -- container walk ------------------------------------------------------
    def _iter_containers(self):
        """Yield (offset, header, blocks_start) for data containers."""
        p = self._first_container
        while p + 4 <= len(self._data):
            if self._data[p : p + len(_EOF_V3)] == _EOF_V3:
                return
            s = ByteStream(self._data, p)
            ch = _parse_container_header(s)
            if ch.start == 4542278 and ch.ref_id == -1:
                return  # EOF container variant
            yield p, ch, s.p
            p = s.p + ch.length

    def _decode_slice(self, comp: CompressionHeader, slice_block_offset: int):
        """Parse one slice (header block + data blocks) -> CramRecords."""
        s = ByteStream(self._data, slice_block_offset)
        hdr_block = Block.parse(s)
        if hdr_block.content_type != SLICE_HEADER:
            raise ValueError("expected slice header block")
        slc = SliceHeader.parse(hdr_block.data)
        core: Optional[BitReader] = None
        external: Dict[int, ByteStream] = {}
        embedded_ref: Optional[bytes] = None
        for _ in range(slc.n_blocks):
            blk = Block.parse(s)
            if blk.content_type == CORE_DATA:
                core = BitReader(blk.data)
            elif blk.content_type == EXTERNAL_DATA:
                external[blk.content_id] = ByteStream(blk.data)
                if blk.content_id == slc.embedded_ref_id:
                    embedded_ref = blk.data
        if core is None:
            core = BitReader(b"")

        if embedded_ref is not None:
            ref_start = slc.start - 1

            def ref_getter(ref_id: int, beg: int, end: int) -> bytes:
                lo, hi = beg - ref_start, end - ref_start
                chunk = embedded_ref[max(0, lo) : max(0, hi)]
                if len(chunk) < end - beg:
                    # Pad on the side that is actually missing: N-prefix
                    # only for the part before the embedded block, N-suffix
                    # for an overrun past its end (padding the wrong side
                    # shifts every surviving base).
                    left_pad = max(0, -lo)
                    right_pad = (end - beg) - len(chunk) - left_pad
                    chunk = b"N" * left_pad + chunk + b"N" * max(0, right_pad)
                return chunk
        else:
            ref_getter = self._ref_bases
        return slc, _decode_slice_records(comp, slc, core, external, ref_getter)

    def _slice_offsets_in_container(self, ch: ContainerHeader,
                                    blocks_start: int) -> List[int]:
        # Landmarks point at slice header blocks (after the compression
        # header block, which is landmark-less at offset 0 by convention).
        offs = [blocks_start + lm for lm in ch.landmarks]
        return offs

    def fetch(self, chrom: str, start: int, end: int, store_rg: bool = False,
              use_native: bool = True) -> ReadSet:
        """All mapped records overlapping 0-based [start, end) as a ReadSet
        (same triage as BamFile.fetch: repacked records run through
        bam._parse_records)."""
        ref_id = self.ref_id.get(chrom)
        if ref_id is None:
            return empty_read_set()

        raw_records: List[bytes] = []
        if self.index is not None:
            wanted = self.index.slices_for_region(ref_id, start, end)
            by_container: Dict[int, List[int]] = {}
            for e in wanted:
                by_container.setdefault(e.container_offset, []).append(e.slice_offset)
            for c_off in sorted(by_container):
                s = ByteStream(self._data, c_off)
                ch = _parse_container_header(s)
                comp = CompressionHeader.parse(Block.parse(ByteStream(self._data, s.p)).data)
                for sl_off in sorted(set(by_container[c_off])):
                    _slc, recs = self._decode_slice(comp, s.p + sl_off)
                    self._collect(recs, ref_id, start, end, raw_records, store_rg)
        else:
            for _off, ch, blocks_start in self._iter_containers():
                if ch.ref_id >= 0 and ch.ref_id != ref_id:
                    continue
                if ch.ref_id >= 0 and ch.span > 0 and (
                    ch.start - 1 >= end or ch.start - 1 + ch.span <= start
                ):
                    continue
                comp = CompressionHeader.parse(
                    Block.parse(ByteStream(self._data, blocks_start)).data)
                for sl_off in self._slice_offsets_in_container(ch, blocks_start):
                    _slc, recs = self._decode_slice(comp, sl_off)
                    self._collect(recs, ref_id, start, end, raw_records, store_rg)

        return _parse_records(iter(raw_records), ref_id, start, end,
                              store_rg,
                              sorted_input=self.coordinate_sorted)

    def _collect(self, recs: List[CramRecord], ref_id: int, start: int,
                 end: int, out: List[bytes], store_rg: bool) -> None:
        for r in recs:
            # Placed-unmapped mates stay, like the BAM decoder (they carry
            # seq+qual and feed the broken-pair logic); only records with
            # no position at all are skipped.
            if r.ref_id != ref_id or (r.bam_flag & BAM_FUNMAP and r.pos < 0):
                continue
            rg = None
            if store_rg and 0 <= r.group < len(self._rg_ids):
                rg = self._rg_ids[r.group]
            out.append(_pack_bam_record(r, rg))


# ---------------------------------------------------------------------------
# Writer (fixtures / tooling)
# ---------------------------------------------------------------------------

def _encode_encoding(codec: int, params: bytes) -> bytes:
    return itf8_encode(codec) + itf8_encode(len(params)) + params


def _ext_enc(cid: int) -> bytes:
    return _encode_encoding(E_EXTERNAL, itf8_encode(cid))


def _stop_enc(stop: int, cid: int) -> bytes:
    return _encode_encoding(E_BYTE_ARRAY_STOP, bytes([stop]) + itf8_encode(cid))


def _len_enc(len_cid: int, val_cid: int) -> bytes:
    inner = _ext_enc(len_cid) + _ext_enc(val_cid)
    return _encode_encoding(E_BYTE_ARRAY_LEN, inner)


# Stable content-id assignment for the writer's external blocks.
_W_SERIES = [
    ("BF", "int"), ("CF", "int"), ("RL", "int"), ("AP", "int"), ("RG", "int"),
    ("MF", "int"), ("NS", "int"), ("NP", "int"), ("TS", "int"), ("TL", "int"),
    ("FN", "int"), ("FC", "byte"), ("FP", "int"), ("DL", "int"), ("BS", "byte"),
    ("PD", "int"), ("HC", "int"), ("RS", "int"), ("MQ", "int"), ("BA", "byte"),
    ("QS", "byte"), ("RI", "int"),
]
_W_BYTEARRAYS = ["RN", "IN", "SC", "BB", "QQ"]


def _writer_compression_header() -> Tuple[bytes, Dict[str, int]]:
    cids: Dict[str, int] = {}
    nid = 1
    for name, _t in _W_SERIES:
        cids[name] = nid
        nid += 1
    for name in _W_BYTEARRAYS:
        cids[name] = nid
        cids[name + "_len"] = nid + 1
        nid += 2

    pres = bytearray()
    entries = [
        (b"RN", b"\x01"),
        (b"AP", b"\x00"),        # absolute positions
        (b"RR", b"\x01"),
        (b"SM", b"\x1b" * 5),    # identity substitution matrix
        (b"TD", itf8_encode(1) + b"\x00"),  # one empty tag line
    ]
    pres += itf8_encode(len(entries))
    for k, v in entries:
        pres += k + v

    ds = bytearray()
    ds_entries: List[Tuple[bytes, bytes]] = []
    for name, _t in _W_SERIES:
        ds_entries.append((name.encode(), _ext_enc(cids[name])))
    ds_entries.append((b"RN", _stop_enc(0x09, cids["RN"])))
    for name in ("IN", "SC", "BB", "QQ"):
        ds_entries.append((name.encode(), _len_enc(cids[name + "_len"], cids[name])))
    ds += itf8_encode(len(ds_entries))
    for k, v in ds_entries:
        ds += k + v

    tags = itf8_encode(0)

    body = (
        itf8_encode(len(pres)) + pres
        + itf8_encode(len(ds)) + ds
        + itf8_encode(len(tags)) + tags
    )
    return bytes(body), cids


def write_cram(
    filename: str,
    references: Sequence[Tuple[str, int]],
    reads: Sequence[dict],
    sample: str = "SAMPLE1",
    extra_header: str = "",
    ref_seqs: Optional[Dict[str, bytes]] = None,
    records_per_slice: int = 1000,
    write_index: bool = True,
) -> None:
    """Write coordinate-sorted CRAM 3.0 (+ .crai).  Read dicts use the
    write_bam schema: name, ref_id, pos (0-based), mapq, flag,
    cigar [(op, len)...], seq, qual, mate_ref_id, mate_pos, tlen.

    When `ref_seqs` maps contig name -> bytes, mapped reads are stored
    reference-compressed (match/mismatch features); otherwise every base
    is emitted verbatim ('b' features)."""
    header_text = "@HD\tVN:1.6\tSO:coordinate\n"
    for name, length in references:
        header_text += f"@SQ\tSN:{name}\tLN:{length}\n"
    header_text += f"@RG\tID:rg1\tSM:{sample}\n" + extra_header
    comp_body, cids = _writer_compression_header()

    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0]) + b"\x00" * 20

    ht = header_text.encode()
    hdr_block = Block(GZIP, FILE_HEADER, 0, struct.pack("<i", len(ht)) + ht)
    hb = hdr_block.serialise()
    out += _container_bytes(-1, 0, 0, 0, 0, 0, [hb])

    crai: List[CraiEntry] = []
    counter = 0
    for chunk_start in range(0, len(reads), records_per_slice):
        chunk = list(reads[chunk_start : chunk_start + records_per_slice])
        if not chunk:
            continue
        blocks, ref_id, start1, span, n_bases, extents = _encode_slice(
            chunk, cids, comp_body, ref_seqs, references, counter)
        comp_block = Block(RAW, COMPRESSION_HEADER, 0, comp_body).serialise()
        all_blocks = [comp_block] + blocks
        container_off = len(out)
        out += _container_bytes(ref_id, start1, span, len(chunk), counter,
                                n_bases, all_blocks,
                                landmarks=[len(comp_block)])
        slice_size = sum(len(b) for b in blocks)
        if ref_id == -2:
            # The crai spec requires one line PER REFERENCE for a
            # multi-reference slice — a single ref_id=-2 line matches no
            # query in slices_for_region and silently hides every read.
            for rid in sorted(extents):
                s1, e1 = extents[rid]
                crai.append(CraiEntry(rid, s1, e1 - s1 + 1, container_off,
                                      len(comp_block), slice_size))
        else:
            crai.append(CraiEntry(ref_id, start1, span, container_off,
                                  len(comp_block), slice_size))
        counter += len(chunk)

    out += _EOF_V3
    with open(filename, "wb") as fh:
        fh.write(out)
    if write_index:
        write_crai(filename + ".crai", crai)


def _encode_slice(chunk, cids, comp_body, ref_seqs, references, counter):
    streams: Dict[str, bytearray] = {k: bytearray() for k in cids}

    def put_int(name: str, v: int) -> None:
        streams[name] += itf8_encode(v)

    def put_byte(name: str, v: int) -> None:
        streams[name].append(v & 0xFF)

    def put_bytes(name: str, data: bytes) -> None:
        streams[name + "_len"] += itf8_encode(len(data))
        streams[name] += data

    ref_id = chunk[0]["ref_id"]
    multi_ref = any(rd["ref_id"] != ref_id for rd in chunk)
    if multi_ref:
        ref_id = -2
    starts = [rd["pos"] + 1 for rd in chunk]
    ends = []
    n_bases = 0
    extents: Dict[int, Tuple[int, int]] = {}  # ref -> (min start1, max end1)

    for rd in chunk:
        flag = rd.get("flag", 0)
        cf = CF_QUAL_STORED | CF_DETACHED
        put_int("BF", flag)
        put_int("CF", cf)
        if multi_ref:
            put_int("RI", rd["ref_id"])
        seq = bytes(rd["seq"])
        rl = len(seq)
        n_bases += rl
        put_int("RL", rl)
        put_int("AP", rd["pos"] + 1)
        put_int("RG", 0)
        streams["RN"] += rd["name"].encode() + b"\x09"
        mf = 0
        if flag & BAM_FMREVERSE:
            mf |= MF_MATE_REVERSE
        if flag & BAM_FMUNMAP:
            mf |= MF_MATE_UNMAPPED
        put_int("MF", mf)
        put_int("NS", rd.get("mate_ref_id", -1))
        put_int("NP", rd.get("mate_pos", -1) + 1)
        put_int("TS", rd.get("tlen", 0))
        put_int("TL", 0)

        if flag & BAM_FUNMAP:
            for b in seq:
                put_byte("BA", b)
            streams["QS"] += bytes(rd["qual"])
            ends.append(rd["pos"] + 1)
            continue

        ref_name = references[rd["ref_id"]][0]
        rseq = ref_seqs.get(ref_name) if ref_seqs else None
        feats = _features_for_read(rd, seq, rseq)
        put_int("FN", len(feats))
        last_fp = 0
        for fp, code, payload in feats:
            put_byte("FC", ord(code))
            put_int("FP", fp - last_fp)
            last_fp = fp
            if code == "X":
                put_byte("BS", payload)
            elif code == "B":
                put_byte("BA", payload[0])
                put_byte("QS", payload[1])
            elif code in ("I", "S", "b"):
                put_bytes({"I": "IN", "S": "SC", "b": "BB"}[code], payload)
            elif code == "D":
                put_int("DL", payload)
            elif code == "N":
                put_int("RS", payload)
            elif code == "H":
                put_int("HC", payload)
            elif code == "P":
                put_int("PD", payload)
        put_int("MQ", rd.get("mapq", 60))
        streams["QS"] += bytes(rd["qual"])
        rd_end = rd["pos"] + sum(
            ln for op, ln in rd["cigar"] if op in (_OP_M, _OP_D, _OP_N))
        ends.append(rd_end)
        rid = rd["ref_id"]
        s1, e1 = extents.get(rid, (1 << 62, -1))
        extents[rid] = (min(s1, rd["pos"] + 1), max(e1, rd_end))

    start1 = min(starts)
    span = max(ends) - start1 + 1 if ends else 0

    used = [k for k in streams if streams[k]]
    ids = sorted(cids[k] for k in used)
    slice_hdr = (
        itf8_encode(ref_id)
        + itf8_encode(start1 if ref_id != -2 else 0)
        + itf8_encode(span if ref_id != -2 else 0)
        + itf8_encode(len(chunk))
        + ltf8_encode(counter)
        + itf8_encode(1 + len(ids))  # core block + externals
        + itf8_encode(len(ids)) + b"".join(itf8_encode(i) for i in ids)
        + itf8_encode(-1)  # no embedded reference
        + b"\x00" * 16  # MD5 unchecked
    )

    blocks = [Block(RAW, SLICE_HEADER, 0, bytes(slice_hdr)).serialise(),
              Block(RAW, CORE_DATA, 0, b"").serialise()]
    for k in sorted(used, key=lambda k: cids[k]):
        data = bytes(streams[k])
        method = RANS if len(data) > 64 else GZIP
        try:
            blk = Block(method, EXTERNAL_DATA, cids[k], data)
            blocks.append(blk.serialise())
        except ValueError:
            blocks.append(Block(GZIP, EXTERNAL_DATA, cids[k], data).serialise())
    return blocks, ref_id, (start1 if ref_id != -2 else 0), (
        span if ref_id != -2 else 0), n_bases, extents


def _features_for_read(rd, seq: bytes, rseq: Optional[bytes]):
    """CRAM features for one mapped read: reference-compressed when the
    contig sequence is available, verbatim 'b' stretches otherwise."""
    feats = []  # (1-based read pos, code, payload)
    read_i = 0
    ref_i = rd["pos"]
    qual = rd["qual"]
    for op, ln in rd["cigar"]:
        if op in (_OP_M, 7, 8):  # M / = / X all consume read+ref alike
            if rseq is None:
                feats.append((read_i + 1, "b", seq[read_i : read_i + ln]))
            else:
                for k in range(ln):
                    rb = rseq[ref_i + k] if ref_i + k < len(rseq) else ord("N")
                    qb = seq[read_i + k]
                    if qb != (rb & ~0x20 if ord("a") <= rb <= ord("z") else rb):
                        # Substitution via the identity matrix when both are
                        # ACGT; otherwise verbatim base+qual.
                        r_idx = _BASE_TO_IDX[rb]
                        q_idx = _BASE_TO_IDX[qb]
                        if r_idx < 4 and q_idx < 4:
                            alts = [b for i, b in enumerate(_BASES) if i != r_idx]
                            feats.append((read_i + k + 1, "X", alts.index(qb)))
                        else:
                            feats.append((read_i + k + 1, "B",
                                          bytes([qb, qual[read_i + k]])))
            read_i += ln
            ref_i += ln
        elif op == _OP_I:
            feats.append((read_i + 1, "I", seq[read_i : read_i + ln]))
            read_i += ln
        elif op == _OP_S:
            feats.append((read_i + 1, "S", seq[read_i : read_i + ln]))
            read_i += ln
        elif op == _OP_D:
            feats.append((read_i + 1, "D", ln))
            ref_i += ln
        elif op == _OP_N:
            feats.append((read_i + 1, "N", ln))
            ref_i += ln
        elif op == _OP_H:
            feats.append((read_i + 1, "H", ln))
        elif op == _OP_P:
            feats.append((read_i + 1, "P", ln))
    return feats
