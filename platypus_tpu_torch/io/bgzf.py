"""BGZF (blocked gzip) reader.

BAM, bgzipped VCF and tabix indices all live in BGZF containers: a series of
independent gzip members, each at most 64 KiB uncompressed, whose compressed
size is recorded in a BC extra subfield.  Random access uses *virtual file
offsets*: (compressed_block_offset << 16) | within_block_offset.

The reference caller gets this from htslib; here it is a small pure-Python
layer (decompression itself is zlib C code, so throughput is fine for the
host-side I/O plane).  Equivalent role: htslib's bgzf.c as used via
Platypus src/cython/htslibWrapper.pyx.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

_BGZF_MAGIC = b"\x1f\x8b\x08\x04"
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BGZFError(ValueError):
    pass


def _parse_block_header(header: bytes) -> int:
    """Return the total compressed block size (BSIZE+1) from an 18-byte
    BGZF block header."""
    if header[:4] != _BGZF_MAGIC:
        raise BGZFError("not a BGZF block (bad magic)")
    xlen = struct.unpack_from("<H", header, 10)[0]
    # Scan extra subfields for BC.
    extra = header[12 : 12 + xlen]
    i = 0
    while i + 4 <= len(extra):
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:
            bsize = struct.unpack_from("<H", extra, i + 4)[0]
            return bsize + 1
        i += 4 + slen
    raise BGZFError("BGZF block missing BC subfield")


class BGZFReader:
    """Streaming + random-access reader over a BGZF file.

    `read(n)` consumes from the current virtual position; `seek_virtual(v)`
    jumps to a virtual offset (used by .bai/.tbi index lookups).
    """

    def __init__(self, filename: str):
        self.filename = filename
        self._fh = open(filename, "rb")
        self._block_coffset = 0      # compressed offset of the cached block
        self._block_data = b""       # decompressed contents of cached block
        self._block_clen = 0         # compressed length of cached block
        self._within = 0             # cursor within the cached block
        self._load_block(0)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _load_block(self, coffset: int) -> bool:
        """Decompress the block starting at compressed offset `coffset`.
        Returns False at EOF."""
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) == 0:
            self._block_coffset = coffset
            self._block_data = b""
            self._block_clen = 0
            self._within = 0
            return False
        if len(header) < 18:
            raise BGZFError("truncated BGZF block header")
        bsize = _parse_block_header(header)
        payload = self._fh.read(bsize - 18)
        if len(payload) < bsize - 18:
            raise BGZFError("truncated BGZF block payload")
        # Payload layout: deflate data ... crc32(4) isize(4)
        cdata = payload[:-8]
        self._block_data = zlib.decompress(cdata, wbits=-15)
        self._block_coffset = coffset
        self._block_clen = bsize
        self._within = 0
        return True

    @property
    def virtual_offset(self) -> int:
        # Normalise an at-end-of-block cursor to the NEXT block's start:
        # BGZF allows 65536-byte uncompressed blocks (e.g. Biopython's
        # writer; htslib caps at 0xFF00), and (coffset << 16) | 65536 would
        # overflow the 16-bit within field into the compressed offset,
        # writing corrupt chunk starts into any .bai/.tbi built from it.
        if self._within == len(self._block_data) and self._block_clen:
            return (self._block_coffset + self._block_clen) << 16
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        within = voffset & 0xFFFF
        if coffset != self._block_coffset or not self._block_data:
            if not self._load_block(coffset):
                raise BGZFError(f"seek past EOF (voffset={voffset:#x})")
        if within > len(self._block_data):
            # A corrupt index voffset would otherwise make read()'s avail
            # negative and silently return bytes from the wrong position.
            raise BGZFError(
                f"voffset {voffset:#x} points beyond its block "
                f"({within} > {len(self._block_data)})")
        self._within = within

    def read(self, n: int) -> bytes:
        """Read exactly n decompressed bytes (fewer only at EOF)."""
        out = bytearray()
        while n > 0:
            avail = len(self._block_data) - self._within
            if avail == 0:
                nxt = self._block_coffset + self._block_clen
                if not self._load_block(nxt):
                    break
                # Skip zero-length blocks (incl. the EOF marker block).
                continue
            take = min(avail, n)
            out += self._block_data[self._within : self._within + take]
            self._within += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        """Decompress the whole file from the current position."""
        chunks = []
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks)


class BGZFWriter:
    """Minimal BGZF writer (used to produce test fixtures and bgzip output)."""

    def __init__(self, filename: str, level: int = 6):
        self._fh = open(filename, "wb")
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= 0xFF00:
            self._flush_block(self._buf[:0xFF00])
            del self._buf[:0xFF00]

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(data)) + co.flush()
        crc = zlib.crc32(bytes(data)) & 0xFFFFFFFF
        bsize = len(cdata) + 18 + 8
        header = (
            _BGZF_MAGIC
            + b"\x00\x00\x00\x00\x00\xff\x06\x00"
            + b"BC\x02\x00"
            + struct.pack("<H", bsize - 1)
        )
        self._fh.write(header + cdata + struct.pack("<II", crc, len(data) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(EOF_MARKER)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
