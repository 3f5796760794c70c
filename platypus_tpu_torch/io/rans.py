"""rANS 4x8 entropy codec (CRAM external compression method 4).

Static-frequency range asymmetric numeral system coder with four
interleaved 32-bit states and byte-wise renormalisation, 12-bit frequency
precision — the byte-stream format htslib's rans_static.c produces inside
CRAM 3.0 blocks (reference reads CRAM through htslib,
htslibWrapper.pyx:143-173; this module plus io/cram.py replace that
dependency with an own decoder).

Layout: 1 byte order (0|1), uint32le compressed size (bytes after this
9-byte header), uint32le uncompressed size, frequency table(s), then four
little-endian initial states followed by the renormalisation byte stream.

Decoding supports order-0 and order-1; encoding (used by the CRAM writer
and the codec round-trip tests) emits order-0.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT  # 4096
RANS_BYTE_L = 1 << 23


# ---------------------------------------------------------------------------
# Frequency tables
# ---------------------------------------------------------------------------

def _read_freq(data: bytes, p: int) -> Tuple[int, int]:
    f = data[p]
    p += 1
    if f >= 128:
        f = ((f & 127) << 8) | data[p]
        p += 1
    return f, p


def _write_freq(out: bytearray, f: int) -> None:
    if f < 128:
        out.append(f)
    else:
        out.append(128 | (f >> 8))
        out.append(f & 0xFF)


def _read_symbol_table(data: bytes, p: int) -> Tuple[List[int], int]:
    """Order-0 style RLE symbol/frequency table -> (freq[256], new offset).

    Symbols appear in increasing order; a symbol equal to prev+1 starts a
    run whose extra length is the next byte.  A 0 'next symbol' terminates
    (symbol 0, if present, is always first)."""
    freqs = [0] * 256
    j = data[p]
    p += 1
    last = -2
    rle = 0
    while True:
        f, p = _read_freq(data, p)
        freqs[j] = f
        if rle > 0:
            rle -= 1
            j += 1
        else:
            last = j
            j = data[p]
            p += 1
            if j == last + 1:
                rle = data[p]
                p += 1
            if j == 0:
                break
    return freqs, p


def _write_symbol_table(out: bytearray, freqs: List[int]) -> None:
    syms = [s for s in range(256) if freqs[s] > 0]
    i = 0
    last = -2
    rle = 0
    while i < len(syms):
        s = syms[i]
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if s == last + 1:
                # Length of the consecutive run that follows.
                run = 0
                while i + 1 + run < len(syms) and syms[i + 1 + run] == s + 1 + run:
                    run += 1
                out.append(run)
                rle = run
        _write_freq(out, freqs[s])
        last = s
        i += 1
    out.append(0)


def _normalise(counts: List[int]) -> List[int]:
    total = sum(counts)
    if total == 0:
        return counts
    freqs = [0] * 256
    for s, c in enumerate(counts):
        if c:
            freqs[s] = max(1, (c * TOTFREQ) // total)
    # Fix the rounding remainder on the most frequent symbol.
    excess = sum(freqs) - TOTFREQ
    top = max(range(256), key=lambda s: freqs[s])
    freqs[top] -= excess
    if freqs[top] <= 0:
        raise ValueError("cannot normalise frequency table")
    return freqs


# ---------------------------------------------------------------------------
# Order-0
# ---------------------------------------------------------------------------

def encode_order0(data: bytes) -> bytes:
    """rANS 4x8 order-0 compress (matches the rans_static.c stream layout)."""
    n = len(data)
    body = bytearray()
    if n:
        counts = [0] * 256
        for b in data:
            counts[b] += 1
        freqs = _normalise(counts)
        cum = [0] * 257
        for s in range(256):
            cum[s + 1] = cum[s] + freqs[s]
        _write_symbol_table(body, freqs)

        # Encode back-to-front; position p uses state p & 3.  Renorm bytes
        # are emitted backwards, so collect and reverse.
        states = [RANS_BYTE_L] * 4
        rev: List[int] = []
        for p in range(n - 1, -1, -1):
            s = data[p]
            f, c = freqs[s], cum[s]
            x = states[p & 3]
            x_max = f << 19  # ((L >> 12) << 8) * f
            while x >= x_max:
                rev.append(x & 0xFF)
                x >>= 8
            states[p & 3] = ((x // f) << TF_SHIFT) + (x % f) + c
        # Flush states 3..0 (4 LE bytes each, also written backwards).
        for j in (3, 2, 1, 0):
            x = states[j]
            for shift in (24, 16, 8, 0):
                rev.append((x >> shift) & 0xFF)
        body.extend(reversed(rev))
    return b"\x00" + struct.pack("<II", len(body), n) + bytes(body)


def _decode_order0(data: bytes, p: int, out_sz: int) -> bytes:
    freqs, p = _read_symbol_table(data, p)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    if cum[256] != TOTFREQ:
        raise ValueError("rANS order-0 frequencies do not sum to 4096")
    # Slot -> symbol lookup.
    lut = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            lut[cum[s] : cum[s + 1]] = bytes([s]) * freqs[s]

    states = list(struct.unpack_from("<IIII", data, p))
    p += 16
    out = bytearray(out_sz)
    L = RANS_BYTE_L
    mask = TOTFREQ - 1
    nd = len(data)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        m = x & mask
        s = lut[m]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
        while x < L and p < nd:
            x = (x << 8) | data[p]
            p += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# Order-1
# ---------------------------------------------------------------------------

def _decode_order1(data: bytes, p: int, out_sz: int) -> bytes:
    # Outer RLE over contexts, inner order-0 style table per context.
    freqs = [[0] * 256 for _ in range(256)]
    cums = [None] * 256
    luts = [None] * 256
    i = data[p]
    p += 1
    last = -2
    rle = 0
    while True:
        f, p = _read_symbol_table(data, p)
        freqs[i] = f
        cum = [0] * 257
        for s in range(256):
            cum[s + 1] = cum[s] + f[s]
        if cum[256] != TOTFREQ:
            raise ValueError("rANS order-1 frequencies do not sum to 4096")
        cums[i] = cum
        lut = bytearray(TOTFREQ)
        for s in range(256):
            if f[s]:
                lut[cum[s] : cum[s + 1]] = bytes([s]) * f[s]
        luts[i] = lut
        if rle > 0:
            rle -= 1
            i += 1
        else:
            last = i
            i = data[p]
            p += 1
            if i == last + 1:
                rle = data[p]
                p += 1
            if i == 0:
                break

    states = list(struct.unpack_from("<IIII", data, p))
    p += 16
    out = bytearray(out_sz)
    L = RANS_BYTE_L
    mask = TOTFREQ - 1
    nd = len(data)
    isz4 = out_sz >> 2
    ctx = [0, 0, 0, 0]
    for i in range(isz4):
        for j in range(4):
            x = states[j]
            m = x & mask
            c = ctx[j]
            s = luts[c][m]
            out[j * isz4 + i] = s
            x = freqs[c][s] * (x >> TF_SHIFT) + m - cums[c][s]
            while x < L and p < nd:
                x = (x << 8) | data[p]
                p += 1
            states[j] = x
            ctx[j] = s
    # Remainder handled by state 3.
    x = states[3]
    c = ctx[3]
    for i in range(4 * isz4, out_sz):
        m = x & mask
        s = luts[c][m]
        out[i] = s
        x = freqs[c][s] * (x >> TF_SHIFT) + m - cums[c][s]
        while x < L and p < nd:
            x = (x << 8) | data[p]
            p += 1
        c = s
    return bytes(out)


def decode(data: bytes) -> bytes:
    """Decompress one rANS 4x8 stream (order-0 or order-1)."""
    if len(data) < 9:
        raise ValueError("truncated rANS stream")
    order = data[0]
    _comp_sz, out_sz = struct.unpack_from("<II", data, 1)
    if out_sz == 0:
        return b""
    if order == 0:
        return _decode_order0(data, 9, out_sz)
    if order == 1:
        return _decode_order1(data, 9, out_sz)
    raise ValueError(f"unknown rANS order {order}")
