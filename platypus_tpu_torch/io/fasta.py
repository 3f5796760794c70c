"""Random-access FASTA reader driven by a samtools ``.fai`` index.

Mirrors the access pattern of the reference caller's FastaFile
(Platypus src/cython/fastafile.pyx): seek arithmetic from the .fai
line geometry, an explicit per-region sequence cache (set once per 100kb
region), upper-casing, and half-open [start, end) coordinates clamped to the
contig.  NCBI ``gi|...|ref|name|`` headers are normalised the same way
(fastafile.pyx:75-78).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class FastaIndexEntry:
    name: str
    length: int
    offset: int
    line_bases: int
    line_width: int


def _normalise_ncbi_name(name: str) -> str:
    # "gi|1234|ref|NC_000020.10|" -> "NC_000020.10"
    if name.startswith("gi|") and "|ref|" in name:
        tail = name.split("|ref|", 1)[1]
        return tail.strip("|")
    return name


class FastaFile:
    """``.fai``-indexed FASTA with a hot region cache."""

    def __init__(self, filename: str, index_filename: Optional[str] = None, parse_ncbi: bool = False):
        self.filename = filename
        index_filename = index_filename or filename + ".fai"
        if not os.path.exists(index_filename):
            raise FileNotFoundError(
                f"FASTA index {index_filename} not found; run 'samtools faidx' or "
                f"platypus_tpu_torch.io.fasta.build_index()"
            )
        self.refs: Dict[str, FastaIndexEntry] = {}
        with open(index_filename, "r") as fh:
            for line in fh:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 5:
                    continue
                name = _normalise_ncbi_name(cols[0]) if parse_ncbi else cols[0]
                self.refs[name] = FastaIndexEntry(
                    name=name,
                    length=int(cols[1]),
                    offset=int(cols[2]),
                    line_bases=int(cols[3]),
                    line_width=int(cols[4]),
                )
        self._fh = open(filename, "rb")
        self._cache: Optional[Tuple[str, int, int, bytes]] = None  # (name, start, end, seq)
        # The engine reads reference sequence from more than one thread
        # (the region pipeline's, and the local assembly on the prefetch
        # helper): the seek+read pair must be atomic.  The cache itself is
        # safe lock-free — readers snapshot the tuple, writers replace it
        # whole.
        self._io_lock = threading.Lock()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _read_raw(self, entry: FastaIndexEntry, start: int, end: int) -> bytes:
        """Read [start, end) of a contig straight from disk (no cache)."""
        if end <= start:
            return b""
        first_line = start // entry.line_bases
        first_col = start % entry.line_bases
        file_start = entry.offset + first_line * entry.line_width + first_col
        # Bytes on disk spanning the request, including newline overhead.
        last_line = (end - 1) // entry.line_bases
        last_col = (end - 1) % entry.line_bases
        file_end = entry.offset + last_line * entry.line_width + last_col + 1
        with self._io_lock:
            self._fh.seek(file_start)
            raw = self._fh.read(file_end - file_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").upper()

    def set_cache_sequence(self, name: str, start: int, end: int) -> None:
        """Cache one region's sequence (fastafile.pyx:141-171); subsequent
        get_sequence calls inside the cached span are memory slices."""
        entry = self.refs[name]
        start = max(0, start)
        end = min(end, entry.length - 1)
        if end <= start:
            self._cache = None
            return
        self._cache = (name, start, end, self._read_raw(entry, start, end))

    def get_sequence(self, name: str, start: int, end: int) -> bytes:
        """Upper-case sequence for the half-open interval [start, end).

        Bounds are clamped like the reference caller's reader
        (fastafile.pyx:174-191): start to 0, end to length-1 — i.e. the
        final base of a contig is never returned.  Haplotype construction
        near contig ends depends on this convention.
        """
        entry = self.refs[name]
        start = max(0, start)
        end = min(end, entry.length - 1)
        if end <= start:
            return b""
        cache = self._cache  # one read: another thread may replace it
        if cache is not None:
            cname, cstart, cend, cseq = cache
            if cname == name and start >= cstart and end <= cend:
                return cseq[start - cstart : end - cstart]
        return self._read_raw(entry, start, end)

    def get_character(self, name: str, pos: int) -> bytes:
        return self.get_sequence(name, pos, pos + 1)


def build_index(filename: str, index_filename: Optional[str] = None) -> None:
    """Write a standard .fai for a FASTA file (used by tests and the CLI when
    no samtools-made index exists)."""
    index_filename = index_filename or filename + ".fai"
    entries = []
    with open(filename, "rb") as fh:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_width = 0
        pos = 0
        for line in fh:
            llen = len(line)
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, line_bases, line_width))
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + llen
                line_bases = 0
                line_width = 0
            else:
                stripped = line.rstrip(b"\r\n")
                if line_bases == 0 and stripped:
                    line_bases = len(stripped)
                    line_width = llen
                length += len(stripped)
            pos += llen
        if name is not None:
            entries.append((name, length, offset, line_bases, line_width))
    with open(index_filename, "w") as out:
        for name, length, offset, line_bases, line_width in entries:
            out.write(f"{name}\t{length}\t{offset}\t{line_bases}\t{line_width}\n")
