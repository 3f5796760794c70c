"""The plain read QC: Platypus's checkAndTrimRead (cwindow.pyx:332-481),
read by read, over records decoded from a BAM.  It imports nothing of the
program and no JAX: plain Python and numpy.

check_and_trim(records, options) takes the records of one fetch in stream
order, each a dict of the fields a BAM record holds (flag, pos: the
leftmost aligned base less a leading soft clip, mapq, rlen, qual: the
quality bytes, cigar: [(op, length)], mate_ref, ref, mate_pos, tlen), and
returns each record's verdict, "good", "bad" (the mate-unmapped and
mate-distant filters: set aside, not failed) or "qcfail", with the
quality bytes after trimming, and the count of each filter.

The cascade, in order, each test on a record no earlier test took:
secondary (0x100; failed, not counted), MAPQ under min_map_qual, fewer
than min_good_qual_bases bases of quality >= min_base_qual, unmapped
(0x4), a paired record whose mate is unmapped (0x8; bad), a paired record
whose mate lies on another reference or that is not a proper pair (0x2
unset; bad), a paired record with a non-zero TLEN whose absolute value is
under its length (failed), and a duplicate: flagged 0x400, or at the same
position with the same length as the record before it in the stream and,
when paired, with the same mate position (failed).  A supplementary
record (0x800) is an ordinary one: Platypus reuses that bit.

Then, on the good records only, the trims zero qualities: the low-quality
tail (from the 3' end, qualities under 5, and trim_read_flank bases),
the overlapping part of a forward record whose reverse mate's fragment is
shorter than twice its length (its last min(len, 2 len - TLEN + 1)
bases), adapter read-through past a fragment shorter than the record
(bases TLEN onward), and the soft-clipped bases.
"""

from __future__ import annotations

import gzip
import struct

PAIRED, PROPER, UNMAP, MUNMAP = 0x1, 0x2, 0x4, 0x8
REVERSE, MREVERSE, SECONDARY, DUP = 0x10, 0x20, 0x100, 0x400
M, INS, SOFT = 0, 1, 4

FILTERS = ("low_map_qual", "low_qual_bases", "unmapped", "mate_unmapped",
           "mate_distant", "small_insert", "duplicate")

DEFAULTS = dict(min_map_qual=20, min_base_qual=20, min_good_qual_bases=20,
                trim_read_flank=0, trim_overlapping=1, trim_adapter=1,
                trim_soft_clipped=1, filter_duplicates=1,
                filter_reads_with_unmapped_mates=1,
                filter_reads_with_distant_mates=1,
                filter_read_pairs_with_small_inserts=1)


def _verdict(rec, prev, o):
    """(verdict, the filter that took it or None)."""
    flag = rec["flag"]
    paired = bool(flag & PAIRED)
    if flag & SECONDARY:
        return "qcfail", None
    if rec["mapq"] < o["min_map_qual"]:
        return "qcfail", "low_map_qual"
    qual = rec["qual"][:rec["rlen"]]
    if sum(1 for q in qual if q >= o["min_base_qual"]) < o["min_good_qual_bases"]:
        return "qcfail", "low_qual_bases"
    if flag & UNMAP:
        return "qcfail", "unmapped"
    if o["filter_reads_with_unmapped_mates"] and paired and flag & MUNMAP:
        return "bad", "mate_unmapped"
    if (o["filter_reads_with_distant_mates"] and paired
            and (rec["ref"] != rec["mate_ref"] or not flag & PROPER)):
        return "bad", "mate_distant"
    if (o["filter_read_pairs_with_small_inserts"] and paired
            and rec["tlen"] != 0 and abs(rec["tlen"]) < rec["rlen"]):
        return "qcfail", "small_insert"
    if o["filter_duplicates"]:
        if flag & DUP:
            return "qcfail", "duplicate"
        if (prev is not None and rec["pos"] == prev["pos"]
                and rec["rlen"] == prev["rlen"]
                and (not paired or rec["mate_pos"] == prev["mate_pos"])):
            return "qcfail", "duplicate"
    return "good", None


def _trim(rec, o):
    """The good record's quality bytes after the trims."""
    q = bytearray(rec["qual"])
    rl, flag = rec["rlen"], rec["flag"]
    reverse = bool(flag & REVERSE)
    if not reverse:
        for k in range(1, rl + 1):
            if k < o["trim_read_flank"] or q[rl - k] < 5:
                q[rl - k] = 0
            else:
                break
    else:
        for k in range(rl):
            if k < o["trim_read_flank"] or q[k] < 5:
                q[k] = 0
            else:
                break
    tlen = rec["tlen"]
    paired = bool(flag & PAIRED)
    if (o["trim_overlapping"] and paired and tlen != 0 and not reverse
            and flag & MREVERSE and abs(tlen) < 2 * rl):
        for k in range(1, min(rl, 2 * rl - tlen + 1) + 1):
            q[rl - k] = 0
    if o["trim_adapter"] and paired and 0 < abs(tlen) < rl:
        for k in range(abs(tlen), rl):
            q[k] = 0
    if o["trim_soft_clipped"]:
        at = 0
        for op, ln in rec["cigar"]:
            if op in (M, INS):
                at += ln
            elif op == SOFT:
                for k in range(at, min(at + ln, rl)):
                    q[k] = 0
                at += ln
    return bytes(q)


def check_and_trim(records, options=None):
    """[(verdict, quality bytes)] per record, in order, and {filter:
    count}; the quality bytes of a record that is not good are its own."""
    o = dict(DEFAULTS, **(options or {}))
    counts = {name: 0 for name in FILTERS}
    out = []
    prev = None
    for rec in records:
        verdict, name = _verdict(rec, prev, o)
        if name is not None:
            counts[name] += 1
        out.append((verdict, _trim(rec, o) if verdict == "good"
                    else bytes(rec["qual"])))
        prev = rec
    return out, counts


def trim_tallies(records, verdicts, options=None):
    """How many good records meet the overlapping-mate trim's and the
    adapter trim's condition: {"overlap": n, "adapter": n}."""
    o = dict(DEFAULTS, **(options or {}))
    overlap = adapter = 0
    for rec, (verdict, _q) in zip(records, verdicts):
        if verdict != "good" or not rec["flag"] & PAIRED or rec["tlen"] == 0:
            continue
        t, rl = abs(rec["tlen"]), rec["rlen"]
        overlap += int(bool(o["trim_overlapping"]
                            and not rec["flag"] & REVERSE
                            and rec["flag"] & MREVERSE and t < 2 * rl))
        adapter += int(bool(o["trim_adapter"] and t < rl))
    return {"overlap": overlap, "adapter": adapter}


def read_bam(path: str) -> bytes:
    """A BAM's uncompressed bytes (BGZF blocks are gzip members)."""
    with gzip.open(path, "rb") as fh:
        return fh.read()


def decode_bam(data: bytes, start: int, end: int):
    """The records of a coordinate-sorted BAM's bytes (read_bam; one
    reference) that overlap [start, end), in file order, as check_and_trim
    takes them.  A record with no reference bases overlaps one base at its
    position, as htslib reads it; a record without bases or qualities is
    left out, as Platypus leaves it out."""
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    out = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        (ref, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, mate_ref,
         mate_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off + 4)
        if ref < 0 or pos >= end:
            break
        at = off + 36 + l_name
        off += 4 + size
        if pos + 2 * l_seq + 10_000 < start:
            continue  # ends before the region: no read spans that far
        words = struct.unpack_from(f"<{n_cigar}I", data, at)
        cigar = [(w & 0xF, w >> 4) for w in words]
        at += 4 * n_cigar + (l_seq + 1) // 2
        qual = data[at:at + l_seq]
        span = sum(ln for op, ln in cigar if op in (0, 2, 3, 7, 8))
        if pos + max(span, 1) <= start or l_seq == 0 or qual[0] == 0xFF:
            continue
        clip = cigar[0][1] if cigar and cigar[0][0] == SOFT else 0
        out.append(dict(flag=flag, pos=pos - clip, mapq=mapq, rlen=l_seq,
                        qual=qual, cigar=cigar, ref=ref, mate_ref=mate_ref,
                        mate_pos=mate_pos, tlen=tlen))
    return out
