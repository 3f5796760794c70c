"""Banded quality-aware read↔haplotype alignment: scalar reference core.

This is the numeric contract of the whole caller (reference
Platypus src/c/align.c:77-586, an SSE2 antidiagonal-wavefront DP):

* states M/I/D in a min-plus semiring, scores in quarter-phred integer units
  with a -0x8000 fixed-point offset;
* an 8-lane wavefront advanced two antidiagonals per step, which realises a
  band of haplotype-minus-read offsets d = x - y in [0, 15];
* free start and end gaps in the haplotype (read is globally aligned);
* mismatch cost 4*qual (N in the haplotype matches anything at cost 0),
  deletion open cost 4*gapopen[deleted base] (position-specific homopolymer
  model), extension 4*gapextend, insertions additionally pay 4*nucprior per
  base;
* final score = (min_score + 0x8000) >> 2, i.e. integer phred.

`band_align_single` simulates the wavefront exactly (including the
even/odd-phase gap-open window shifts, the per-step init-mask and the
padding conventions) so that scores are bit-identical to the reference —
validated against the compiled reference kernel in
tests/test_align_goldens.py.  The batched JAX/Pallas kernels in
align_jax.py / align_pallas.py must agree with this function exactly.
"""

from __future__ import annotations

import numpy as np

POS_INF = 0x7800
N_LANES = 8
BAND = 2 * N_LANES  # effective band width in d = x - y


def band_align_single(
    hap: bytes,
    read: bytes,
    quals: np.ndarray,
    gapextend: int,
    nucprior: int,
    gapopen: np.ndarray,
) -> int:
    """Score one (haplotype segment, read) pair.

    hap must satisfy len(hap) == len(read) + 15; gapopen is a per-base
    phred gap-open array over hap positions.
    """
    len1 = len(hap)
    len2 = len(read)
    assert len1 == len2 + 2 * N_LANES - 1, (len1, len2)
    assert len1 > N_LANES

    hap_a = np.frombuffer(hap, dtype=np.uint8).astype(np.int32)
    read_a = np.frombuffer(read, dtype=np.uint8).astype(np.int32)
    quals = np.asarray(quals, dtype=np.int32)
    gapopen = np.asarray(gapopen, dtype=np.int32)

    ge = 4 * gapextend
    npr = 4 * nucprior
    n_char = ord("N")

    m1 = np.full(N_LANES, POS_INF, np.int32)
    i1 = m1.copy()
    d1 = m1.copy()
    m2 = m1.copy()
    i2 = m1.copy()
    d2 = m1.copy()

    seq1win = hap_a[:N_LANES].copy()
    seq2win = np.full(N_LANES, POS_INF, np.int32)
    qual2win = np.full(N_LANES, 64 * 4, np.int32)
    nqual = np.where(seq1win == n_char, 0, POS_INF).astype(np.int32)
    gowin = 4 * gapopen[:N_LANES].astype(np.int32)

    minscore = np.int32(POS_INF)

    def shift_up(v, newval):
        out = np.empty_like(v)
        out[1:] = v[:-1]
        out[0] = newval
        return out

    def shift_down(v, newval):
        out = np.empty_like(v)
        out[:-1] = v[1:]
        out[-1] = newval
        return out

    for s in range(0, 2 * (len2 + N_LANES), 2):
        s2 = s // 2

        # ---- even phase: antidiagonal s ---------------------------------
        if s2 < len2:
            seq2win = shift_up(seq2win, read_a[s2])
            qual2win = shift_up(qual2win, 4 * quals[s2])
        else:
            seq2win = shift_up(seq2win, ord("0"))
            qual2win = shift_up(qual2win, 64 * 4)

        if s2 < N_LANES:
            m1[s2] = -0x8000
            m2[s2] = -0x8000

        m1 = np.minimum(m1, np.minimum(i1, d1))

        if s2 >= len2:
            minscore = min(minscore, m1[s2 - len2])

        m1 = m1 + np.minimum(np.where(seq2win == seq1win, 0, qual2win), nqual)
        d1_new = np.minimum(d2 + ge, np.minimum(m2, i2) + shift_down(gowin, 0))
        d1 = shift_up(d1_new, POS_INF)
        i1 = np.minimum(i2 + ge, m2 + gowin) + npr

        # ---- odd phase: antidiagonal s + 1 ------------------------------
        c = hap_a[N_LANES + s2] if N_LANES + s2 < len1 else n_char
        seq1win = shift_down(seq1win, c)
        nqual = shift_down(nqual, 0 if c == n_char else POS_INF)
        go_idx = N_LANES + s2 if N_LANES + s2 < len1 else len1 - 1
        gowin = shift_down(gowin, 4 * gapopen[go_idx])

        m2 = np.minimum(m2, np.minimum(i2, d2))

        if s2 >= len2:
            minscore = min(minscore, m2[s2 - len2])

        m2 = m2 + np.minimum(np.where(seq2win == seq1win, 0, qual2win), nqual)
        d2 = np.minimum(d1 + ge, np.minimum(m1, i1) + gowin)
        i2 = np.minimum(shift_down(i1, POS_INF) + ge, shift_down(m1, POS_INF) + gowin) + npr
        i2[-1] = POS_INF

    return int(minscore + 0x8000) >> 2


def band_align_traceback(
    hap: bytes,
    read: bytes,
    quals: np.ndarray,
    gapextend: int,
    nucprior: int,
    gapopen: np.ndarray,
):
    """Score + alignment traceback for one pair.

    Mirrors the reference kernel's traceback mode (align.c:96-586): the low
    two bits of every DP score carry the state label of its predecessor, so
    scores differ by up to 3 quarter-units from the no-traceback mode —
    reproduced exactly.  Returns (score, aln1, aln2, firstpos) where aln1 /
    aln2 are the haplotype/read rows of the alignment ('-' for gaps).
    """
    len1 = len(hap)
    len2 = len(read)
    assert len1 == len2 + 2 * N_LANES - 1

    hap_a = np.frombuffer(hap, dtype=np.uint8).astype(np.int32)
    read_a = np.frombuffer(read, dtype=np.uint8).astype(np.int32)
    quals = np.asarray(quals, dtype=np.int32)
    gapopen = np.asarray(gapopen, dtype=np.int32)

    ge = 4 * gapextend
    npr = 4 * nucprior
    n_char = ord("N")
    MATCH, INSERT, DELETE = 0, 1, 3

    m1 = np.full(N_LANES, POS_INF, np.int32)
    i1 = m1.copy(); d1 = m1.copy()
    m2 = m1.copy(); i2 = m1.copy(); d2 = m1.copy()

    seq1win = hap_a[:N_LANES].copy()
    seq2win = np.full(N_LANES, POS_INF, np.int32)
    qual2win = np.full(N_LANES, 64 * 4, np.int32)
    nqual = np.where(seq1win == n_char, 0, POS_INF).astype(np.int32)
    gowin = 4 * gapopen[:N_LANES].astype(np.int32)

    n_steps = 2 * (len2 + N_LANES)
    backpointers = np.zeros((n_steps, N_LANES), np.int32)

    minscore = np.int32(POS_INF)
    minscoreidx = -1

    def shift_up(v, newval):
        out = np.empty_like(v); out[1:] = v[:-1]; out[0] = newval; return out

    def shift_down(v, newval):
        out = np.empty_like(v); out[:-1] = v[1:]; out[-1] = newval; return out

    for s in range(0, n_steps, 2):
        s2 = s // 2
        if s2 < len2:
            seq2win = shift_up(seq2win, read_a[s2])
            qual2win = shift_up(qual2win, 4 * quals[s2])
        else:
            seq2win = shift_up(seq2win, ord("0"))
            qual2win = shift_up(qual2win, 64 * 4)

        if s2 < N_LANES:
            m1[s2] = -0x8000
            m2[s2] = -0x8000

        m1 = np.minimum(m1, np.minimum(i1, d1))
        if s2 >= len2 and s2 - len2 < N_LANES:
            if m1[s2 - len2] < minscore:
                minscore = m1[s2 - len2]
                minscoreidx = s

        m1 = m1 + np.minimum(np.where(seq2win == seq1win, 0, qual2win), nqual)
        d1_new = np.minimum(d2 + ge, np.minimum(m2, i2) + shift_down(gowin, 0))
        d1 = shift_up(d1_new, POS_INF)
        i1 = np.minimum(i2 + ge, m2 + gowin) + npr

        backpointers[s] = (3 & m1) | ((3 & i1) << (2 * INSERT)) | ((3 & d1) << (2 * DELETE))
        m1 = m1 & ~3
        i1 = (i1 & ~3) | 1
        d1 = (d1 & ~3) | 3

        c = hap_a[N_LANES + s2] if N_LANES + s2 < len1 else n_char
        seq1win = shift_down(seq1win, c)
        nqual = shift_down(nqual, 0 if c == n_char else POS_INF)
        go_idx = N_LANES + s2 if N_LANES + s2 < len1 else len1 - 1
        gowin = shift_down(gowin, 4 * gapopen[go_idx])

        m2 = np.minimum(m2, np.minimum(i2, d2))
        if s2 >= len2 and s2 - len2 < N_LANES:
            if m2[s2 - len2] < minscore:
                minscore = m2[s2 - len2]
                minscoreidx = s + 1

        m2 = m2 + np.minimum(np.where(seq2win == seq1win, 0, qual2win), nqual)
        d2 = np.minimum(d1 + ge, np.minimum(m1, i1) + gowin)
        i2 = np.minimum(shift_down(i1, POS_INF) + ge, shift_down(m1, POS_INF) + gowin) + npr
        i2[-1] = POS_INF

        backpointers[s + 1] = (3 & m2) | ((3 & i2) << (2 * INSERT)) | ((3 & d2) << (2 * DELETE))
        m2 = m2 & ~3
        i2 = (i2 & ~3) | 1
        d2 = (d2 & ~3) | 3

    score = int(minscore + 0x8000) >> 2
    aln1, aln2, firstpos = traceback_from_backpointers(
        backpointers, minscoreidx, hap, read)
    return score, aln1, aln2, firstpos


def traceback_from_backpointers(
    backpointers: np.ndarray,   # [n_steps, N_LANES] int, 8-bit state words
    minscoreidx: int,
    hap: bytes,
    read: bytes,
):
    """Backtrace (align.c:523-577) from a filled backpointer matrix —
    shared by the scalar DP above and the Pallas traceback kernel (which
    produces the same words on device).  Returns (aln1, aln2, firstpos)."""
    len2 = len(read)
    MATCH, INSERT = 0, 1
    s = minscoreidx
    i = s // 2 - len2
    y = len2
    x = s - y
    aln1 = []
    aln2 = []
    state = (int(backpointers[s, i]) >> (2 * MATCH)) & 3
    s -= 2
    while y > 0:
        new_state = (int(backpointers[s, i]) >> (2 * state)) & 3
        if state == MATCH:
            s -= 2
            x -= 1
            y -= 1
            aln1.append(hap[x])
            aln2.append(read[y])
        elif state == INSERT:
            i += s & 1
            s -= 1
            y -= 1
            aln1.append(ord("-"))
            aln2.append(read[y])
        else:
            s -= 1
            i -= s & 1
            x -= 1
            aln1.append(hap[x])
            aln2.append(ord("-"))
        state = new_state
    firstpos = x
    return bytes(reversed(aln1)), bytes(reversed(aln2)), firstpos


def unpack_backpointers(packed: np.ndarray) -> np.ndarray:
    """[(len2+8)*8] packed words (even phase in bits 0-7, odd phase in
    bits 8-15, lane-major within each antidiagonal pair) -> the
    [n_steps, N_LANES] layout traceback_from_backpointers expects."""
    n_half = len(packed) // N_LANES
    lanes = packed.reshape(n_half, N_LANES)
    out = np.empty((2 * n_half, N_LANES), np.int32)
    out[0::2] = lanes & 0xFF
    out[1::2] = (lanes >> 8) & 0xFF
    return out


def calculate_flank_score(
    hap_len: int,
    hap_flank: int,
    quals: np.ndarray,
    gapopen: np.ndarray,
    gapextend: int,
    nucprior: int,
    firstpos: int,
    aln1: bytes,
    aln2: bytes,
) -> int:
    """Alignment penalty incurred inside the flank buffers
    (align.c:593-644); subtracted from the score when
    --calculateFlankScore is on."""
    prevstate = "M"
    x = firstpos
    y = 0
    score = 0
    for c1, c2 in zip(aln1, aln2):
        if c1 == ord("-"):
            newstate = "I"
        elif c2 == ord("-"):
            newstate = "D"
        else:
            newstate = "M"
        if newstate == "M":
            if c1 != c2 and (x < hap_flank or x >= hap_len - hap_flank):
                if c1 == ord("N"):
                    score += 0
                else:
                    score += int(quals[y])
            x += 1
            y += 1
        elif newstate == "I":
            if x < hap_flank or x >= hap_len - hap_flank:
                if prevstate == "I":
                    score += gapextend + nucprior
                else:
                    score += int(gapopen[x - 1]) + nucprior
            y += 1
        else:
            if x < hap_flank or x >= hap_len - hap_flank:
                if prevstate == "D":
                    score += gapextend
                else:
                    score += int(gapopen[x])
            x += 1
        prevstate = newstate
    return score
