"""Sequence-context error models: homopolymer gap-open penalties, tandem
repeat annotation and the context-dependent indel prior.

Reimplements three reference components:

* the homopolymer indel table and per-base gap-open annotation applied to
  every haplotype sequence (Platypus src/cython/chaplotype.pyx:64-67
  and :552-590);
* the bit-parallel tandem-repeat annotator
  (Platypus src/c/tandem.c:132-263) — here as a windowed run-length
  computation with the same 64-nt scan caps, N pseudo-randomisation,
  acceptance rule and ascending (pos, unit) update order, so sizes and
  displacements match byte-for-byte (see tests/test_error_model.py goldens);
* the per-(unit, tract-length) indel prior table and the geometric prior for
  indels in non-repetitive context (variant.pyx:68-95,146-217).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Homopolymer gap-open model (chaplotype.pyx:64-67)
# ---------------------------------------------------------------------------

_PER_BASE_INDEL_ERRORS = [2.9e-5, 2.9e-5, 2.9e-5, 2.9e-5, 4.3e-5, 1.1e-4,
                          2.4e-4, 5.7e-4, 1.0e-3, 1.4e-3] + [
    1.4e-3 + 4.3e-4 * (n - 10) for n in range(11, 50)
]

# phred+33 encoded gap-open quality per homopolymer run length.
HOMOPOLQ = bytes(
    int(33.5 + 10 * math.log((idx + 1) * q) / math.log(0.1))
    for idx, q in enumerate(_PER_BASE_INDEL_ERRORS)
)


_HOMOPOLQ_ARR = np.frombuffer(HOMOPOLQ, np.uint8).astype(np.int32) - ord("!")
# Run-length cap: the reference stops extending where the table would go
# non-positive (chaplotype.pyx:566-570); with this table that never
# happens, so the cap is the table end.
_HOMOPOL_CAP = len(HOMOPOLQ) - 1


def annotate_gap_open(hap_seq: bytes) -> np.ndarray:
    """Per-base phred gap-open array for a haplotype sequence
    (chaplotype.pyx:552-590: filled back-to-front, run length capped at the
    table end, N resets the run).

    The native single-pass loop (ptpu_gap_open) is exact by construction —
    integer run lengths + table lookups, no floats; the vectorised numpy
    body below is the oracle/fallback: the scalar recurrence is
    homopollen(i) = min(e(i) - i, cap) where e(i) is the last index of the
    homopolymer run containing i (runs are broken at every N, which the
    scalar code achieves by clobbering the remembered previous base)."""
    n = len(hap_seq)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    from .. import native

    out = native.native_gap_open(hap_seq, _HOMOPOLQ_ARR)
    if out is not None:
        return out
    arr = np.frombuffer(bytes(hap_seq), np.uint8)
    is_n = arr == ord("N")
    # boundary[i]: position i ends its run (next char differs or either is N).
    boundary = np.empty(n, bool)
    boundary[-1] = True
    boundary[:-1] = (arr[:-1] != arr[1:]) | is_n[:-1] | is_n[1:]
    ends = np.nonzero(boundary)[0]
    e = ends[np.searchsorted(ends, np.arange(n))]
    homopollen = np.minimum(e - np.arange(n), _HOMOPOL_CAP)
    return _HOMOPOLQ_ARR[homopollen]


# ---------------------------------------------------------------------------
# Tandem repeat annotation (tandem.c)
# ---------------------------------------------------------------------------

MAX_UNIT_LENGTH = 12
MIN_PARTIAL_MATCH = 5


def approximate_indel_rate(size: int, displacement: int) -> int:
    """Guess of indel rate in -10*phred units (tandem.c:60-68)."""
    if displacement == 1:
        return -360 + 24 * size
    if displacement == 2:
        return -327 + 15 * size
    if displacement == 3:
        return -291 + 8 * size
    return -282 + 6 * size


def _encode_two_bit(seq: bytes, total: int) -> np.ndarray:
    """A/C/G/T -> 0..3; N -> position-dependent pseudo-random; beyond-end
    -> 'A' (0).  Mirrors twobit() (tandem.c:11-56)."""
    out = np.zeros(total, dtype=np.int64)
    arr = np.frombuffer(seq, dtype=np.uint8).astype(np.int64) & 0xDF
    n = len(seq)
    code = np.zeros(n, dtype=np.int64)
    code[arr == ord("C")] = 1
    code[arr == ord("G")] = 2
    code[arr == ord("T")] = 3
    other = ~np.isin(arr, [ord("A"), ord("C"), ord("G"), ord("T")])
    if other.any():
        idx = np.nonzero(other)[0]
        m257 = idx % 257
        code[idx] = ((m257 * (1 + m257)) // 2 + (idx % 5)) % 4
    out[:n] = code
    return out


def calculate_size_and_displacement(seq: bytes, annotate_all: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per-base (repeat tract length, repeat unit size), matching
    tandem.c annotate() exactly.  Dispatches to the C++ annotator
    (native/src/tandem.cpp, ~40x) when built; the Python implementation
    below is the parity oracle."""
    from ..native import native_tandem_annotate

    res = native_tandem_annotate(bytes(seq), annotate_all)
    if res is not None:
        return res
    return _calculate_size_and_displacement_py(seq, annotate_all)


def _calculate_size_and_displacement_py(seq: bytes, annotate_all: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-Python oracle, matching tandem.c annotate() exactly, including
    the 64-nt scan-window caps and the ascending (pos-block, unit) update
    order."""
    length = len(seq)
    sizes = np.ones(length, dtype=np.int32)
    disps = np.ones(length, dtype=np.int32)
    if length == 0:
        return sizes, disps

    code = _encode_two_bit(seq, length + 64 + MAX_UNIT_LENGTH + 4)

    # Per unit-length d: run[i] = #consecutive positions with
    # code[i + k] == code[i + d + k].
    runs = {}
    n_cmp = length + 64
    for d in range(1, MAX_UNIT_LENGTH):
        eq = code[:n_cmp] == code[d : n_cmp + d]
        run = np.zeros(n_cmp + 1, dtype=np.int32)
        for i in range(n_cmp - 1, -1, -1):
            run[i] = run[i + 1] + 1 if eq[i] else 0
        runs[d] = run

    rate_cache = {}

    def rate(size: int, disp: int) -> int:
        key = (size, disp)
        v = rate_cache.get(key)
        if v is None:
            v = approximate_indel_rate(size, disp)
            rate_cache[key] = v
        return v

    def foundmatch(p: int, size: int, d: int) -> None:
        # tandem.c:89-128
        if p + d + size > length:
            size = length - d - p
        size += d
        if size < d + min(MIN_PARTIAL_MATCH, d):
            return
        if rate(int(sizes[p]), int(disps[p])) < rate(size, d):
            sizes[p] = size
            disps[p] = d
            if annotate_all:
                hi = min(length, p + size)
                for i in range(p + 1, hi):
                    sizes[i] = size
                    disps[i] = d

    for pos in range(0, length, 4):
        for d in range(1, MAX_UNIT_LENGTH):
            if pos + d >= length:
                break
            run = runs[d]
            near_end = pos + d + 32 >= length
            for j in range(4):
                p = pos + j
                if p >= length:
                    break
                cap = (32 - j) if near_end else (64 - j)
                # First mismatch at index >= j within the 64-nt window,
                # expressed as run length from p, capped by the window.
                size_j = min(int(run[p]), cap)
                foundmatch(p, size_j, d)

    return sizes, disps


# ---------------------------------------------------------------------------
# Indel prior model (variant.pyx:68-95,146-217)
# ---------------------------------------------------------------------------

# Hard-coded per-(unit size, tract length) phred prior strings; index
# [displacement][tract_length - 1] - 33 gives the phred prior.
INDEL_PRIOR_MODEL = {
    1: "LIGC@:62/-*'&%$",
    2: "LIGDB@><9630.,+**)(''&&%%%$$$",
    3: "LIGA@B@><;8763220/.-,+++)*))(((''''&&&&&&%%%%%%%%$$$$$$$",
    4: "LIGA@???=<886533210/.--,+**))))((('''''&&&&&&&&%%%%%%%%%%%$$$$$$$$",
    5: "LIGA@??>=>=;966543210///-,,++*",
    6: "LIGA@??>>=<=;:764532210/----,++",
    7: "LIGA@??>>==<;;987543210/....-,,,++++",
    8: "LIGA@??>>==<<;9876432200/..--,,,+++",
    9: "LIGA@??>>==<<;;9966432100//../..----,,,,,++++++",
    10: "LIGA@??>>==<<;;:986432110//..----,,,,++++",
    11: "LIGA@??>>==<<<;;:87642210////..--,,,,,+++",
    12: "LIGA@??>>==<<<;;;:986532110000/...-----,,,,,+++++",
    13: "LIGA@??>>==<<<;;;::987543111000/////.......--------,,,,,,,,,,,,,+++++++++",
    14: "LIGA@??>>==<<<;;;::987642210/0/.....-------,,,,,,,,+++++++",
    15: "LIGA@??>>==<<<;;;;::988754322110000////////.......------------,,,,,,,,,,,,,,,,,++++++++++",
    16: "LIGA@??>>==<<<;;;;:::98765321110////........-------,,,,,,,,,,,,,,+++++++++",
    17: "LIGA@??>>==<<<;;;;::::988764433211110000000///////.............-----------------,,,,,,,,,,,,,,,,,,,",
    18: "LIGA@??>>==<<<;;;:::::998875433221111000000///////.............-----------------,,,,,,,,,,,,,,,,,,,",
    19: "LIGA@??>>==<<<;;;;::::999887654433222221111111100000000//////////////..................------------",
    20: "LIGA@??>>==<<<;;;;::::9999876543322111000000///////............-----------------,,,,,,,,,,,,,,,,,,,",
    21: "LIGA@??>>==<<<;;;;::::9999988765544433322222221111111100000000000000//////////////////.............",
    22: "LIGA@??>>==<<<;;;;::::9999987765432221000000////////...........-----------------,,,,,,,,,,,,,,,,,,,",
    23: "LIGA@??>>==<<<;;;;::::9999998776543322111100000000////////................-------------------,,,,,,",
    24: "LIGA@??>>==<<<;;;;::::9999998887654433322111111100000000/////////////...................-----------",
}

COMPLEX_DELETION_PRIOR = 5e-5
COMPLEX_INSERTION_PRIOR = 5e-6


def indel_prior(ref_context: bytes, rel_ref_pos: int, indel_length_and_type: int) -> float:
    """Context-dependent indel prior (variant.pyx:146-217).

    ref_context: reference sequence around the variant (the reference uses
    getSequence(refName, leftPos+1, rightPos+1) with a ±100bp window);
    rel_ref_pos: index of the variant position inside ref_context;
    indel_length_and_type: +n for an n-base insertion, -n for a deletion.
    """
    qbase = 33
    prior_phred = ord(INDEL_PRIOR_MODEL[1][0]) - qbase
    prior_tractlength = 255

    sizes, disps = calculate_size_and_displacement(ref_context, True)

    for i in range(rel_ref_pos - 1, rel_ref_pos + 1):
        if i < 0 or i >= len(ref_context):
            continue
        disp = int(disps[i])
        if disp in INDEL_PRIOR_MODEL:
            size = int(sizes[i])
            model = INDEL_PRIOR_MODEL[disp]
            if size > len(model):
                size = len(model)
            new_prior = ord(model[size - 1]) - qbase
            if new_prior < prior_phred:
                prior_phred = new_prior
                prior_tractlength = size

    dprior = math.pow(0.1, prior_phred / 10.0)

    # Geometric length prior for indels in non-repetitive context.
    if prior_tractlength <= 3:
        if indel_length_and_type < 0:
            dprior = COMPLEX_DELETION_PRIOR * math.pow(0.75, (-indel_length_and_type) - 1) * 0.25
        else:
            dprior = (
                COMPLEX_INSERTION_PRIOR
                * math.pow(0.75, indel_length_and_type - 1)
                * 0.25
                * math.pow(0.33, indel_length_and_type)
            )
    return dprior


# ---------------------------------------------------------------------------
# Repeat-unit canonicalisation and per-base gap-open annotation from
# calibrated error models (cerrormodel.pyx:40-455).  Used by the offline
# error-model calibration tool; the main calling path uses the simpler
# homopolymer table above, exactly as the reference does.
# ---------------------------------------------------------------------------

MINIMUM_TANDEM_LENGTH = 4

_COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C"}


def normalize_repunit(unit: str) -> str:
    """Canonical repeat unit: lexicographic minimum over all rotations of the
    unit and of its reverse complement (lower-cased when the reverse strand
    wins) — cerrormodel.pyx:86-96."""
    unit = unit.upper()
    if "N" in unit:
        return "N" * len(unit)
    length = len(unit)
    unit2 = "".join(_COMPLEMENT.get(c, "N") for c in reversed(unit))
    doubled = unit + unit
    doubled2 = unit2 + unit2
    candidates = [doubled[i : i + length] for i in range(length)]
    candidates += [doubled2[i : i + length] + "-" for i in range(length)]
    norm = sorted(candidates)[0]
    if norm.endswith("-"):
        return norm[:-1].lower()
    return norm


def get_repeats(sequence: bytes, min_length: int, pos: int):
    """Non-overlapping (position, tract length, canonical unit) repeats with
    tract length >= min_length (cerrormodel.pyx:99-131)."""
    sizes, disps = calculate_size_and_displacement(sequence, True)
    seq_str = sequence.decode() if isinstance(sequence, bytes) else sequence
    repeats = []
    for idx in range(len(seq_str)):
        size = int(sizes[idx])
        if size >= min_length:
            disp = int(disps[idx])
            if (not repeats or repeats[-1][1] != size
                    or len(repeats[-1][2]) != disp
                    or repeats[-1][0] + size < pos + idx):
                unit = normalize_repunit(seq_str[idx : idx + disp])
                if not unit.upper().startswith("N"):
                    repeats.append((pos + idx, size, unit))
    return repeats


def _model_lookup(indel_q_data: dict, tandemunit: str, tandemlen: int) -> int:
    """Per-(unit, tract length) phred+33 byte (add_tandem core,
    cerrormodel.pyx:185-221)."""
    tandemunit = tandemunit.upper()
    qdata = 99
    model = indel_q_data.get(tandemunit)
    if model is not None:
        qdata = ord(model[min(tandemlen - 1, len(model) - 1)])
    generic = indel_q_data.get(len(tandemunit))
    if generic is not None and (model is None or tandemlen > len(model)):
        qdata = min(qdata, ord(generic[min(tandemlen - 1, len(generic) - 1)]))
    return qdata


def _iter_tandems(sequence: str):
    """Concatenated repeat spans as the fast annotator sees them
    (cerrormodel.pyx:309-355)."""
    seq_b = sequence.encode() if isinstance(sequence, str) else sequence
    sizes, disps = calculate_size_and_displacement(seq_b, False)
    seq_str = seq_b.decode()
    old_pos = -1
    old_len = -1
    old_unit = None
    for pos in range(len(seq_str)):
        tandemlen = int(sizes[pos])
        unitlen = int(disps[pos])
        unit = normalize_repunit(seq_str[pos : pos + unitlen])
        if tandemlen >= 2 and "N" not in unit.upper():
            if old_pos + old_len >= pos and old_unit == unit:
                old_len = pos + tandemlen - old_pos
            else:
                if old_pos != -1 and old_len >= MINIMUM_TANDEM_LENGTH:
                    yield old_pos, old_len, old_unit
                old_pos, old_len, old_unit = pos, tandemlen, unit
    if old_pos != -1:
        yield old_pos, old_len, old_unit


def annotate_sequence(sequence, indel_q_data: dict, output_base: int = 0) -> bytes:
    """Per-base gap-open penalties from a calibrated error model
    (cerrormodel.pyx:306-355)."""
    seq_str = sequence.decode() if isinstance(sequence, bytes) else sequence
    default = ord(indel_q_data[1][0]) - ord("!") + output_base
    indelq = [default] * len(seq_str)
    for pos, tandemlen, unit in _iter_tandems(seq_str):
        qdata = _model_lookup(indel_q_data, unit, tandemlen)
        if qdata == 99:
            continue
        q = qdata - 33 + output_base
        for idx in range(pos, min(pos + tandemlen, len(indelq))):
            indelq[idx] = min(q, indelq[idx])
    return bytes(indelq)


def annotate_sequence_read(sequence, indel_q_data: dict, output_base: int = 0,
                           reverse: bool = False) -> bytes:
    """Read-oriented variant: per-position model index, followed by a
    running forward minimum (cerrormodel.pyx:360-424)."""
    seq_str = sequence.decode() if isinstance(sequence, bytes) else sequence
    if reverse:
        seq_str = seq_str[::-1]
    default = ord(indel_q_data[1][0]) - ord("!") + output_base
    indelq = [default] * len(seq_str)
    for pos, tandemlen, unit in _iter_tandems(seq_str):
        unit_u = unit.upper()
        model = indel_q_data.get(unit_u)
        generic = indel_q_data.get(len(unit_u))
        for idx in range(pos, min(pos + tandemlen, len(indelq))):
            qdata = 99
            model_idx = idx - pos
            if model is not None:
                qdata = ord(model[min(model_idx, len(model) - 1)])
            if generic is not None and (model is None or model_idx > len(model)):
                qdata = min(qdata, ord(generic[min(model_idx, len(generic) - 1)]))
            if qdata == 99:
                break
            indelq[idx] = min(qdata - 33 + output_base, indelq[idx])
    # Forward running minimum.
    q = indelq[0] if indelq else 0
    for idx in range(len(indelq)):
        indelq[idx] = min(q, indelq[idx])
        q = indelq[idx]
    if reverse:
        indelq = indelq[::-1]
    return bytes(indelq)
