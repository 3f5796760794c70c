"""General VCF 3.3 / 4.0 / 4.1 reader-writer.

The calling pipeline itself reads candidate VCFs through io/vcfsource.py
and writes through vcfout/writer.py; this module is the standalone
general-purpose library filling the role of the reference's
src/python/vcf.py:92-953 (itself vendored pysam code): typed
##INFO/##FILTER/##FORMAT schemas, version-specific allele conventions
(v3.3 I/D alleles are rewritten to v4.0 padded alleles), a configurable
by-name error policy, region filtering, genotype parsing, write
round-trips, call comparison, and a whole-file sorted reader.

Public names follow the reference so its users can switch directly
(``VCF().parse(stream)`` yields per-record dicts with 0-based positions;
``ignoreerror``/``warnerror`` tune the error policy), but the internals
are this project's own design, organised around three ideas the
reference's parser does not have:

* **declaration-time decoders** — every ##INFO/##FORMAT declaration is
  compiled once, when the header is read, into a closure that decodes a
  raw value string straight to its typed list (`FieldDef.decoder`);
  record parsing never re-dispatches on the field's Type;
* **a tokenised metadata scanner** — `<ID=..,Description="..">` bodies
  are split by a quote-aware regex rather than incremental string
  surgery;
* **a column pipeline** — one small method per VCF column group
  (alleles, quality, filters, info, samples), composed by `parse_data`.

A copy of platypus_tpu/io/vcf.py with the logic unchanged.
"""

from __future__ import annotations

import bisect
import re
import sys
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

# Genotype separators: unphased /, phased |, and the rare literal backslash.
_GT_SEP = re.compile(r"([|/\\])")
_ALLELE_OK = re.compile(r"[ACGTN]+\Z")
# key=value pairs of a <...> metadata body; values may be quoted (and then
# contain commas).  One scan, no incremental slicing.
_META_PAIR = re.compile(r'\s*(?P<k>[^=,<>\s]+)\s*=\s*(?P<v>"[^"]*"|[^,]*)')
# Positional v3.3 bodies have bare tokens between the named ones.
_META_BARE = re.compile(r'\s*(?P<v>"[^"]*"|[^,]*)')


class VCFError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Error policy: stable public NAMES (the reference's users address errors by
# name through ignoreerror/warnerror), own numbering and own messages.
# ---------------------------------------------------------------------------

_ERROR_NAMES: Tuple[Tuple[str, str], ...] = (
    ("UNKNOWN_FORMAT_STRING", "unrecognised ##fileformat value"),
    ("BADLY_FORMATTED_FORMAT_STRING", "malformed field declaration"),
    ("BADLY_FORMATTED_HEADING", "#CHROM heading is missing columns %s"),
    ("BAD_NUMBER_OF_COLUMNS", "data line has %s columns"),
    ("POS_NOT_NUMERICAL", "POS is not an integer"),
    ("POS_NOT_POSITIVE", "POS must be >= 1"),
    ("UNKNOWN_CHAR_IN_REF", "REF contains a non-ACGTN character"),
    ("V33_BAD_REF", "v3.3 REF must be a single base"),
    ("V33_BAD_ALLELE", "v3.3 ALT must be a base, Dn or I<seq>"),
    ("V33_UNMATCHED_DELETION", "v3.3 deletion disagrees with the reference (%s)"),
    ("V40_BAD_ALLELE", "ALT allele %s is not ACGTN"),
    ("V40_MISSING_ANGLE_BRACKETS", "declaration body not wrapped in <>"),
    ("V40_FORMAT_MUST_HAVE_NAMED_FIELDS", "v4.0 declarations need key=value fields"),
    ("QUAL_NOT_NUMERICAL", "QUAL must be a number or '.'"),
    ("ERROR_INFO_STRING", "cannot parse INFO field"),
    ("ERROR_UNKNOWN_KEY", "key %s was never declared in the header"),
    ("ERROR_FORMAT_NOT_NUMERICAL", "expected a number, got %s"),
    ("ERROR_FORMAT_NOT_CHAR", "expected a single character"),
    ("ERROR_TRAILING_DATA", "numeric value %s carries trailing text"),
    ("ERROR_NON_FLAG_WITHOUT_VALUE", "non-Flag field given without a value"),
    ("ERROR_FLAG_HAS_VALUE", "Flag field given a value"),
    ("FILTER_NOT_DEFINED", "FILTER %s missing from the header"),
    ("FORMAT_NOT_DEFINED", "FORMAT %s missing from the header"),
    ("BAD_NUMBER_OF_VALUES", "sample column %s has more values than FORMAT keys"),
    ("BAD_NUMBER_OF_PARAMETERS", "wrong value count: %s"),
    ("BAD_GENOTYPE", "cannot parse genotype %s"),
    ("FORMAT_MISSING_QUOTES", "Description must be double-quoted"),
    ("HEADING_NOT_SEPARATED_BY_TABS", "#CHROM heading uses spaces, not tabs"),
    ("MISSING_REF", "REF is missing"),
    ("WRONG_REF", "REF disagrees with the reference FASTA %s"),
    ("ZERO_LENGTH_ALLELE", "empty allele"),
    ("MISSING_INDEL_ALLELE_REF_BASE", "indel allele lacks the leading reference base"),
    ("BAD_CHR_TAG", "cannot order chromosome %s"),
)
_ERROR_CODES = {name: i for i, (name, _) in enumerate(_ERROR_NAMES)}


# ---------------------------------------------------------------------------
# Typed field model
# ---------------------------------------------------------------------------

@dataclass
class FieldDef:
    """One ##INFO/##FILTER/##FORMAT declaration, with its value decoder
    compiled at declaration time."""

    id: str
    numbertype: int
    number: int
    type: str
    description: str
    missingvalue: object

    def __post_init__(self):
        self._decode = _compile_decoder(self.type, self.missingvalue)

    def decode(self, raw: Optional[str], vcf: "VCF", line: str) -> list:
        """Raw value string -> typed list (Flag -> []), routing malformed
        input through the VCF's error policy."""
        if self.type == "Flag":
            if raw is not None:
                vcf.error(line, vcf.ERROR_FLAG_HAS_VALUE)
            return []
        if raw is None:
            vcf.error(line, vcf.ERROR_NON_FLAG_WITHOUT_VALUE)
            return []
        parts = raw.split(",")
        if self.type in ("Float", "Integer") and ";" in parts[-1]:
            vcf.error(line, vcf.ERROR_TRAILING_DATA, parts[-1])
            parts[-1] = parts[-1].partition(";")[0]
        try:
            return self._decode(parts, vcf, line)
        except ValueError:
            vcf.error(line, vcf.ERROR_FORMAT_NOT_NUMERICAL, parts)
            fallback = 0 if self.type == "Integer" else 0.0
            return [fallback] * len(parts)


def _compile_decoder(typ: str, missing) -> Callable:
    """Type-specific decode closure — chosen once per declaration, not per
    record."""
    if typ == "Integer":
        def dec(parts, _vcf, _line):
            return [missing if p == "." else int(p) for p in parts]
    elif typ == "Float":
        def dec(parts, _vcf, _line):
            return [missing if p == "." else float(p) for p in parts]
    elif typ == "Character":
        def dec(parts, vcf, line):
            for p in parts:
                if len(p) != 1:
                    vcf.error(line, vcf.ERROR_FORMAT_NOT_CHAR)
            return parts
    elif typ == "String":
        def dec(parts, _vcf, _line):
            return parts
    else:  # Flag and anything exotic: handled before dispatch
        def dec(parts, vcf, line):
            vcf.error(line, vcf.ERROR_INFO_STRING)
            return []
    return dec


# The reference exposes its declaration tuple type as vcf.FORMAT.
FORMAT = FieldDef


# ---------------------------------------------------------------------------
# Small free functions
# ---------------------------------------------------------------------------

def get_sequence(chrom: str, start: int, end: int, fa) -> str:
    """Reference-FASTA fill-in; 'N' padding when absent or short."""
    want = max(0, end - start)
    if fa is None:
        return "N" * want
    seq = fa.fetch(chrom, start, end)
    if isinstance(seq, bytes):
        seq = seq.decode()
    seq = seq.upper()
    return seq + "N" * (want - len(seq)) if len(seq) < want else seq


def parse_regions(string: str) -> List[Tuple[str, int, int]]:
    """'chrom[:start[-end]],...' (1-based inclusive) -> 0-based half-open."""
    out = []
    for token in string.split(","):
        chrom, _, span = token.partition(":")
        if not span:
            out.append((chrom, 0, sys.maxsize))
            continue
        start, _, end = span.partition("-")
        out.append((chrom, int(start or "1") - 1,
                    int(end) if end else sys.maxsize))
    return out


def _trim_shared_tail(ref: str, alts: List[str]) -> Tuple[str, List[str]]:
    """Drop bases shared by the tail of REF and EVERY ALT, keeping at least
    one base of each (VCF right-trim normalisation)."""
    n_keep = min([len(ref)] + [len(a) for a in alts])
    while n_keep > 1:
        tail = ref[-1].upper()
        if any(a[-1].upper() != tail for a in alts):
            break
        ref = ref[:-1]
        alts = [a[:-1] for a in alts]
        n_keep -= 1
    return ref, alts


# ---------------------------------------------------------------------------
# The parser/writer
# ---------------------------------------------------------------------------

class VCF:
    """Version-aware VCF parser/writer (API mirrors the reference's)."""

    NT_UNKNOWN = 0
    NT_NUMBER = 1
    NT_ALLELES = 2
    NT_NR_ALLELES = 3
    NT_GENOTYPES = 4
    NT_PHASED_GENOTYPES = 5

    _NUMBER_WORDS = {
        ".": NT_UNKNOWN,
        "A": NT_ALLELES, "#alleles": NT_ALLELES,
        "#nonref_alleles": NT_NR_ALLELES,
        "G": NT_GENOTYPES, "#genotypes": NT_GENOTYPES,
        "#phased_genotypes": NT_PHASED_GENOTYPES,
    }
    _NUMBER_LABELS = {
        NT_UNKNOWN: ".", NT_ALLELES: "#alleles",
        NT_NR_ALLELES: "#nonref_alleles", NT_GENOTYPES: "#genotypes",
        NT_PHASED_GENOTYPES: "#phased_genotypes",
    }
    # Expected value count per numbertype given the ALT list.
    _COUNT_RULES: Dict[int, Callable] = {
        NT_NUMBER: lambda f, nalt: f.number,
        NT_ALLELES: lambda f, nalt: nalt + 1,
        NT_NR_ALLELES: lambda f, nalt: nalt,
        NT_GENOTYPES: lambda f, nalt: (nalt + 1) * (nalt + 2) // 2,
        NT_PHASED_GENOTYPES: lambda f, nalt: (nalt + 1) * (nalt + 1),
    }

    _required = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                 "INFO", "FORMAT"]

    def __init__(self, reference=None, regions=None, lines=None,
                 leftalign: bool = False, _fastGT: bool = False):
        self._header: List[Tuple[str, str]] = []
        self._version = 40
        self._info: Dict[str, FieldDef] = {}
        self._filter: Dict[str, FieldDef] = {}
        self._format: Dict[str, FieldDef] = {}
        self._samples: List[str] = []
        self._ignored_errors = {self.ERROR_UNKNOWN_KEY}
        self._warn_errors: set = set()
        self._reference = reference
        self._regions = regions
        self._leftalign = leftalign
        self._fastGT = _fastGT
        self._lines = lines
        self._lineno = -1
        self._line: Optional[str] = None

    # Error names resolve as attributes (self.FILTER_NOT_DEFINED etc.).
    def __getattr__(self, name: str) -> int:
        try:
            return _ERROR_CODES[name]
        except KeyError:
            raise AttributeError(name)

    # -- error policy ------------------------------------------------------
    def error(self, line, code: int, opt=None) -> None:
        if code in self._ignored_errors:
            return
        name, template = _ERROR_NAMES[code]
        detail = template
        if opt is not None:
            try:
                detail = template % opt
            except TypeError:
                detail = f"{template} ({opt})"
        msg = f"Error parsing vcf: {name}: {detail}\n{line}"
        if code in self._warn_errors:
            print(f"Warning: {msg}", file=sys.stderr)
            return
        raise VCFError(msg)

    def _policy(self, which: set, errorstring: str) -> None:
        code = _ERROR_CODES.get(errorstring)
        if code is None:
            raise ValueError(f"Invalid error string: {errorstring}")
        which.add(code)

    def ignoreerror(self, errorstring: str) -> None:
        self._policy(self._ignored_errors, errorstring)

    def warnerror(self, errorstring: str) -> None:
        self._policy(self._warn_errors, errorstring)

    # -- header ----------------------------------------------------------
    def parse_format(self, line: str, body: str, filter: bool = False) -> FieldDef:
        """One declaration body -> FieldDef.  v4.x bodies are <k=v,...>;
        v3.3 bodies may be bare positional ID,Number,Type,"Description"."""
        if self._version >= 40:
            if not (body.startswith("<") and body.endswith(">")):
                self.error(line, self.V40_MISSING_ANGLE_BRACKETS)
            body = body.removeprefix("<").removesuffix(">")

        fields: Dict[str, str] = {}
        positional = ["ID", "Number", "Type", "Description"]
        if filter:
            del positional[1:3]
        pos_idx = 0
        cursor = 0
        while cursor < len(body):
            m = _META_PAIR.match(body, cursor)
            if m:
                key, val = m.group("k"), m.group("v")
            else:
                m = _META_BARE.match(body, cursor)
                val = m.group("v")
                if self._version >= 40:
                    self.error(line, self.V40_FORMAT_MUST_HAVE_NAMED_FIELDS)
                if pos_idx >= len(positional):
                    self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
                    break
                key = positional[pos_idx]
            pos_idx += 1
            if key == "Description":
                if val.startswith('"') and val.endswith('"') and len(val) >= 2:
                    val = val[1:-1]
                else:
                    self.error(line, self.FORMAT_MISSING_QUOTES)
            fields[key] = val
            cursor = m.end()
            if cursor < len(body) and body[cursor] == ",":
                cursor += 1

        fid = fields.get("ID")
        descr = fields.get("Description")
        if not fid:
            self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
        if descr is None:
            self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
            descr = "<none>"
        number, typ = fields.get("Number"), fields.get("Type")
        if not typ and not number:
            return FieldDef(fid, self.NT_NUMBER, 0, "Flag", descr, ".")
        if typ not in ("Integer", "Float", "Character", "String", "Flag"):
            self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
        if not number:
            self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
        missing = None if typ in ("Integer", "Float") else "."
        if number and number.lstrip("-").isdigit():
            return FieldDef(fid, self.NT_NUMBER, int(number), typ, descr,
                            missing)
        numbertype = self._NUMBER_WORDS.get(number)
        if numbertype is None:
            self.error(line, self.BADLY_FORMATTED_FORMAT_STRING)
            numbertype = self.NT_UNKNOWN
        return FieldDef(fid, numbertype, -1, typ, descr, missing)

    def format_format(self, fmt: FieldDef, filter: bool = False) -> str:
        pairs = [("ID", fmt.id)]
        if fmt.number is not None and not filter:
            label = self._NUMBER_LABELS.get(fmt.numbertype, str(fmt.number))
            pairs += [("Number", label), ("Type", fmt.type)]
        pairs.append(("Description", '"' + fmt.description + '"'))
        if self._version == 33:
            return ",".join(v for _k, v in pairs)
        return "<" + ",".join(f"{k}={v}" for k, v in pairs) + ">"

    def get_expected(self, key: str, formatdict, alt: Sequence[str]) -> int:
        f = formatdict.get(key)
        if f is None or f.numbertype == self.NT_UNKNOWN:
            return -1
        rule = self._COUNT_RULES.get(f.numbertype)
        return rule(f, len(alt)) if rule else 0

    def _declare_adhoc(self, formatdict, key, sample_values, line) -> None:
        """Register an undeclared key encountered in data (or output),
        guessing its type from the first value."""
        if key in formatdict:
            return
        self.error(line, self.ERROR_UNKNOWN_KEY, key)
        probe = sample_values[0] if sample_values else ""
        if sample_values is None:
            formatdict[key] = FieldDef(key, self.NT_NUMBER, 0, "Flag",
                                       "(Undefined tag)", ".")
        elif isinstance(probe, float):
            formatdict[key] = FieldDef(key, self.NT_UNKNOWN, -1, "Float",
                                       "(Undefined tag)", None)
        elif isinstance(probe, int):
            formatdict[key] = FieldDef(key, self.NT_UNKNOWN, -1, "Integer",
                                       "(Undefined tag)", None)
        else:
            formatdict[key] = FieldDef(key, self.NT_UNKNOWN, -1, "String",
                                       "(Undefined tag)", ".")

    def enter_default_format(self) -> None:
        for f in (FieldDef("GT", self.NT_NUMBER, 1, "String", "Genotype", "."),
                  FieldDef("GQ", self.NT_NUMBER, 1, "Integer",
                           "Genotype Quality", -1),
                  FieldDef("DP", self.NT_NUMBER, 1, "Integer",
                           "Read depth at this position for this sample", -1),
                  FieldDef("HQ", self.NT_UNKNOWN, -1, "Integer",
                           "Haplotype Quality", -1),
                  FieldDef("FT", self.NT_NUMBER, 1, "String",
                           "Sample Genotype Filter", ".")):
            self._format.setdefault(f.id, f)

    _VERSIONS = {"VCFv3.3": 33, "VCFv4.0": 40, "VCFv4.1": 41}

    def parse_header(self, line: str) -> None:
        assert line.startswith("##")
        key, _, value = line[2:].partition("=")
        key, value = key.strip(), value.strip()
        if key == "fileformat":
            if value not in self._VERSIONS:
                self.error(line, self.UNKNOWN_FORMAT_STRING)
            self._version = self._VERSIONS.get(value, self._version)
        elif key in ("INFO", "FILTER", "FORMAT"):
            f = self.parse_format(line, value, filter=(key == "FILTER"))
            {"INFO": self._info, "FILTER": self._filter,
             "FORMAT": self._format}[key][f.id] = f
        else:
            self._header.append((key, value))

    def write_header(self, stream) -> None:
        stream.write("##fileformat=VCFv%d.%d\n"
                     % divmod(self._version, 10))
        for key, value in self._header:
            stream.write(f"##{key}={value}\n")
        for schema, label in ((self._info, "INFO"), (self._filter, "FILTER"),
                              (self._format, "FORMAT")):
            for f in schema.values():
                stream.write("##%s=%s\n" % (
                    label, self.format_format(f, filter=(label == "FILTER"))))

    def parse_heading(self, line: str) -> None:
        assert line.startswith("#") and not line.startswith("##")
        headings = line[1:].split("\t")
        if len(headings) == 1 and len(line[1:].split()) >= 9:
            self.error(line, self.HEADING_NOT_SEPARATED_BY_TABS)
            headings = line[1:].split()
        for i, want in enumerate(self._required):
            if i < len(headings) and headings[i] == want:
                continue
            if len(headings) == 8:
                headings.append("FORMAT")
            else:
                got = (f"({i + 1}th entry not found)" if i >= len(headings)
                       else f"(found {headings[i]}, expected {want})")
                self.error(line, self.BADLY_FORMATTED_HEADING, got)
        self._samples = headings[9:]

    def write_heading(self, stream) -> None:
        stream.write("#" + "\t".join(self._required + self._samples) + "\n")

    # -- genotypes ---------------------------------------------------------
    def convertGT(self, gt: str):
        """'0/1' -> [0, '/', 1]; haploid '0' -> [0]; missing -> ['.']."""
        if gt in (".", "1", "") or gt.startswith(".:"):
            return ["."]
        tokens = _GT_SEP.split(gt)  # [a] or [a, sep, b]
        try:
            if len(tokens) == 1:
                return [int(tokens[0])]
            if len(tokens) != 3:
                raise ValueError
            a, sep, b = tokens
            if a == "." and b == ".":
                return [a, sep, b]
            return [int(a), sep, int(b)]
        except ValueError:
            self.error(self._line, self.BAD_GENOTYPE, gt)
            return [".", "|", "."]

    def convertGTback(self, gtdata) -> str:
        return "".join(map(str, gtdata))

    def parse_formatdata(self, key, value, formatdict, line):
        """Typed decode of one INFO/FORMAT value via the declaration's
        compiled decoder (kept as a public method for API parity)."""
        f = formatdict.get(key)
        if f is None:
            self._declare_adhoc(formatdict, key, value, line)
            f = formatdict[key]
        if f.type == "String" and f.id == "GT":
            self._line = line
            return [self.convertGT(v) for v in value.split(",")]
        return f.decode(value, self, line)

    def inregion(self, chrom: str, pos: int) -> bool:
        if not self._regions:
            return True
        return any(c == chrom and s <= pos < e
                   for c, s, e in self._regions)

    # -- record parsing: one method per column group -----------------------
    def _parse_pos(self, cols, line) -> int:
        try:
            pos = int(cols[1]) - 1
        except ValueError:
            self.error(line, self.POS_NOT_NUMERICAL)
            return 0
        if pos < 0:
            self.error(line, self.POS_NOT_POSITIVE)
        return pos

    def _parse_ref(self, chrom, pos, raw, line) -> Tuple[str, Optional[str]]:
        """REF column; returns (ref, left_flank_cache) where the flank is
        the FASTA slice [pos-100, pos+len(ref)) used by left-alignment."""
        ref = raw.upper()
        if ref == ".":
            self.error(line, self.MISSING_REF)
            ref = (get_sequence(chrom, pos, pos + 1, self._reference)
                   if self._version == 33 else "")
        else:
            if not _ALLELE_OK.match(ref):
                self.error(line, self.UNKNOWN_CHAR_IN_REF)
            if "N" in ref:
                ref = get_sequence(chrom, pos, pos + len(ref),
                                   self._reference)
        flank = None
        if self._reference:
            left = max(0, pos - 100)
            flank = get_sequence(chrom, left, pos + len(ref), self._reference)
            from_fasta = flank[pos - left:]
            if from_fasta != ref:
                self.error(line, self.WRONG_REF,
                           f"(reference is {from_fasta}, VCF says {ref})")
            ref = from_fasta
        return ref, flank

    def _parse_qual(self, raw, line) -> float:
        if raw == ".":
            return -1.0
        try:
            return float(raw)
        except ValueError:
            self.error(line, self.QUAL_NOT_NUMERICAL)
            return -1.0

    def _parse_filters(self, raw, line) -> List[str]:
        if raw in (".", "PASS", "0"):
            return []
        filters = raw.split(";")
        for f in filters:
            if f not in self._filter:
                self.error(line, self.FILTER_NOT_DEFINED, f)
        return filters

    def _parse_info(self, raw, line) -> dict:
        info = {}
        if raw in (".", ""):
            return info
        for item in raw.split(";"):
            key, eq, value = item.partition("=")
            if "=" in value:
                self.error(line, self.ERROR_INFO_STRING)
            info[key] = self.parse_formatdata(key, value if eq else None,
                                              self._info, line)
        return info

    def _check_alt_alleles(self, ref, alt, line, check_bases=True) -> None:
        """ALT validation: the ACGTN base check applies to v4.x alleles
        only (check_bases); the zero-length / indel-anchor-base checks
        apply to every version, including v3.3 POST-conversion alleles."""
        if check_bases:
            for allele in alt:
                if allele == "<DEL>" and self._version == 41:
                    continue
                if not _ALLELE_OK.match(allele):
                    self.error(line, self.V40_BAD_ALLELE, allele)
        for allele in alt:
            if allele == "<DEL>" or len(allele) == len(ref):
                continue
            if len(allele) == 0:
                self.error(line, self.ZERO_LENGTH_ALLELE)
            lead = (ref[:1] + allele[:1]).upper()
            if ref[:1].upper() != allele[:1].upper() and "N" not in lead:
                self.error(line, self.MISSING_INDEL_ALLELE_REF_BASE)

    def _parse_sample(self, name, raw, fmt, alt, line) -> dict:
        decoded = {}
        values = raw.split(":")
        if len(values) > len(fmt):
            self.error(line, self.BAD_NUMBER_OF_VALUES, raw)
        for idx, key in enumerate(fmt):
            expected = self.get_expected(key, self._format, alt)
            if idx < len(values):
                value = values[idx]
            else:
                value = "." if expected == -1 else ",".join(["."] * expected)
            got = self.parse_formatdata(key, value, self._format, line)
            if expected != -1 and len(got) != expected:
                self.error(line, self.BAD_NUMBER_OF_PARAMETERS,
                           f"id={key}, expected {expected}, got {got}")
                got = (got + [got[-1]] * (expected - len(got)))[:expected]
            decoded[key] = got
        return decoded

    def parse_data(self, line: str, lineparse: bool = False,
                   parseGenotypes: bool = True):
        """One data line -> record dict with 0-based pos (v3.3 alleles
        rewritten to padded form, shared trailing bases trimmed, optional
        left-alignment against the reference FASTA)."""
        cols = line.split("\t")
        if len(cols) != len(self._samples) + 9:
            if len(cols) == 8 and not self._samples:
                cols.append("")
            else:
                self.error(line, self.BAD_NUMBER_OF_COLUMNS, len(cols))
        chrom = cols[0]
        pos = self._parse_pos(cols, line)
        if not self.inregion(chrom, pos):
            return None
        if lineparse:
            return chrom, pos, line

        ref, flank = self._parse_ref(chrom, pos, cols[3], line)
        alt = [] if cols[4] == "." else cols[4].upper().split(",")
        qual = self._parse_qual(cols[5], line)
        filters = self._parse_filters(cols[6], line)
        info = self._parse_info(cols[7], line)

        fmt = [] if cols[8] == "" else cols[8].split(":")
        if self._fastGT:
            fmt = fmt[:1]
        for key in fmt:
            if key not in self._format:
                self.error(line, self.FORMAT_NOT_DEFINED, key)

        if self._version == 33:
            ref, alt, pos = self._convert_v33_alleles(line, chrom, pos, ref,
                                                      alt)
            self._check_alt_alleles(ref, alt, line, check_bases=False)
        else:
            self._check_alt_alleles(ref, alt, line)
        if alt:
            ref, alt = _trim_shared_tail(ref, alt)
        if self._leftalign and self._reference:
            ref, alt, pos = self._leftalign_alleles(chrom, pos, ref, alt,
                                                    max(0, pos - 100), flank)

        record = {"chrom": chrom, "pos": pos, "id": cols[2], "ref": ref,
                  "alt": alt, "qual": qual, "filter": filters, "info": info,
                  "format": fmt}
        if parseGenotypes:
            for name, raw in zip(self._samples, cols[9:]):
                if self._fastGT:
                    record[name] = {fmt[0]: [self.convertGT(raw)]}
                else:
                    record[name] = self._parse_sample(name, raw, fmt, alt,
                                                      line)
        return record

    def _convert_v33_alleles(self, line, chrom, pos, ref, alt):
        """v3.3 SNP/I<seq>/Dn alleles -> v4.0 padded replacement alleles."""
        if len(ref) != 1:
            self.error(line, self.V33_BAD_REF)

        def extend_ref_to(length: int, converted: List[str]) -> str:
            """Pull reference bases so len(ref) >= length; keeps previously
            converted alleles in step.  Returns the fetched tail ('' when
            no extension was needed)."""
            nonlocal ref
            tail = ""
            if len(ref) < length:
                tail = get_sequence(chrom, pos + len(ref), pos + length,
                                    self._reference)
                ref += tail
                converted[:] = [c + tail for c in converted]
            return tail

        converted: List[str] = []
        saw_deletion = False
        for a in alt:
            if len(a) == 1:                       # SNP
                converted.append(a + ref[1:])
            elif a.startswith("I"):               # insertion of a[1:]
                converted.append(ref[0] + a[1:] + ref[1:])
            elif a.startswith("D"):               # deletion
                saw_deletion = True
                body = a[1:]
                if body.isdigit():
                    n = int(body)
                    extend_ref_to(n, converted)
                    converted.append(ref[n:])
                else:
                    # Validate only the freshly-fetched extension against
                    # the allele's tail, and let an all-N fetch (no real
                    # reference attached) pass: the deleted prefix already
                    # in `ref` is the REF column itself, not evidence of a
                    # mismatch.
                    tail = extend_ref_to(len(body), converted)
                    if (tail and not body.endswith(tail)
                            and tail != "N" * len(tail)):
                        self.error(line, self.V33_UNMATCHED_DELETION, a)
                    converted.append(ref[len(body):])
            else:
                self.error(line, self.V33_BAD_ALLELE)
                converted.append(a)
        alt = converted
        if saw_deletion:
            # Deletions need an anchor base: prepend the base before pos
            # (or append one at contig start).
            if pos == 0:
                pad = get_sequence(chrom, pos + len(ref), pos + len(ref) + 1,
                                   self._reference)
                ref += pad
                alt = [a + pad for a in alt]
            else:
                pad = get_sequence(chrom, pos - 1, pos, self._reference)
                ref = pad + ref
                alt = [pad + a for a in alt]
                pos -= 1
        return ref, alt, pos

    def _leftalign_alleles(self, chrom, pos, ref, alt, left, flank):
        """Shift indel alleles left while the rotated base matches."""
        def rotatable(a: str, b: str) -> bool:
            longer, shorter = (a, b) if len(a) > len(b) else (b, a)
            return (len(longer) != len(shorter)
                    and longer[:len(shorter)].upper() == shorter.upper()
                    and longer[-1].upper()
                    == longer[len(shorter) - 1].upper())

        while left < pos:
            if not all(rotatable(allele, ref) for allele in alt):
                break
            ref = ref[:-1]
            alt = [a[:-1] for a in alt]
            if len(ref) == 0 or min((len(a) for a in alt), default=0) == 0:
                base = flank[pos - left - 1]
                ref = base + ref
                alt = [base + a for a in alt]
                pos -= 1
        return ref, alt, pos

    # -- writing -----------------------------------------------------------
    def format_formatdata(self, data, fmt, key=True, value=True,
                          separator=":") -> str:
        """INFO/FORMAT dict -> column text; GT leads, other keys sorted,
        trailing all-missing entries trimmed."""
        if isinstance(data, list):
            data = {k: [] for k in data}
        for k in data:
            self._declare_adhoc(fmt, k, data[k], "(output)")
            data[k] = ["." if v == fmt[k].missingvalue else v
                       for v in data[k]]
        ordered = sorted((k, v) for k, v in data.items() if k != "GT")
        if "GT" in data:
            ordered.insert(0, ("GT", [self.convertGTback(x)
                                      for x in data["GT"]]))
        fields = []
        for k, v in ordered:
            joined = ",".join(map(str, v)) if v else None
            if key and value:
                fields.append(f"{k}={joined}" if joined is not None else k)
            elif key:
                fields.append(k)
            elif value:
                fields.append(joined if joined is not None else ".")
        while len(fields) > 1 and not fields[-1].replace(",", "").replace(".", ""):
            fields.pop()
        return separator.join(fields)

    def write_data(self, stream, data) -> None:
        for k in [c.lower() for c in self._required] + self._samples:
            if k not in data:
                raise ValueError(f"Required key {k} not found in data")
        alt = ",".join(data["alt"]) if data["alt"] else "."
        if data["filter"] is None:
            filt = "."
        elif data["filter"] == []:
            filt = "0" if self._version == 33 else "PASS"
        else:
            filt = ";".join(data["filter"])
        qual = "." if data["qual"] == -1 else str(data["qual"])
        qual = qual.removesuffix(".0")
        cols = [data["chrom"], str(data["pos"] + 1), data["id"],
                data["ref"], alt, qual, filt,
                self.format_formatdata(data["info"], self._info,
                                       separator=";"),
                self.format_formatdata(data["format"], self._format,
                                       value=False)]
        cols += [self.format_formatdata(data[s], self._format, key=False)
                 for s in self._samples]
        stream.write("\t".join(cols) + "\n")

    # -- streaming API -------------------------------------------------------
    def _parse_header_lines(self, stream) -> Optional[str]:
        self._lineno = 0
        for line in stream:
            self._lineno += 1
            if line.startswith("##"):
                self.parse_header(line.strip())
            elif line.startswith("#"):
                self.parse_heading(line.strip())
                self.enter_default_format()
            else:
                return line
        return None

    def _parse(self, first, stream, parseGenotypes) -> Iterator[dict]:
        def records():
            if first is not None:
                yield first
            for line in stream:
                self._lineno += 1
                if self._lines and self._lineno > self._lines:
                    return
                yield line

        for line in records():
            line = line.strip()
            if not line:
                continue
            d = self.parse_data(line, parseGenotypes=parseGenotypes)
            if d:
                yield d

    def getsamples(self):
        return self._samples

    def setsamples(self, samples):
        self._samples = samples

    def getheader(self):
        return self._header

    def setheader(self, header):
        self._header = header

    def getinfo(self):
        return self._info

    def setinfo(self, info):
        self._info = info

    def getformat(self):
        return self._format

    def setformat(self, fmt):
        self._format = fmt

    def getfilter(self):
        return self._filter

    def setfilter(self, filt):
        self._filter = filt

    def setversion(self, version: int) -> None:
        if version not in (33, 40, 41):
            raise ValueError("Can only handle v3.3 and v4.0/v4.1 VCF files")
        self._version = version

    def setregions(self, regions):
        self._regions = regions

    def setreference(self, ref):
        self._reference = ref

    def parse(self, stream, parseGenotypes: bool = True) -> Iterator[dict]:
        first = self._parse_header_lines(stream)
        return self._parse(first, stream, parseGenotypes)

    def write(self, stream, datagenerator) -> None:
        self.write_header(stream)
        self.write_heading(stream)
        for data in datagenerator:
            self.write_data(stream, data)

    def writeheader(self, stream) -> None:
        self.write_header(stream)
        self.write_heading(stream)

    def compare_calls(self, pos1, ref1, alt1, pos2, ref2, alt2) -> bool:
        """Call equality: same position and same right-trimmed ALT."""
        if pos1 != pos2:
            return False

        def trimmed(ref: str, alt: str) -> str:
            while ref and alt and ref[-1] == alt[-1]:
                ref, alt = ref[:-1], alt[:-1]
            return alt

        return trimmed(ref1, alt1) == trimmed(ref2, alt2)


class sortedVCF(VCF):
    """Whole-file reader yielding records position-sorted within each
    chromosome, chromosomes in natural order (numeric before named)."""

    def __init__(self):
        super().__init__()
        self._by_chrom: Optional[Dict[str, list]] = None

    def chr_tag(self, chrom: str):
        stem = chrom[3:] if chrom[:3].upper() == "CHR" else chrom
        try:
            return (chrom, int(stem))
        except ValueError:
            return (chrom, stem)

    def chr_order(self, chroms=None):
        if chroms is None:
            chroms = list(self._by_chrom.keys())
        tagged = [self.chr_tag(c) for c in chroms]
        tagged.sort(key=lambda t: (isinstance(t[1], str), t[1]))
        return [t[0] for t in tagged]

    def _load(self, first, stream) -> None:
        def lines():
            if first is not None:
                yield first
            yield from stream

        for line in lines():
            line = line.strip()
            if not line:
                continue
            located = self.parse_data(line, lineparse=True)
            if located:
                chrom, pos, text = located
                self._by_chrom[chrom].append((pos, text))
        for bucket in self._by_chrom.values():
            bucket.sort()

    def _parse_sorted(self, region=None) -> Iterator[dict]:
        if region is not None:
            chrom, start, end = region
            bucket = self._by_chrom[chrom]
            positions = [p for p, _ in bucket]
            lo = bisect.bisect_left(positions, start)
            hi = bisect.bisect_right(positions, end)
            span = bucket[lo:hi]
        else:
            span = [entry for chrom in self.chr_order()
                    for entry in self._by_chrom[chrom]]
        for _pos, text in span:
            yield self.parse_data(text.strip())

    def getdata(self):
        return self._by_chrom

    def parse(self, stream, region=None) -> Iterator[dict]:
        if self._by_chrom is None:
            self._by_chrom = defaultdict(list)
            first = self._parse_header_lines(stream)
            self._load(first, stream)
        return self._parse_sorted(region)
