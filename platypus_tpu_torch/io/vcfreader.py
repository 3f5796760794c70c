"""General VCF reader.

Role equivalent of the reference's bundled parser
(Platypus src/python/vcf.py): parse headers (INFO/FILTER/FORMAT
declarations, samples) and data lines into typed records.  Used by the
heads, the sanity harness and tests; transparently handles gzip/bgzip.
A copy of platypus_tpu/io/vcfreader.py with the logic unchanged.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO, Union


@dataclass
class VCFHeaderField:
    id: str
    number: str
    type: str
    description: str


@dataclass
class VCFRecord:
    chrom: str
    pos: int                      # 1-based, as written
    id: str
    ref: str
    alts: List[str]
    qual: str
    filters: List[str]
    info: Dict[str, List[str]]
    format_keys: List[str] = field(default_factory=list)
    samples: Dict[str, Dict[str, str]] = field(default_factory=dict)

    @property
    def pos0(self) -> int:
        return self.pos - 1

    def sample_gt(self, sample: str) -> Optional[tuple]:
        gt = self.samples.get(sample, {}).get("GT")
        if gt is None:
            return None
        sep = "|" if "|" in gt else "/"
        return tuple(gt.split(sep))

    def sample_floats(self, sample: str, key: str) -> Optional[List[float]]:
        raw = self.samples.get(sample, {}).get(key)
        if raw is None:
            return None
        try:
            return [float(x) for x in raw.split(",")]
        except ValueError:
            return None


def _parse_structured(line: str) -> Optional[VCFHeaderField]:
    # ##INFO=<ID=...,Number=...,Type=...,Description="...">
    if "<" not in line or ">" not in line:
        return None
    body = line[line.index("<") + 1 : line.rindex(">")]
    fields = {}
    key = val = ""
    in_quotes = False
    parts = []
    cur = ""
    for ch in body:
        if ch == '"':
            in_quotes = not in_quotes
            cur += ch
        elif ch == "," and not in_quotes:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    for part in parts:
        if "=" in part:
            k, v = part.split("=", 1)
            fields[k] = v.strip('"')
    return VCFHeaderField(
        id=fields.get("ID", ""), number=fields.get("Number", "."),
        type=fields.get("Type", "String"), description=fields.get("Description", ""),
    )


class VCFReader:
    def __init__(self, source: Union[str, TextIO]):
        if isinstance(source, str):
            if source.endswith((".gz", ".bgz")):
                self._fh = gzip.open(source, "rt")
            else:
                self._fh = open(source)
            self._own = True
        else:
            self._fh = source
            self._own = False
        self.meta: List[str] = []
        self.infos: Dict[str, VCFHeaderField] = {}
        self.filters: Dict[str, VCFHeaderField] = {}
        self.formats: Dict[str, VCFHeaderField] = {}
        self.samples: List[str] = []
        self.platypus_options: Optional[str] = None
        self._first_data_line: Optional[str] = None
        self._read_header()

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _read_header(self) -> None:
        for line in self._fh:
            if line.startswith("##"):
                self.meta.append(line.rstrip("\n"))
                if line.startswith("##INFO="):
                    f = _parse_structured(line)
                    if f:
                        self.infos[f.id] = f
                elif line.startswith("##FILTER="):
                    f = _parse_structured(line)
                    if f:
                        self.filters[f.id] = f
                elif line.startswith("##FORMAT="):
                    f = _parse_structured(line)
                    if f:
                        self.formats[f.id] = f
                elif line.startswith("##platypusOptions="):
                    self.platypus_options = line.split("=", 1)[1].strip()
            elif line.startswith("#CHROM"):
                cols = line.rstrip("\n").split("\t")
                self.samples = cols[9:]
                return
            else:
                self._first_data_line = line
                return

    def _parse_line(self, line: str) -> VCFRecord:
        cols = line.rstrip("\n").split("\t")
        info: Dict[str, List[str]] = {}
        if len(cols) > 7 and cols[7] != ".":
            for item in cols[7].split(";"):
                if "=" in item:
                    k, v = item.split("=", 1)
                    info[k] = v.split(",")
                else:
                    info[item] = []
        fmt = cols[8].split(":") if len(cols) > 8 else []
        samples = {}
        for name, data in zip(self.samples, cols[9:]):
            samples[name] = dict(zip(fmt, data.split(":")))
        return VCFRecord(
            chrom=cols[0], pos=int(cols[1]), id=cols[2], ref=cols[3],
            alts=cols[4].split(","), qual=cols[5],
            filters=cols[6].split(";") if cols[6] != "." else [],
            info=info, format_keys=fmt, samples=samples,
        )

    def __iter__(self) -> Iterator[VCFRecord]:
        if self._first_data_line is not None:
            yield self._parse_line(self._first_data_line)
            self._first_data_line = None
        for line in self._fh:
            if line.strip():
                yield self._parse_line(line)
