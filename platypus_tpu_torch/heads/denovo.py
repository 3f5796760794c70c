"""Trio de novo head.

Reimplements Platypus extensions/DeNovo/bayesianDeNovoFilter.py:

* ploidy handling for X/Y by child sex, with haploid GT/GL reduction;
* GQ>=30-gated Mendelian-error check against all inherited genotype pairs;
* hard filters: child VAF >= 0.20, child variant reads >= 8, parental VAF
  < 0.03, parents genotyped 0/0 on a reference background;
* a Bayes factor summing 10^(GL_child+GL_mother+GL_father+prior) over
  enumerated de-novo vs no-de-novo genotype-triple patterns with priors
  P(denovo)=2e-8, P(snp)=1e-3; pass when log10 BF < 0.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

PRIOR_DENOVO = math.log10(2.0e-8)
PRIOR_SNP = math.log10(1e-3)
PRIOR_NO_DENOVO = math.log10(1.0 - 10 ** PRIOR_DENOVO - 10 ** PRIOR_SNP)

MAX_PARENTAL_VAR_FRAC = 0.03
MIN_VAR_FRAC_IN_CHILD = 0.20
MIN_READS_IN_CHILD = 8
LOG_BF_THRESHOLD = math.log10(1.0)
GQ_THRESHOLD = 30

BAD_FILTERS = {"strandBias", "Q20", "alleleBias"}

# Genotype-triple patterns (child, mother, father) indexing [homRef, het, homAlt].
_DIPLOID_NO_DENOVO = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 2),
                      (1, 1, 0), (1, 1, 1), (1, 1, 2), (1, 2, 0), (1, 2, 1),
                      (2, 1, 1), (2, 1, 2), (2, 2, 1), (2, 2, 2))
_DIPLOID_DENOVO = ((0, 0, 2), (0, 1, 2), (0, 2, 0), (0, 2, 1), (0, 2, 2),
                   (1, 0, 0), (1, 2, 2), (2, 0, 0), (2, 0, 1), (2, 0, 2),
                   (2, 1, 0), (2, 2, 0))
_F_X_NO_DENOVO = ((0, 1, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1), (1, 2, 0), (2, 1, 1), (2, 2, 1))
_F_X_DENOVO = ((0, 0, 1), (0, 1, 1), (0, 2, 1), (0, 2, 0), (1, 0, 0), (1, 2, 1),
               (2, 0, 0), (2, 1, 0), (2, 0, 1))
_M_X_NO_DENOVO = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1),
                  (1, 1, 0), (1, 1, 1), (1, 2, 0), (1, 2, 1))
_M_X_DENOVO = ((0, 2, 0), (0, 2, 1), (1, 0, 0), (1, 0, 1))
_M_Y_NO_DENOVO = ()
_M_Y_DENOVO = ((0, 0, 1), (1, 0, 0))


def check_ploidy(chrom: str, sex: str) -> int:
    if chrom == "X":
        return 1 if sex == "M" else 2
    if chrom == "Y":
        return 1 if sex == "M" else 0
    return 2


class TrioRecord:
    """One VCF site's trio data (already ploidy-adjusted)."""

    def __init__(self, chrom: str, pos: int,
                 child_gt: Tuple[str, ...], mother_gt: Tuple[str, ...], father_gt: Tuple[str, ...],
                 child_gl: Sequence[float], mother_gl: Sequence[float], father_gl: Sequence[float],
                 child_gq: int, mother_gq: int, father_gq: int,
                 child_nr: int, mother_nr: int, father_nr: int,
                 child_nv: int, mother_nv: int, father_nv: int):
        self.chrom = chrom
        self.pos = pos
        self.child_gt = child_gt
        self.mother_gt = mother_gt
        self.father_gt = father_gt
        self.child_gl = list(child_gl)
        self.mother_gl = list(mother_gl)
        self.father_gl = list(father_gl)
        self.child_gq = child_gq
        self.mother_gq = mother_gq
        self.father_gq = father_gq
        self.child_nr = child_nr
        self.mother_nr = mother_nr
        self.father_nr = father_nr
        self.child_nv = child_nv
        self.mother_nv = mother_nv
        self.father_nv = father_nv


def adjust_for_ploidy(gt: Tuple[str, ...], gl: List[float], ploidy: int):
    if ploidy == 1 and len(gl) == 3:
        if gl[2] > gl[0]:
            return ("1",), [gl[0], gl[2]]
        return ("0",), [gl[0], gl[2]]
    if ploidy == 0:
        return (), []
    return gt, gl


def is_mendel_error(rec: TrioRecord, sex_of_child: str) -> bool:
    if "." in rec.child_gt or "." in rec.mother_gt or "." in rec.father_gt:
        return False
    if min(rec.child_gq, rec.father_gq, rec.mother_gq) < GQ_THRESHOLD:
        return False
    if rec.chrom == "X" and check_ploidy(rec.chrom, sex_of_child) == 1:
        return not any(g == rec.child_gt[0] for g in rec.mother_gt)
    if rec.chrom == "Y" and check_ploidy(rec.chrom, sex_of_child) == 1:
        if sex_of_child == "F":
            return False
        return not any(g == rec.child_gt[0] for g in rec.father_gt)
    for pair in itertools.product(rec.father_gt, rec.mother_gt):
        if rec.child_gt == pair or tuple(reversed(rec.child_gt)) == pair:
            return False
    return True


def is_de_novo(rec: TrioRecord, sex_of_child: str) -> bool:
    if rec.child_nr == 0 or rec.child_nv / rec.child_nr < MIN_VAR_FRAC_IN_CHILD:
        return False
    if rec.child_nv < MIN_READS_IN_CHILD:
        return False
    if rec.father_nr == 0 or rec.mother_nr == 0:
        return False
    if rec.father_nv / rec.father_nr >= MAX_PARENTAL_VAR_FRAC:
        return False
    if rec.mother_nv / rec.mother_nr >= MAX_PARENTAL_VAR_FRAC:
        return False
    if rec.father_gt == ("0", "0") and rec.mother_gt == ("0", "0"):
        return rec.child_gt != ("0", "0")
    if rec.father_gt == ("0",) and rec.mother_gt == ("0", "0"):
        if sex_of_child == "M":
            return rec.child_gt != ("0",)
        return rec.child_gt != ("0", "0")
    if rec.father_gt == ("0",) and rec.mother_gt == ():
        if sex_of_child == "M":
            return rec.child_gt != ("0",)
    return False


def compute_bayes_factor(rec: TrioRecord, sex_of_child: str) -> float:
    """log10 BF(no de novo / de novo); < 0 supports the de novo."""
    if check_ploidy(rec.chrom, "M") == 2:
        no_dn, dn = _DIPLOID_NO_DENOVO, _DIPLOID_DENOVO
    elif sex_of_child == "F":
        no_dn, dn = _F_X_NO_DENOVO, _F_X_DENOVO
    elif rec.chrom == "X":
        no_dn, dn = _M_X_NO_DENOVO, _M_X_DENOVO
    else:
        no_dn, dn = _M_Y_NO_DENOVO, _M_Y_DENOVO

    c, m, f = rec.child_gl, rec.mother_gl, rec.father_gl
    lik_ref = 10 ** (c[0] + f[0] + m[0] + PRIOR_NO_DENOVO)
    lik_no = sum(10 ** (c[cg] + f[fg] + m[mg] + PRIOR_SNP) for cg, mg, fg in no_dn)
    lik_dn = sum(10 ** (c[cg] + f[fg] + m[mg] + PRIOR_DENOVO) for cg, mg, fg in dn)

    log_ref = math.log10(max(1e-300, lik_ref))
    log_no = math.log10(max(1e-300, lik_no))
    log_dn = math.log10(max(1e-300, lik_dn))
    total_no = math.log10(10 ** log_ref + 10 ** log_no)
    return total_no - log_dn


def passes_bayesian_filter(rec: TrioRecord, sex_of_child: str) -> bool:
    return compute_bayes_factor(rec, sex_of_child) < LOG_BF_THRESHOLD


# ---------------------------------------------------------------------------
# VCF / PED plumbing
# ---------------------------------------------------------------------------

def read_pedigree(ped_path: str) -> Tuple[Dict[str, str], str]:
    """Parse a PED file; returns ({Child/Mother/Father: sample}, child sex).

    Two formats are accepted:
    * the reference extension's own 4-column format — one line of
      `child father mother sex` (bayesianDeNovoFilter.py:217-243);
    * standard 6-column PED (the child is the individual whose parents
      appear in the file)."""
    rows = []
    with open(ped_path) as fh:
        for line in fh:
            cols = line.split()
            if cols and not line.startswith("#"):
                rows.append(cols)
    for r in rows:
        if len(r) == 4:
            sex = "M" if r[3] in ("1", "M") else "F"
            return {"Child": r[0], "Father": r[1], "Mother": r[2]}, sex
    by_id = {r[1]: r for r in rows if len(r) >= 5}
    for r in rows:
        if len(r) >= 5 and r[2] in by_id and r[3] in by_id:
            sex = "M" if r[4] in ("1", "M") else "F"
            return {"Child": r[1], "Father": r[2], "Mother": r[3]}, sex
    raise ValueError(f"No complete trio found in {ped_path}")


def _parse_sample_field(format_keys: List[str], data: str) -> Dict[str, str]:
    return dict(zip(format_keys, data.split(":")))


def trio_record_from_vcf_line(line: str, samples: List[str],
                              pedigree: Dict[str, str], sex_of_child: str
                              ) -> Optional[TrioRecord]:
    cols = line.strip().split("\t")
    chrom = cols[0].upper()
    chrom = chrom[3:] if chrom.startswith("CHR") else chrom
    pos = int(cols[1])
    fmt = cols[8].split(":")
    fields = {s: _parse_sample_field(fmt, d) for s, d in zip(samples, cols[9:])}

    def get(role):
        d = fields[pedigree[role]]
        gt_raw = d.get("GT", "./.")
        sep = "|" if "|" in gt_raw else "/"
        gt = tuple(gt_raw.split(sep))
        gl = [float(x) for x in d["GL"].split(",")] if "GL" in d else None
        if gl is None and "PL" in d:
            gl = [-0.1 * float(x) for x in d["PL"].split(",")]
        gq = int(float(d.get("GQ", "0").split(",")[0]))
        nr = int(d.get("NR", "0").split(",")[0])
        nv = int(d.get("NV", "0").split(",")[0])
        return gt, gl, gq, nr, nv

    try:
        (cgt, cgl, cgq, cnr, cnv) = get("Child")
        (mgt, mgl, mgq, mnr, mnv) = get("Mother")
        (fgt, fgl, fgq, fnr, fnv) = get("Father")
    except (KeyError, ValueError):
        return None
    if cgl is None or mgl is None or fgl is None:
        return None

    cgt, cgl = adjust_for_ploidy(cgt, cgl, check_ploidy(chrom, sex_of_child))
    mgt, mgl = adjust_for_ploidy(mgt, mgl, check_ploidy(chrom, "F"))
    fgt, fgl = adjust_for_ploidy(fgt, fgl, check_ploidy(chrom, "M"))
    return TrioRecord(chrom, pos, cgt, mgt, fgt, cgl, mgl, fgl,
                      cgq, mgq, fgq, cnr, mnr, fnr, cnv, mnv, fnv)


def filter_denovo_vcf(in_vcf: TextIO, ped_path: str,
                      out_mendel: TextIO, out_denovo: TextIO,
                      out_filtered: TextIO) -> Tuple[int, int, int]:
    """Stream a trio VCF producing the three output tiers the reference
    writes (mendel errors, de novo candidates, Bayes-passing de novos)."""
    samples: List[str] = []
    pedigree: Dict[str, str] = {}
    sex_of_child = "F"
    counts = [0, 0, 0]
    for line in in_vcf:
        if line.startswith("#"):
            if not line.startswith("##"):
                samples = line.strip().split("\t")[9:]
                pedigree, sex_of_child = read_pedigree(ped_path)
            out_mendel.write(line)
            out_denovo.write(line)
            out_filtered.write(line)
            continue
        cols = line.split("\t")
        if "," in cols[4]:
            continue
        filters = set(cols[6].split(";"))
        if filters & BAD_FILTERS:
            continue
        rec = trio_record_from_vcf_line(line, samples, pedigree, sex_of_child)
        if rec is None:
            continue
        if is_mendel_error(rec, sex_of_child):
            out_mendel.write(line)
            counts[0] += 1
            if is_de_novo(rec, sex_of_child):
                out_denovo.write(line)
                counts[1] += 1
                if passes_bayesian_filter(rec, sex_of_child):
                    out_filtered.write(line)
                    counts[2] += 1
    return tuple(counts)
