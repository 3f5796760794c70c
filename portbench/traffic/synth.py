"""The benchmark's one traffic generator: a synthetic contig, each
sample's two haplotypes with planted variants, and single-end reads drawn
from them, written as FASTA and one BAM per sample (with their indexes).

The haplotype and read simulation is copied from tests/synth.py
(SimHaplotype, simulate_reads_bulk) and the dataset layout from
tools/scaling_bench.py build_dataset and tools/cohort_bench.py
build_cohort, with their writers replaced by harness/bamio.py; the variant
models are the traffic files' own.  A traffic file's "variants"
block picks the model.  Sites come every spacing[0]..spacing[1] bp, drawn
as SNVs, insertions or deletions by the "snv" / "ins" / "del" shares, the
indels indel_length[0]..indel_length[1] bp; then, by "genotype":

* "genome" -- one sample's genome: a site is homozygous with probability
  hom_share, else on one of its two haplotypes, drawn evenly;
* "population" -- a cohort drawn from a population: a site's allele is
  carried by k of the cohort's 2n haplotypes, k drawn with probability
  proportional to 1/k (the neutral site frequency spectrum of a sample of
  2n haplotypes), the k haplotypes drawn evenly.

Everything is drawn from the seed: the same seed gives the same bytes.
The planted variants are returned as the truth the calls are held to.
"""

from __future__ import annotations

import json
import os

import numpy as np

from portbench.harness import bamio

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


class SimHaplotype:
    """A mutated genome with hap<->ref coordinate blocks.  variants:
    (ref_pos, removed_len, added_bytes); a SNV is (pos, 1, b"X"), a
    deletion (pos, n, b""), an insertion (pos, 0, b"XYZ") before ref_pos."""

    def __init__(self, ref_seq: np.ndarray, variants):
        self.variants = sorted(variants)
        blocks = []  # (hap_start, length, ref_start or None)
        parts = []
        hlen = 0
        cur_ref = 0
        for pos, removed_len, added in self.variants:
            if pos > cur_ref:
                blocks.append((hlen, pos - cur_ref, cur_ref))
                parts.append(ref_seq[cur_ref:pos])
                hlen += pos - cur_ref
            if added:
                is_sub = removed_len == len(added)
                blocks.append((hlen, len(added), pos if is_sub else None))
                parts.append(np.frombuffer(added, np.uint8))
                hlen += len(added)
            cur_ref = pos + removed_len
        blocks.append((hlen, len(ref_seq) - cur_ref, cur_ref))
        parts.append(ref_seq[cur_ref:])
        self.seq = np.concatenate(parts)
        self.blocks = blocks
        self._hstarts = np.array([b[0] for b in blocks], np.int64)
        ref_blocks = [b for b in blocks if b[2] is not None]
        self._ref_rstarts = np.array([b[2] for b in ref_blocks], np.int64)
        self._ref_hstarts = np.array([b[0] for b in ref_blocks], np.int64)
        self._ref_lens = np.array([b[1] for b in ref_blocks], np.int64)

    def cigar_for(self, hap_start: int, length: int):
        """(bam_pos, cigar) of a read over hap [hap_start, +length)."""
        ops = []
        bam_pos = prev_ref_end = None
        hap_end = hap_start + length
        first = max(0, int(np.searchsorted(self._hstarts, hap_start,
                                           side="right")) - 1)
        for hstart, blen, rstart in self.blocks[first:]:
            if hstart >= hap_end:
                break
            lo, hi = max(hstart, hap_start), min(hstart + blen, hap_end)
            if hi <= lo:
                continue
            if rstart is None:
                ops.append([1, hi - lo])
            else:
                seg = rstart + (lo - hstart)
                if bam_pos is None:
                    bam_pos = seg
                if prev_ref_end is not None and seg > prev_ref_end:
                    ops.append([2, seg - prev_ref_end])
                ops.append([0, hi - lo])
                prev_ref_end = seg + (hi - lo)
        merged = []
        for op, ln in ops:
            if merged and merged[-1][0] == op:
                merged[-1][1] += ln
            else:
                merged.append([op, ln])
        if bam_pos is None:
            return None, None
        return bam_pos, [tuple(x) for x in merged]

    def affine_runs(self):
        """Hap intervals with one affine hap->ref map: (hstart, hend, off)."""
        runs = []
        for hstart, blen, rstart in self.blocks:
            if rstart is None or blen == 0:
                continue
            off = rstart - hstart
            if runs and runs[-1][1] == hstart and runs[-1][2] == off:
                runs[-1][1] = hstart + blen
            else:
                runs.append([hstart, hstart + blen, off])
        return tuple(np.array([r[k] for r in runs], np.int64) for k in range(3))


def simulate_reads(haps, start, end, read_len, coverage, rng, err_rng,
                   error_rate):
    """Reads uniformly over [start, end), alternating between `haps`:
    (pos[n], seq[n, L] uint8, special {row: cigar}) sorted by position;
    rows absent from special are single-M."""
    n_reads = int((end - start) * coverage / read_len)
    L = read_len
    starts = rng.integers(start, max(start + 1, end - L), size=n_reads)
    hap_idx = np.arange(n_reads) % len(haps)
    pos_l, h_l, hap_l, single_l = [], [], [], []
    for k, hap in enumerate(haps):
        rs = starts[hap_idx == k]
        i = np.clip(np.searchsorted(hap._ref_rstarts, rs, side="right") - 1,
                    0, len(hap._ref_rstarts) - 1)
        ok = ((rs >= hap._ref_rstarts[i])
              & (rs < hap._ref_rstarts[i] + hap._ref_lens[i]))
        h = hap._ref_hstarts[i] + (rs - hap._ref_rstarts[i])
        ok &= h + L <= len(hap.seq)
        h = h[ok]
        run_s, run_e, run_off = hap.affine_runs()
        j = np.clip(np.searchsorted(run_s, h, side="right") - 1, 0,
                    len(run_s) - 1)
        single = (h >= run_s[j]) & (h + L <= run_e[j])
        pos_l.append(np.where(single, h + run_off[j], -1))
        h_l.append(h)
        hap_l.append(np.full(len(h), k, np.int64))
        single_l.append(single)
    all_pos, all_h = np.concatenate(pos_l), np.concatenate(h_l)
    all_hap, all_single = np.concatenate(hap_l), np.concatenate(single_l)
    n = len(all_h)
    seq = np.empty((n, L), np.uint8)
    col = np.arange(L)[None, :]
    for k, hap in enumerate(haps):
        rows = np.nonzero(all_hap == k)[0]
        for lo in range(0, len(rows), 1 << 20):
            r = rows[lo:lo + (1 << 20)]
            seq[r] = hap.seq[all_h[r][:, None] + col]
    special = {}
    for r in np.nonzero(~all_single)[0]:
        bam_pos, cigar = haps[int(all_hap[r])].cigar_for(int(all_h[r]), L)
        if bam_pos is None:
            all_pos[r] = -2
            continue
        all_pos[r] = bam_pos
        special[int(r)] = cigar
    keep = all_pos != -2
    if not keep.all():
        remap = np.cumsum(keep) - 1
        special = {int(remap[r]): c for r, c in special.items() if keep[r]}
        all_pos, seq = all_pos[keep], seq[keep]
    if error_rate > 0:
        m = err_rng.random(seq.shape) < error_rate
        seq[m] = ACGT[err_rng.integers(0, 4, size=int(m.sum()))]
    order = np.argsort(all_pos, kind="stable")
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    special = {int(inv[r]): c for r, c in special.items()}
    return all_pos[order], seq[order], special


def plant_sites(ref: np.ndarray, span: int, spec: dict, rng):
    """Sites every spec['spacing'] bp inside [1000, span - 1000): a list of
    (pos, removed_len, added_bytes)."""
    lo, hi = spec["spacing"]
    shares = np.cumsum([spec.get("snv", 1.0), spec.get("ins", 0.0),
                        spec.get("del", 0.0)])
    max_indel = spec.get("indel_length", [1, 1])
    sites = []
    pos = 1000
    while True:
        pos += int(rng.integers(lo, hi + 1))
        if pos >= span - 1000:
            return sites
        k = rng.random() * shares[-1]
        if k < shares[0]:
            sites.append((pos, 1, bytes([int(rng.choice(ACGT[ACGT != ref[pos]]))])))
        elif k < shares[1]:
            n = int(rng.integers(max_indel[0], max_indel[1] + 1))
            sites.append((pos, 0, rng.choice(ACGT, size=n).tobytes()))
        else:
            sites.append((pos, int(rng.integers(max_indel[0],
                                                max_indel[1] + 1)), b""))


def genotypes(sites, n_samples: int, spec: dict, rng):
    """[sample][hap] -> list of the sites that haplotype carries."""
    out = [[[], []] for _ in range(n_samples)]
    if spec["genotype"] == "genome":
        hom = rng.random(len(sites)) < spec["hom_share"]
        hap = rng.integers(0, 2, size=len(sites))
        for site, both, h in zip(sites, hom, hap):
            for k in ((0, 1) if both else (int(h),)):
                out[0][k].append(site)
        return out
    n_haps = 2 * n_samples
    k = np.arange(1, n_haps)
    carriers = rng.choice(k, size=len(sites), p=(1 / k) / (1 / k).sum())
    for site, c in zip(sites, carriers):
        for h in rng.choice(n_haps, size=int(c), replace=False):
            out[int(h) // 2][int(h) % 2].append(site)
    return out


def build(workdir: str, config: dict, traffic: dict, seed: int) -> dict:
    """Write the dataset of (config, traffic, seed) into `workdir`: ref.fa,
    one BAM per sample, and meta.json (file names relative to `workdir`,
    the regions, the reads each region holds by leftmost position, and the
    planted variants with each sample's genotype).  Returns the meta."""
    data = config
    contig, length = data["contig"], int(data["genome_length"])
    L = int(data["read_length"])
    ref = ACGT[_rng(seed, 0).integers(0, 4, size=length)]
    bamio.write_fasta(os.path.join(workdir, "ref.fa"), contig, ref)
    site_rng = _rng(seed, 1)
    sites = plant_sites(ref, length, traffic["variants"], site_rng)
    carried = genotypes(sites, int(data["samples"]), traffic["variants"],
                        site_rng)
    region = int(config["platypus"]["buffer_size"])
    edges = np.arange(0, length + region, region)
    edges[-1] = min(edges[-1], length)
    reads_per_region = np.zeros(len(edges) - 1, np.int64)
    bams, truth = [], {}
    for s, haps_vars in enumerate(carried):
        name = f"S{s:03d}"
        haps = [SimHaplotype(ref, hv) for hv in haps_vars]
        pos, seq, special = simulate_reads(
            haps, 0, length, L, float(traffic["coverage"]), _rng(seed, 10 + 2 * s),
            _rng(seed, 11 + 2 * s), float(data["error_rate"]))
        path = os.path.join(workdir, f"{name}.bam")
        bamio.write_bam(path, contig, length, pos, seq, special,
                        int(data["base_quality"]), int(data["mapq"]), name)
        bams.append(f"{name}.bam")
        reads_per_region += np.histogram(pos, bins=edges)[0]
        for h, hv in enumerate(haps_vars):
            for p, n, alt in hv:
                gt = truth.setdefault(f"{p}:{n}:{alt.decode()}",
                                      [[0, 0] for _ in carried])
                gt[s][h] = 1
    regions = [[contig, int(a), int(b)] for a, b in zip(edges[:-1], edges[1:])]
    meta = dict(ref="ref.fa", bams=bams,
                regions=regions, reads_per_region=reads_per_region.tolist(),
                truth=truth)
    with open(os.path.join(workdir, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return meta
