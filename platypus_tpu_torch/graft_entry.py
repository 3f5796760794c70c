"""Driver entry points of the torch port (twin of the repository's
__graft_entry__.py).

entry(device)               -> (forward step on the flagship compute path,
                               example args on `device`): one batched
                               banded pair alignment (K1 on CUDA, its
                               plain version on the CPU) and the
                               log-likelihood conversion.
dryrun_multichip(n, device) -> the demo calling step on an n-shard mesh,
                               then the production path: a synthetic BAM +
                               FASTA (simulate_dataset) through the port's
                               region preparation and mesh_call_region,
                               with and without --calculateFlankScore,
                               checked against the float64 host path for
                               identical calls.

Both run on the card unless the caller names another device: `device`
None means CUDA, and raises without a card (utils/backend.resolve_device).

check_mesh_region is the production check on any prepared region and any
meshes; chip_smoke.py runs it on the card.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

from .config import PlatypusConfig, derive_runtime
from .engine.caller import finish_window
from .engine.region import prepare_region_call
from .engine.runner import open_bams
from .io.bam import write_bam
from .io.fasta import FastaFile, build_index
from .ops.align_cuda import band_align_padded
from .ops.align_torch import pad_alignment_inputs
from .ops.likelihood_torch import scores_to_logliks
from .parallel import mesh as mesh_mod
from .utils.backend import resolve_device


def entry(device=None):
    """(forward, args): B = 256 pairs of 100 bp reads cut from random
    haplotypes (the inputs of __graft_entry__.entry, from the same seed),
    padded on `device` (None: the card); forward aligns them and converts
    the scores to per-read log-likelihoods at mapping quality 60."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    B, L2 = 256, 100
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = rng.choice(bases, size=(B, L2 + 15)).astype(np.int32)
    go = np.full((B, L2 + 15), 45, np.int32)
    read = np.zeros((B, L2), np.int32)
    for b in range(B):
        off = rng.integers(0, 8)
        read[b] = hap[b, off : off + L2]
    qual = np.full((B, L2), 30, np.int32)
    rl = np.full(B, L2, np.int32)
    padded = pad_alignment_inputs(hap, go, read, qual, rl, device=device)
    mapq = torch.full((B,), 60.0, dtype=torch.float32, device=device)

    def forward(hap_cols, go4, read_cols, qual4, read_len, mapq):
        scores = band_align_padded(hap_cols, go4, read_cols, qual4, read_len)
        return scores_to_logliks(scores.to(torch.float32), mapq)

    return forward, (*padded, mapq)


@contextlib.contextmanager
def recorded_pair_scores():
    """Record each window's pair scores as mesh_call_region unpacks them:
    yields a dict id(AlignmentRequest) -> int array."""
    seen = {}
    inner = mesh_mod.window_loglik_from_pair_scores

    def record(req, pair_scores):
        seen[id(req)] = np.array(pair_scores)
        return inner(req, pair_scores)

    mesh_mod.window_loglik_from_pair_scores = record
    try:
        yield seen
    finally:
        mesh_mod.window_loglik_from_pair_scores = inner


def check_mesh_region(config: PlatypusConfig, region, device,
                      meshes: Sequence[mesh_mod.DeviceMesh]) -> dict:
    """Prepare `region` (chrom, start, end) with the port on `device`
    (config.mesh_devices set: no alignment is queued), then run
    mesh_call_region over its windows on each mesh.  Every mesh must leave
    no alignable window over and give the first mesh's pair scores bit for
    bit; with each mesh's inference every window must make the calls of
    the float64 host path.  Returns the counts of windows, pairs and
    variant posteriors called."""
    if not config.mesh_devices:
        raise ValueError("check_mesh_region needs config.mesh_devices")
    bam_files, samples_by_bam, samples = open_bams(config)
    ref = FastaFile(config.ref_file)
    try:
        rt = derive_runtime(config, n_individuals=len(samples))
        rt.rlen = config.rlen
        state = prepare_region_call(*region, bam_files, samples_by_bam, ref,
                                    config, rt, torch.device(device))
        if state is None or state.pending is not None or not state.live:
            raise AssertionError(f"{region}: no windows prepared for the mesh")
        first = None
        for mesh in meshes:
            with recorded_pair_scores() as scores:
                ll_by, inf_by, left = mesh_mod.mesh_call_region(
                    state.live, len(samples), mesh)
            if any(p.request is not None and p.request.n_pairs()
                   for _, p in left):
                raise AssertionError(f"{mesh}: alignable windows left over")
            if not ll_by:
                raise AssertionError(f"{mesh}: no window crossed the mesh")
            calls = {}
            for w_idx, prep in state.live:
                if w_idx not in inf_by:
                    continue
                host = finish_window(prep, ll_by[w_idx], ref, config)
                dev = finish_window(prep, ll_by[w_idx], ref, config,
                                    inference=inf_by[w_idx])
                if host is None:
                    continue
                if (host.genotype_calls != dev.genotype_calls
                        or set(host.variant_posteriors)
                        != set(dev.variant_posteriors)):
                    raise AssertionError(f"{mesh}: window {w_idx} calls "
                                         f"differ from the host path")
                calls[w_idx] = (dev.genotype_calls,
                                sorted(dev.variant_posteriors))
            result = ({w: scores[id(p.request)] for w, p in state.live
                       if w in ll_by}, calls)
            if first is None:
                first = result
                continue
            if set(result[0]) != set(first[0]) or any(
                    not np.array_equal(result[0][w], first[0][w])
                    for w in first[0]):
                raise AssertionError(f"{mesh}: pair scores differ from "
                                     f"{meshes[0]}'s")
            if result[1] != first[1]:
                raise AssertionError(f"{mesh}: calls differ from "
                                     f"{meshes[0]}'s")
        return dict(windows=len(first[0]),
                    pairs=int(sum(len(s) for s in first[0].values())),
                    calls=sum(len(v) for _, v in first[1].values()))
    finally:
        for bam in bam_files:
            bam.close()
        ref.close()


def simulate_dataset(directory: str, length: int = 3000, seed: int = 7,
                     read_len: int = 80, coverage: int = 24):
    """A reference `chr20` of `length` random bases (ref.fa, indexed) and
    single-end reads (reads.bam, sample S1) over [500, length - 200),
    alternating between the reference and a haplotype with three planted
    variants: a SNP at 800, TG inserted before 1600, and the two bases at
    2300 deleted.  Returns (FASTA path, BAM path)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length).tobytes()
    ref_path = os.path.join(directory, "ref.fa")
    with open(ref_path, "w") as fh:
        fh.write(">chr20\n")
        for i in range(0, length, 60):
            fh.write(ref[i : i + 60].decode() + "\n")
    build_index(ref_path)
    snp = b"A" if ref[800] != ord("A") else b"C"
    # Each haplotype as its bases and, per base, the reference position it
    # stands on (-1 for an inserted base).
    alt, alt_pos, cur = bytearray(), [], 0
    for pos, removed, added in ((800, 1, snp), (1600, 0, b"TG"),
                                (2300, 2, b"")):
        alt += ref[cur:pos]
        alt_pos += range(cur, pos)
        alt += added
        alt_pos += range(pos, pos + len(added)) if removed else [-1] * len(added)
        cur = pos + removed
    alt += ref[cur:]
    alt_pos += range(cur, length)
    haps = [(ref, list(range(length))), (bytes(alt), alt_pos)]
    reads = []
    lo, hi = 500, length - 200
    for i in range(int((hi - lo) * coverage / read_len)):
        seq, ref_of = haps[i % 2]
        start = int(rng.integers(lo, hi - read_len))
        h = ref_of.index(start) if start in ref_of else -1
        if h < 0 or h + read_len > len(seq):
            continue
        cigar, prev = [], None
        for p in ref_of[h : h + read_len]:
            if p < 0:
                op = 1
            else:
                if prev is not None and p > prev + 1:
                    cigar.append([2, p - prev - 1])
                op, prev = 0, p
            if cigar and cigar[-1][0] == op:
                cigar[-1][1] += 1
            else:
                cigar.append([op, 1])
        reads.append(dict(name=f"r{i}", ref_id=0, pos=start, mapq=60, flag=0,
                          cigar=[tuple(c) for c in cigar],
                          seq=seq[h : h + read_len], qual=[35] * read_len))
    reads.sort(key=lambda r: r["pos"])
    bam_path = os.path.join(directory, "reads.bam")
    write_bam(bam_path, [("chr20", length)], reads, sample="S1")
    return ref_path, bam_path


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The demo calling step on get_engine_mesh(n_devices, device), then
    the production check (check_mesh_region, against a 1-shard mesh too)
    on a synthetic 3 kb region with three planted variants
    (simulate_dataset), in default and --calculateFlankScore mode.
    `device` None means the card.  Returns each mode's counts."""
    device = resolve_device(device)
    mesh_mod.dryrun_multichip(n_devices, device)
    meshes = [mesh_mod.get_engine_mesh(1, device),
              mesh_mod.get_engine_mesh(n_devices, device)]
    out = {}
    with tempfile.TemporaryDirectory() as td:
        ref_path, bam_path = simulate_dataset(td)
        for flank in (0, 1):
            config = PlatypusConfig(bam_files=[bam_path], ref_file=ref_path,
                                    output="-", mesh_devices=n_devices,
                                    calculate_flank_score=flank)
            counts = check_mesh_region(config, ("chr20", 0, 3000), device,
                                       meshes)
            if counts["calls"] < 3:
                raise AssertionError(f"expected the 3 planted variants "
                                     f"(flank={flank}), got {counts}")
            out["flank" if flank else "default"] = counts
    return out
