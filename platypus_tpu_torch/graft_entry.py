"""Driver entry points of the torch port (twin of the repository's
__graft_entry__.py).

entry(device)               -> (forward step on the flagship compute path,
                               example args on `device`): one batched
                               banded pair alignment (K1 on CUDA, its
                               plain version on the CPU) and the
                               log-likelihood conversion.
dryrun_multichip(n, device) -> the demo calling step on an n-shard mesh,
                               then the production path: a synthetic BAM +
                               FASTA through the port's region preparation
                               and mesh_call_region, with and without
                               --calculateFlankScore, checked against the
                               float64 host path for identical calls.

check_mesh_region is the production check on any prepared region and any
meshes; chip_smoke.py runs it on the card.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
from typing import Sequence

import numpy as np
import torch

from platypus_tpu.config import PlatypusConfig, derive_runtime
from platypus_tpu.engine.caller import finish_window
from platypus_tpu.engine.runner import open_bams
from platypus_tpu.io.fasta import FastaFile

from .engine.region import prepare_region_call
from .ops.align_cuda import band_align_padded
from .ops.align_torch import pad_alignment_inputs
from .ops.likelihood_torch import scores_to_logliks
from .parallel import mesh as mesh_mod

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cpu"):
    """(forward, args): B = 256 pairs of 100 bp reads cut from random
    haplotypes (the inputs of __graft_entry__.entry, from the same seed),
    padded on `device`; forward aligns them and converts the scores to
    per-read log-likelihoods at mapping quality 60."""
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


def dryrun_multichip(n_devices: int, device="cpu") -> dict:
    """The demo calling step on get_engine_mesh(n_devices, device), then
    the production check (check_mesh_region, against a 1-shard mesh too)
    on a synthetic 3 kb region with three planted variants, in default and
    --calculateFlankScore mode.  Returns each mode's counts."""
    mesh_mod.dryrun_multichip(n_devices, device)
    sys.path.insert(0, os.path.join(_REPO, "tests"))
    from synth import (SimHaplotype, make_reference, simulate_reads,
                       write_synth_bam)

    meshes = [mesh_mod.get_engine_mesh(1, device),
              mesh_mod.get_engine_mesh(n_devices, device)]
    out = {}
    with tempfile.TemporaryDirectory() as td:
        ref_path, ref_seq = make_reference(td, length=3000, seed=7)
        alt = SimHaplotype(ref_seq, [
            (800, 1, b"A" if ref_seq[800] != ord("A") else b"C"),
            (1600, 0, b"TG"),
            (2300, 2, b""),
        ])
        reads = simulate_reads([SimHaplotype(ref_seq, []), alt], 500, 2800,
                               read_len=80, coverage=24)
        bam_path = write_synth_bam(td, reads, ref_len=3000)
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
