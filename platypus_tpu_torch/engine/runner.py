"""Top-level entry of the torch port: one process, one device.

Twin of platypus_tpu/engine/runner.py's run_single_process and the
n_cpu <= 1 branch of run_variant_caller, with its --HLATyping branch
(runner.py:275-298).  Region generation, BAM opening, logging setup and
the VCF writer are the JAX package's host code.  The options the port
does not run yet raise NotImplementedError naming the flag; none of them
falls back to the JAX package.  --usePallas is accepted and ignored: on
CUDA the hand-written kernels are the path.
"""

from __future__ import annotations

import logging
import sys
from typing import List, Optional, Sequence

import torch

from platypus_tpu.config import PlatypusConfig, derive_runtime
from platypus_tpu.engine.region import RegionPrefetch
from platypus_tpu.engine.runner import (Region, _chrom_sort_key, get_regions,
                                        open_bams, setup_logging)
from platypus_tpu.io.fasta import FastaFile
from platypus_tpu.vcfout.writer import VCFWriter

from ..utils.backend import DeviceError
from .hla import call_hla_variants_in_region
from .region import (begin_region_inference, finish_region_call,
                     prepare_region_call)

logger = logging.getLogger("platypus_tpu")

# (flag, config field, predicate on its value that the port cannot run)
UNSUPPORTED = (
    ("--nCPU", "n_cpu", lambda v: v > 1),
    ("--meshDevices", "mesh_devices", lambda v: v != 0),
    ("--distributed", "distributed", lambda v: v != 0),
    ("--inferenceService", "inference_service", lambda v: v != 0),
)


def check_supported(config: PlatypusConfig) -> None:
    for flag, field_name, unsupported in UNSUPPORTED:
        value = getattr(config, field_name)
        if unsupported(int(value)):
            raise NotImplementedError(
                f"{flag}={value} is not supported by platypus_tpu_torch yet; "
                f"run it with the platypus_tpu package")


def run_single_process(
    config: PlatypusConfig,
    regions: Sequence[Region],
    output_path: str,
    device: torch.device,
    append: bool = False,
) -> int:
    """Call all given regions into one VCF file on `device` (with
    --HLATyping=1, through run_hla_regions).

    Three-deep region pipeline (runner.py:176-186): while region k does
    its host work and queues its alignments, region k-1's scores are
    awaited and its inference queued, and region k-2's inference is
    gathered and written.  Output stays in region order because writes
    happen only in finish_region_call."""
    bam_files, samples_by_bam, samples = open_bams(config)
    ref_file = FastaFile(config.ref_file, parse_ncbi=bool(config.parse_ncbi))
    rt = derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen

    out = sys.stdout if output_path == "-" else open(
        output_path, "a" if append else "w")
    writer = VCFWriter(out, samples, options_line=config.to_json())
    if not append:
        writer.write_header()

    regions = list(regions)
    n_written = 0
    aligning = None   # PreparedRegion whose alignments are in flight
    inferring = None  # PreparedRegion whose inference is in flight
    prefetch = None   # next region's BAM decode on a helper thread
    try:
        if config.hla_typing:
            return run_hla_regions(config, regions, bam_files, samples_by_bam,
                                   ref_file, rt, out, device)
        for index, (chrom, start, end) in enumerate(regions):
            if index % 10 == 0:
                logger.info("Processing region %s:%s-%s", chrom, start, end)
            state = prepare_region_call(chrom, start, end, bam_files,
                                        samples_by_bam, ref_file, config, rt,
                                        device, preloaded=prefetch)
            if prefetch is not None:
                prefetch.join()  # never leave the helper running into a fetch
                prefetch = None
            if index + 1 < len(regions):
                prefetch = RegionPrefetch(bam_files, samples_by_bam,
                                          *regions[index + 1], config)
            if aligning is not None:
                begin_region_inference(aligning, config, device)
            if inferring is not None:
                n_written += finish_region_call(inferring, ref_file, config,
                                                writer, device)
            inferring, aligning = aligning, state
        for state in (inferring, aligning):
            if state is not None:
                n_written += finish_region_call(state, ref_file, config,
                                                writer, device)
    finally:
        if prefetch is not None:
            prefetch.join()
        if output_path != "-":
            out.close()
        for bam in bam_files:
            bam.close()
        ref_file.close()
    return n_written


def run_hla_regions(config: PlatypusConfig, regions, bam_files,
                    samples_by_bam, ref_file, rt, out,
                    device: torch.device) -> int:
    """--HLATyping=1: every region in order through the port's
    call_hla_variants_in_region, writing to `out` (runner.py:275-298).
    A region that fails on the host is skipped and logged as there; a
    DeviceError stops the run."""
    n_written = 0
    for index, (chrom, start, end) in enumerate(regions):
        if index % 10 == 0:
            logger.info("Processing region %s:%s-%s", chrom, start, end)
        try:
            n_written += call_hla_variants_in_region(
                chrom, start, end, bam_files, samples_by_bam, ref_file,
                config, rt, out, device)
        except DeviceError:
            raise  # the region's device work is not contained
        except Exception:  # noqa: BLE001 — region crash containment
            logger.exception("Region %s:%s-%s will be skipped",
                             chrom, start, end)
    return n_written


def run_variant_caller(config: PlatypusConfig, device: torch.device,
                       regions: Optional[List[Region]] = None) -> None:
    setup_logging(config)
    check_supported(config)
    if regions is None:
        regions = get_regions(config)
    regions = sorted(regions, key=lambda r: (_chrom_sort_key(r[0]), r[1], r[2]))
    run_single_process(config, regions, config.output, device)
