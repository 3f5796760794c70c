"""Command-line interface of the torch port: `callVariants`,
`continueCalling`, `somatic` and `denovo`.

    python -m platypus_tpu_torch.cli callVariants --bamFiles=... --refFile=... -o out.vcf
    python -m platypus_tpu_torch.cli continueCalling --vcfFile=partial.vcf
    platypus-tpu-torch callVariants ...

The flag names are the reference CLI's (Platypus.py + runner.py:512-599,
camelCase), mapped onto the PlatypusConfig dataclass.  Without an explicit
device the run needs a CUDA card and fails without one.
--calculateFlankScore=1 aligns its windows with the traceback kernel, and
--HLATyping=1 types each region as an HLA region.  --nCPU>1 runs the pool
of engine/runner.py (host workers, at most one device worker, or with
--inferenceService=1 the device-owner service); --meshDevices=N runs each
region's step over a mesh of N GPUs (parallel/mesh.py), and
--distributed=1 one process of a multi-host run
(parallel/distributed.py); --usePallas is accepted and ignored (on CUDA
the hand-written kernels are the path).  `somatic` and `denovo` filter a
VCF on the host (heads/) and touch no device.

The engine (and torch) are imported inside main(): the pool spawns its
workers, a spawned child re-imports this module as its __main__, and the
host workers must not pay for torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from typing import List, Optional

from .config import PlatypusConfig
from .utils.fileio import expand_bam_file_names, expand_list_arg

# CLI flag name (reference spelling) -> config field.
_FLAG_MAP = {
    "output": "output",
    "refFile": "ref_file",
    "regions": "regions",
    "skipRegionsFile": "skip_regions_file",
    "bamFiles": "bam_files",
    "bufferSize": "buffer_size",
    "minReads": "min_reads",
    "maxReads": "max_reads",
    "verbosity": "verbosity",
    "maxReadLength": "rlen",
    "logFileName": "log_file_name",
    "source": "source_file",
    "nCPU": "n_cpu",
    "workerPlatform": "worker_platform",
    "parseNCBI": "parse_ncbi",
    "longHaps": "long_haps",
    "alignScoreFile": "align_score_file",
    "HLATyping": "hla_typing",
    "compressReads": "compress_reads",
    "qualBinSize": "qual_bin_size",
    "fileCaching": "file_caching",
    "maxSize": "max_size",
    "largeWindows": "large_windows",
    "maxVariants": "max_variants",
    "coverageSamplingLevel": "coverage_sampling_level",
    "maxHaplotypes": "max_haplotypes",
    "skipDifficultWindows": "skip_difficult_windows",
    "getVariantsFromBAMs": "get_variants_from_bams",
    "genSNPs": "gen_snps",
    "genIndels": "gen_indels",
    "mergeClusteredVariants": "merge_clustered_variants",
    "minFlank": "min_flank",
    "trimReadFlank": "trim_read_flank",
    "filterVarsByCoverage": "filter_vars_by_coverage",
    "filteredReadsFrac": "filtered_reads_frac",
    "maxVarDist": "max_var_dist",
    "minVarDist": "min_var_dist",
    "useEMLikelihoods": "use_em_likelihoods",
    "countOnlyExactIndelMatches": "count_only_exact_indel_matches",
    "calculateFlankScore": "calculate_flank_score",
    "assemble": "assemble",
    "assembleAll": "assemble_all",
    "assemblyRegionSize": "assembly_region_size",
    "assembleBadReads": "assemble_bad_reads",
    "assemblerKmerSize": "assembler_kmer_size",
    "assembleBrokenPairs": "assemble_broken_pairs",
    "noCycles": "no_cycles",
    "minMapQual": "min_map_qual",
    "minBaseQual": "min_base_qual",
    "minGoodQualBases": "min_good_qual_bases",
    "filterDuplicates": "filter_duplicates",
    "filterReadsWithUnmappedMates": "filter_reads_with_unmapped_mates",
    "filterReadsWithDistantMates": "filter_reads_with_distant_mates",
    "filterReadPairsWithSmallInserts": "filter_read_pairs_with_small_inserts",
    "trimOverlapping": "trim_overlapping",
    "trimAdapter": "trim_adapter",
    "trimSoftClipped": "trim_soft_clipped",
    "maxGOF": "max_gof",
    "minPosterior": "min_posterior",
    "sbThreshold": "sb_threshold",
    "scThreshold": "sc_threshold",
    "abThreshold": "ab_threshold",
    "minVarFreq": "min_var_freq",
    "badReadsWindow": "bad_reads_window",
    "badReadsThreshold": "bad_reads_threshold",
    "rmsmqThreshold": "rmsmq_threshold",
    "qdThreshold": "qd_threshold",
    "hapScoreThreshold": "hap_score_threshold",
    "outputRefCalls": "output_ref_calls",
    "refCallBlockSize": "ref_call_block_size",
    "usePallas": "use_pallas",
    "deviceInference": "device_inference",
    "inferenceService": "inference_service",
    "tpuWorkers": "tpu_workers",
    "meshDevices": "mesh_devices",
    "distributed": "distributed",
}

_LIST_FLAGS = {"bamFiles", "regions", "source"}


def build_config(argv: List[str]) -> PlatypusConfig:
    fields = {f.name: f for f in dataclasses.fields(PlatypusConfig)}
    parser = argparse.ArgumentParser(prog="platypus-tpu-torch callVariants")
    for flag, field_name in _FLAG_MAP.items():
        f = fields[field_name]
        if flag in _LIST_FLAGS:
            parser.add_argument(f"--{flag}", type=str, default=None)
        elif f.type in ("int", int):
            parser.add_argument(f"--{flag}", type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(f"--{flag}", type=float, default=None)
        else:
            parser.add_argument(f"--{flag}", type=str, default=None)
    parser.add_argument("-o", dest="output_short", type=str, default=None)
    args = parser.parse_args(argv)

    config = PlatypusConfig()
    for flag, field_name in _FLAG_MAP.items():
        value = getattr(args, flag, None)
        if value is None:
            continue
        if flag in _LIST_FLAGS:
            value = expand_list_arg(value)
        setattr(config, field_name, value)
    if args.output_short:
        config.output = args.output_short
    if not config.bam_files or not config.ref_file:
        parser.error("--bamFiles and --refFile are required")
    config.bam_files = expand_bam_file_names(config.bam_files)
    return config


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """Run a CLI command.  `device` None means CUDA (RuntimeError without
    a card); tests pass device="cpu" to run the plain torch versions."""
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if not argv or argv[0] in ("--help", "-h", "help"):
        print("usage: platypus-tpu-torch {callVariants,continueCalling,"
              "somatic,denovo} [options]")
        return 0 if argv else 2
    if argv[0] in ("--version", "-V", "version"):
        from . import __version__

        print(f"platypus-tpu-torch {__version__}")
        return 0
    command, rest = argv[0], argv[1:]
    if command in ("callVariants", "continueCalling"):
        from .engine.runner import continue_calling, run_variant_caller
        from .utils.backend import resolve_device

        if command == "continueCalling":
            parser = argparse.ArgumentParser(
                prog="platypus-tpu-torch continueCalling")
            parser.add_argument("--vcfFile", required=True)
            continue_calling(parser.parse_args(rest).vcfFile,
                             resolve_device(device))
            return 0
        config = build_config(rest)
        run_variant_caller(config, resolve_device(device))
        return 0
    if command == "somatic":
        # Tumour/normal head (extensions/Cancer CLI contract).
        from .heads.somatic import filter_somatic_vcf

        parser = argparse.ArgumentParser(prog="platypus-tpu-torch somatic")
        parser.add_argument("--inputVCF", required=True)
        parser.add_argument("--outputVCF", required=True)
        parser.add_argument("--tumourSample", required=True)
        parser.add_argument("--normalSample", required=True)
        parser.add_argument("--minPosterior", type=int, default=5)
        args = parser.parse_args(rest)
        with open(args.inputVCF) as src, open(args.outputVCF, "w") as dst:
            n = filter_somatic_vcf(src, dst, args.tumourSample, args.normalSample,
                                   args.minPosterior)
        print(f"wrote {n} somatic calls to {args.outputVCF}")
        return 0
    if command == "denovo":
        # Trio head (extensions/DeNovo CLI contract: inVCF pedFile [ext]).
        from .heads.denovo import filter_denovo_vcf

        parser = argparse.ArgumentParser(prog="platypus-tpu-torch denovo")
        parser.add_argument("inputVCF")
        parser.add_argument("pedFile")
        parser.add_argument("extension", nargs="?", default="")
        args = parser.parse_args(rest)
        stem = args.inputVCF.split(".")[0]
        ext = args.extension
        with open(args.inputVCF) as src, \
                open(f"{stem}_mendelErrors{ext}.vcf", "w") as out_m, \
                open(f"{stem}_deNovoVariants{ext}.vcf", "w") as out_d, \
                open(f"{stem}_deNovoVariantsPassingBayesianFilter{ext}.vcf", "w") as out_f:
            counts = filter_denovo_vcf(src, args.pedFile, out_m, out_d, out_f)
        print(f"Found {counts[0]} mendel errors, {counts[1]} de novos "
              f"({counts[2]} passing the bayesian filter)")
        return 0
    print(f"unknown command {command!r}; use callVariants, continueCalling, "
          f"somatic or denovo")
    return 2


if __name__ == "__main__":
    sys.exit(main())
