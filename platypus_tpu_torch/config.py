"""Configuration for the platypus-tpu variant caller.

One dataclass holds every knob of the calling pipeline.  Flag names and
defaults mirror the reference caller's CLI contract (see
Platypus src/python/runner.py:519-597) so that users of the reference
can move over without relearning options, but the object is an immutable-ish
dataclass rather than a mutated optparse namespace.  Runtime-derived values
(longest observed read, per-process sample count) live in `RuntimeState`.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PlatypusConfig:
    # ---- I/O -------------------------------------------------------------
    bam_files: List[str] = field(default_factory=list)
    ref_file: str = ""
    output: str = "AllVariants.vcf"
    regions: Optional[List[str]] = None
    skip_regions_file: Optional[str] = None
    source_file: Optional[List[str]] = None  # VCFs of candidate alleles
    log_file_name: str = "log.txt"
    parse_ncbi: int = 0

    # ---- Sharding / process model ---------------------------------------
    buffer_size: int = 100_000         # region shard size in bp
    n_cpu: int = 1                     # host-side worker processes
    # Platform of the calling workers.  "auto": the n_cpu<=1 process runs
    # on the card, spawned n_cpu>1 host workers run the bit-identical CPU
    # path and at most one device worker owns the card.  A value other than
    # "default" turns the automatic device worker off (engine/runner.py
    # _n_device_workers).  Device-scale parallelism goes
    # through parallel/ (mesh and torch.distributed).
    worker_platform: str = "auto"
    max_reads: int = 5_000_000         # per-region read cap
    compress_reads: int = 0
    qual_bin_size: int = 1
    file_caching: int = 0

    # ---- Candidate generation --------------------------------------------
    min_reads: int = 2
    max_size: int = 1500               # max variant size / window size cap
    large_windows: int = 0
    max_variants: int = 8              # max variants per window
    coverage_sampling_level: int = 30
    max_haplotypes: int = 50
    skip_difficult_windows: int = 0
    get_variants_from_bams: int = 1
    gen_snps: int = 1
    gen_indels: int = 1
    merge_clustered_variants: int = 1
    min_flank: int = 10
    trim_read_flank: int = 0
    filter_vars_by_coverage: int = 1
    filtered_reads_frac: float = 0.7
    max_var_dist: int = 15
    min_var_dist: int = 9
    use_em_likelihoods: int = 0
    count_only_exact_indel_matches: int = 0
    calculate_flank_score: int = 0

    # ---- Assembly ---------------------------------------------------------
    assemble: int = 0
    assemble_all: int = 1
    assembly_region_size: int = 1500
    assemble_bad_reads: int = 1
    assembler_kmer_size: int = 15
    assemble_broken_pairs: int = 0
    no_cycles: int = 0

    # ---- Read filters -----------------------------------------------------
    min_map_qual: int = 20
    min_base_qual: int = 20
    min_good_qual_bases: int = 20
    filter_duplicates: int = 1
    filter_reads_with_unmapped_mates: int = 1
    filter_reads_with_distant_mates: int = 1
    filter_read_pairs_with_small_inserts: int = 1
    trim_overlapping: int = 1
    trim_adapter: int = 1
    trim_soft_clipped: int = 1

    # ---- Genotype calling / filters ---------------------------------------
    max_gof: int = 30
    min_posterior: int = 5
    sb_threshold: float = 1e-3
    sc_threshold: float = 0.95
    ab_threshold: float = 1e-3
    min_var_freq: float = 0.05
    bad_reads_window: int = 11
    bad_reads_threshold: int = 15
    rmsmq_threshold: int = 40
    qd_threshold: int = 10
    hap_score_threshold: int = 4

    # ---- Output ------------------------------------------------------------
    output_ref_calls: int = 0
    ref_call_block_size: int = 1000
    verbosity: int = 2

    # ---- HLA mode -----------------------------------------------------------
    hla_typing: int = 0
    long_haps: int = 0
    align_score_file: str = ""

    # ---- Read length -------------------------------------------------------
    # Reference default 150; updated at runtime to the longest observed read
    # (reference runner.py:528, variantcaller.pyx:478-487).
    rlen: int = 150

    # ---- Device knobs (no reference equivalent) ---------------------------
    use_pallas: int = 1                # accepted and ignored: CUDA kernels run
    # Fused device GL/EM/posterior inference (parallel/batch.py): -1 = auto
    # (on when the run's device is CUDA), 0 = host float64 path, 1 = on.
    device_inference: int = -1
    # Device-owner inference service for multi-worker runs
    # (engine/device_service.py): one spawned process owns the card and
    # serves fused inference to the nCPU host workers.  0 = off, 1 = on.
    # PLATYPUS_TPU_INFERENCE_SERVICE overrides.
    inference_service: int = 0
    # Hybrid worker pool (engine/runner.py): add ONE device worker to the
    # nCPU host workers; it steals whole regions from the shared queue and
    # calls them end-to-end on the card.  -1 = auto (engine/runner.py
    # _n_device_workers), 0 = off, 1 = force.
    # PLATYPUS_TPU_HYBRID_WORKER overrides.
    tpu_workers: int = -1
    # Device-mesh calling path (parallel/mesh.mesh_call_region): alignment +
    # inference for a region's windows run as ONE sharded program over an
    # n-device mesh.  0 = off (single-device async dispatch), -1 = all local
    # devices, N = first N devices.
    mesh_devices: int = 0
    # Multi-host mode (parallel/distributed.py): each process of a
    # torch.distributed group calls its share of the regions, rank 0 merges.
    distributed: int = 0
    read_len_bucket: int = 160         # padded read length for DP batching
    batch_lanes: int = 128             # alignment batch lane width
    max_anchors: int = 4               # anchor candidates per (read, hap)
    device_mesh_shape: Optional[List[int]] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PlatypusConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclass
class RuntimeState:
    """Per-process state derived from data (mutable, unlike the config)."""

    n_individuals: int = 1
    max_haplotypes: int = 257          # capped: variantcaller.pyx:916-924
    original_max_haplotypes: int = 257
    max_genotypes: int = 33153
    rlen: int = 150


def derive_runtime(config: PlatypusConfig, n_individuals: int) -> RuntimeState:
    """Compute the per-run capped limits (reference variantcaller.pyx:916-933)."""
    max_haps = config.max_haplotypes if config.max_haplotypes != -1 else 257
    original = max_haps
    max_haps = min(257, max_haps)
    n_geno = max_haps * (max_haps + 1) // 2
    if not config.hla_typing:
        n_geno = original * (original + 1) // 2
    return RuntimeState(
        n_individuals=n_individuals,
        max_haplotypes=max_haps,
        original_max_haplotypes=original,
        max_genotypes=min(33153, n_geno) if config.hla_typing else n_geno,
        rlen=config.rlen,
    )
