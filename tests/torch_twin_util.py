"""Shared helper of the torch port's parity tests: each package prepares a
region through its own host code -- its own PlatypusConfig, BAM and FASTA
readers and region preparation -- from the same files, so no object of one
package ever reaches a function of the other.  Results are compared as
numpy arrays, calls or VCF bytes."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

JAX_PKG, PORT_PKG = "platypus_tpu", "platypus_tpu_torch"


def module(pkg: str, name: str):
    """`name` (e.g. "engine.region") of package `pkg`."""
    return importlib.import_module(f"{pkg}.{name}")


@dataclass
class Prepared:
    """A region prepared by one package: its PreparedRegion (`state`), the
    package's FastaFile and config, the sample count and the open BAMs."""

    state: object
    ref: object
    config: object
    n_samples: int
    bam_files: list

    def close(self) -> None:
        for bam in self.bam_files:
            bam.close()
        self.ref.close()


def prepare(pkg: str, region, device=None, **config_kw) -> Prepared:
    """prepare_region_call of package `pkg` on `region` (chrom, start,
    end) with PlatypusConfig(**config_kw); the port's runs on `device`
    (None: its host path, native alignment)."""
    cfg = module(pkg, "config")
    config = cfg.PlatypusConfig(**config_kw)
    bam_files, samples_by_bam, samples = module(pkg, "engine.runner").open_bams(config)
    ref = module(pkg, "io.fasta").FastaFile(config.ref_file)
    rt = cfg.derive_runtime(config, n_individuals=len(samples))
    rt.rlen = config.rlen
    args = (*region, bam_files, samples_by_bam, ref, config, rt)
    if pkg == PORT_PKG:
        args += (device,)
    state = module(pkg, "engine.region").prepare_region_call(*args)
    return Prepared(state, ref, config, len(samples), bam_files)
