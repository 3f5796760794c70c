"""vcf_genotypes_s_per_mreads: seconds in vcfout.records per-sample genotype fields, each site's loop over the samples, from the program's span vcf_genotypes (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "vcf_genotypes")
