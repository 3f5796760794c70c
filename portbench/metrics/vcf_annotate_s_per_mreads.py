"""vcf_annotate_s_per_mreads: seconds in vcfout.records INFO and FILTER (compute_vcf_info, compute_vcf_filter), from the program's span vcf_annotate (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "vcf_annotate")
