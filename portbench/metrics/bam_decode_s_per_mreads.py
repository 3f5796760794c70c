"""bam_decode_s_per_mreads: seconds in the BAM decode and read QC of engine/region.load_region_buffers, on the prefetch thread or inline in region_load, from the program's span bam_decode (its total over every thread), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "bam_decode")
