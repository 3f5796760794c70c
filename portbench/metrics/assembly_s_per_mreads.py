"""assembly_s_per_mreads: seconds in the local assembler's tile loop (the program's span assembly, inside candidate_generation), per million reads of the window."""

from portbench.metrics._program import span_per_mreads


def read(ctx):
    return span_per_mreads(ctx, "assembly")
