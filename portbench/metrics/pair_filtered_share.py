"""pair_filtered_share: the share, in percent, of the reads the program loaded (its counter reads: good and bad piles of every region) that the read-pair checks of io.readbuffer.check_and_trim_reads set aside: the mate-unmapped, mate-distant, small-insert and duplicate filters (counters reads_filtered.<name>); None where the program has no such counters."""

from portbench.metrics._program import counters

PAIR_FILTERS = ("mate_unmapped", "mate_distant", "small_insert", "duplicate")


def read(ctx):
    c = counters()
    names = ["reads_filtered." + n for n in PAIR_FILTERS]
    if not c.get("reads") or any(n not in c for n in names):
        return None
    return 100.0 * sum(c[n] for n in names) / c["reads"]
