"""A plain colored de Bruijn assembler: one tile's candidate variants from
its reference slice and its reads, for the comparison with the program's
native assembler.  Plain Python and numpy; it imports nothing of the
program and nothing of JAX.

Written from the description of Platypus's assembler (Rimmer et al. 2014;
SURVEY.md section 3.3 and the assembler row of its table):

* the graph's nodes are k-mers, coloured REF, READ or both.  The
  reference slice is loaded first, so a k-mer of the reference keeps the
  position where it first occurs; a node's position is set when the node
  is made and never changed;
* an edge joins two k-mers that follow each other in a sequence.  A read
  adds the edge of each (k + 1)-base window that holds no N and whose
  lowest base quality is at least `min_qual`, with that lowest quality as
  its weight (the reference's edges weigh 1).  An edge seen again adds its
  weight; a node holds at most 4 edges out, and a fifth distinct successor
  is not joined;
* bubbles: from each REF-and-READ node inside [assem_start, assem_end),
  along each edge to a READ-only node, a depth-first walk extends a path
  along edges of weight at least min_weight = min_reads x min_base_qual
  (or into any node the reference holds) until it reaches a REF-and-READ
  node: one bubble a path;
* a bubble is the bases of its path (each node's first) against the
  reference from its first node's position to its last's; the bases both
  share at the end are trimmed, then those they share at the start, which
  moves the variant right: (pos, removed, added);
* with the cycle check on, a graph holding a directed cycle is built
  again with k + 5, and the tile gives nothing once k passes 50.

Where this departs from the description, it does as the program's
assembler does, so that the two can agree exactly:

* the last (k + 1)-base window of the reference slice and of each read is
  not loaded (a window starts at 0 .. len - k - 2);
* "at most 20 paths a node" counts as the program counts: the walk from
  one edge out of a start node keeps a stack of open paths, and it is
  dropped whole, bubbles found so far included, when it pops a path while
  either the open paths (that one included) or the bubbles found would
  number more than 20;
* a path that visits a node twice is dropped when it is popped;
* a bubble whose last node lies left of its first gives no variant;
* the walk only follows an edge of weight under min_weight into a node
  the reference holds;
* a bubble found from several start nodes is returned once for each.

The cycle check uses Kahn's topological order, not a depth-first search:
either finds whether the graph holds a cycle.
"""

from __future__ import annotations

import numpy as np

REF, READ = 1, 2
BOTH = REF | READ
MAX_EDGES = 4
MAX_PATHS = 20


class Graph:
    """Nodes in the order they were made: kmer -> id, and per id its
    colours, position and out-edges [[child, weight], ...]."""

    def __init__(self):
        self.ids = {}
        self.kmers = []
        self.colours = []
        self.position = []
        self.edges = []

    def node(self, kmer: bytes, colour: int, position: int) -> int:
        i = self.ids.get(kmer)
        if i is None:
            i = len(self.kmers)
            self.ids[kmer] = i
            self.kmers.append(kmer)
            self.colours.append(colour)
            self.position.append(position)
            self.edges.append([])
        else:
            self.colours[i] |= colour
        return i

    def join(self, a: bytes, b: bytes, colour: int, pos_a: int, pos_b: int,
             weight: float) -> None:
        ia = self.node(a, colour, pos_a)
        ib = self.node(b, colour, pos_b)
        out = self.edges[ia]
        for e in out:
            if e[0] == ib:
                e[1] += weight
                return
        if len(out) < MAX_EDGES:
            out.append([ib, weight])

    def has_cycle(self) -> bool:
        n = len(self.kmers)
        indegree = np.zeros(n, np.int64)
        for out in self.edges:
            for child, _w in out:
                indegree[child] += 1
        ready = [i for i in range(n) if indegree[i] == 0]
        seen = 0
        while ready:
            i = ready.pop()
            seen += 1
            for child, _w in self.edges[i]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    ready.append(child)
        return seen < n


def build(k: int, ref_seq: bytes, ref_start: int, reads, min_qual: int) -> Graph:
    """The tile's graph: the reference slice, then each (seq, qual) read
    (uint8 arrays of the read's own length) in order."""
    g = Graph()
    for i in range(len(ref_seq) - k - 1):
        g.join(ref_seq[i:i + k], ref_seq[i + 1:i + 1 + k], REF,
               ref_start + i, ref_start + i + 1, 1.0)
    for seq, qual in reads:
        n = len(seq) - k - 1
        if n <= 0:
            continue
        win_q = np.lib.stride_tricks.sliding_window_view(qual, k + 1)[:n].min(1)
        win_n = np.lib.stride_tricks.sliding_window_view(
            seq == ord("N"), k + 1)[:n].any(1)
        raw = bytes(seq)
        for i in np.flatnonzero((win_q >= min_qual) & ~win_n):
            g.join(raw[i:i + k], raw[i + 1:i + 1 + k], READ, -1, -1,
                   float(win_q[i]))
    return g


def _walk(g: Graph, first: list, min_weight: float):
    """The bubbles reached from the path `first`, or None where the walk
    passes the path cap."""
    stack, found = [first], []
    while stack:
        path = stack.pop()
        if len(stack) + 1 > MAX_PATHS or len(found) + 1 > MAX_PATHS:
            return None
        if len(set(path)) != len(path):
            continue
        colour = g.colours[path[-1]]
        if colour == BOTH:
            found.append(path)
        elif colour == READ:
            for child, w in g.edges[path[-1]]:
                if w >= min_weight or g.colours[child] & REF:
                    stack.append(path + [child])
    return found


def _variant(g: Graph, path: list, ref_seq: bytes, ref_start: int):
    start, end = g.position[path[0]], g.position[path[-1]]
    if end < start:
        return None
    alt = bytes(g.kmers[i][0] for i in path)
    ref = ref_seq[start - ref_start:end - ref_start + 1]
    n = 0
    while n < min(len(alt), len(ref)) and alt[-1 - n] == ref[-1 - n]:
        n += 1
    alt, ref = alt[:len(alt) - n], ref[:len(ref) - n]
    n = 0
    while n < min(len(alt), len(ref)) and alt[n] == ref[n]:
        n += 1
    return (start + n, ref[n:], alt[n:])


def assemble_tile(ref_seq: bytes, ref_start: int, assem_start: int,
                  assem_end: int, reads, kmer_size: int = 15,
                  min_qual: int = 20, min_weight: float = 40.0,
                  no_cycles: bool = False):
    """(the tile's variants as a sorted list of (pos, removed, added),
    the graphs built again after a cycle)."""
    k, retries = kmer_size, 0
    g = build(k, ref_seq, ref_start, reads, min_qual)
    while no_cycles and g.has_cycle():
        if k > 50:
            return [], retries
        k += 5
        retries += 1
        g = build(k, ref_seq, ref_start, reads, min_qual)
    out = []
    for i in range(len(g.kmers)):
        if g.colours[i] != BOTH or not assem_start <= g.position[i] < assem_end:
            continue
        for child, _w in g.edges[i]:
            if g.colours[child] != READ:
                continue
            for path in _walk(g, [i, child], min_weight) or ():
                v = _variant(g, path, ref_seq, ref_start)
                if v is not None:
                    out.append(v)
    return sorted(out), retries


def tile_inputs(tiles, piles, slices, region_ref: bytes):
    """assemble_tile's inputs for each tile of one call of the program's
    region assembler, from that call's arguments: tiles (assem_start,
    assem_end, ref_start, ref_offset, ref_length), piles (read sets with
    seq and qual [N, L], rlen and qc_fail), slices [tile, pile, 2] (row
    bounds) and the tiles' reference slices laid end to end.  Yields
    (ref_seq, ref_start, assem_start, assem_end, reads)."""
    for t, (a, b, ref_start, off, n) in enumerate(tiles):
        reads = []
        for p, rs in enumerate(piles):
            for i in range(int(slices[t][p][0]), int(slices[t][p][1])):
                if rs.qc_fail[i]:
                    continue
                m = int(rs.rlen[i])
                reads.append((np.asarray(rs.seq[i][:m], np.uint8),
                              np.asarray(rs.qual[i][:m], np.uint8)))
        yield region_ref[off:off + n], int(ref_start), int(a), int(b), reads
