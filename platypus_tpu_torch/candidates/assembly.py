"""Local reassembly: colored de Bruijn graph bubble-calling.

Reimplements Platypus src/cython/assembler.pyx:

* graph nodes are k-mers coloured REF/READ/both; the reference sequence is
  loaded first (so shared nodes carry reference positions), then read
  k-mers gated on per-window minimum base quality and no Ns, with edge
  weights accumulating the minimum quality (assembler.pyx:1295-1387);
* nodes keep at most 4 out-edges (a 5th distinct successor is dropped,
  matching the reference's fixed edge array);
* variant discovery walks, from each in-tile REF_AND_READ node, depth-first
  along read-only paths until they rejoin the reference ("bubbles"),
  bounded by the edge-weight threshold minReads*minBaseQual, a 20-path cap
  per start node and a per-path cycle check (assembler.pyx:1027-1177);
* a bubble converts to a Variant by trailing/leading context trimming
  (assembler.pyx:1196-1291);
* regions are assembled in overlapping tiles of assemblyRegionSize stepped
  by max(100, min(1000, size/2)), gated by the gaps/improper-pair
  heuristics unless assembleAll is set (variantcaller.pyx:276-321,496-519).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import os

import numpy as np

from ..config import PlatypusConfig
from .variant import ASSEMBLER_VAR, Variant

REF = 1
READ = 2
REF_AND_READ = 3

MAX_EDGES = 4
MAX_PATHS = 20


class _Node:
    __slots__ = ("kmer", "colours", "position", "weight", "edges", "index")

    def __init__(self, kmer: bytes, colours: int, position: int, weight: float, index: int):
        self.kmer = kmer
        self.colours = colours
        self.position = position
        self.weight = weight
        self.edges: List[Tuple["_Node", float]] = []
        self.index = index


class DeBruijnGraph:
    def __init__(self, kmer_size: int):
        self.kmer_size = kmer_size
        self.nodes: Dict[bytes, _Node] = {}
        self.all_nodes: List[_Node] = []

    def _insert_or_update(self, kmer: bytes, colours: int, position: int,
                          weight: float) -> _Node:
        node = self.nodes.get(kmer)
        if node is None:
            node = _Node(kmer, colours, position, weight, len(self.all_nodes))
            self.nodes[kmer] = node
            self.all_nodes.append(node)
        else:
            node.colours |= colours
            node.weight += weight
        return node

    def add_edge(self, kmer1: bytes, kmer2: bytes, colours: int,
                 pos1: int, pos2: int, weight: float) -> None:
        start = self._insert_or_update(kmer1, colours, pos1, weight)
        end = self._insert_or_update(kmer2, colours, pos2, weight)
        for i, (en, w) in enumerate(start.edges):
            if en is end:
                start.edges[i] = (en, w + weight)
                return
        if len(start.edges) < MAX_EDGES:
            start.edges.append((end, weight))


def load_reference(graph: DeBruijnGraph, ref_seq: bytes, ref_start: int) -> None:
    k = graph.kmer_size
    for i in range(len(ref_seq) - k - 1):
        graph.add_edge(ref_seq[i : i + k], ref_seq[i + 1 : i + 1 + k],
                       REF, ref_start + i, ref_start + i + 1, 1.0)


def load_read(graph: DeBruijnGraph, seq: np.ndarray, qual: np.ndarray,
              rlen: int, min_qual: int) -> None:
    k = graph.kmer_size
    n = rlen - k - 1
    if n <= 0:
        return
    s = seq[:rlen]
    q = qual[:rlen]
    # min quality / N presence over the (k+1)-base window covering both kmers.
    win = np.lib.stride_tricks.sliding_window_view(q, k + 1)[:n]
    min_quals = win.min(axis=1)
    n_mask = np.lib.stride_tricks.sliding_window_view(s == ord("N"), k + 1)[:n].any(axis=1)
    ok = (min_quals >= min_qual) & ~n_mask
    raw = s.tobytes()
    for i in np.nonzero(ok)[0]:
        w = float(min_quals[i])
        graph.add_edge(raw[i : i + k], raw[i + 1 : i + 1 + k], READ, -1, -1, w)


def _check_path_for_cycles(path: List[_Node]) -> bool:
    return len(set(id(n) for n in path)) != len(path)


def _variant_paths_from_node(path: List[_Node], min_weight: float) -> Optional[List[Tuple[List[_Node], bool]]]:
    """DFS continuation of `path` until the reference is rejoined
    (assembler.pyx:1027-1112).  Returns None when the 20-path cap trips."""
    stack: List[List[_Node]] = [path]
    finished: List[Tuple[List[_Node], bool]] = []
    while stack:
        path_so_far = stack.pop()
        end = path_so_far[-1]
        if len(stack) + 1 > MAX_PATHS or len(finished) + 1 > MAX_PATHS:
            return None
        if _check_path_for_cycles(path_so_far):
            continue
        if end.colours == REF_AND_READ:
            finished.append((path_so_far, True))
        elif end.colours == REF:
            continue
        else:
            for edge_node, weight in end.edges:
                if weight >= min_weight or edge_node.colours in (REF_AND_READ, REF):
                    stack.append(path_so_far + [edge_node])
    return finished


def _extract_variant(path: List[_Node], is_bubble: bool, ref_seq: bytes,
                     chrom: str, ref_start: int) -> Optional[Variant]:
    start_node = path[0]
    end_node = path[-1]
    if is_bubble:
        start_pos = start_node.position
        end_pos = end_node.position
        if end_pos < start_pos:
            return None
    else:
        start_pos = start_node.position
        end_pos = start_pos
    read_seq = bytes(n.kmer[0] for n in path)
    this_ref = ref_seq[start_pos - ref_start : end_pos - ref_start + 1]
    this_read = read_seq
    while this_read and this_ref and this_ref[-1] == this_read[-1]:
        this_ref = this_ref[:-1]
        this_read = this_read[:-1]
    while this_read and this_ref and this_ref[0] == this_read[0]:
        start_pos += 1
        this_ref = this_ref[1:]
        this_read = this_read[1:]
    return Variant(chrom, start_pos, this_ref, this_read, 0, ASSEMBLER_VAR)


def find_bubbles(graph: DeBruijnGraph, min_weight: float, ref_seq: bytes,
                 chrom: str, ref_start: int, assem_start: int,
                 assem_end: int) -> List[Variant]:
    variants: List[Variant] = []
    for node in graph.all_nodes:
        if node.colours == REF_AND_READ and assem_start <= node.position < assem_end:
            for edge_node, _w in node.edges:
                if edge_node.colours == READ:
                    paths = _variant_paths_from_node([node, edge_node], min_weight)
                    if paths is None:
                        continue
                    for p, is_bubble in paths:
                        var = _extract_variant(p, is_bubble, ref_seq, chrom, ref_start)
                        if var is not None:
                            variants.append(var)
    return variants


def detect_cycles(graph: DeBruijnGraph) -> bool:
    """Iterative 3-colour DFS over all edges (assembler.pyx:873-898)."""
    WHITE, GREY, BLACK = 0, 1, 2
    colour = {id(n): WHITE for n in graph.all_nodes}
    for root in graph.all_nodes:
        if colour[id(root)] != WHITE:
            continue
        stack: List[Tuple[_Node, int]] = [(root, 0)]
        colour[id(root)] = GREY
        while stack:
            node, ei = stack[-1]
            if ei < len(node.edges):
                stack[-1] = (node, ei + 1)
                child = node.edges[ei][0]
                c = colour[id(child)]
                if c == GREY:
                    return True
                if c == WHITE:
                    colour[id(child)] = GREY
                    stack.append((child, 0))
            else:
                colour[id(node)] = BLACK
                stack.pop()
    return False


def assemble_reads_and_detect_variants(
    chrom: str, assem_start: int, assem_end: int, ref_start: int,
    ref_seq: bytes, buffers, config: PlatypusConfig,
    use_native: bool = True,
) -> List[Variant]:
    """assembler.pyx:1429-1476 for one tile.  Uses the C++ graph when built
    (same semantics; this module is the parity oracle)."""
    from ..native import NativeAssembler

    min_qual = config.min_base_qual
    kmer_size = config.assembler_kmer_size
    min_weight = config.min_reads * min_qual
    native = use_native and NativeAssembler.available()

    def read_piles(buf):
        piles = [(buf.good, buf.window_slice(assem_start, assem_end))]
        if config.assemble_bad_reads:
            piles.append((buf.bad, buf.bad_window_slice(assem_start, assem_end)))
        if config.assemble_broken_pairs:
            piles.append((buf.broken, buf.broken_window_slice(assem_start, assem_end)))
        return piles

    def build(k: int):
        g = NativeAssembler(k) if native else DeBruijnGraph(k)
        if native:
            g.load_reference(ref_seq, ref_start)
        else:
            load_reference(g, ref_seq, ref_start)
        for buf in buffers:
            for rs, sl in read_piles(buf):
                rows = np.arange(sl.start, sl.stop)[~rs.qc_fail[sl.start:sl.stop]]
                if native:
                    g.load_reads_batch(rs, rows, min_qual)
                else:
                    for i in rows:
                        load_read(g, rs.seq[i], rs.qual[i], int(rs.rlen[i]), min_qual)
        return g

    graph = build(kmer_size)
    if config.no_cycles:
        while (graph.detect_cycles() if native else detect_cycles(graph)):
            if kmer_size > 50:
                return []
            kmer_size += 5
            graph = build(kmer_size)

    if native:
        raw = graph.find_bubbles(float(min_weight), ref_seq, ref_start,
                                 assem_start, assem_end)
        variants = [Variant(chrom, pos, removed, added, 0, ASSEMBLER_VAR)
                    for pos, removed, added in raw]
    else:
        variants = find_bubbles(graph, min_weight, ref_seq, chrom, ref_start,
                                assem_start, assem_end)
    return sorted(variants, key=lambda v: v.sort_key())


def need_to_assemble(buffers, assem_start: int, assem_end: int,
                     config: PlatypusConfig) -> bool:
    """variantcaller.pyx:276-321."""
    if config.assemble_all:
        return True
    for buf in buffers:
        sl = buf.window_slice(assem_start, assem_end)
        n_good = sl.stop - sl.start
        bsl = buf.bad_window_slice(assem_start, assem_end)
        n_bad = bsl.stop - bsl.start
        if n_good == 0:
            continue
        gaps = buf.count_alignment_gaps(assem_start, assem_end)
        improper = buf.count_improper_pairs(assem_start, assem_end)
        if gaps / n_good > 2:
            return True
        if improper / (n_good + n_bad) > 0.1:
            return True
    return False


def _native_region_tiles(chrom: str, tiles, buffers, config: PlatypusConfig,
                         n_threads: int) -> Optional[List[Variant]]:
    """One native call for the whole tile loop; None → use the Python path.

    Matches the sequential path exactly: same per-(tile, pile) read-row
    slices, same per-tile variant discovery order, same per-tile sort."""
    from ..native import NativeAssembler, native_assemble_region

    if not NativeAssembler.available():
        return None

    piles = []
    slice_fns = []
    for buf in buffers:
        piles.append(buf.good)
        slice_fns.append(buf.window_slice)
        if config.assemble_bad_reads:
            piles.append(buf.bad)
            slice_fns.append(buf.bad_window_slice)
        if config.assemble_broken_pairs:
            piles.append(buf.broken)
            slice_fns.append(buf.broken_window_slice)
    for rs in piles:
        if rs.seq.ndim != 2:  # dense [N, L] payloads required
            return None

    n_tiles = len(tiles)
    slices = np.zeros((n_tiles, len(piles), 2), np.int64)
    tile_meta = []
    ref_parts = []
    off = 0
    for t, (assem_start, assem_end, ref_start, ref_seq) in enumerate(tiles):
        for p, fn in enumerate(slice_fns):
            sl = fn(assem_start, assem_end)
            slices[t, p, 0] = sl.start
            slices[t, p, 1] = sl.stop
        tile_meta.append((assem_start, assem_end, ref_start, off, len(ref_seq)))
        ref_parts.append(ref_seq)
        off += len(ref_seq)

    raw = native_assemble_region(
        tile_meta, piles, config.assembler_kmer_size, config.min_base_qual,
        float(config.min_reads * config.min_base_qual), config.no_cycles,
        n_threads, b"".join(ref_parts), slices,
    )
    if raw is None:
        return None
    out: List[Variant] = []
    for tile_vars in raw:
        vs = [Variant(chrom, pos, removed, added, 0, ASSEMBLER_VAR)
              for pos, removed, added in tile_vars]
        out.extend(sorted(vs, key=lambda v: v.sort_key()))
    return out


def assemble_region_variants(chrom: str, start: int, end: int, ref_file,
                             buffers, config: PlatypusConfig) -> List[Variant]:
    """Tile loop over a region (variantcaller.pyx:496-519).

    Tiles are independent de Bruijn graphs.  When the native library is
    built, the WHOLE tile loop runs in one ctypes call — C++ fans tiles
    out over its own thread pool with zero per-tile Python glue.  The
    Python path keeps a small thread pool as fallback.  Reference-sequence
    fetches and the assembly gate stay on the calling thread (the FASTA
    cache is not thread-safe), and results are concatenated in tile order,
    so output is deterministic either way.
    """
    from concurrent.futures import ThreadPoolExecutor

    shift = max(100, min(1000, config.assembly_region_size // 2))
    tiles = []
    for assem_start in range(start, end, shift):
        assem_end = min(assem_start + config.assembly_region_size, end)
        ref_start = max(0, assem_start - config.assembly_region_size)
        ref_end = assem_end + config.assembly_region_size
        if not need_to_assemble(buffers, assem_start, assem_end, config):
            continue
        ref_seq = ref_file.get_sequence(chrom, ref_start, ref_end)
        tiles.append((assem_start, assem_end, ref_start, ref_seq))
    if not tiles:
        return []

    budget = int(os.environ.get("PLATYPUS_TPU_WORKER_THREADS", "0")) or (os.cpu_count() or 1)
    n_workers = min(4, len(tiles), budget)

    native_out = _native_region_tiles(chrom, tiles, buffers, config, n_workers)
    if native_out is not None:
        return native_out

    def run_tile(t):
        assem_start, assem_end, ref_start, ref_seq = t
        return assemble_reads_and_detect_variants(
            chrom, assem_start, assem_end, ref_start, ref_seq, buffers, config
        )

    out: List[Variant] = []
    if n_workers <= 1:
        for t in tiles:
            out.extend(run_tile(t))
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            for res in pool.map(run_tile, tiles):
                out.extend(res)
    return out
