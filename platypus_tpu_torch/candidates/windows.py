"""Window generation: cluster candidate variants into calling windows.

Mirrors Platypus src/python/window.py: variants are grouped by
position, interacting groups are concatenated, and near-by groups merge
subject to window-size / variant-count limits.  Windows also optionally
yield variant-free REFCALL gap blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List

from .variant import Variant


@dataclass
class Window:
    chromosome: str
    start_pos: int
    end_pos: int
    variants: List[Variant] = field(default_factory=list)

    @property
    def n_var(self) -> int:
        return len(self.variants)


def _vars_by_pos(chromosome: str, start: int, end: int,
                 sorted_variants: List[Variant]) -> List[List[Variant]]:
    by_pos = {}
    for v in sorted_variants:
        if v.ref_name == chromosome and start <= v.ref_pos < end:
            by_pos.setdefault(v.ref_pos, []).append(v)
    return [by_pos[p] for p in sorted(by_pos)]


def _bunch_interacting(vars_by_pos: List[List[Variant]], *, rlen: int,
                       max_size: int, large_windows: bool, max_var_dist: int,
                       min_var_dist: int, max_variants: int,
                       merge_clustered: bool) -> List[List[Variant]]:
    bunched: List[List[Variant]] = []
    for var_list in vars_by_pos:
        if not bunched:
            bunched.append(list(var_list))
            continue
        min_last = min(x.min_ref_pos for x in bunched[-1])
        max_last = max(x.max_ref_pos for x in bunched[-1])
        min_this = min(x.min_ref_pos for x in var_list)
        max_this = max(x.max_ref_pos for x in var_list)

        if max_last >= min_this:
            bunched[-1].extend(var_list)
        elif merge_clustered:
            this_window_size = max_this - min_last
            max_window_size = max_size if large_windows else rlen
            edge_var_dist = min_this - max_last
            if edge_var_dist < max_var_dist:
                if this_window_size <= max_window_size:
                    if len(bunched[-1]) + len(var_list) <= max_variants:
                        bunched[-1].extend(var_list)
                    elif edge_var_dist >= min_var_dist:
                        bunched.append(list(var_list))
                    else:
                        bunched[-1].extend(var_list)
                else:
                    bunched.append(list(var_list))
            else:
                bunched.append(list(var_list))
        else:
            bunched.append(list(var_list))
    return bunched


def generate_windows(
    chromosome: str,
    start: int,
    end: int,
    max_contig_pos: int,
    sorted_variants: List[Variant],
    *,
    rlen: int,
    max_size: int = 1500,
    large_windows: bool = False,
    max_var_dist: int = 15,
    min_var_dist: int = 9,
    max_variants: int = 8,
    merge_clustered: bool = True,
    output_ref_calls: bool = False,
    ref_call_block_size: int = 1000,
) -> Iterator[Window]:
    """Yield calling windows (window.py:140-238)."""
    window_vars = _bunch_interacting(
        _vars_by_pos(chromosome, start, end, sorted_variants),
        rlen=rlen, max_size=max_size, large_windows=large_windows,
        max_var_dist=max_var_dist, min_var_dist=min_var_dist,
        max_variants=max_variants, merge_clustered=merge_clustered,
    )

    for index, vars_this_window in enumerate(window_vars):
        win_start = max(min(v.min_ref_pos for v in vars_this_window) - min_var_dist, start)
        win_end = min(max(v.max_ref_pos for v in vars_this_window) + min_var_dist, max_contig_pos)

        if output_ref_calls:
            if index == 0:
                first_var_pos = max(min(v.min_ref_pos for v in vars_this_window) + 1, start)
                if first_var_pos - start >= 1:
                    for block_start in range(start, first_var_pos, ref_call_block_size):
                        block_end = min(block_start + ref_call_block_size, first_var_pos - 1)
                        if block_start == block_end:
                            continue
                        yield Window(chromosome, block_start, block_end, [])
            else:
                last_var_pos = max(v.max_ref_pos for v in window_vars[index - 1])
                next_var_pos = min(v.min_ref_pos for v in vars_this_window) + 1
                if next_var_pos - last_var_pos > 1:
                    for block_start in range(last_var_pos + 1, next_var_pos, ref_call_block_size):
                        block_end = min(block_start + ref_call_block_size, next_var_pos - 1)
                        if block_start == block_end:
                            continue
                        yield Window(chromosome, block_start, block_end, [])

        yield Window(chromosome, win_start, win_end, list(vars_this_window))
