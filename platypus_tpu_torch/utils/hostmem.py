"""Host allocator tuning for large NumPy buffers.

glibc malloc services any allocation above M_MMAP_THRESHOLD (128 KB by
default) with a fresh anonymous mmap and gives the pages straight back on
free.  Every multi-megabyte NumPy temporary in the host pipeline (read
buffers, window gathers, quality masks) therefore pays first-touch page
faults on every single allocation.  On bare metal that costs ~0.2 us/page;
on lazily-paged VMs (snapshot-restored guests, which is how the benchmark
driver runs) a first touch can take 100 us+ per page, turning vectorised
NumPy passes over ~30 MB arrays into multi-second stalls (measured 1.7 s
for one boolean compare).

Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps those buffers on the
brk heap, where freed pages stay faulted-in and are reused, so the cost is
paid once per high-water mark instead of once per allocation.

The reference engine never hit this because its Cython hot path reuses
malloc'd C arrays across windows by design (e.g. the growable read arrays
in Platypus src/cython/arrays.pyx and the per-window buffers in
cwindow.pyx); this is the allocator-level equivalent for a NumPy pipeline.
"""

from __future__ import annotations

import ctypes
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_THRESHOLD = 1 << 30  # keep every allocation below 1 GiB on the heap
_applied = False


def tune_malloc() -> bool:
    """Apply the malloc tuning to this process and export it to children.

    Returns True if mallopt was applied (or already applied).  No-op on
    non-glibc platforms or when PLATYPUS_TPU_NO_MALLOC_TUNE is set.
    """
    global _applied
    if _applied:
        return True
    if os.environ.get("PLATYPUS_TPU_NO_MALLOC_TUNE"):
        return False
    # Children (spawned workers, subprocess benches) should get the tuning
    # from glibc's own env parsing, before their interpreter allocates.
    os.environ.setdefault("MALLOC_MMAP_THRESHOLD_", str(_THRESHOLD))
    os.environ.setdefault("MALLOC_TRIM_THRESHOLD_", str(_THRESHOLD))
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, _THRESHOLD)) and bool(
            libc.mallopt(_M_TRIM_THRESHOLD, _THRESHOLD)
        )
    except (OSError, AttributeError):
        return False
    _applied = ok
    return ok
