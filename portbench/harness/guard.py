"""The import guard: the names in sys.modules whose top-level package (the
part before the first dot, compared whole) is JAX's or the JAX package's.
platypus_tpu_torch passes: its top-level name is not platypus_tpu."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "platypus_tpu")


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
