"""platypus-tpu-torch: the PyTorch / CUDA port of the platypus-tpu caller.

The JAX package `platypus_tpu` stays the reference.  This package runs the
same caller on an NVIDIA GPU: the banded pair-alignment DP is a hand-written
CUDA C++ kernel for sm_90a (csrc/band_align.cu; csrc/band_align_tb.cu for
its traceback mode), the gather/pad and the fused GL -> EM -> posterior
inference are plain torch.

The package carries its own host layers -- config, io, candidates, models,
the host ops (align_core, kmer, likelihood), vcfout, heads and the native
C++ runtime (native/, built at first use into _build/) -- and imports
nothing of `platypus_tpu`.  There are no parameters to carry across: the
caller has no learned weights.  Its only "state" is the numpy arrays that
the host layers build (the per read-length group haplotype / gap-open /
read / quality matrices and pair index vectors of engine/score.py, the
InferenceBatch arrays of parallel/batch.py) and the PlatypusConfig.

Beyond one card, parallel/mesh.py runs each region's step over a mesh of
the host's GPUs (--meshDevices) and parallel/distributed.py one process
of a multi-host run (--distributed).

The package imports `torch` only where the device needs it, and never
`jax`.  Every device entry point takes an explicit `torch.device`; inside
the engine the device None is the host path of a pool's host worker.  See
utils/backend.py.
"""

__version__ = "0.1.0"

# Keep large NumPy buffers on the reusable brk heap instead of fresh mmaps
# (see utils/hostmem.py).
from .utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()
del _tune_malloc
