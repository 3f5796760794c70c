"""platypus-tpu-torch: the PyTorch / CUDA port of the platypus-tpu caller.

The JAX package `platypus_tpu` stays the reference.  This package runs the
same `callVariants` main path on an NVIDIA GPU: the banded pair-alignment
DP is a hand-written CUDA C++ kernel for sm_90a (csrc/band_align.cu), the
gather/pad and the fused GL -> EM -> posterior inference are plain torch.

There are no parameters to carry across from the JAX package: the caller
has no learned weights.  Its only "state" is the numpy arrays that the
shared host code of `platypus_tpu` builds -- the per read-length group
haplotype / gap-open / read / quality matrices and pair index vectors
(platypus_tpu/engine/score.py, dispatch_alignment_requests) and the
InferenceBatch arrays (platypus_tpu/parallel/batch.py) -- plus the same
PlatypusConfig object.  Both packages therefore receive byte-identical
inputs by construction, and no converter exists or is needed.

This package imports `torch` and never `jax`.  From `platypus_tpu` it
imports only host-side layers (io, candidates, models, vcfout, native,
config, ops.align_core / likelihood / kmer, and the host functions of
engine and parallel.batch).  Every device entry point takes an explicit
`torch.device`; see utils/backend.py.
"""

__version__ = "0.1.0"
