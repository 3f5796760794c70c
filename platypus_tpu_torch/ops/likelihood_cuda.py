"""The fused window inference kernel (csrc/infer_window.cu) and its wrapper.

The card route of platypus_tpu/ops/likelihood_jax.py::infer_window_batch,
an XLA program (not a Pallas kernel): genotype GL/GOF, rescale, relative
log GLs, a log-domain EM that stops each window at its own convergence,
and the posterior log ratios.  A tensor on the CPU goes to the plain torch
version (likelihood_torch.infer_window_batch); a CUDA tensor launches the
kernels or raises.  Nothing falls back, and no route gives way to another.
The library is built, bound and counted by ops/align_cuda.py
(KERNELS["infer_window"]), as K1 and K2 are.

h1/h2 must be the lexicographic genotype pairs of Hmax
(ops/likelihood.genotype_index_pairs), as every caller passes them: the
kernel's M-step finds the genotypes of each hap from that order, and it
writes NaN into every output of a batch whose pairs differ.

em_path picks the kernel's route from (Hmax, I, Rmax): "warp" (one warp
per window, a lane per individual, GL/GOF in the same launch) for small
windows of at most 32 individuals and few enough reads, else one CTA per
window with its tables in shared memory ("shared", up to 227 KB) or, for
example at Hmax = 256 with one individual or Hmax = 64 with 30, in a
global workspace ("global").
"""

from __future__ import annotations

import torch

from . import align_cuda
from .likelihood_torch import infer_window_batch as infer_window_batch_reference

# Shared memory one block may use on Hopper (227 KB), and what the CTA
# routes' EM kernel holds besides its tables (three sets of per-warp
# reduction slots).
SHARED_LIMIT = 232448
_EM_STATIC_BYTES = 3 * 8 * 4
# The warp route: the most individuals its kernel takes (a lane each).  For
# each Hmax it has a kernel for (the batch buckets up to 4,
# parallel/batch.py geom_bucket): the individuals it sums in one pass over
# a window's reads (kC, csrc/infer_window.cu gl_gof_warp), and the most
# passes x Rmax em_path sends to it.  One warp walks all of its window's
# per-read terms, once a pass, where the CTA routes spread them over
# blocks: the limits are where it beat the CTA route and the previous
# two-kernel design on the card (PERF.md section 6: full windows of Hmax
# 2-6 with 1-30 individuals and 8-64 reads each, and the slice's and the
# cohorts' batches at 6x and 30x).  Its shared memory, a few KB a window,
# always fits.
WARP_MAX_IND = 32
WARP_PASS_IND = {2: 8, 3: 8, 4: 4}
WARP_ROUTE_LIMIT = {2: 7680, 3: 1024, 4: 1536}
ROUTES = ("warp", "shared", "global")


def em_table_bytes(n_haps: int, n_ind: int) -> int:
    """Bytes of one window's EM tables on the CTA routes
    (csrc/infer_window.cu table_floats): gl_rel and log responsibilities
    [I, G], log_resp [G], log_freq and the next log_freq [H], the variant
    side's log sums [I], in float32."""
    G = n_haps * (n_haps + 1) // 2
    return 4 * (2 * n_ind * G + G + 2 * n_haps + n_ind)


def warp_read_passes(n_haps: int, n_ind: int, n_reads: int) -> int:
    """Passes over a window's reads times Rmax: the per-read steps each
    lane of the warp route takes for GL/GOF."""
    return -(-n_ind // WARP_PASS_IND[n_haps]) * n_reads


def em_path(n_haps: int, n_ind: int, n_reads: int) -> str:
    """The kernel's route for a batch of Hmax `n_haps`, `n_ind` individuals
    and Rmax `n_reads`: 'warp' where it fits (route_fits) and
    warp_read_passes is at most WARP_ROUTE_LIMIT[n_haps]; else 'shared'
    when one window's tables and the EM kernel's reduction slots fit in
    SHARED_LIMIT bytes; else 'global' (a workspace in device memory)."""
    if (route_fits("warp", n_haps, n_ind) and warp_read_passes(
            n_haps, n_ind, n_reads) <= WARP_ROUTE_LIMIT[n_haps]):
        return "warp"
    return "shared" if route_fits("shared", n_haps, n_ind) else "global"


def route_fits(route: str, n_haps: int, n_ind: int) -> bool:
    """Whether `route` can run a batch of (n_haps, n_ind): the warp route
    has a kernel for each Hmax of WARP_ROUTE_LIMIT and a lane for each of
    at most WARP_MAX_IND individuals; the shared route needs one window's
    tables in shared memory."""
    if route == "warp":
        return n_haps in WARP_ROUTE_LIMIT and n_ind <= WARP_MAX_IND
    if route == "shared":
        return em_table_bytes(n_haps, n_ind) + _EM_STATIC_BYTES <= SHARED_LIMIT
    return route == "global"


def _check_inputs(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                  has_reads):
    """Types, shapes, contiguity and one device; returns (W, H, R, I, V)."""
    dev = loglik.device
    if loglik.dim() != 3 or sample_onehot.dim() != 3 or var_hap_mask.dim() != 3:
        raise ValueError("infer_window_batch: loglik, sample_onehot and "
                         "var_hap_mask must be 3-d")
    W, H, R = loglik.shape
    I, V = sample_onehot.shape[1], var_hap_mask.shape[1]
    G = H * (H + 1) // 2
    specs = (("loglik", loglik, torch.float32, (W, H, R)),
             ("sample_onehot", sample_onehot, torch.float32, (W, I, R)),
             ("hap_mask", hap_mask, torch.bool, (W, H)),
             ("h1", h1, torch.int32, (G,)),
             ("h2", h2, torch.int32, (G,)),
             ("var_hap_mask", var_hap_mask, torch.bool, (W, V, H)),
             ("has_reads", has_reads, torch.bool, (W, I)))
    for name, t, dtype, shape in specs:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"infer_window_batch: {name} must be {dtype} on "
                             f"{dev}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"infer_window_batch: {name} must be a "
                             f"contiguous {shape} tensor, got "
                             f"{tuple(t.shape)}")
    if I == 0:
        raise ValueError("infer_window_batch: no individuals")
    return W, H, R, I, V


def launch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask, has_reads,
           em_iters: int = 100, route: str | None = None):
    """The kernel on CUDA tensors: (outputs, EM iterations each window ran
    [W] int32), the outputs being infer_window_batch's seven followed by
    those iterations, so that every caller of either entry finds them.
    `route` (one of ROUTES, em_path's choice by default) picks the
    kernel's route; a route whose tables do not fit raises.  Raises when
    the library does not build or the launch is refused."""
    W, H, R, I, V = _check_inputs(loglik, sample_onehot, hap_mask, h1, h2,
                                  var_hap_mask, has_reads)
    route = em_path(H, I, R) if route is None else route
    if route not in ROUTES or not route_fits(route, H, I):
        raise ValueError(f"infer_window_batch: route {route!r} cannot run "
                         f"Hmax={H}, I={I}")
    dev = loglik.device
    G = H * (H + 1) // 2
    tol = min(1e-3, 1.0 / (I * 4))  # reference eps, cpopulation.pyx:705
    lib = align_cuda.load("infer_window")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    lik, em, gof, gl_rel = (empty(W, I, G) for _ in range(4))
    freq, ratios, margin = empty(W, H), empty(W, V), empty(W)
    iters = empty(W, dtype=torch.int32)
    outs = (lik, em, freq, gof, ratios, gl_rel, margin, iters)
    if W == 0:
        return outs, iters
    workspace = (empty(W * em_table_bytes(H, I) // 4) if route == "global"
                 else None)
    align_cuda._launch(
        dev, "infer_window", lib.ptt_infer_window_batch,
        *(t.data_ptr() for t in (loglik, sample_onehot, hap_mask, h1, h2,
                                 var_hap_mask, has_reads, *outs)),
        None if workspace is None else workspace.data_ptr(), W, H, R, I, V,
        int(em_iters), tol, ROUTES.index(route))
    return outs, iters


def infer_window_batch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                       has_reads, em_iters: int = 100):
    """likelihood_torch.infer_window_batch's signature and outputs (lik,
    em, freq, gof, ratios, gl_rel, em_margin), and on the card an eighth:
    the EM iterations each window ran (launch).  On the card: loglik and
    sample_onehot float32, the masks bool, h1/h2 int32
    genotype_index_pairs(Hmax), all contiguous on one device."""
    dev = loglik.device
    if dev.type == "cpu":
        return infer_window_batch_reference(loglik, sample_onehot, hap_mask,
                                            h1, h2, var_hap_mask, has_reads,
                                            em_iters=em_iters)
    if dev.type != "cuda":
        raise ValueError(f"infer_window_batch: unsupported device {dev}")
    return launch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                  has_reads, em_iters)[0]
