"""The fused window inference kernel (csrc/infer_window.cu) and its wrapper.

The card route of platypus_tpu/ops/likelihood_jax.py::infer_window_batch,
an XLA program (not a Pallas kernel): genotype GL/GOF, rescale, relative
log GLs, a log-domain EM that stops each window at its own convergence,
and the posterior log ratios, in two kernels launched by one C entry.  A
tensor on the CPU goes to the plain torch version
(likelihood_torch.infer_window_batch); a CUDA tensor launches the kernels
or raises.  Nothing falls back.  The library is built, bound and counted
by ops/align_cuda.py (KERNELS["infer_window"]), as K1 and K2 are.

h1/h2 must be the lexicographic genotype pairs of Hmax
(ops/likelihood.genotype_index_pairs), as every caller passes them: the
kernel's M-step finds the genotypes of each hap from that order, and it
writes NaN into every output of a batch whose pairs differ.

A window's EM tables live in shared memory while they fit in 227 KB
(em_path); beyond that, for example at Hmax = 256 with one individual or
Hmax = 64 with 30, the same kernel runs on a global workspace.
"""

from __future__ import annotations

import torch

from . import align_cuda
from .likelihood_torch import infer_window_batch as infer_window_batch_reference

# Shared memory one block may use on Hopper (227 KB), and what the EM
# kernel holds besides its tables (its per-warp reduction slots).
SHARED_LIMIT = 232448
_EM_STATIC_BYTES = 8 * 4


def em_table_bytes(n_haps: int, n_ind: int) -> int:
    """Bytes of one window's EM tables (csrc/infer_window.cu table_floats):
    gl_rel and log responsibilities [I, G], log_resp [G], log_freq and the
    next log_freq [H], the variant side's log sums [I], in float32."""
    G = n_haps * (n_haps + 1) // 2
    return 4 * (2 * n_ind * G + G + 2 * n_haps + n_ind)


def em_path(n_haps: int, n_ind: int) -> str:
    """'shared' when a window's EM tables and the kernel's reduction slots
    fit in SHARED_LIMIT bytes, else 'global' (a workspace in device memory)."""
    fits = em_table_bytes(n_haps, n_ind) + _EM_STATIC_BYTES <= SHARED_LIMIT
    return "shared" if fits else "global"


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
           em_iters: int = 100):
    """The kernels on CUDA tensors: (the seven outputs of
    infer_window_batch, EM iterations each window ran [W] int32).  Raises
    when the library does not build or the launch is refused."""
    W, H, R, I, V = _check_inputs(loglik, sample_onehot, hap_mask, h1, h2,
                                  var_hap_mask, has_reads)
    dev = loglik.device
    G = H * (H + 1) // 2
    tol = min(1e-3, 1.0 / (I * 4))  # reference eps, cpopulation.pyx:705
    lib = align_cuda.load("infer_window")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    lik, em, gof, gl_rel = (empty(W, I, G) for _ in range(4))
    freq, ratios, margin = empty(W, H), empty(W, V), empty(W)
    iters = empty(W, dtype=torch.int32)
    outs = (lik, em, freq, gof, ratios, gl_rel, margin)
    if W == 0:
        return outs, iters
    workspace = None
    if em_path(H, I) == "global":
        workspace = empty(W * em_table_bytes(H, I) // 4)
    align_cuda._launch(
        dev, "infer_window", lib.ptt_infer_window_batch,
        *(t.data_ptr() for t in (loglik, sample_onehot, hap_mask, h1, h2,
                                 var_hap_mask, has_reads, *outs, iters)),
        None if workspace is None else workspace.data_ptr(),
        W, H, R, I, V, int(em_iters), tol)
    return outs, iters


def infer_window_batch(loglik, sample_onehot, hap_mask, h1, h2, var_hap_mask,
                       has_reads, em_iters: int = 100):
    """likelihood_torch.infer_window_batch's signature and outputs (lik,
    em, freq, gof, ratios, gl_rel, em_margin).  On the card: loglik and
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
