"""What can stand in a stage's place for reading the limits of `correct`:
the control (the plain inference in bfloat16 in K3's place) and faults
planted under the timed path.  Each is set on a module attribute that the
program looks up at call time, beneath the benchmark's own wrappers
(harness/probes.py), so the comparison sees what the broken stage made.

The benchmark's own runs use none of them; `run.py --control` and
`run.py --fault` read their numbers at a cell's own load, and the CPU tests
check that each makes `correct` false.
"""

from __future__ import annotations

import contextlib

import numpy as np


def _k3_bf16(orig):
    import torch

    from portbench.reference import em

    def k3(ll, oh, hm, h1, h2, vm, hr, em_iters=100):
        outs = em.infer_window_batch(ll.to(torch.bfloat16),
                                     oh.to(torch.bfloat16), hm, h1, h2, vm,
                                     hr, em_iters=em_iters)
        return tuple(o.float() for o in outs)
    return k3


def _k1_altered(orig):
    def k1(*args, **kw):
        out = orig(*args, **kw).clone()
        out[len(out) // 2] += 1  # one score of each launch altered
        return out
    return k1


def _k3_unchanged(orig):
    def k3(*args, em_iters=100):
        return orig(*args, em_iters=0)  # the EM returns its starting state
    return k3


def _k3_half(orig):
    def k3(*args, em_iters=100):
        import torch

        W = args[0].shape[0]
        h = max(1, W // 2)
        # h1 / h2 (args 3, 4) index genotypes, not windows
        part = orig(*(a[:h] if k not in (3, 4) and a.dim() and a.shape[0] == W
                      else a for k, a in enumerate(args)), em_iters=em_iters)
        # the left-out windows take the mean over the rest
        return tuple(torch.cat([p, p.mean(0, keepdim=True).expand(
            W - h, *p.shape[1:])]) if W > h else p for p in part)
    return k3


def _candidates_half(orig):
    def generate(*args, **kw):
        return orig(*args, **kw)[::2]  # every other candidate left out
    return generate


def _genotype_altered(orig):
    def finish(*args, **kw):
        call = orig(*args, **kw)
        if call is not None and len(call.hap1_idx) > 1:
            # one sample's genotype likelihoods of each window moved by one
            # genotype, so its best genotype is another
            i = call.window.start_pos % len(call.likelihoods)
            lik = call.likelihoods.copy()
            lik[i] = np.roll(lik[i], 1)
            call.likelihoods = lik
        return call
    return finish


# name: (module, attribute, the stand-in made from the original)
SUBSTITUTES = {
    "bf16": ("platypus_tpu_torch.ops.likelihood_cuda", "infer_window_batch",
             _k3_bf16),
    "k1_altered": ("platypus_tpu_torch.ops.align_cuda", "band_align_pairs",
                   _k1_altered),
    "k3_unchanged": ("platypus_tpu_torch.ops.likelihood_cuda",
                     "infer_window_batch", _k3_unchanged),
    "k3_half": ("platypus_tpu_torch.ops.likelihood_cuda", "infer_window_batch",
                _k3_half),
    "candidates_half": ("platypus_tpu_torch.engine.region",
                        "generate_variants_in_region", _candidates_half),
    "genotype_altered": ("platypus_tpu_torch.engine.region", "finish_window",
                         _genotype_altered),
}
CONTROLS = ("bf16",)
FAULTS = tuple(k for k in SUBSTITUTES if k not in CONTROLS)


@contextlib.contextmanager
def planted(name):
    """Put SUBSTITUTES[name] in place for the duration (None: nothing)."""
    if name is None:
        yield
        return
    import importlib

    path, attr, make = SUBSTITUTES[name]
    module = importlib.import_module(path)
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)
