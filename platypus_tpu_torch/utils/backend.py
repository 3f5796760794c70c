"""Device selection and host transfer for the torch port.

Counterpart of platypus_tpu/utils/backend.py.  The JAX package infers its
backend from the environment; the port instead threads an explicit
`torch.device` through every entry point, and a run that asks for CUDA
without a card fails here instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


class DeviceError(RuntimeError):
    """Device work failed inside a host stage that contains crashes (the
    beam search scores reads from inside a window's preparation; the HLA
    path calls windows and scores regions inside its window and region
    containment).  Each containment re-raises it: a window or region whose
    device work failed stops the run instead of vanishing from the VCF."""


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when this process has no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "platypus_tpu_torch needs a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain torch versions")
    return torch.device("cuda")


def resolve_device(device: Optional[object] = None) -> torch.device:
    """None means CUDA (and raises without a card); anything else is
    taken as given."""
    if device is None:
        return require_cuda()
    return torch.device(device)


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy same-dtype device tensors to host numpy arrays in ONE
    device->host transfer (flattened and concatenated on the device)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[off : off + n].reshape(tuple(t.shape)))
        off += n
    return out
