"""Device selection and host transfer for the torch port.

The port threads an explicit `torch.device` through every entry point, and
a run that asks for CUDA without a card fails here instead of quietly
running on the CPU.  The device `None` inside the engine means the host
path of a pool's host worker: native alignment and float64 inference,
without torch.  This module imports torch only inside the functions that
need it, so that path never loads it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

if TYPE_CHECKING:
    import torch


class DeviceError(RuntimeError):
    """Device work failed.  Every device stage raises it (the region
    pipeline's dispatch, finalize, inference and gather, through
    device_stage; the beam search and the HLA path, which score from inside
    a window's preparation or a region's call).  Each host containment
    re-raises it: a window or region whose device work failed stops the run
    instead of vanishing from the VCF."""


@contextmanager
def device_stage(device, what: str):
    """Run a device stage of the region pipeline on `device`: whatever it
    raises leaves as DeviceError (naming `what` and the device), which
    every host containment re-raises.  With `device` None the stage runs
    on the host, and what it raises passes unchanged to the host
    containments."""
    if device is None:
        yield
        return
    try:
        yield
    except DeviceError:
        raise
    except Exception as exc:
        raise DeviceError(f"{what} on {device} failed: {exc}") from exc


def require_cuda() -> "torch.device":
    """The CUDA device, or RuntimeError when this process has no card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "platypus_tpu_torch needs a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain torch versions")
    return torch.device("cuda")


def resolve_device(device: Optional[object] = None) -> "torch.device":
    """None means CUDA (and raises without a card); anything else is
    taken as given."""
    import torch

    if device is None:
        return require_cuda()
    return torch.device(device)


def fetch(tensors: Sequence["torch.Tensor"]) -> List[np.ndarray]:
    """Copy tensors of one device to host numpy arrays in ONE
    device->host transfer: their bytes, concatenated on the device, so
    the tensors may differ in dtype."""
    if not tensors:
        return []
    import torch

    flat = torch.cat([t.reshape(-1).view(torch.uint8)
                      for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[off : off + n].view(dtype).reshape(tuple(t.shape)))
        off += n
    return out
