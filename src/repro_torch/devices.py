"""Where the port's entry points run: the GPU unless the caller asks for
another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the GPU, or a RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port's engines "
                           "run on the GPU unless asked otherwise — pass "
                           "device=\"cpu\" to run the plain PyTorch versions")
    return torch.device("cuda")


def to_device_async(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device`` without waiting for the device:
    to a CUDA device through a pinned staging copy and a non-blocking copy
    (a copy from pageable memory first waits for every queued kernel of
    the stream, a host sync on each call)."""
    t = torch.as_tensor(x)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
