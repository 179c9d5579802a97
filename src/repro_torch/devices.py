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
