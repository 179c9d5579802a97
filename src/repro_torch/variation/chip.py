"""The (4, C) per-channel operand layout of kernel B and the fused kernel.

Port of the operand rows of ``repro.variation.chip``. Row ``CHAN_U_*``
perturbs u as ``gain * u + offset`` (pixel mismatch + calibration trim),
row ``CHAN_LOGIT_*`` the switching logit as ``gain * logit + offset`` (the
channel's MTJ corner). Sampling chips and folding them into these rows come
with the variation slice; the serving path runs the identity rows.
"""
from __future__ import annotations

import torch

CHAN_U_GAIN = 0
CHAN_U_OFFSET = 1
CHAN_LOGIT_GAIN = 2
CHAN_LOGIT_OFFSET = 3
CHAN_ROWS = 4


def identity_operands(n_channels: int, device=None) -> torch.Tensor:
    """The no-variation (4, C) rows: a bit-exact pass-through."""
    z = torch.zeros((n_channels,), dtype=torch.float32, device=device)
    o = torch.ones((n_channels,), dtype=torch.float32, device=device)
    return torch.stack([o, z, o, z])
