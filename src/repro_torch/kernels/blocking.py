"""SAME-convolution geometry shared by the frontend kernels and their plain
versions (port of ``repro.kernels.blocking``'s geometry helpers).

SAME puts the extra padding element on the HIGH side: for 32x32 frames at
stride 2 with a 3x3 kernel that is pad (0, 1) on each spatial axis. The TPU
block-size helpers are not ported; the CUDA kernels choose their own launch
geometry.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def conv_out_hw(h: int, stride: int) -> int:
    """SAME-padding output extent: ceil(h / stride)."""
    return -(-h // stride)


def same_pads(h: int, w: int, kernel: int, stride: int
              ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """SAME padding amounts ((lo_h, hi_h), (lo_w, hi_w)), extra on the high
    side, exactly as ``jax.lax.conv_general_dilated(..., "SAME")``."""
    ho, wo = conv_out_hw(h, stride), conv_out_hw(w, stride)
    pad_h = max((ho - 1) * stride + kernel - h, 0)
    pad_w = max((wo - 1) * stride + kernel - w, 0)
    return ((pad_h // 2, pad_h - pad_h // 2),
            (pad_w // 2, pad_w - pad_w // 2))


def pad_same(images: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC SAME zero-padding."""
    _, h, w, _ = images.shape
    (plo_h, phi_h), (plo_w, phi_w) = same_pads(h, w, kernel, stride)
    # F.pad lists pads from the last axis backwards: C, then W, then H
    return F.pad(images, (0, 0, plo_w, phi_w, plo_h, phi_h))
