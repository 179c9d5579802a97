"""P2M first-layer physics: configuration, weight init and quantization.

Port of the serving subset of ``repro.core.p2m``: ``P2MConfig``,
``init_params``, the 4-bit symmetric fake-quant and the relu-split phase
packing ``[w+, w-]`` that kernel A and the fused kernel consume.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mtj, pixel


@dataclasses.dataclass(frozen=True)
class P2MConfig:
    """A copy of ``repro.core.p2m.P2MConfig``; tests hold the two equal."""
    in_channels: int = 3
    out_channels: int = 32      # paper §2.4.4: 32 channels (pixel pitch limit)
    kernel_size: int = 3
    stride: int = 2             # paper §2.4.4: stride 2
    weight_bits: int = 4        # Table 1: 4-bit weights
    pixel: pixel.PixelCircuitParams = pixel.DEFAULT_PIXEL
    mtj: mtj.MTJParams = mtj.DEFAULT_MTJ
    # train-time stochastic-switching noise injection (Fig. 8 study)
    noise_p_fail: float = 0.0
    noise_p_false: float = 0.0


def init_params(generator: torch.Generator, cfg: P2MConfig, *,
                device=None, dtype=torch.float32) -> dict:
    """He-normal HWIO weights and a unit ``v_th``. ``generator`` lives on
    the CPU; the draws are moved to ``device`` afterwards, so one seed gives
    the same weights on every device."""
    k = cfg.kernel_size
    fan_in = k * k * cfg.in_channels
    w = torch.randn((k, k, cfg.in_channels, cfg.out_channels),
                    generator=generator, dtype=dtype)
    w = w * (2.0 / fan_in) ** 0.5
    return {"w": w.to(device), "v_th": torch.ones((), dtype=dtype,
                                                  device=device)}


def quantize_weights(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor fake-quant (transistor-width discretization)."""
    if bits <= 0 or bits >= 16:
        return w
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.clamp(torch.max(torch.abs(w)), min=1e-8) / qmax
    wq = torch.round(w / scale) * scale
    # w + (wq - w): the reference's straight-through form, kept for its
    # rounding (it is not always wq bit for bit)
    return w + (wq - w)


def relu_split_pack(w: torch.Tensor) -> torch.Tensor:
    """(..., C) signed weights -> (..., 2C): ``[max(w, 0), max(-w, 0)]``."""
    return torch.cat([torch.clamp(w, min=0.0), torch.clamp(-w, min=0.0)],
                     dim=-1)
