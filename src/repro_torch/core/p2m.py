"""P2M first-layer physics: configuration, weight init and quantization.

Port of ``repro.core.p2m``: ``P2MConfig``, ``init_params``, the 4-bit
symmetric fake-quant (straight-through gradient), the relu-split phase
packing ``[w+, w-]`` that kernel A and the fused kernel consume, the int8
operand helpers of the quantized kernels, and the plain two-phase conv of
the ``ideal`` / ``analog`` / ``device`` backends (one packed cuDNN
convolution, TF32 off, XLA's SAME padding), BatchNorm folding and the
output sparsity.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import mtj, pixel
from repro_torch.kernels import blocking


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


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, as XLA divides. On CUDA PyTorch applies a
    Python-float divisor as a multiply by its reciprocal, up to an ulp off,
    which moves a weight that sits on a rounding boundary of the
    quantization grid to the next step; a tensor divisor divides."""
    return x / x.new_full((), c)


def quantize_weights(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor fake-quant (transistor-width discretization)."""
    if bits <= 0 or bits >= 16:
        return w
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = _div(torch.clamp(torch.max(torch.abs(w)), min=1e-8), qmax)
    wq = torch.round(w / scale) * scale
    # w + stop_gradient(wq - w): the straight-through estimator (the
    # gradient is the identity), in the reference's form, kept for its
    # rounding (it is not always wq bit for bit)
    return w + (wq - w).detach()


def relu_split_pack(w: torch.Tensor) -> torch.Tensor:
    """(..., C) signed weights -> (..., 2C): ``[max(w, 0), max(-w, 0)]``,
    each half a maximum against a zero tensor, as ``jnp.maximum``: a
    gradient at a tie (a quantized weight is often exactly 0) goes half to
    each phase."""
    zero = w.new_zeros(())
    return torch.cat([torch.maximum(w, zero), torch.maximum(-w, zero)],
                     dim=-1)


def phase_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC conv with HWIO weights (one analog integration phase), SAME
    padding with the extra element on the high side, as XLA pads. cuDNN
    runs it in IEEE float32: its TF32 default would move u by ~1e-3. The
    flags hold for the forward only; the backward convs run when the
    gradient is taken, which ``repro_torch.train.vision`` does under the
    same flags."""
    (pt, pb), _ = blocking.same_pads(x.shape[1], x.shape[2], w.shape[0],
                                     stride)
    _, (pl, pr) = blocking.same_pads(x.shape[1], x.shape[2], w.shape[1],
                                     stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def packed_phase_conv(x: torch.Tensor, wq: torch.Tensor, stride: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both integration phases in ONE 2C-channel convolution over the
    ``relu_split_pack`` weights: ``(mac_pos, mac_neg)``."""
    c = wq.shape[-1]
    y = phase_conv(x, relu_split_pack(wq), stride)
    return y[..., :c], y[..., c:]


def hardware_conv(x: torch.Tensor, w: torch.Tensor, cfg: P2MConfig, *,
                  curve_gain=None, out_offset=None) -> torch.Tensor:
    """Two-phase signed MAC with the per-phase circuit curve, then the
    subtractor. ``curve_gain`` scales the pixel curve (both phases, the
    ``pixel.get_curve`` hook); ``out_offset`` is the subtractor's DC
    offset, added after the difference."""
    wq = quantize_weights(w, cfg.weight_bits)
    mac_pos, mac_neg = packed_phase_conv(x, wq, cfg.stride)
    if curve_gain is None and out_offset is None:
        return pixel.hardware_conv_output(mac_pos, mac_neg, cfg.pixel)
    g = pixel.get_curve(cfg.pixel.curve, cfg.pixel, gain=curve_gain)
    u = g(mac_pos) - g(mac_neg)
    return u if out_offset is None else u + out_offset


def fuse_batchnorm(w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN into ``(w_fused, threshold_shift)`` (paper §2.4.1): the scale
    into the HWIO weights, the shift into the comparator threshold."""
    s = gamma / torch.sqrt(var + eps)
    w_fused = w * s[None, None, None, :]
    b = beta - mean * s
    return w_fused, b


def output_sparsity(o: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros in the binary activation map (Table 1 'Sp.')."""
    return 1.0 - torch.mean(o)


# --- int8 packed-operand quantization ----------------------------------------
#
# Weights: per-output-column symmetric int8 over the (K, 2C) relu-split
# operand, so column j of the packed dot dequantizes by its own scale and the
# two phases need no cross term. Activations: the fixed 1/128 grid over the
# [0, 1] photocurrent range; a power-of-two step makes the combined dequant
# factor scale/128 one exact float32 multiply. Products are < 2^14 and the
# contraction depth k*k*C_in keeps partial sums < 2^24, so any accumulator
# (int32 in the kernels, float64/float32 in the plain versions) is exact.
# torch.round rounds half to even, as jnp.round does.

ACT_SCALE_Q8 = 128.0   # activation quantization step = 1/128 (power of two)
QMAX_INT8 = 127.0      # symmetric int8 range


def quantize_packed_weights(wm: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, 2C) packed weights -> ``(wq int8, scale float32 (2C,))`` with
    ``scale_j = max|wm[:, j]| / 127`` (guarded for all-zero columns)."""
    scale = _div(torch.clamp(torch.amax(torch.abs(wm), dim=0), min=1e-12),
                 QMAX_INT8)
    wq = torch.clamp(torch.round(wm / scale), -QMAX_INT8, QMAX_INT8)
    return wq.to(torch.int8), scale.to(torch.float32)


def dequantize_packed_weights(wq: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_packed_weights`` (round-trip error <= scale/2)."""
    return wq.to(torch.float32) * scale[None, :].to(torch.float32)


def quantize_acts_q8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] activations -> int8 on the 1/128 grid: ``round(x * 128)``
    clipped to +-127."""
    return torch.clamp(torch.round(x * ACT_SCALE_Q8),
                       -QMAX_INT8, QMAX_INT8).to(torch.int8)


def packed_dequant_row(scale: torch.Tensor) -> torch.Tensor:
    """The (1, 2C) combined dequant factor ``weight_scale / 128`` of the
    int8 packed dot (the division by a power of two is exact)."""
    return (scale.to(torch.float32) / ACT_SCALE_Q8)[None, :]
