"""Public frontend pipelines over the CUDA kernels (port of the serving part
of ``repro.kernels.ops``).

``p2m_frontend`` is the exact step: kernel A -> theta combined on the
device -> kernel B. ``p2m_frontend_fused`` is the streaming step: one fused
kernel at a carried theta. Both return ``(acts (B, H', W', C), aux)`` with
the reference's aux keys; every aux value comes out of the kernels' partial
reductions and stays on the device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mtj as mtj_model
from repro_torch.core import pixel as pixel_model
from repro_torch.kernels import blocking
from repro_torch.kernels.p2m_conv import (_fmix32, _gather_patches,  # noqa: F401
                                          combine_hoyer_partials,
                                          combine_v_conv_partials,
                                          draw_bits, p2m_fused_stream,
                                          p2m_phase_a_implicit, p2m_phase_b,
                                          pack_phase_weights)

conv_out_hw = blocking.conv_out_hw


def im2col(images: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC -> (B*H'*W', k*k*C) SAME patch rows (odd kernels only).

    TEST-ONLY: the row-layout definition the kernels gather in-kernel."""
    if kernel % 2 == 0:
        raise ValueError(f"im2col only supports odd kernel sizes (got "
                         f"kernel={kernel})")
    return _gather_patches(images, kernel, stride)


def resolve_precision(precision: Optional[str]) -> str:
    """The frontend's matmul precision: only float32 is ported so far."""
    if precision in (None, "f32"):
        return "f32"
    if precision == "int8":
        raise NotImplementedError("the int8 frontend kernels are not ported "
                                  "yet; use precision=None or 'f32'")
    raise ValueError(f"unknown frontend precision {precision!r} "
                     "(expected 'f32' or 'int8')")


def _prepare(images: torch.Tensor, w: torch.Tensor, kernel: int, stride: int):
    b, h, wd, cin = images.shape
    cout = w.shape[-1]
    ho, wo = conv_out_hw(h, stride), conv_out_hw(wd, stride)
    wm = pack_phase_weights(w.reshape(kernel * kernel * cin, cout))
    return (images.to(torch.float32).contiguous(), wm.contiguous(),
            (b, ho, wo, cout))


def p2m_frontend(images: torch.Tensor, w: torch.Tensor, v_th: torch.Tensor,
                 key, *, kernel: int = 3, stride: int = 2,
                 chan: Optional[torch.Tensor] = None,
                 pixel_params=pixel_model.DEFAULT_PIXEL,
                 mtj_params=mtj_model.DEFAULT_MTJ,
                 precision: Optional[str] = None):
    """Exact frontend step. images (B, H, W, C) in [0, 1]; w (k, k, C, Cout)
    quantized HWIO weights; v_th one value; key a host key (``prng``).
    Returns ``(acts (B, H', W', Cout), {"theta", "v_conv_*"})``."""
    resolve_precision(precision)
    images, wm, (b, ho, wo, cout) = _prepare(images, w, kernel, stride)
    v_th = v_th.to(torch.float32).contiguous()
    u, hoyer_partials = p2m_phase_a_implicit(
        images, wm, v_th, kernel=kernel, stride=stride,
        pixel_params=pixel_params)
    theta = combine_hoyer_partials(hoyer_partials, v_th)
    out, v_partials = p2m_phase_b(u, theta, key, chan=chan,
                                  pixel_params=pixel_params,
                                  mtj_params=mtj_params)
    n = b * ho * wo
    aux = {"theta": theta, **combine_v_conv_partials(v_partials, n, cout)}
    return out.reshape(b, ho, wo, cout), aux


def p2m_frontend_fused(images: torch.Tensor, w: torch.Tensor,
                       v_th: torch.Tensor, theta: torch.Tensor, key, *,
                       kernel: int = 3, stride: int = 2,
                       chan: Optional[torch.Tensor] = None,
                       pixel_params=pixel_model.DEFAULT_PIXEL,
                       mtj_params=mtj_model.DEFAULT_MTJ,
                       precision: Optional[str] = None):
    """Fused streaming step: the draws run at the CARRIED ``theta`` (one
    value on the device). aux carries the FRESH ``theta`` of this batch
    (the drift guard's input), ``theta_used``, ``channel_rates`` from the
    kernel's per-block counts and the ``v_conv_*`` stats."""
    resolve_precision(precision)
    images, wm, (b, ho, wo, cout) = _prepare(images, w, kernel, stride)
    v_th = v_th.to(torch.float32).contiguous()
    theta = theta.to(torch.float32).reshape(()).contiguous()
    out, hoyer_partials, v_partials, rate_partials = p2m_fused_stream(
        images, wm, v_th, theta, key, chan, kernel=kernel, stride=stride,
        pixel_params=pixel_params, mtj_params=mtj_params)
    n = b * ho * wo
    aux = {"theta": combine_hoyer_partials(hoyer_partials, v_th),
           "theta_used": theta,
           "channel_rates": torch.sum(rate_partials, dim=0) / n,
           **combine_v_conv_partials(v_partials, n, cout)}
    return out.reshape(b, ho, wo, cout), aux
