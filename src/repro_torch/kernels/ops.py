"""Public frontend pipelines over the CUDA kernels (port of the serving part
of ``repro.kernels.ops``).

``p2m_frontend`` is the exact step: kernel A -> theta combined on the
device -> kernel B. ``p2m_frontend_fused`` is the streaming step: one fused
kernel at a carried theta. Both return ``(acts (B, H', W', C), aux)`` with
the reference's aux keys; every aux value comes out of the kernels' partial
reductions and stays on the device. ``precision`` picks the matmul of
kernel A / the fused kernel: an explicit ``"f32"`` or ``"int8"`` wins,
otherwise the per-shape table (``kernels/autotune.py``; f32 when untuned).
``"int8"`` quantizes the packed weights on every call
(``quantize_frontend_weights``) and runs the int8 kernels; kernel B and the
device chain are the same either way.

``p2m_frontend_fleet`` / ``p2m_frontend_fused_fleet`` are the same two
steps for G chips at once (frames (G, B, H, W, C), one key a chip, the
chips' (G, 4, C) rows, the fused step's (G,) carried thetas): one launch
of each kernel whatever G is, each chip's outputs its single-chip call's,
the precision resolved at the per-chip key (``autotune.resolve_fleet``).

``p2m_conv`` is the legacy entry kept as the baseline: a materialised
``im2col`` patch matrix, then the legacy fused kernel at a given theta.

``flash_attention`` is the GQA-aware attention op over the flash-attention
kernel (``kernels/flash_attention.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mtj as mtj_model
from repro_torch.core import p2m as p2m_core
from repro_torch.core import pixel as pixel_model
from repro_torch.kernels import autotune, blocking
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import p2m_conv as pk
from repro_torch.kernels.p2m_conv import (_fmix32, _gather_patches,  # noqa: F401
                                          combine_hoyer_partials,
                                          combine_v_conv_partials,
                                          draw_bits, p2m_fused_stream,
                                          p2m_fused_stream_q8,
                                          p2m_phase_a_implicit,
                                          p2m_phase_a_implicit_q8,
                                          p2m_phase_b, pack_phase_weights)

conv_out_hw = blocking.conv_out_hw


def im2col(images: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC -> (B*H'*W', k*k*C) SAME patch rows (odd kernels only): the
    row layout the kernels gather in-kernel, materialised only for the
    legacy ``p2m_conv`` baseline and the tests."""
    if kernel % 2 == 0:
        raise ValueError(f"im2col only supports odd kernel sizes (got "
                         f"kernel={kernel})")
    return _gather_patches(images, kernel, stride)


def quantize_frontend_weights(wm: torch.Tensor):
    """Packed (K, 2C) relu-split weights -> ``(wq int8, dequant_row (1, 2C))``,
    the int8 kernels' weight operands."""
    wq, scale = p2m_core.quantize_packed_weights(wm)
    return wq.contiguous(), p2m_core.packed_dequant_row(scale).contiguous()


def _prepare(images: torch.Tensor, w: torch.Tensor, kernel: int, stride: int,
             precision: Optional[str]):
    """Contiguous float32 frames, the packed weights, the output shape and
    the resolved precision of one frontend call."""
    b, h, wd, cin = images.shape
    cout = w.shape[-1]
    ho, wo = conv_out_hw(h, stride), conv_out_hw(wd, stride)
    kk = kernel * kernel * cin
    prec = autotune.resolve_precision(b * ho * wo, kk, cout, precision)
    wm = pack_phase_weights(w.reshape(kk, cout))
    return (images.to(torch.float32).contiguous(), wm.contiguous(),
            (b, ho, wo, cout), prec)


def p2m_frontend(images: torch.Tensor, w: torch.Tensor, v_th: torch.Tensor,
                 key, *, kernel: int = 3, stride: int = 2,
                 chan: Optional[torch.Tensor] = None,
                 pixel_params=pixel_model.DEFAULT_PIXEL,
                 mtj_params=mtj_model.DEFAULT_MTJ,
                 precision: Optional[str] = None):
    """Exact frontend step. images (B, H, W, C) in [0, 1]; w (k, k, C, Cout)
    quantized HWIO weights; v_th one value; key a host key (``prng``).
    Returns ``(acts (B, H', W', Cout), {"theta", "v_conv_*"})``."""
    images, wm, (b, ho, wo, cout), prec = _prepare(images, w, kernel, stride,
                                                   precision)
    v_th = v_th.to(torch.float32).contiguous()
    if prec == "int8":
        wq, dq = quantize_frontend_weights(wm)
        u, hoyer_partials = p2m_phase_a_implicit_q8(
            images, wq, dq, v_th, kernel=kernel, stride=stride,
            pixel_params=pixel_params)
    else:
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
    kernel's per-tile counts and the ``v_conv_*`` stats — the same keys at
    either precision."""
    images, wm, (b, ho, wo, cout), prec = _prepare(images, w, kernel, stride,
                                                   precision)
    v_th = v_th.to(torch.float32).contiguous()
    theta = theta.to(torch.float32).reshape(()).contiguous()
    kw = dict(kernel=kernel, stride=stride, pixel_params=pixel_params,
              mtj_params=mtj_params)
    if prec == "int8":
        wq, dq = quantize_frontend_weights(wm)
        out, hoyer_partials, v_partials, rate_partials = p2m_fused_stream_q8(
            images, wq, dq, v_th, theta, key, chan, **kw)
    else:
        out, hoyer_partials, v_partials, rate_partials = p2m_fused_stream(
            images, wm, v_th, theta, key, chan, **kw)
    n = b * ho * wo
    aux = {"theta": combine_hoyer_partials(hoyer_partials, v_th),
           "theta_used": theta,
           "channel_rates": torch.sum(rate_partials, dim=0) / n,
           **combine_v_conv_partials(v_partials, n, cout)}
    return out.reshape(b, ho, wo, cout), aux


def _prepare_fleet(images: torch.Tensor, w: torch.Tensor, kernel: int,
                   stride: int, precision: Optional[str]):
    """``_prepare`` of a (G, B, H, W, C) fleet call: the precision resolves
    at the per-chip (N, K, C) key."""
    g, b, h, wd, cin = images.shape
    cout = w.shape[-1]
    ho, wo = conv_out_hw(h, stride), conv_out_hw(wd, stride)
    kk = kernel * kernel * cin
    prec = autotune.resolve_fleet(g, b * ho * wo, kk, cout, precision)
    wm = pack_phase_weights(w.reshape(kk, cout))
    return (images.to(torch.float32).contiguous(), wm.contiguous(),
            (g, b, ho, wo, cout), prec)


def p2m_frontend_fleet(images: torch.Tensor, w: torch.Tensor,
                       v_th: torch.Tensor, keys, *, kernel: int = 3,
                       stride: int = 2, chan: Optional[torch.Tensor] = None,
                       pixel_params=pixel_model.DEFAULT_PIXEL,
                       mtj_params=mtj_model.DEFAULT_MTJ,
                       precision: Optional[str] = None):
    """The exact step over a leading chip axis: images (G, B, H, W, C),
    ``keys`` one host key a chip, ``chan`` the chips' (G, 4, C) rows or
    None (every chip nominal); the weights are the fleet's. One kernel A
    and one kernel B launch whatever G is; each chip's theta is combined on
    the device between them. Returns ``(acts (G, B, H', W', C), aux)`` with
    a leading G on every aux value, chip g's the single-chip call's."""
    images, wm, (g, b, ho, wo, cout), prec = _prepare_fleet(
        images, w, kernel, stride, precision)
    v_th = v_th.to(torch.float32).contiguous()
    if prec == "int8":
        wq, dq = quantize_frontend_weights(wm)
        u, hoyer_partials = pk.p2m_phase_a_implicit_q8_fleet(
            images, wq, dq, v_th, kernel=kernel, stride=stride,
            pixel_params=pixel_params)
    else:
        u, hoyer_partials = pk.p2m_phase_a_implicit_fleet(
            images, wm, v_th, kernel=kernel, stride=stride,
            pixel_params=pixel_params)
    theta = pk.combine_fleet_hoyer_partials(hoyer_partials, v_th)
    out, v_partials = pk.p2m_phase_b_fleet(u, theta, keys, chan=chan,
                                           pixel_params=pixel_params,
                                           mtj_params=mtj_params)
    n = b * ho * wo
    aux = {"theta": theta,
           **pk.combine_fleet_v_conv_partials(v_partials, n, cout)}
    return out.reshape(g, b, ho, wo, cout), aux


def p2m_frontend_fused_fleet(images: torch.Tensor, w: torch.Tensor,
                             v_th: torch.Tensor, theta: torch.Tensor, keys,
                             *, kernel: int = 3, stride: int = 2,
                             chan: Optional[torch.Tensor] = None,
                             pixel_params=pixel_model.DEFAULT_PIXEL,
                             mtj_params=mtj_model.DEFAULT_MTJ,
                             precision: Optional[str] = None):
    """The fused streaming step over a leading chip axis: each chip draws
    at its own carried ``theta`` (G,) in one fused launch. aux as
    ``p2m_frontend_fused``'s with a leading G."""
    images, wm, (g, b, ho, wo, cout), prec = _prepare_fleet(
        images, w, kernel, stride, precision)
    v_th = v_th.to(torch.float32).contiguous()
    theta = theta.to(torch.float32).reshape(g).contiguous()
    kw = dict(kernel=kernel, stride=stride, pixel_params=pixel_params,
              mtj_params=mtj_params)
    if prec == "int8":
        wq, dq = quantize_frontend_weights(wm)
        out, hoyer_partials, v_partials, rate_partials = \
            pk.p2m_fused_stream_q8_fleet(images, wq, dq, v_th, theta, keys,
                                         chan, **kw)
    else:
        out, hoyer_partials, v_partials, rate_partials = \
            pk.p2m_fused_stream_fleet(images, wm, v_th, theta, keys, chan,
                                      **kw)
    n = b * ho * wo
    aux = {"theta": pk.combine_fleet_hoyer_partials(hoyer_partials, v_th),
           "theta_used": theta,
           "channel_rates": torch.sum(rate_partials, dim=1) / n,
           **pk.combine_fleet_v_conv_partials(v_partials, n, cout)}
    return out.reshape(g, b, ho, wo, cout), aux


def p2m_conv(images: torch.Tensor, w: torch.Tensor, theta, key, *,
             kernel: int = 3, stride: int = 2,
             pixel_params=pixel_model.DEFAULT_PIXEL,
             mtj_params=mtj_model.DEFAULT_MTJ) -> torch.Tensor:
    """Legacy fused P2M layer: ``im2col`` patch rows, then the legacy kernel
    at the GIVEN ``theta`` (a caller must run its own conv pass to get one —
    the double conv ``p2m_frontend`` removes). images (B, H, W, C) in
    [0, 1]; w (k, k, C, Cout) quantized weights. Returns (B, H', W', Cout)
    binary draws; the words are hashed at the flat index ``row * Cout + c``,
    as kernel B hashes them."""
    b, h, wd, cin = images.shape
    cout = w.shape[-1]
    ho, wo = conv_out_hw(h, stride), conv_out_hw(wd, stride)
    patches = im2col(images.to(torch.float32), kernel, stride).contiguous()
    wm = pack_phase_weights(w.reshape(kernel * kernel * cin, cout))
    theta = torch.as_tensor(theta, dtype=torch.float32,
                            device=images.device).reshape(()).contiguous()
    out = pk.p2m_conv(patches, wm.contiguous(), theta, key,
                      pixel_params=pixel_params, mtj_params=mtj_params)
    return out.reshape(b, ho, wo, cout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA-aware attention: (B, Sq, H, D) x (B, Sk, Hkv, D) -> (B, Sq, H,
    D), the counterpart of ``repro.kernels.ops.flash_attention``, with the
    sliding ``window`` and the unequal lengths (non-causal, no window) of
    the reference's model layer (window 0: none). The
    reference's kv-head repeat, 128-lane D padding and block sizes are TPU
    layout choices: the kernel reads kv head ``h // (H / Hkv)`` in place
    and picks its own tiles."""
    return fa.flash_attention(q, k, v, causal=causal, window=window)
