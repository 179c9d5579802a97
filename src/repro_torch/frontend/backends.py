"""The SensorFrontend backends (port of ``repro.frontend.backends``).

All consume the same ``P2MConfig`` and return ``(activations, aux)`` with
the reference's aux keys; they differ in which physical effects they model:

  ideal    linear conv (no circuit curve) + Hoyer spike, the algorithmic
           upper bound.
  analog   the train-time path: two-phase circuit-curve conv + Hoyer spike,
           with the Fig. 8 bit flips (``noise_p_fail`` / ``noise_p_false``)
           when a key is given, in straight-through form.
  device   Monte-Carlo per-MTJ Bernoulli switching at the threshold-matched
           V_CONV and the n-device majority vote; the draws are threefry
           words, the reference's bit for bit (``prng.bernoulli``).
  cuda     the hand-written CUDA kernel pipeline, the counterpart of the
           reference's ``pallas``: the majority folded into one draw.

A fleet call (``SensorFrontend.fleet``) serves G chips: ``cuda`` through
``cuda_fleet_backend`` (each kernel launched once for all G, the chips'
(G, 4, C) rows), every other backend a chip at a time.

``ideal``, ``analog`` and ``device`` run one packed cuDNN convolution and
plain PyTorch; ``cuda`` runs the kernels of ``kernels/ops.py``. For
``cuda`` the patch matmul runs once, in kernel A, which also emits the
Hoyer partials; theta is combined on the device; kernel B draws the
activations and emits the V_CONV partials. With ``params["theta_carry"]``
set (only ``VisionEngine.stream`` plants it) the step is the single fused
kernel at the carried threshold, and aux still carries the FRESH theta for
the engine's drift guard.

Device variation: ``cfg.variation`` + ``cfg.chip_id`` select a sampled chip
(``variation.chip.sample_chip``, drawn once per (profile, chip, device) and
kept), and a ``ChipMaps`` in ``params["chip"]`` overrides it at call time;
``params["cal_trim"]`` is a programmed calibration trim. ``device`` runs
the chip exactly per device (``variation.chip.device_chain`` and the
heterogeneous majority of its own draws), ``cuda`` folds chip and trim into
the kernels' (4, C) channel rows, ``analog`` draws its Fig. 8 flips from the
chip's per-channel error maps, and ``ideal`` models no device and ignores
both. A profile with every sigma 0 is no chip at all, so the nominal paths
stay byte for byte what they were.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import hoyer, mtj, p2m, pixel
from repro_torch.frontend.api import (FrontendConfig, register_backend,
                                      register_fleet_backend)
from repro_torch.kernels import ops
from repro_torch.variation import chip as chip_mod


def _theta(u: torch.Tensor, v_th: torch.Tensor) -> torch.Tensor:
    """Hardware-mapped algorithmic threshold, in conv-output units."""
    return hoyer.effective_threshold(u, v_th) * v_th


@functools.lru_cache(maxsize=64)
def _sampled(vcfg: chip_mod.VariationConfig, n_channels: int,
             n_redundant: int, chip_id: int,
             device: torch.device) -> chip_mod.ChipMaps:
    """A sampled chip, drawn once per (profile, chip, device): its ~1,400
    small threefry ops would otherwise run again on every call."""
    return chip_mod.sample_chip(vcfg, n_channels, n_redundant, chip_id,
                                device=device)


def _sampled_chip(cfg: FrontendConfig,
                  device: torch.device) -> Optional[chip_mod.ChipMaps]:
    """The chip this frontend simulates, or None for the nominal device (an
    all-zero profile too, so the nominal paths stay byte for byte)."""
    if cfg.variation is None or not cfg.variation.enabled:
        return None
    return _sampled(cfg.variation, cfg.p2m.out_channels,
                    cfg.p2m.mtj.n_redundant, cfg.chip_id, device)


def _resolve_chip(cfg: FrontendConfig, params: dict,
                  device: torch.device) -> Optional[chip_mod.ChipMaps]:
    """The chip this call simulates: ``params["chip"]`` wins over the
    config's sampled chip."""
    chip = params.get("chip")
    if chip is not None:
        return (chip if isinstance(chip, chip_mod.ChipMaps)
                else chip_mod.ChipMaps(*chip))
    return _sampled_chip(cfg, device)


def _chip_rows(cfg: FrontendConfig, params: dict,
               device: torch.device) -> Optional[torch.Tensor]:
    """The kernels' (4, C) rows of this call's chip and trim, or None (the
    identity rows) for the nominal chip without a trim."""
    chip = _resolve_chip(cfg, params, device)
    trim = params.get("cal_trim")
    if chip is None and trim is None:
        return None
    if chip is None:
        chip = chip_mod.identity_chip(cfg.p2m.out_channels,
                                      cfg.p2m.mtj.n_redundant, device=device)
    return chip_mod.channel_operands(chip, trim)


def _stages(backend: str, cfg: FrontendConfig, params: dict,
            images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The deterministic stages of ``ideal`` / ``analog`` / ``device``
    before their spike or draw: the conv output ``u`` (the linear conv for
    ``ideal``, the circuit-curve conv otherwise), ``theta`` and the
    subtractor voltage ``v_conv``; for ``device`` also ``p_dev``, each of
    the n MTJs' switching probability (..., C, n), at the chip's corners
    where there is a chip or a trim. A check of where two devices may
    disagree reads the same stages the backend ran."""
    pcfg = cfg.p2m
    if backend == "ideal":
        wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
        u = p2m.phase_conv(images, wq, pcfg.stride)
    else:
        u = p2m.hardware_conv(images, params["w"], pcfg)
    theta = _theta(u, params["v_th"])
    out = {"u": u, "theta": theta}
    chip = trim = None
    if backend == "device":
        chip = _resolve_chip(cfg, params, images.device)
        trim = params.get("cal_trim")
    if chip is None and trim is None:
        out["v_conv"] = pixel.conv_voltage(u, theta, pcfg.pixel)
        if backend == "device":
            p_sw = mtj.switching_probability(
                out["v_conv"], pcfg.mtj.write_pulse_ps, pcfg.mtj)
            out["p_dev"] = p_sw[..., None].expand(*p_sw.shape,
                                                  pcfg.mtj.n_redundant)
    else:
        if chip is None:
            chip = chip_mod.identity_chip(pcfg.out_channels,
                                          pcfg.mtj.n_redundant,
                                          device=images.device)
        out["v_conv"], out["p_dev"] = chip_mod.device_chain(
            u, theta, chip, trim, pcfg.pixel, pcfg.mtj)
    return out


def _v_conv_stats(v: torch.Tensor) -> Dict:
    """Statistics of the subtractor voltage driving the VC-MTJ."""
    return {"v_conv_mean": torch.mean(v), "v_conv_min": torch.min(v),
            "v_conv_max": torch.max(v)}


def _ste_flip(o: torch.Tensor, key, p_fail, p_false) -> torch.Tensor:
    """Fig. 8 bit flips with a straight-through gradient: the forward is
    the flipped map, the gradient that of ``o``. The probabilities are
    scalars or tensors that broadcast against ``o`` (a chip's (C,) maps)."""
    k1, k2 = prng.split(key)
    fail = prng.bernoulli(k1, p_fail, o.shape, o.device)
    false = prng.bernoulli(k2, p_false, o.shape, o.device)
    noisy = torch.where(o > 0.5, 1.0 - fail.to(o.dtype), false.to(o.dtype))
    return o + (noisy - o).detach()


@register_backend("ideal", differentiable=True)
def ideal_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                  key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Ideal (no circuit curve, deterministic) reference for ablations; it
    models no device and ignores a chip or trim."""
    st = _stages("ideal", cfg, params, images)
    o, hl = hoyer.hoyer_spike(st["u"], params["v_th"])
    return o, {"hoyer_loss": hl, "theta": st["theta"],
               **_v_conv_stats(st["v_conv"])}


@register_backend("analog", differentiable=True)
def analog_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                   key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Training path: circuit-curve conv + Hoyer spike; with a key, the
    Fig. 8 bit flips: at ``noise_p_fail`` / ``noise_p_false``, or on a chip
    at its per-channel (fail, false) maps, each combined with the
    configured scalars as ``1 - (1 - a)(1 - b)`` (independent sources)."""
    pcfg = cfg.p2m
    chip = _resolve_chip(cfg, params, images.device)
    st = _stages("analog", cfg, params, images)
    o, hl = hoyer.hoyer_spike(st["u"], params["v_th"])
    if key is not None and chip is not None:
        p_fail, p_false = chip_mod.noise_maps(chip, pcfg.mtj, pcfg.pixel)
        p_fail = 1.0 - (1.0 - p_fail) * (1.0 - pcfg.noise_p_fail)
        p_false = 1.0 - (1.0 - p_false) * (1.0 - pcfg.noise_p_false)
        o = _ste_flip(o, key, p_fail, p_false)
    elif key is not None and (pcfg.noise_p_fail > 0
                              or pcfg.noise_p_false > 0):
        o = _ste_flip(o, key, pcfg.noise_p_fail, pcfg.noise_p_false)
    return o, {"hoyer_loss": hl, "theta": st["theta"],
               **_v_conv_stats(st["v_conv"])}


@register_backend("device", stateful=True)
def device_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                   key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Hardware-eval path: conv -> threshold-matching voltage -> per-MTJ
    stochastic switching x n_redundant -> majority. On a chip (or with a
    trim) each MTJ switches at its own corner and the majority is taken
    over the heterogeneous draws; theta stays that of the unperturbed u.
    The nominal chip draws the same words as
    ``mtj.sample_majority_activation``, which is this call on its
    broadcast probabilities."""
    if key is None:
        raise ValueError("the 'device' backend is stochastic — pass key=")
    st = _stages("device", cfg, params, images)
    o = mtj.sample_majority_activation_per_device(key, st["p_dev"],
                                                  cfg.p2m.mtj.majority)
    return o, {"hoyer_loss": torch.zeros((), device=images.device),
               "theta": st["theta"], **_v_conv_stats(st["v_conv"])}


@register_backend("cuda", stateful=True)
def cuda_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                 key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """The hand-written CUDA kernel pipeline (plain PyTorch on CPU tensors);
    a chip and a trim fold into the kernels' (4, C) channel rows."""
    if key is None:
        raise ValueError("the 'cuda' backend is stochastic — pass key=")
    pcfg = cfg.p2m
    wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
    kw = dict(kernel=pcfg.kernel_size, stride=pcfg.stride,
              chan=_chip_rows(cfg, params, images.device),
              pixel_params=pcfg.pixel, mtj_params=pcfg.mtj,
              precision=cfg.precision)
    carry = params.get("theta_carry")
    if carry is not None:
        o, kernel_aux = ops.p2m_frontend_fused(images, wq, params["v_th"],
                                               carry, key, **kw)
    else:
        o, kernel_aux = ops.p2m_frontend(images, wq, params["v_th"], key, **kw)
    return o, {"hoyer_loss": torch.zeros((), device=images.device),
               **kernel_aux}


def _fleet_chip_rows(cfg: FrontendConfig, params: dict, g: int,
                     device: torch.device) -> Optional[torch.Tensor]:
    """The kernels' (G, 4, C) rows of a fleet call's chips and trims (a
    stacked ``ChipMaps`` in ``params["chip"]``, (G, C) trims), or None
    (every chip nominal, no trim); without a stacked chip every row holds
    the config's sampled chip, or the nominal one under a trim."""
    chip = params.get("chip")
    trim = params.get("cal_trim")
    if chip is None:
        chip = _sampled_chip(cfg, device)
        if chip is None and trim is None:
            return None
        if chip is None:
            chip = chip_mod.identity_chip(cfg.p2m.out_channels,
                                          cfg.p2m.mtj.n_redundant,
                                          device=device)
        chip = chip_mod.ChipMaps(*(m.expand(g, *m.shape) for m in chip))
    elif not isinstance(chip, chip_mod.ChipMaps):
        chip = chip_mod.ChipMaps(*chip)
    return chip_mod.channel_operands(chip, trim)


@register_fleet_backend("cuda")
def cuda_fleet_backend(cfg: FrontendConfig, params: dict,
                       images: torch.Tensor, keys) -> Tuple[torch.Tensor,
                                                            Dict]:
    """The kernel pipeline over G chips: one launch of kernel A and one of
    kernel B (or one fused launch at the chips' carried thetas) whatever G
    is, each chip with its own key and (4, C) rows."""
    if keys is None:
        raise ValueError("the 'cuda' backend is stochastic — pass keys=")
    pcfg = cfg.p2m
    g = images.shape[0]
    wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
    kw = dict(kernel=pcfg.kernel_size, stride=pcfg.stride,
              chan=_fleet_chip_rows(cfg, params, g, images.device),
              pixel_params=pcfg.pixel, mtj_params=pcfg.mtj,
              precision=cfg.precision)
    carry = params.get("theta_carry")
    if carry is not None:
        o, kernel_aux = ops.p2m_frontend_fused_fleet(
            images, wq, params["v_th"], carry, keys, **kw)
    else:
        o, kernel_aux = ops.p2m_frontend_fleet(images, wq, params["v_th"],
                                               keys, **kw)
    return o, {"hoyer_loss": torch.zeros((g,), device=images.device),
               **kernel_aux}
