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

``ideal``, ``analog`` and ``device`` run one packed cuDNN convolution and
plain PyTorch; ``cuda`` runs the kernels of ``kernels/ops.py``. For
``cuda`` the patch matmul runs once, in kernel A, which also emits the
Hoyer partials; theta is combined on the device; kernel B draws the
activations and emits the V_CONV partials. With ``params["theta_carry"]``
set (only ``VisionEngine.stream`` plants it) the step is the single fused
kernel at the carried threshold, and aux still carries the FRESH theta for
the engine's drift guard. Chip variation and calibration trim operands come
with the variation slice and are refused where the reference reads them,
not ignored.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core import hoyer, mtj, p2m, pixel
from repro_torch.frontend.api import FrontendConfig, register_backend
from repro_torch.kernels import ops


def _theta(u: torch.Tensor, v_th: torch.Tensor) -> torch.Tensor:
    """Hardware-mapped algorithmic threshold, in conv-output units."""
    return hoyer.effective_threshold(u, v_th) * v_th


def _stages(backend: str, pcfg: p2m.P2MConfig, params: dict,
            images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The deterministic stages of ``ideal`` / ``analog`` / ``device``
    before their spike or draw: the conv output ``u`` (the linear conv for
    ``ideal``, the circuit-curve conv otherwise), ``theta`` and the
    subtractor voltage ``v_conv``; for ``device`` also the per-MTJ
    switching probability ``p_sw``. A check of where two devices may
    disagree reads the same stages the backend ran."""
    if backend == "ideal":
        wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
        u = p2m.phase_conv(images, wq, pcfg.stride)
    else:
        u = p2m.hardware_conv(images, params["w"], pcfg)
    theta = _theta(u, params["v_th"])
    out = {"u": u, "theta": theta,
           "v_conv": pixel.conv_voltage(u, theta, pcfg.pixel)}
    if backend == "device":
        out["p_sw"] = mtj.switching_probability(
            out["v_conv"], pcfg.mtj.write_pulse_ps, pcfg.mtj)
    return out


def _v_conv_stats(v: torch.Tensor) -> Dict:
    """Statistics of the subtractor voltage driving the VC-MTJ."""
    return {"v_conv_mean": torch.mean(v), "v_conv_min": torch.min(v),
            "v_conv_max": torch.max(v)}


def _refuse_variation(params: dict, names) -> None:
    for name in names:
        if params.get(name) is not None:
            raise NotImplementedError(
                f"params[{name!r}]: chip variation and calibration operands "
                "are not ported yet")


def _ste_flip(o: torch.Tensor, key, p_fail, p_false) -> torch.Tensor:
    """Fig. 8 bit flips with a straight-through gradient: the forward is
    the flipped map, the gradient that of ``o``."""
    k1, k2 = prng.split(key)
    fail = prng.bernoulli(k1, p_fail, o.shape, o.device)
    false = prng.bernoulli(k2, p_false, o.shape, o.device)
    noisy = torch.where(o > 0.5, 1.0 - fail.to(o.dtype), false.to(o.dtype))
    return o + (noisy - o).detach()


@register_backend("ideal", differentiable=True)
def ideal_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                  key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Ideal (no circuit curve, deterministic) reference for ablations; it
    models no device, so a chip operand would not reach it."""
    st = _stages("ideal", cfg.p2m, params, images)
    o, hl = hoyer.hoyer_spike(st["u"], params["v_th"])
    return o, {"hoyer_loss": hl, "theta": st["theta"],
               **_v_conv_stats(st["v_conv"])}


@register_backend("analog", differentiable=True)
def analog_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                   key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Training path: circuit-curve conv + Hoyer spike; with a key and
    ``noise_p_fail`` / ``noise_p_false`` set, the Fig. 8 bit flips."""
    _refuse_variation(params, ("chip",))
    pcfg = cfg.p2m
    st = _stages("analog", pcfg, params, images)
    o, hl = hoyer.hoyer_spike(st["u"], params["v_th"])
    if key is not None and (pcfg.noise_p_fail > 0 or pcfg.noise_p_false > 0):
        o = _ste_flip(o, key, pcfg.noise_p_fail, pcfg.noise_p_false)
    return o, {"hoyer_loss": hl, "theta": st["theta"],
               **_v_conv_stats(st["v_conv"])}


@register_backend("device", stateful=True)
def device_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                   key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """Hardware-eval path: conv -> threshold-matching voltage -> per-MTJ
    stochastic switching x n_redundant -> majority, for the nominal chip."""
    if key is None:
        raise ValueError("the 'device' backend is stochastic — pass key=")
    _refuse_variation(params, ("chip", "cal_trim"))
    pcfg = cfg.p2m
    st = _stages("device", pcfg, params, images)
    o = mtj.sample_majority_activation(key, st["p_sw"], pcfg.mtj.n_redundant,
                                       pcfg.mtj.majority)
    return o, {"hoyer_loss": torch.zeros((), device=images.device),
               "theta": st["theta"], **_v_conv_stats(st["v_conv"])}


@register_backend("cuda", stateful=True)
def cuda_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                 key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """The hand-written CUDA kernel pipeline (plain PyTorch on CPU tensors)."""
    if key is None:
        raise ValueError("the 'cuda' backend is stochastic — pass key=")
    _refuse_variation(params, ("chip", "cal_trim"))
    pcfg = cfg.p2m
    wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
    kw = dict(kernel=pcfg.kernel_size, stride=pcfg.stride,
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
