"""Weight-augmented pixel circuit + passive analog subtractor (paper §2.2.1-2).

Port of ``repro.core.pixel``: the circuit-curve registry (``ideal``,
``gf22_tanh``) with its gain / offset mismatch hooks, the photodiode
discharge, the two-phase MAC, the threshold-matching offset and
``conv_voltage``. Every
expression keeps the reference's operation order, so float32 results agree
to the ulp wherever the transcendental functions agree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

CurveFn = Callable[[torch.Tensor], torch.Tensor]
CurveFactory = Callable[["PixelCircuitParams"], CurveFn]

_CURVES: Dict[str, CurveFactory] = {}
# the id each registered curve carries into the CUDA kernels (p2m_physics.cuh)
CURVE_IDS: Dict[str, int] = {}


def register_curve(name: str, curve_id: int):
    def deco(fn: CurveFactory) -> CurveFactory:
        _CURVES[name] = fn
        CURVE_IDS[name] = curve_id
        return fn
    return deco


def get_curve(name: str, p: "PixelCircuitParams" = None, *,
              gain=None, offset=None) -> CurveFn:
    """Resolve a registered transfer curve, bound to circuit params.

    ``gain`` / ``offset`` (tensors broadcast against the curve input, or
    floats) return ``x -> gain * g(x) + offset``, the pixel-mismatch hook;
    ``None`` for both keeps the registered curve itself."""
    if name not in _CURVES:
        raise KeyError(f"unknown pixel curve {name!r}; "
                       f"registered: {sorted(_CURVES)}")
    g = _CURVES[name](p if p is not None else DEFAULT_PIXEL)
    if gain is None and offset is None:
        return g
    gn = 1.0 if gain is None else gain
    off = 0.0 if offset is None else offset
    return lambda x: gn * g(x) + off


def circuit_curve(x: torch.Tensor, saturation: float = 2.5) -> torch.Tensor:
    """Compressive pixel/bitline transfer curve over the normalized range."""
    return saturation * torch.tanh(x / saturation)


@register_curve("ideal", 0)
def _ideal(p: "PixelCircuitParams") -> CurveFn:
    return lambda x: x


@register_curve("gf22_tanh", 1)
def _gf22_tanh(p: "PixelCircuitParams") -> CurveFn:
    sat = p.saturation
    return lambda x: circuit_curve(x, sat)


@dataclasses.dataclass(frozen=True)
class PixelCircuitParams:
    """Analog front-end constants (GF22nm FDX-flavoured).

    A copy of ``repro.core.pixel.PixelCircuitParams``; tests hold the two
    equal field for field.
    """
    vdd: float = 1.0              # analog supply for the subtractor/buffer
    v_sw: float = 0.8             # VC-MTJ near-deterministic switching voltage
    norm_range: float = 3.0       # algorithmic normalized range [-3, 3] (Fig. 4a)
    curve: str = "gf22_tanh"
    saturation: float = 2.5       # Fig. 4a compressive knee of the bitline curve
    integration_time_us: float = 5.0

    @property
    def volts_per_unit(self) -> float:
        """Linear map of the +-norm_range algorithmic range onto [0, VDD]."""
        return self.vdd / (2.0 * self.norm_range)


DEFAULT_PIXEL = PixelCircuitParams()


def photodiode_discharge(intensity: torch.Tensor,
                         p: PixelCircuitParams = DEFAULT_PIXEL
                         ) -> torch.Tensor:
    """Node-N voltage after integration (linear discharge): the M1 gate
    voltage in volts for a normalized [0, 1] intensity."""
    return p.vdd * (1.0 - torch.clamp(intensity, 0.0, 1.0))


def two_phase_mac(x: torch.Tensor, w: torch.Tensor,
                  p: PixelCircuitParams = DEFAULT_PIXEL) -> torch.Tensor:
    """Signed MAC as two integration phases, each through the circuit
    curve; contracts the trailing ``w.ndim`` axes of ``x`` against ``w``."""
    g = get_curve(p.curve, p)
    axes = tuple(range(x.ndim - w.ndim, x.ndim))
    mac_pos = torch.sum(x * torch.clamp(w, min=0.0), dim=axes)
    mac_neg = torch.sum(x * torch.clamp(-w, min=0.0), dim=axes)
    return g(mac_pos) - g(mac_neg)


def hardware_conv_output(mac_pos: torch.Tensor, mac_neg: torch.Tensor,
                         p: PixelCircuitParams = DEFAULT_PIXEL
                         ) -> torch.Tensor:
    """Apply the per-phase circuit curve and subtract (normalized units)."""
    g = get_curve(p.curve, p)
    return g(mac_pos) - g(mac_neg)


def threshold_matching_offset(v_th: torch.Tensor,
                              p: PixelCircuitParams = DEFAULT_PIXEL
                              ) -> torch.Tensor:
    """V_OFS = 0.5*VDD + (V_SW - V_TH)  (paper §2.2.2)."""
    return 0.5 * p.vdd + (p.v_sw - v_th)


def algorithmic_threshold_to_volts(theta: torch.Tensor,
                                   p: PixelCircuitParams = DEFAULT_PIXEL
                                   ) -> torch.Tensor:
    """Map a normalized algorithmic threshold onto the subtractor voltage."""
    return 0.5 * p.vdd + p.volts_per_unit * theta


def conv_voltage(conv_norm: torch.Tensor, theta: torch.Tensor,
                 p: PixelCircuitParams = DEFAULT_PIXEL) -> torch.Tensor:
    """Voltage applied to the VC-MTJ for a normalized conv output.

    ``conv_norm >= theta`` iff ``V_CONV >= V_SW``; the buffer rails clip
    V_CONV to [0, ``v_conv_max(p)``].
    """
    v_th = algorithmic_threshold_to_volts(theta, p)
    v_ofs = threshold_matching_offset(v_th, p)
    v = v_ofs + p.volts_per_unit * conv_norm
    return torch.clamp(v, 0.0, v_conv_max(p))


def v_conv_max(p: PixelCircuitParams = DEFAULT_PIXEL) -> float:
    """The buffer's upper rail on V_CONV: 1.2 VDD."""
    return 1.2 * p.vdd
