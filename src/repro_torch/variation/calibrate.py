"""Per-channel threshold-trim calibration: what a chip programs at test.

Port of ``repro.variation.calibrate``. Known frames are exposed, each
column's activation rate is compared with the design target (the nominal
chip's), and a per-column trim (an offset on the subtractor, in conv-output
units) is solved to cancel the column's composite mismatch:

    art = calibrate(params, p2m_cfg, vcfg, frames, chip_id=3)
    params = apply_calibration(params, art)     # params["cal_trim"] = trim

The rates are the chain's expectation (the heterogeneous majority, no
sampling noise) and the solver a bisection over all channels at once: the
rate is monotone increasing in an additive u-domain offset, so ``iters``
steps pin each trim to ``span / 2**iters``. The reference solves eagerly
(a jitted bisection rounds one LSB differently); this one is an eager loop
of tensor ops with no host sync inside (``torch.where``, never ``.item()``).

A stack of K chips (maps with a leading (K,) axis, ``sample_chips``) goes
through ``channel_rates`` and ``solve_trim`` in one pass: (K, C) rates and
trims, the maps lifted to (K, 1, ..., 1, C[, n]) against the frames' u, the
means taken over the frame axes only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import hoyer, mtj, p2m, pixel
from repro_torch.devices import resolve_device
from repro_torch.models.params import to_device
from repro_torch.variation.chip import (ChipMaps, VariationConfig,
                                        device_chain, sample_chip)


@dataclasses.dataclass
class CalibrationArtifact:
    """The per-chip correction a tester would program (and its audit)."""
    trim: torch.Tensor              # (C,) u-domain offset correction
    rate_err_before: torch.Tensor   # (C,) |rate - target| of the raw chip
    rate_err_after: torch.Tensor    # (C,) |rate - target| with the trim
    chip_id: int = 0


def _channel_mean(q: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The mean over the frame axes of ``u`` (all of u's axes but the last
    channel axis); a leading chip axis of ``q`` stays."""
    return torch.mean(q, dim=tuple(range(q.ndim - u.ndim, q.ndim - 1)))


def _lift(x: torch.Tensor, lead: int, u: torch.Tensor) -> torch.Tensor:
    """A stacked map (its first ``lead`` axes the chips') with one unit
    axis per frame axis of ``u`` after the chip axes."""
    return x.reshape(x.shape[:lead] + (1,) * (u.ndim - 1) + x.shape[lead:])


def channel_rates(u: torch.Tensor, theta: torch.Tensor, chip: ChipMaps,
                  trim: Optional[torch.Tensor],
                  pcfg: p2m.P2MConfig) -> torch.Tensor:
    """Expected per-channel (C,) activation rate of the chip at a trim:
    the ``device`` backend's chain (``chip.device_chain``) in expectation,
    through the heterogeneous majority. A stack of K chips (and a (C,) or
    (K, C) trim) gives (K, C)."""
    lead = chip.pixel_gain.ndim - 1
    if lead:
        chip = ChipMaps(*(_lift(m, lead, u) for m in chip))
        if trim is not None and trim.ndim > 1:
            trim = _lift(trim, lead, u)
    _, p_dev = device_chain(u, theta, chip, trim, pcfg.pixel, pcfg.mtj)
    return _channel_mean(mtj.majority_prob_hetero(p_dev, pcfg.mtj.majority),
                         u)


def target_rates(u: torch.Tensor, theta: torch.Tensor,
                 pcfg: p2m.P2MConfig) -> torch.Tensor:
    """The design-target per-channel activation rates (the nominal chip)."""
    v = pixel.conv_voltage(u, theta, pcfg.pixel)
    p_sw = mtj.switching_probability(v, pcfg.mtj.write_pulse_ps, pcfg.mtj)
    return _channel_mean(mtj.majority_prob_poly(
        p_sw, pcfg.mtj.n_redundant, pcfg.mtj.majority), u)


def solve_trim(u: torch.Tensor, theta: torch.Tensor, chip: ChipMaps,
               ref: torch.Tensor, pcfg: p2m.P2MConfig, *,
               iters: int = 16, span: float = 2.0) -> torch.Tensor:
    """Bisection for the per-channel trim of one chip: ``iters`` steps over
    ``[-span, span]`` on float32 endpoints, every channel at once, on the
    operands' device. ``ref`` holds the (C,) target rates. A stack of K
    chips gives their (K, C) trims in the same loop."""
    shape = chip.pixel_gain.shape
    lo = torch.full(shape, -span, dtype=torch.float32, device=ref.device)
    hi = torch.full(shape, span, dtype=torch.float32, device=ref.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        under = channel_rates(u, theta, chip, mid, pcfg) < ref
        lo, hi = torch.where(under, mid, lo), torch.where(under, hi, mid)
    return 0.5 * (lo + hi)


def calibrate(params: Dict, pcfg: p2m.P2MConfig, vcfg: VariationConfig,
              frames: torch.Tensor, chip_id: int = 0, *, iters: int = 16,
              span: float = 2.0, chip: Optional[ChipMaps] = None,
              device=None) -> CalibrationArtifact:
    """Solve the per-channel trim of one chip on calibration frames, on
    ``device`` (the GPU unless asked otherwise; params, frames and a given
    chip move there). ``params`` = ``{"w", "v_th"}``, the deployed frontend
    weights; ``frames`` a (B, H, W, C) batch in [0, 1]. ``chip=`` reuses
    given maps; otherwise the chip is sampled from ``(vcfg, chip_id)``."""
    device = resolve_device(device)
    if chip is None:
        chip = sample_chip(vcfg, pcfg.out_channels, pcfg.mtj.n_redundant,
                           chip_id, device=device)
    chip, params = to_device(chip, device), to_device(params, device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    v_th = params["v_th"]
    u = p2m.hardware_conv(frames, params["w"], pcfg)
    theta = hoyer.effective_threshold(u, v_th) * v_th
    ref = target_rates(u, theta, pcfg)
    trim = solve_trim(u, theta, chip, ref, pcfg, iters=iters, span=span)
    zero = torch.zeros((pcfg.out_channels,), dtype=torch.float32,
                       device=device)
    return CalibrationArtifact(
        trim=trim,
        rate_err_before=torch.abs(
            channel_rates(u, theta, chip, zero, pcfg) - ref),
        rate_err_after=torch.abs(
            channel_rates(u, theta, chip, trim, pcfg) - ref),
        chip_id=int(chip_id))


def apply_calibration(params: Dict,
                      artifact: Optional[CalibrationArtifact]) -> Dict:
    """Merge the programmed trim into a frontend param tree (a new dict);
    ``None`` returns the params unchanged (an uncalibrated chip)."""
    if artifact is None:
        return params
    return {**params, "cal_trim": artifact.trim}
