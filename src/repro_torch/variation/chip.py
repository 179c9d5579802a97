"""Per-chip device variation: a frozen profile -> deterministic mismatch maps.

Port of ``repro.variation.chip``. A fabricated sensor is never the nominal
device: each of the C x n MTJs sits at its own process corner and each
pixel column carries its own gain / offset mismatch.

    vcfg = VariationConfig(sigma_logit_offset=0.3, sigma_pixel_offset=0.1)
    chip = sample_chip(vcfg, n_channels=32, n_redundant=8, chip_id=7)

``sample_chip`` draws the reference's maps from ``(chip_seed, chip_id)``
with ``prng.normal`` (jax's words, XLA's ``erf_inv``: at most 3 float32
ulps from ``jax.random.normal``), so a chip, its calibration trim and its
yield statistics are the reference's. The maps are tensors on the device
the caller names (the GPU unless asked otherwise).

Kernel-facing operands: ``channel_operands`` folds a chip (+ the programmed
trim) into the (4, C) rows of kernel B and the fused kernels, and
``pixel_operands`` widens them to the (4, N_pix, C) per-pixel layout. Row
``CHAN_U_*`` perturbs u as ``gain * u + offset`` (pixel mismatch +
calibration trim), row ``CHAN_LOGIT_*`` the switching logit as
``gain * logit + offset`` (the channel's mean MTJ corner).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mtj as mtj_model
from repro_torch.core import pixel as pixel_model
from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class VariationConfig:
    """Process-variation profile of a chip population (frozen, hashable).

    Sampling is deterministic in ``(chip_seed, chip_id)``; the sigmas select
    the spread of each mismatch family. ``sigma=0`` for every family is the
    nominal chip.
    """
    sigma_logit_offset: float = 0.0   # per-MTJ additive switching-logit offset
    sigma_logit_slope: float = 0.0    # per-MTJ relative logit-slope spread
    sigma_r_p: float = 0.0            # per-MTJ relative R_P spread
    sigma_tmr: float = 0.0            # per-MTJ relative TMR spread
    sigma_pixel_gain: float = 0.0     # per-channel curve-gain mismatch
    sigma_pixel_offset: float = 0.0   # per-channel subtractor offset (norm units)
    sigma_column: float = 0.0         # spatially-correlated column noise (norm units)
    column_corr: float = 4.0          # column-noise correlation length (columns)
    chip_seed: int = 0                # base seed; chip i folds i into it

    @property
    def enabled(self) -> bool:
        """True when any mismatch family has non-zero spread."""
        return any(s > 0.0 for s in (
            self.sigma_logit_offset, self.sigma_logit_slope, self.sigma_r_p,
            self.sigma_tmr, self.sigma_pixel_gain, self.sigma_pixel_offset,
            self.sigma_column))

    def scaled(self, s: float) -> "VariationConfig":
        """The same profile with every sigma scaled by ``s`` (sweep axis)."""
        return dataclasses.replace(
            self,
            sigma_logit_offset=self.sigma_logit_offset * s,
            sigma_logit_slope=self.sigma_logit_slope * s,
            sigma_r_p=self.sigma_r_p * s,
            sigma_tmr=self.sigma_tmr * s,
            sigma_pixel_gain=self.sigma_pixel_gain * s,
            sigma_pixel_offset=self.sigma_pixel_offset * s,
            sigma_column=self.sigma_column * s)


class ChipMaps(NamedTuple):
    """One sampled chip: float32 tensors on one device. A stack of G chips
    (``yield_analysis``) is the same tuple with a leading (G,) axis."""
    mtj_logit_offset: torch.Tensor   # (C, n_redundant)
    mtj_logit_gain: torch.Tensor     # (C, n_redundant)
    r_p_scale: torch.Tensor          # (C, n_redundant)
    tmr_scale: torch.Tensor          # (C, n_redundant)
    pixel_gain: torch.Tensor         # (C,)
    pixel_offset: torch.Tensor       # (C,)  incl. correlated column noise


def _correlated_column_noise(key, n: int, sigma: float, corr: float,
                             device) -> torch.Tensor:
    """Unit-variance Gaussian noise, circularly smoothed to ``corr`` columns
    and scaled by ``sigma``: the reference's ``jnp.convolve`` of the noise
    repeated around the circle with a Gaussian kernel normalized to unit
    output variance, here an explicit sum over the kernel's taps in float32
    (the kernel is symmetric, so convolution and correlation agree). The
    wrap holds for any kernel radius ``r`` against ``n``. A (G, 2) stack of
    keys gives (G, n)."""
    eps = prng.normal(key, (n,), device)
    r = max(int(3.0 * corr), 1)
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * torch.square(d / max(corr, 1e-6)))
    k = k / torch.sqrt(torch.sum(torch.square(k)))
    idx = (torch.arange(n, device=device)[:, None]
           + torch.arange(-r, r + 1, device=device)[None, :]) % n
    taps = eps[..., idx]                             # (..., n, 2r + 1)
    smooth = taps[..., 0] * k[0]
    for j in range(1, 2 * r + 1):
        smooth = smooth + taps[..., j] * k[j]
    return sigma * smooth


def _family_keys(vcfg: VariationConfig, chip_id: int) -> np.ndarray:
    """The (7, 2) keys of one chip's mismatch families."""
    return prng.split(prng.fold_in(prng.PRNGKey(vcfg.chip_seed), chip_id), 7)


def _draw(vcfg: VariationConfig, ks: np.ndarray, n_channels: int,
          n_redundant: int, device) -> ChipMaps:
    """The maps of the family keys ``ks`` (7, 2), or of a stack of chips'
    (G, 7, 2) (every map then gains a leading (G,) axis, each row the
    chip's own maps bit for bit)."""
    cn = (n_channels, n_redundant)

    def normal(i, shape):
        return prng.normal(ks[..., i, :], shape, device)

    off = vcfg.sigma_logit_offset * normal(0, cn)
    gain = 1.0 + vcfg.sigma_logit_slope * normal(1, cn)
    r_p = 1.0 + vcfg.sigma_r_p * normal(2, cn)
    tmr = 1.0 + vcfg.sigma_tmr * normal(3, cn)
    pg = 1.0 + vcfg.sigma_pixel_gain * normal(4, (n_channels,))
    po = vcfg.sigma_pixel_offset * normal(5, (n_channels,))
    if vcfg.sigma_column > 0.0:
        po = po + _correlated_column_noise(ks[..., 6, :], n_channels,
                                           vcfg.sigma_column,
                                           vcfg.column_corr, device)
    # resistances and slopes are physical positives; clip the far tails
    return ChipMaps(mtj_logit_offset=off,
                    mtj_logit_gain=torch.clamp(gain, min=0.05),
                    r_p_scale=torch.clamp(r_p, min=0.05),
                    tmr_scale=torch.clamp(tmr, min=0.05),
                    pixel_gain=torch.clamp(pg, min=0.05),
                    pixel_offset=po)


def sample_chip(vcfg: VariationConfig, n_channels: int, n_redundant: int,
                chip_id: int = 0, device=None) -> ChipMaps:
    """Draw one deterministic chip instance on ``device`` (the GPU unless
    asked otherwise). The same inputs always return the same maps; a family
    at sigma 0 returns its identity map (zeros / ones)."""
    return _draw(vcfg, _family_keys(vcfg, chip_id), n_channels, n_redundant,
                 resolve_device(device))


def sample_chips(vcfg: VariationConfig, n_channels: int, n_redundant: int,
                 chip_ids: Sequence[int], device=None) -> ChipMaps:
    """``sample_chip`` of every id at once: maps with a leading (G,) axis,
    row g bit for bit chip ``chip_ids[g]``'s. Only the keys are derived a
    chip at a time (on the host); every draw is one batched op."""
    ks = np.stack([_family_keys(vcfg, cid) for cid in chip_ids])
    return _draw(vcfg, ks, n_channels, n_redundant, resolve_device(device))


def identity_chip(n_channels: int, n_redundant: int, device=None) -> ChipMaps:
    """The nominal chip on ``device`` (the GPU unless asked otherwise)."""
    device = resolve_device(device)
    cn = (n_channels, n_redundant)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return ChipMaps(mtj_logit_offset=full(cn, 0.0),
                    mtj_logit_gain=full(cn, 1.0),
                    r_p_scale=full(cn, 1.0), tmr_scale=full(cn, 1.0),
                    pixel_gain=full((n_channels,), 1.0),
                    pixel_offset=full((n_channels,), 0.0))


# --- kernel-facing channel operands ------------------------------------------

CHAN_U_GAIN = 0        # u        -> gain * u + offset   (pixel mismatch
CHAN_U_OFFSET = 1      #                                  + calibration trim)
CHAN_LOGIT_GAIN = 2    # logit    -> gain * logit + offset (MTJ corner,
CHAN_LOGIT_OFFSET = 3  #             channel mean over the n devices)
CHAN_ROWS = 4


def channel_operands(chip: ChipMaps,
                     cal_trim: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold a chip (+ the programmed trim, (C,)) into the (4, C) rows of
    kernel B and the fused kernels, on the chip's device. The folded
    majority needs one effective device a channel, so the per-MTJ logit
    maps enter as their mean over the n devices (the last axis). A stack
    of G chips (leaves (G, C, n) and (G, C), trims (G, C)) folds into
    (G, 4, C), row g chip g's rows."""
    u_off = chip.pixel_offset
    if cal_trim is not None:
        u_off = u_off + cal_trim
    return torch.stack([chip.pixel_gain, u_off,
                        torch.mean(chip.mtj_logit_gain, dim=-1),
                        torch.mean(chip.mtj_logit_offset, dim=-1)],
                       dim=-2).to(torch.float32)


def identity_operands(n_channels: int, device=None) -> torch.Tensor:
    """The no-variation (4, C) rows: a bit-exact pass-through."""
    z = torch.zeros((n_channels,), dtype=torch.float32, device=device)
    o = torch.ones((n_channels,), dtype=torch.float32, device=device)
    return torch.stack([o, z, o, z])


def pixel_operands(chip: ChipMaps, n_pix: int,
                   cal_trim: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (4, N_pix, C) per-pixel operand: the chip's (4, C) rows at every
    one of a frame's ``n_pix = H' * W'`` output positions (rows of u are
    frame-major, pixel-minor, and row r reads pixel ``r % n_pix``). A
    contiguous copy, so a caller may perturb it pixel by pixel; as it
    stands it is value-identical to the (4, C) rows at every pixel."""
    chan = channel_operands(chip, cal_trim)
    return chan[:, None, :].expand(CHAN_ROWS, n_pix,
                                   chan.shape[-1]).contiguous()


# --- the chip-perturbed device chain -----------------------------------------

def device_chain(u: torch.Tensor, theta: torch.Tensor, chip: ChipMaps,
                 trim: Optional[torch.Tensor],
                 pixel_params: pixel_model.PixelCircuitParams,
                 mtj_params: mtj_model.MTJParams
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (..., C) -> ``(v_conv, p_devices (..., C, n))`` at the chip's
    corners: pixel gain / offset (+ the trim) on u, the threshold-matching
    voltage map, then each of the n MTJs' switching probability at its own
    logit corner. The ``device`` backend draws from it and the calibration
    tester takes its expectation, so the trim is solved for the chain the
    backend runs."""
    u_eff = chip.pixel_gain * u + chip.pixel_offset
    if trim is not None:
        u_eff = u_eff + trim
    v = pixel_model.conv_voltage(u_eff, theta, pixel_params)
    p_dev = mtj_model.switching_probability(
        v[..., None], mtj_params.write_pulse_ps, mtj_params,
        logit_offset=chip.mtj_logit_offset, logit_gain=chip.mtj_logit_gain)
    return v, p_dev


# --- Fig. 8 noise maps -------------------------------------------------------

def noise_maps(chip: ChipMaps,
               mtj_params: mtj_model.MTJParams = mtj_model.DEFAULT_MTJ,
               pixel_params: pixel_model.PixelCircuitParams =
               pixel_model.DEFAULT_PIXEL
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel ``(p_fail, p_false)`` (C,) for Fig. 8 noise injection:
    each channel's heterogeneous majority error at the paper's Fig. 5
    operating points (should switch at 0.8 V, should not at 0.7 V), with
    the channel's pixel gain scaling its margin to the switching voltage
    and its offset shifting it. Works on a stack of chips too (leading
    axes broadcast)."""
    v_on = mtj_params.measured_voltages[1]
    v_off = mtj_params.measured_voltages[0]
    v_sw = pixel_params.v_sw
    vpu = pixel_params.volts_per_unit
    dv = vpu * chip.pixel_offset
    v_on_eff = v_sw + chip.pixel_gain * (v_on - v_sw) + dv
    v_off_eff = v_sw + chip.pixel_gain * (v_off - v_sw) + dv
    p_on = mtj_model.switching_probability(
        v_on_eff[..., None], mtj_params.write_pulse_ps, mtj_params,
        logit_offset=chip.mtj_logit_offset, logit_gain=chip.mtj_logit_gain)
    p_off = mtj_model.switching_probability(
        v_off_eff[..., None], mtj_params.write_pulse_ps, mtj_params,
        logit_offset=chip.mtj_logit_offset, logit_gain=chip.mtj_logit_gain)
    maj = mtj_params.majority
    p_fail = 1.0 - mtj_model.majority_prob_hetero(p_on, maj)
    p_false = mtj_model.majority_prob_hetero(p_off, maj)
    return p_fail, p_false
