"""Temporal drift: a sampled chip that ages (port of
``repro.lifetime.drift``).

    dcfg = DriftConfig(sigma_pixel_offset=0.1, tau_frames=1e4)
    maps = sample_drift_maps(dcfg, n_channels, n_redundant, chip_id)
    aged = evolve_chip(chip, maps, t, dcfg=dcfg)     # t in frames

Each drift family's sigma is its magnitude at the log-time age ``a(t) =
log1p(t / tau_frames) = 1``; a sinusoidal temperature excursion adds a
common-mode switching-logit shift. The perturbations act through the same
``ChipMaps`` fields the variation physics reads, so an aged chip goes into
every backend as ``params["chip"]``. A zero-rate profile returns the input
chip object itself; ``t = 0`` returns its values bit for bit.

The drift directions are drawn as the reference draws them (``fold_in`` of
the chip id into ``PRNGKey(drift_seed)``, six split keys, ``prng.normal``:
jax's words, at most 3 float32 ulps from ``jax.random.normal``). The age
enters in float32, as in the reference: ``aging`` and ``temp_excursion_c``
turn ``t`` into a float32 tensor (a 0-d CPU tensor for a Python number,
which a card's maps take as a scalar operand) before ``log1p`` and ``sin``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.p2m import _div
from repro_torch.devices import resolve_device, to_device_async
from repro_torch.variation.chip import ChipMaps


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Aging profile of a chip population (frozen, hashable). Rates are per
    unit of the log-time factor ``a(t) = log1p(t / tau_frames)``; every
    rate at 0 (and ``temp_amplitude_c = 0``) makes ``evolve_chip`` the
    identity at any age."""
    sigma_logit_offset: float = 0.0   # per-MTJ additive logit drift / age unit
    sigma_logit_gain: float = 0.0     # per-MTJ relative slope drift
    sigma_r_p: float = 0.0            # per-MTJ relative R_P drift
    sigma_tmr: float = 0.0            # per-MTJ relative TMR random drift
    tmr_retention: float = 0.0        # common TMR-window loss (retention)
    sigma_pixel_gain: float = 0.0     # per-channel curve-gain random drift
    pixel_gain_aging: float = 0.0     # common curve-gain fade
    sigma_pixel_offset: float = 0.0   # per-channel subtractor offset drift
    tau_frames: float = 1.0e4         # age normalization of the log-time law
    # ambient temperature: dT(t) = amplitude * sin(2 pi t / period), a
    # common-mode switching-logit shift of temp_logit_per_c * dT
    temp_amplitude_c: float = 0.0
    temp_period_frames: float = 1.0e5
    temp_logit_per_c: float = -0.02   # logit shift per deg C
    drift_seed: int = 1               # base seed; chip i folds i into it

    @property
    def enabled(self) -> bool:
        """True when any drift family has a non-zero rate."""
        return any(r > 0.0 for r in (
            self.sigma_logit_offset, self.sigma_logit_gain, self.sigma_r_p,
            self.sigma_tmr, self.tmr_retention, self.sigma_pixel_gain,
            self.pixel_gain_aging, self.sigma_pixel_offset,
            self.temp_amplitude_c))

    def scaled(self, s: float) -> "DriftConfig":
        """The same profile with every rate scaled by ``s`` (sweep axis)."""
        return dataclasses.replace(
            self,
            sigma_logit_offset=self.sigma_logit_offset * s,
            sigma_logit_gain=self.sigma_logit_gain * s,
            sigma_r_p=self.sigma_r_p * s,
            sigma_tmr=self.sigma_tmr * s,
            tmr_retention=self.tmr_retention * s,
            sigma_pixel_gain=self.sigma_pixel_gain * s,
            pixel_gain_aging=self.pixel_gain_aging * s,
            sigma_pixel_offset=self.sigma_pixel_offset * s,
            temp_amplitude_c=self.temp_amplitude_c * s)


class DriftMaps(NamedTuple):
    """One chip's frozen unit-normal drift directions (float32 tensors); a
    stack of G chips' has a leading (G,) axis on every map."""
    d_logit_offset: torch.Tensor   # (C, n_redundant)
    d_logit_gain: torch.Tensor     # (C, n_redundant)
    d_r_p: torch.Tensor            # (C, n_redundant)
    d_tmr: torch.Tensor            # (C, n_redundant)
    d_pixel_gain: torch.Tensor     # (C,)
    d_pixel_offset: torch.Tensor   # (C,)


def _drift_keys(dcfg: DriftConfig, chip_id: int) -> np.ndarray:
    """The (6, 2) keys of one chip's drift families."""
    return prng.split(prng.fold_in(prng.PRNGKey(dcfg.drift_seed), chip_id),
                      6)


def sample_drift_maps(dcfg: DriftConfig, n_channels: int, n_redundant: int,
                      chip_id: Union[int, Sequence[int]] = 0,
                      device=None) -> DriftMaps:
    """One chip's deterministic drift directions on ``device`` (the GPU
    unless asked otherwise), or, for a sequence of chip ids, every chip's
    at once with a leading (G,) axis (row g bit for bit chip g's; only the
    keys are derived a chip at a time, on the host)."""
    if isinstance(chip_id, (int, np.integer)):
        ks = _drift_keys(dcfg, int(chip_id))
    else:
        ks = np.stack([_drift_keys(dcfg, int(c)) for c in chip_id])
    device = resolve_device(device)
    cn = (n_channels, n_redundant)

    def normal(i, shape):
        return prng.normal(ks[..., i, :], shape, device)

    return DriftMaps(d_logit_offset=normal(0, cn), d_logit_gain=normal(1, cn),
                     d_r_p=normal(2, cn), d_tmr=normal(3, cn),
                     d_pixel_gain=normal(4, (n_channels,)),
                     d_pixel_offset=normal(5, (n_channels,)))


def _age(t) -> torch.Tensor:
    """The age as float32: a tensor keeps its device, a number becomes a
    0-d CPU tensor (rounded to float32 as ``jnp.asarray(t, float32)``)."""
    return torch.as_tensor(t, dtype=torch.float32)


def aging(t, tau_frames: float) -> torch.Tensor:
    """Log-time aging factor ``log1p(max(t, 0) / tau)`` in float32: 0 at
    t = 0, 1 at t ~ 1.72 tau."""
    return torch.log1p(_div(torch.clamp(_age(t), min=0.0), tau_frames))


def temp_excursion_c(t, dcfg: DriftConfig) -> torch.Tensor:
    """Ambient-temperature excursion (deg C) at frame age ``t``, in float32
    with the reference's order ``(2 pi * t) / period``."""
    return dcfg.temp_amplitude_c * torch.sin(
        _div(2.0 * math.pi * _age(t), dcfg.temp_period_frames))


def _fleet_factors(t, dcfg: DriftConfig, device: torch.device):
    """The aging and temperature-logit factors of a (G,) age vector: each
    age's 0-d float32 factors as a single chip's age forms them (the same
    host ``log1p`` / ``sin``), then one copy to ``device`` that does not
    wait for it, shaped (G, 1, 1) for the (G, C, n) leaves and (G, 1) for
    the (G, C) ones."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
    ages = [torch.as_tensor(x, dtype=torch.float32) for x in t]
    a = torch.stack([aging(x, dcfg.tau_frames) for x in ages])
    d = torch.stack([dcfg.temp_logit_per_c * temp_excursion_c(x, dcfg)
                     for x in ages])
    a, d = to_device_async(torch.stack([a, d]), device)
    return a[:, None, None], a[:, None], d[:, None, None]


def evolve_chip(chip: ChipMaps, maps: DriftMaps, t, *,
                dcfg: DriftConfig) -> ChipMaps:
    """The chip at frame-clock age ``t``: ``chip`` is the t = 0 instance
    (sampled, or ``identity_chip``), ``maps`` its drift directions (a stack
    of chips and their maps works too, at one age, or at a (G,) vector of
    ages (a sequence, array or 1-d tensor), row g at age g: row g is
    ``evolve_chip`` of chip g at its own age bit for bit). Aged gains and
    resistances keep ``sample_chip``'s floor of 0.05 (a forward clamp;
    chips carry no gradient). ``dcfg.enabled == False`` returns ``chip``
    itself."""
    if not dcfg.enabled:
        return chip
    if (t.ndim if isinstance(t, torch.Tensor) else np.ndim(t)) == 1:
        a3, a2, d_logit_t = _fleet_factors(t, dcfg,
                                           chip.pixel_gain.device)
    else:
        a3 = a2 = aging(t, dcfg.tau_frames)
        d_logit_t = dcfg.temp_logit_per_c * temp_excursion_c(t, dcfg)
    off = (chip.mtj_logit_offset
           + dcfg.sigma_logit_offset * a3 * maps.d_logit_offset + d_logit_t)
    gain = chip.mtj_logit_gain * (1.0 + dcfg.sigma_logit_gain * a3
                                  * maps.d_logit_gain)
    r_p = chip.r_p_scale * (1.0 + dcfg.sigma_r_p * a3 * maps.d_r_p)
    tmr = chip.tmr_scale * (1.0 - dcfg.tmr_retention * a3) \
        * (1.0 + dcfg.sigma_tmr * a3 * maps.d_tmr)
    pg = chip.pixel_gain * (1.0 - dcfg.pixel_gain_aging * a2) \
        * (1.0 + dcfg.sigma_pixel_gain * a2 * maps.d_pixel_gain)
    po = chip.pixel_offset + dcfg.sigma_pixel_offset * a2 * maps.d_pixel_offset
    return ChipMaps(mtj_logit_offset=off,
                    mtj_logit_gain=torch.clamp(gain, min=0.05),
                    r_p_scale=torch.clamp(r_p, min=0.05),
                    tmr_scale=torch.clamp(tmr, min=0.05),
                    pixel_gain=torch.clamp(pg, min=0.05),
                    pixel_offset=po)
