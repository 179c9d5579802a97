"""Recalibration scheduling: when a deployed sensor re-runs its tester
(port of ``repro.lifetime.schedule``).

    policy    = SchedulePolicy(period_frames=4096)            # periodic
    policy    = SchedulePolicy(rate_err_threshold=0.02)       # triggered
    scheduler = RecalibrationScheduler(policy, pcfg, cal_frames, params_p2m)

Either armed condition fires: every ``period_frames`` of the engine's frame
clock, or when the EMA of the streamed per-channel activation rates
(``observe``) has moved more than ``rate_err_threshold`` from the baseline
captured after the last refresh, once ``min_interval_frames`` have passed.

A refresh re-runs the calibration bisection (``variation.calibrate.
solve_trim``) against the aged chip. The calibration frames' u, theta and
target rates are computed once, at construction, on the scheduler's device
(the weights do not age); a refresh is an eager loop of tensor ops on that
device with no host sync, and ``recalibrate_fleet`` solves a stack of chips
in the same loop. Each refresh is charged ``energy.recalibration_energy_pj``
of the same ceil-rounded frame geometry the engine serves. The monitor is
the reference's float64 numpy EMA on the host: one (C,) copy of the rates a
microbatch.

``LifetimeState`` is the engine's record of one aging sensor: its t = 0
chip, drift directions, programmed trim, frame-clock age and the refresh
audit trail.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional

import numpy as np
import torch

from repro_torch.core import energy, hoyer, p2m
from repro_torch.devices import resolve_device
from repro_torch.lifetime.drift import DriftMaps
from repro_torch.models.params import to_device
from repro_torch.obs.clock import WallProbe
from repro_torch.variation.calibrate import (channel_rates, solve_trim,
                                             target_rates)
from repro_torch.variation.chip import ChipMaps


@dataclasses.dataclass(frozen=True)
class SchedulePolicy:
    """When to refresh the trim (frozen; both conditions may be armed)."""
    period_frames: Optional[int] = None       # periodic: every N frames
    rate_err_threshold: Optional[float] = None  # triggered: EMA drift bound
    min_interval_frames: int = 0              # hysteresis for the trigger
    ema: float = 0.5          # decay of the channel-rate monitoring EMA
    cal_iters: int = 12       # bisection depth of each refresh
    cal_span: float = 2.0     # bisection window (conv-output units)

    @property
    def enabled(self) -> bool:
        return (self.period_frames is not None
                or self.rate_err_threshold is not None)


@dataclasses.dataclass
class LifetimeState:
    """One aging sensor as the serving engine carries it."""
    chip0: ChipMaps              # the t = 0 chip instance
    maps: DriftMaps              # its frozen drift directions
    trim: torch.Tensor           # (C,) currently-programmed trim
    age_frames: int = 0          # frame-clock age
    recal_count: int = 0
    last_recal_frame: int = 0
    recal_energy_pj: float = 0.0  # cumulative maintenance energy charged
    rate_err: float = 0.0         # latest monitored rate-error metric
    # recent monitored values, bounded: a long stream must not grow host
    # memory
    rate_err_history: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=1024))


class RecalibrationScheduler:
    """Monitors streamed channel rates and refreshes the trim on schedule.

    ``params_p2m`` holds the deployed ``{"w", "v_th"}`` frontend weights,
    ``cal_frames`` a (B, H, W, C) calibration batch that every refresh
    re-exposes; both move to ``device`` (the GPU unless asked otherwise).
    ``obs`` (a ``repro_torch.obs.Obs``) records each solve as a
    ``recal_solve`` / ``recal_solve_fleet`` span that closes when the solve
    is done on the device; without it a solve is queued and not waited
    for.
    """

    def __init__(self, policy: SchedulePolicy, pcfg: p2m.P2MConfig,
                 cal_frames, params_p2m: dict, *,
                 frame_spec: Optional[energy.FrameSpec] = None,
                 consts: energy.EnergyConstants = energy.DEFAULT_ENERGY,
                 device=None, obs=None):
        self._obs = obs
        if not policy.enabled:
            raise ValueError("SchedulePolicy needs period_frames and/or "
                             "rate_err_threshold set")
        if cal_frames is None:
            raise ValueError("a scheduler needs calibration frames: the "
                             "tester loop re-exposes them at every refresh")
        self.policy = policy
        self.pcfg = pcfg
        self.device = resolve_device(device)
        weights = to_device({"w": params_p2m["w"],
                             "v_th": params_p2m["v_th"]}, self.device)
        frames = torch.as_tensor(cal_frames, dtype=torch.float32,
                                 device=self.device)
        self._u = p2m.hardware_conv(frames, weights["w"], pcfg)
        self._theta = hoyer.effective_threshold(
            self._u, weights["v_th"]) * weights["v_th"]
        self._ref = target_rates(self._u, self._theta, pcfg)
        if frame_spec is None:
            # VisionEngine._frame_spec's ceil-rounded geometry, so a
            # scheduler built alone charges what the engine's charges
            b, h, w, c = frames.shape
            frame_spec = energy.FrameSpec(
                h_in=h, w_in=w, c_in=c,
                h_out=max(-(-h // pcfg.stride) // 2, 1),
                w_out=max(-(-w // pcfg.stride) // 2, 1),
                c_out=pcfg.out_channels, kernel=pcfg.kernel_size,
                stride=pcfg.stride, n_mtj=pcfg.mtj.n_redundant)
        # the tester-loop energy of ONE refresh, charged per firing
        self.recal_energy_pj = energy.recalibration_energy_pj(
            frame_spec, consts, n_cal_frames=frames.shape[0],
            bisection_iters=policy.cal_iters)
        self._ema: Optional[np.ndarray] = None
        self._baseline: Optional[np.ndarray] = None
        self._last_err = 0.0

    def _spanned_solve(self, chip: ChipMaps, span: str) -> torch.Tensor:
        if self._obs is None:
            return self._solve(chip)
        with self._obs.span(span, iters=self.policy.cal_iters):
            trim = self._solve(chip)
            WallProbe.record(self.device).wait()
        return trim

    def _solve(self, chip: ChipMaps) -> torch.Tensor:
        return solve_trim(self._u, self._theta, chip, self._ref, self.pcfg,
                          iters=self.policy.cal_iters,
                          span=self.policy.cal_span)

    def observe(self, rates) -> float:
        """Fold one microbatch's per-channel activation rates (the
        frontend's ``aux["channel_rates"]``, or None: a no-op) into the
        EMA; returns mean |EMA - baseline|, the baseline being the EMA just
        after the last refresh."""
        if rates is None:
            return self._last_err
        if isinstance(rates, torch.Tensor):
            rates = rates.detach().cpu().numpy()
        r = np.asarray(rates, np.float64)
        if self._ema is None:
            self._ema = r.copy()
        else:
            e = self.policy.ema
            self._ema = e * self._ema + (1.0 - e) * r
        if self._baseline is None:
            self._baseline = self._ema.copy()
        self._last_err = float(np.mean(np.abs(self._ema - self._baseline)))
        return self._last_err

    def should_fire(self, age_frames: int, last_recal_frame: int) -> bool:
        since = age_frames - last_recal_frame
        p = self.policy
        if p.period_frames is not None and since >= p.period_frames:
            return True
        return (p.rate_err_threshold is not None
                and since >= p.min_interval_frames
                and self._last_err > p.rate_err_threshold)

    def recalibrate(self, chip: ChipMaps) -> torch.Tensor:
        """The trim re-solved against the aged chip; re-arms the monitor's
        baseline. Key-free: the tester measures expected rates."""
        trim = self._spanned_solve(chip, "recal_solve")
        self._ema = None
        self._baseline = None
        self._last_err = 0.0
        return trim

    def recalibrate_fleet(self, chips: ChipMaps) -> torch.Tensor:
        """The (K, C) trims of a stack of K chips in one bisection. Unlike
        ``recalibrate`` it leaves the single-chip monitor as it is."""
        return self._spanned_solve(chips, "recal_solve_fleet")

    def rate_error(self, chip: ChipMaps,
                   trim: Optional[torch.Tensor]) -> float:
        """Mean |rate - target| of a chip at a trim (None: zero)."""
        if trim is None:
            trim = torch.zeros_like(self._ref)
        rates = channel_rates(self._u, self._theta, chip, trim, self.pcfg)
        return float(torch.mean(torch.abs(rates - self._ref)))
