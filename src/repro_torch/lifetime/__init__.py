"""Sensor lifetime: drift, recalibration scheduling and fleet-lifetime
analysis (port of ``repro.lifetime``).

    drift.py     DriftConfig (frozen) + per-chip DriftMaps ->
                 ``evolve_chip(chip, maps, t)``: the chip at frame-clock
                 age t, through the variation physics' ChipMaps fields
    schedule.py  SchedulePolicy (periodic / rate-error-triggered) and the
                 RecalibrationScheduler that monitors streamed channel
                 rates, re-solves the trim against the aged chip and
                 charges its energy; LifetimeState, the engine's record of
                 one aging sensor
    fleet.py     rate error and accuracy against age (stale against
                 refreshed trim) over a stack of chips, time to failure

``repro_torch.serving.VisionEngine(drift=, schedule=)`` serves an aging
chip; this package never imports the engine.
"""
from repro_torch.lifetime.drift import (DriftConfig, DriftMaps, aging,
                                        evolve_chip, sample_drift_maps,
                                        temp_excursion_c)
from repro_torch.lifetime.fleet import (accuracy_vs_age, rate_error_vs_age,
                                        time_to_failure)
from repro_torch.lifetime.schedule import (LifetimeState,
                                           RecalibrationScheduler,
                                           SchedulePolicy)

__all__ = ["DriftConfig", "DriftMaps", "LifetimeState",
           "RecalibrationScheduler", "SchedulePolicy", "accuracy_vs_age",
           "aging", "evolve_chip", "rate_error_vs_age", "sample_drift_maps",
           "temp_excursion_c", "time_to_failure"]
