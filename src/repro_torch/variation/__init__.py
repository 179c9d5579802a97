"""Device variation and calibration (port of ``repro.variation``).

    chip.py            VariationConfig (frozen) -> deterministic ChipMaps;
                       the kernels' (4, C) and (4, N_pix, C) operands; the
                       perturbed device chain; Fig. 8 noise maps
    calibrate.py       the tester's per-channel trim bisection -> a
                       calibration artifact, served as ``params["cal_trim"]``
    yield_analysis.py  Monte-Carlo fleet statistics over a stack of sampled
                       chips, and end-task accuracy vs sigma

``repro_torch.frontend`` threads a chip through the ``analog``, ``device``
and ``cuda`` backends via ``FrontendConfig(variation=, chip_id=)`` or a
``ChipMaps`` in ``params["chip"]``; this package imports no frontend module
at module scope (the frontend imports ``variation.chip``).
"""
from repro_torch.variation.calibrate import (CalibrationArtifact,
                                             apply_calibration, calibrate,
                                             channel_rates, solve_trim,
                                             target_rates)
from repro_torch.variation.chip import (ChipMaps, VariationConfig,
                                        channel_operands, identity_chip,
                                        identity_operands, noise_maps,
                                        sample_chip)
from repro_torch.variation.yield_analysis import (accuracy_sweep, chip_stats,
                                                  read_margin, yield_sweep)

__all__ = ["CalibrationArtifact", "ChipMaps", "VariationConfig",
           "accuracy_sweep", "apply_calibration", "calibrate",
           "channel_operands", "channel_rates", "chip_stats", "identity_chip",
           "identity_operands", "noise_maps", "read_margin", "sample_chip",
           "solve_trim", "target_rates", "yield_sweep"]
