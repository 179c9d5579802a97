"""Energy / latency constants and the global-shutter frame time (paper §3.4).

Port of the serving subset of ``repro.core.energy``: ``EnergyConstants``
(a copy of the reference's, held equal by a test), ``FrameSpec`` and
``frame_latency_us``, which the shutter stage and ``VisionEngine``'s
``sensor_latency_us`` telemetry need. Plain Python arithmetic.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    # pixel front-end
    e_pixel_integration_pj: float = 15.0   # per pixel per integration cycle
    e_adc12_pj: float = 400.0              # 12-bit conversion (baseline CIS)
    e_adc4_pj: float = 47.0                # 4-bit conversion (in-sensor [17])
    e_subtractor_pj: float = 0.10          # passive cap subtractor, per kernel
    e_buffer_pj: float = 0.25              # unity-gain buffer per MTJ write
    e_mtj_write_pj: float = 0.01           # VCMA write, ~10 fJ
    e_mtj_read_pj: float = 0.05            # divider + comparator strobe
    e_col_readout_pj: float = 5.0          # column bitline drive (baseline)
    # communication (LVDS, same-PCB)
    e_lvds_pj_per_bit: float = 2.0
    activity_multibit: float = 0.50        # toggle activity of raw 12b data
    activity_binary: float = 0.353         # spike-link activity incl. framing
    # calibration maintenance: programming one channel's trim DAC
    e_trim_dac_write_pj: float = 1.0
    # timing
    t_integration_us: float = 5.0
    t_reset_us: float = 1.0
    t_channel_settle_us: float = 0.60      # per-channel bitline settle/sample
    t_mtj_write_ps: float = 700.0
    t_mtj_read_ps: float = 500.0
    read_parallel_columns: int = 112       # column-parallel burst read


DEFAULT_ENERGY = EnergyConstants()


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    h_in: int = 224
    w_in: int = 224
    c_in: int = 3                # RGB channels after demosaic
    bits_in: int = 12
    h_out: int = 56              # after stride-2 conv + 2x2 maxpool
    w_out: int = 56
    c_out: int = 32
    bits_out: int = 1
    kernel: int = 3
    stride: int = 2
    n_mtj: int = 8

    @property
    def n_pixels(self) -> int:
        return self.h_in * self.w_in            # Bayer mosaic: 1 value/pixel

    @property
    def n_kernel_outputs(self) -> int:
        """conv output positions x channels (pre-pool) = #MTJ neuron groups."""
        return (self.h_in // self.stride) * (self.w_in // self.stride) * self.c_out


VGG16_IMAGENET = FrameSpec()


def frame_latency_us(f: FrameSpec = VGG16_IMAGENET,
                     c: EnergyConstants = DEFAULT_ENERGY) -> dict:
    """Global-shutter frame time: two integration phases, the burst MTJ
    writes and the column-parallel burst read."""
    t_phase = c.t_reset_us + c.t_integration_us + f.c_out * c.t_channel_settle_us
    t_write = f.c_out * f.n_mtj * c.t_mtj_write_ps * 1e-6
    reads_per_col = f.n_kernel_outputs * f.n_mtj / c.read_parallel_columns
    t_read = reads_per_col * c.t_mtj_read_ps * 1e-6
    total = 2 * t_phase + t_write + t_read
    return {"t_phase_us": t_phase, "t_write_us": t_write, "t_read_us": t_read,
            "total_us": total, "fps": 1e6 / total}
