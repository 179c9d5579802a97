"""Energy / bandwidth / latency models (paper §3.2-3.4, Eq. 3, Fig. 9).

Port of ``repro.core.energy``: ``EnergyConstants`` (a copy of the
reference's, held equal by a test), ``FrameSpec``, the bandwidth reduction
(the consistent reading of Eq. 3, and Eq. 3 as printed), the front-end and
communication energies with their report (the paper's 8.2x / 8.5x energy
and 6x bandwidth ratios), one trim refresh's energy and its amortized
maintenance energy per frame, and the global-shutter frame time. Plain
Python arithmetic.
"""
from __future__ import annotations

import dataclasses
import math


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

    @property
    def bits_transmitted_out(self) -> int:
        return self.h_out * self.w_out * self.c_out * self.bits_out

    @property
    def bits_transmitted_in(self) -> int:
        return self.n_pixels * self.bits_in     # raw mosaic readout


VGG16_IMAGENET = FrameSpec()


# --- bandwidth (Eq. 3) -------------------------------------------------------

def bandwidth_reduction(f: FrameSpec = VGG16_IMAGENET) -> float:
    """Sensor bits out (baseline) over in-pixel bits out: 6.0 for VGG16."""
    return f.bits_transmitted_in / f.bits_transmitted_out


def paper_eq3(f: FrameSpec = VGG16_IMAGENET) -> float:
    """Eq. 3 literally as printed (kept for reference)."""
    ratio = (f.h_out * f.w_out * f.c_out) / (f.h_in * f.w_in * f.c_in)
    return ratio * (f.bits_in / f.bits_out) * (4.0 / 3.0)


def effective_bandwidth_with_sparsity(f: FrameSpec, sparsity: float,
                                      coding: str = "entropy",
                                      csr_index_bits: int = 18) -> float:
    """The reduction with sparse coding of the spike map: ``"entropy"``
    codes at H(p) bits a position, ``"csr"`` sends each nonzero's index."""
    if coding == "csr":
        nnz = (1.0 - sparsity) * f.bits_transmitted_out
        coded = nnz * csr_index_bits
    else:
        p = min(max(1.0 - sparsity, 1e-9), 1 - 1e-9)
        h = -p * math.log2(p) - (1 - p) * math.log2(1 - p)
        coded = h * f.bits_transmitted_out
    return f.bits_transmitted_in / max(coded, 1.0)


# --- front-end energy (Fig. 9) ----------------------------------------------

def frontend_energy_baseline(f: FrameSpec = VGG16_IMAGENET,
                             c: EnergyConstants = DEFAULT_ENERGY) -> float:
    """Conventional CIS: integrate + 12b ADC per pixel + column readout (pJ)."""
    return f.n_pixels * (c.e_pixel_integration_pj + c.e_adc12_pj
                         + c.e_col_readout_pj)


def frontend_energy_insensor(f: FrameSpec = VGG16_IMAGENET,
                             c: EnergyConstants = DEFAULT_ENERGY) -> float:
    """In-sensor P2M [17]: analog MAC in pixels, multi-bit ADC per kernel."""
    integrate = f.n_pixels * 2 * c.e_pixel_integration_pj
    per_kernel = f.n_kernel_outputs * (c.e_subtractor_pj + c.e_adc4_pj)
    return integrate + per_kernel


def frontend_energy_ours(f: FrameSpec = VGG16_IMAGENET,
                         c: EnergyConstants = DEFAULT_ENERGY) -> float:
    """This work: two integrations + subtractor + buffered MTJ write +
    burst read."""
    integrate = f.n_pixels * 2 * c.e_pixel_integration_pj
    per_kernel = f.n_kernel_outputs * (
        c.e_subtractor_pj
        + f.n_mtj * (c.e_buffer_pj + c.e_mtj_write_pj + c.e_mtj_read_pj))
    return integrate + per_kernel


def recalibration_energy_pj(f: FrameSpec = VGG16_IMAGENET,
                            c: EnergyConstants = DEFAULT_ENERGY, *,
                            n_cal_frames: int = 32,
                            bisection_iters: int = 12) -> float:
    """One per-channel trim refresh (pJ): ``n_cal_frames`` exposures per
    bisection iteration through the frontend, then one trim DAC write per
    channel."""
    exposures = n_cal_frames * bisection_iters
    return exposures * frontend_energy_ours(f, c) \
        + f.c_out * c.e_trim_dac_write_pj


def maintenance_energy_per_frame_pj(f: FrameSpec = VGG16_IMAGENET,
                                    c: EnergyConstants = DEFAULT_ENERGY, *,
                                    recal_period_frames: float,
                                    n_cal_frames: int = 32,
                                    bisection_iters: int = 12) -> float:
    """One refresh's energy amortized over its period of served frames."""
    return recalibration_energy_pj(
        f, c, n_cal_frames=n_cal_frames,
        bisection_iters=bisection_iters) / max(recal_period_frames, 1.0)


# --- communication energy (Fig. 9) -------------------------------------------

def comm_energy_baseline(f: FrameSpec = VGG16_IMAGENET,
                         c: EnergyConstants = DEFAULT_ENERGY) -> float:
    return f.bits_transmitted_in * c.e_lvds_pj_per_bit * c.activity_multibit


def comm_energy_ours(f: FrameSpec = VGG16_IMAGENET,
                     c: EnergyConstants = DEFAULT_ENERGY) -> float:
    return f.bits_transmitted_out * c.e_lvds_pj_per_bit * c.activity_binary


def energy_report(f: FrameSpec = VGG16_IMAGENET,
                  c: EnergyConstants = DEFAULT_ENERGY) -> dict:
    fe_base = frontend_energy_baseline(f, c)
    fe_insensor = frontend_energy_insensor(f, c)
    fe_ours = frontend_energy_ours(f, c)
    cm_base = comm_energy_baseline(f, c)
    cm_ours = comm_energy_ours(f, c)
    return {
        "frontend_pj": {"baseline": fe_base, "in_sensor": fe_insensor,
                        "ours": fe_ours},
        "frontend_improvement_vs_baseline": fe_base / fe_ours,
        "frontend_improvement_vs_insensor": fe_insensor / fe_ours,
        "comm_pj": {"baseline": cm_base, "ours": cm_ours},
        "comm_improvement": cm_base / cm_ours,
        "bandwidth_reduction": bandwidth_reduction(f),
        "recalibration_pj": recalibration_energy_pj(f, c),
    }


# --- frame latency (§3.4) -----------------------------------------------------


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
