"""VC-MTJ device model (paper §2.1, Figs. 1-2, 5).

Port of the parts of ``repro.core.mtj`` the serving path runs: the measured
switching fit (piecewise-linear in logit), the precession envelope, the
folded n-device majority, the Bernoulli draw from uint16 words and the
burst-read comparator. Expressions keep the reference's operation order;
``majority_prob_poly`` raises to integer powers by the same
square-and-multiply sequence as ``jax.lax.integer_pow``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

# --- measured device points (paper §2.2.3 / Fig. 5 caption) -----------------
MEASURED_VOLTAGES = (0.70, 0.80, 0.90)          # volts, 700 ps AP->P pulses
MEASURED_P_SW = (0.062, 0.924, 0.9717)          # switching probabilities


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


@dataclasses.dataclass(frozen=True)
class MTJParams:
    """Device parameters for the fabricated VC-MTJ stack.

    A copy of ``repro.core.mtj.MTJParams``; tests hold the two equal field
    for field.
    """
    r_p: float = 4.0e3            # ohms, parallel state
    tmr: float = 1.55             # (R_AP - R_P)/R_P > 150% near zero bias
    diameter_nm: float = 70.0
    write_pulse_ps: float = 700.0  # AP->P activation pulse (paper)
    reset_pulse_ps: float = 500.0  # P->AP reset pulse @ 0.9 V (paper)
    reset_voltage: float = 0.9
    precession_period_ps: float = 1400.0   # write envelope peak @ 700 ps
    reset_precession_period_ps: float = 1000.0  # reset envelope peak @ 500 ps
    read_voltage: float = 0.1     # |V| well below disturb threshold
    n_redundant: int = 8          # MTJs per kernel (paper uses 8)
    measured_voltages: Tuple[float, ...] = MEASURED_VOLTAGES
    measured_p_sw: Tuple[float, ...] = MEASURED_P_SW

    @property
    def r_ap(self) -> float:
        return self.r_p * (1.0 + self.tmr)

    @property
    def majority(self) -> int:
        """Votes needed to activate — majority of n_redundant."""
        return self.n_redundant // 2

    @property
    def measured_logits(self) -> Tuple[float, ...]:
        return tuple(_logit(p) for p in self.measured_p_sw)


DEFAULT_MTJ = MTJParams()


def logit_fit(params: MTJParams = DEFAULT_MTJ):
    """``(v0, v1, l0, l1, slope_lo, slope_hi)`` of the two-segment fit, as
    Python floats — the constants ``switching_logit`` and the CUDA kernels
    both evaluate (each rounds them to float32 at use, as JAX does)."""
    (v0, v1, v2) = params.measured_voltages
    (l0, l1, l2) = params.measured_logits
    return v0, v1, l0, l1, (l1 - l0) / (v1 - v0), (l2 - l1) / (v2 - v1)


def switching_logit(voltage: torch.Tensor, params: MTJParams = DEFAULT_MTJ,
                    *, logit_offset=0.0, logit_gain=1.0) -> torch.Tensor:
    """Monotone logit(P_sw) vs applied voltage, 700 ps pulse, AP->P.

    Piecewise-linear through the three measured points; ``logit_gain`` /
    ``logit_offset`` perturb it as ``gain * logit + offset``.
    """
    v0, v1, l0, l1, slope_lo, slope_hi = logit_fit(params)
    lo = l0 + slope_lo * (voltage - v0)
    hi = l1 + slope_hi * (voltage - v1)
    return logit_gain * torch.where(voltage < v1, lo, hi) + logit_offset


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), the expression the CUDA kernels evaluate."""
    return 1.0 / (1.0 + torch.exp(-x))


def pulse_envelope(pulse_ps: float, period_ps: float) -> np.float32:
    """Precessional sin^2 envelope, evaluated in float32 on the host."""
    x = np.float32(np.pi) * np.float32(pulse_ps) / np.float32(period_ps)
    s = np.sin(np.float32(x))
    return np.float32(s * s)


def envelope_factor(pulse_ps: float, params: MTJParams = DEFAULT_MTJ
                    ) -> float:
    """``clip(env / env_ref, 0, 1)`` in float32: exactly 1 at the nominal
    write pulse. The kernels receive this number, never the envelope."""
    env = pulse_envelope(pulse_ps, params.precession_period_ps)
    env_ref = pulse_envelope(params.write_pulse_ps,
                             params.precession_period_ps)
    return float(np.clip(np.float32(env / env_ref), np.float32(0.0),
                         np.float32(1.0)))


def switching_probability(voltage: torch.Tensor, pulse_ps: float = 700.0,
                          params: MTJParams = DEFAULT_MTJ, *,
                          logit_offset=0.0, logit_gain=1.0) -> torch.Tensor:
    """P(AP->P switch) for a voltage pulse of given width."""
    p_v = sigmoid(switching_logit(voltage, params, logit_offset=logit_offset,
                                  logit_gain=logit_gain))
    return p_v * envelope_factor(pulse_ps, params)


# --- folded Bernoulli draw ---------------------------------------------------

_DRAW_SCALE = 1.0 / 2 ** 16


def bernoulli_from_bits(bits: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One Bernoulli(q) draw per element from uint16 words (held in any
    integer dtype): fires when ``word * 2^-16 < q``. Returns float {0,1}."""
    return ((bits.to(torch.float32) * _DRAW_SCALE) < q).to(torch.float32)


def integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` by the square-and-multiply order of ``jax.lax.integer_pow``
    (no ``pow`` call, so every product rounds where the reference's does)."""
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def majority_prob_poly(p: torch.Tensor, n: int = 8, m: int = 4
                       ) -> torch.Tensor:
    """P(Binomial(n, p) >= m) as an explicit polynomial (multiply/add)."""
    out = torch.zeros_like(p)
    for k in range(m, n + 1):
        out = out + math.comb(n, k) * integer_pow(p, k) * integer_pow(1 - p,
                                                                     n - k)
    return out


# --- burst read (Fig. 6) -----------------------------------------------------

def read_voltage_divider(state_parallel: torch.Tensor,
                         params: MTJParams = DEFAULT_MTJ,
                         r_load: float = 6.0e3) -> torch.Tensor:
    """V_MTJ seen by the comparator for P / AP states (resistive divider)."""
    r = torch.where(state_parallel > 0.5, params.r_p, params.r_ap).to(
        torch.float32)
    return params.read_voltage * r_load / (r + r_load)


def comparator_threshold(params: MTJParams = DEFAULT_MTJ,
                         r_load: float = 6.0e3) -> float:
    v_p = params.read_voltage * r_load / (params.r_p + r_load)
    v_ap = params.read_voltage * r_load / (params.r_ap + r_load)
    return float(0.5 * (v_p + v_ap))


def burst_read(states: torch.Tensor, params: MTJParams = DEFAULT_MTJ,
               r_load: float = 6.0e3) -> torch.Tensor:
    """Sequential burst read of MTJ states -> binary activations (Fig. 6)."""
    v = read_voltage_divider(states, params, r_load)
    return (v > comparator_threshold(params, r_load)).to(torch.float32)
