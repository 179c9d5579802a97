"""VC-MTJ device model (paper §2.1, Figs. 1-2, 5).

Port of ``repro.core.mtj``: the measured switching fit (piecewise-linear
in logit), the precession envelope, the reset probability, the n-device
majority (folded polynomial, binomial tail, heterogeneous devices), the
Bernoulli draw from uint16 words, the Monte-Carlo majority vote over
threefry draws (``prng.bernoulli``, the reference's words bit for bit) and
the burst-read comparator. Expressions keep the reference's operation
order; ``majority_prob_poly`` raises to integer powers by the same
square-and-multiply sequence as ``jax.lax.integer_pow``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import prng

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


def reset_probability(params: MTJParams = DEFAULT_MTJ) -> torch.Tensor:
    """P(P->AP reset) at the nominal 0.9 V / 500 ps reset pulse (the
    envelope is at its peak there by construction)."""
    return sigmoid(switching_logit(
        torch.tensor(params.reset_voltage, dtype=torch.float32), params))


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


# --- multi-MTJ majority statistics (Fig. 5) ---------------------------------

_EPS_F32 = float(np.finfo(np.float32).eps)


def _binom_pmf(k: torch.Tensor, n: int, p: torch.Tensor) -> torch.Tensor:
    """Binomial(n, p) pmf at ``k`` through log-gamma, ``p`` clipped to
    [eps, 1 - eps] of float32 (no 0 * inf at the edges)."""
    log_c = (torch.lgamma(torch.full((), n + 1.0, device=k.device))
             - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0))
    pc = torch.clamp(p, _EPS_F32, 1.0 - _EPS_F32)
    return torch.exp(log_c + k * torch.log(pc) + (n - k) * torch.log1p(-pc))


def majority_activation_probability(p_single, n: int = 8,
                                    majority: int = 4) -> torch.Tensor:
    """P(>= majority of n MTJs switch) given the per-device P_sw: the
    activation probability of the redundant neuron."""
    p = torch.as_tensor(p_single, dtype=torch.float32)
    ks = torch.arange(majority, n + 1, dtype=torch.float32, device=p.device)
    return torch.sum(_binom_pmf(ks, n, p[..., None]), dim=-1)


def majority_prob_hetero(p_devices: torch.Tensor,
                         majority: int) -> torch.Tensor:
    """P(>= majority of n heterogeneous devices switch), the Poisson
    binomial of the per-device probabilities on the LAST axis (..., n).

    A pairwise tree of polynomial products (multiply/add only, exact at p
    in {0, 1}): devices padded to a power of two with p = 0 phantoms (an
    exact no-op for the tail), each level multiplying every pair at once.
    """
    n = p_devices.shape[-1]
    p = p_devices.to(torch.float32)
    n2 = 1 << max(n - 1, 0).bit_length()          # next power of two
    if n2 > n:
        p = torch.cat([p, p.new_zeros(p.shape[:-1] + (n2 - n,))], dim=-1)
    pmf = torch.stack([1.0 - p, p], dim=-1)       # (..., n2, 2)
    m = n2
    while m > 1:
        half = m // 2
        a, b = pmf[..., :half, :], pmf[..., half:, :]
        length = a.shape[-1]
        out = a.new_zeros(a.shape[:-1] + (2 * length - 1,))
        for i in range(length):
            out[..., i:i + length] += a[..., i:i + 1] * b
        pmf = out
        m = half
    return torch.sum(pmf[..., 0, majority:], dim=-1)


def majority_prob_hetero_dp(p_devices: torch.Tensor,
                            majority: int) -> torch.Tensor:
    """The sequential DP over devices (n full-width multiply-adds), the
    cross-check of ``majority_prob_hetero``."""
    n = p_devices.shape[-1]
    pmf = p_devices.new_zeros(p_devices.shape[:-1] + (n + 1,),
                              dtype=torch.float32)
    pmf[..., 0] = 1.0
    for i in range(n):
        p = p_devices[..., i:i + 1]
        shifted = torch.cat([torch.zeros_like(pmf[..., :1]), pmf[..., :-1]],
                            dim=-1)
        pmf = pmf * (1.0 - p) + shifted * p
    return torch.sum(pmf[..., majority:], dim=-1)


def majority_error_rates(p_should_switch, p_should_not, n: int = 8,
                         majority: int = 4
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fail-to-activate, false-activate) rates of the majority neuron."""
    fail = 1.0 - majority_activation_probability(p_should_switch, n,
                                                 majority)
    false = majority_activation_probability(p_should_not, n, majority)
    return fail, false


def sample_majority_activation(key, p_single: torch.Tensor, n: int = 8,
                               majority: int = 4) -> torch.Tensor:
    """Monte-Carlo hardware path: n Bernoulli switches per element, drawn
    from ``key`` on ``p_single``'s device, then the majority vote. Returns
    float {0,1} of ``p_single``'s shape."""
    return sample_majority_activation_per_device(
        key, p_single[..., None].expand(*p_single.shape, n), majority)


def sample_majority_activation_per_device(key, p_devices: torch.Tensor,
                                          majority: int = 4) -> torch.Tensor:
    """The majority vote over heterogeneous devices, the per-device
    switching probabilities on the last axis (..., n)."""
    draws = prng.bernoulli(key, p_devices, p_devices.shape)
    votes = torch.sum(draws.to(torch.int32), dim=-1)
    return (votes >= majority).to(p_devices.dtype)


# --- burst read (Fig. 6) -----------------------------------------------------

def read_voltage_divider(state_parallel: torch.Tensor,
                         params: MTJParams = DEFAULT_MTJ,
                         r_load: float = 6.0e3, *, r_p_scale=1.0,
                         tmr_scale=1.0) -> torch.Tensor:
    """V_MTJ seen by the comparator for P / AP states (resistive divider).
    ``r_p_scale`` / ``tmr_scale`` (tensors broadcast against the states, or
    floats) are the relative per-device R_P and TMR spreads."""
    r_p = params.r_p * r_p_scale
    r_ap = r_p * (1.0 + params.tmr * tmr_scale)
    r = torch.where(state_parallel > 0.5, r_p, r_ap).to(torch.float32)
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
