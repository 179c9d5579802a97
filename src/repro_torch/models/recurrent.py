"""The RG-LRU mixer (RecurrentGemma / Griffin): port of the RG-LRU part of
``repro.models.recurrent``.

``rglru_spec`` / ``rglru_cache_spec`` are the reference's leaves, shapes
and inits; ``rglru_apply`` runs train, prefill and decode as the reference
does, in its precision: the projections and the depthwise causal conv in
the compute dtype (the conv's four taps summed in the reference's order,
so bf16 rounds where it does), the gates' ``a`` and ``b`` and the state in
float32. The gates come in two parts: ``_rglru_gate_inputs`` (the two
gate projections and sigmoids in the compute dtype, and c = -8
softplus(lam)) and ``_rglru_ab`` (their float32 tail, a and b);
``_rglru_gates`` is both, the reference's function. Train and prefill run
the tail and the recurrence over the sequence through
``kernels.rglru_scan.rglru_scan_gated`` (one hand-written kernel on the
card that writes h in the compute dtype and the last step's h; on the CPU
the tail, the reference's associative scan in PyTorch ops and the cast);
decode advances it one token in plain ops, as the reference computes it.

The cache: a decode step writes the new state ``h`` and conv window IN
PLACE into the cache it is given (the reference returns new ones), as the
attention cache does (``models/lm.py``). mLSTM and sLSTM (xlstm-350m) come
with a later slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan import rglru_ab as _rglru_ab
from repro_torch.kernels.rglru_scan import rglru_scan_gated
from repro_torch.models.params import ParamSpec

_RGLRU_C = 8.0
_CONV_W = 4


def rglru_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    r = d                     # lru width = d_model (RecurrentGemma-2B)
    return {
        "w_in": ParamSpec((d, r)),
        "w_gate": ParamSpec((d, r)),
        "conv_w": ParamSpec((_CONV_W, r), scale=2.0),
        "w_a": ParamSpec((r, r)),
        "b_a": ParamSpec((r,), init="zeros"),
        "w_i": ParamSpec((r, r)),
        "b_i": ParamSpec((r,), init="zeros"),
        "lam": ParamSpec((r,), init="ones"),
        "w_out": ParamSpec((r, d)),
    }


def rglru_cache_spec(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    r = cfg.d_model
    return {
        "h": ParamSpec((batch, r), init="zeros", dtype="float32"),
        "conv": ParamSpec((batch, _CONV_W - 1, r), init="zeros"),
    }


def _causal_conv1d(u: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u: (B, S, R), w: (W, R). Returns (out,
    new_state): the taps summed from 0 in u's dtype, as the reference's
    ``sum``, and the last W - 1 rows of the padded input."""
    width = w.shape[0]
    if state is None:
        pad = u.new_zeros(u.shape[:1] + (width - 1,) + u.shape[2:])
    else:
        pad = state
    full = torch.cat([pad, u], dim=1)
    out = sum(full[:, i:i + u.shape[1]] * w[i] for i in range(width))
    return out, full[:, -(width - 1):]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it op by op: 1 / (1 + exp(-x)),
    each step rounded to x's dtype (in bf16 ``torch.sigmoid`` rounds once,
    one bf16 ulp off the reference on about a third of the elements)."""
    return 1 / (1 + torch.exp(-x))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form, in its order with its
    constants in x's dtype: bit for bit the reference's in bf16."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float32).to(x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _rglru_gate_inputs(params: Dict, u: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gates r and i (the two gate projections in u's dtype) and c =
    -8 softplus(lam) (R,) float32, the coefficient of log a = c r."""
    r = _sigmoid(u @ params["w_a"].to(u.dtype) + params["b_a"].to(u.dtype))
    i = _sigmoid(u @ params["w_i"].to(u.dtype) + params["b_i"].to(u.dtype))
    return r, i, -_RGLRU_C * _softplus(params["lam"].to(torch.float32))


def _rglru_gates(params: Dict, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's a and b, float32: the two gate projections in u's
    dtype, log a = -8 softplus(lam) r, b = sqrt(1 - a^2) (i u) with i u
    formed in u's dtype."""
    r, i, c = _rglru_gate_inputs(params, u)
    return _rglru_ab(r, i, u, c)


def rglru_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The RG-LRU block on x (B, S, d). mode: train | prefill | decode.
    Prefill returns the cache ``{"h": h of the last position (float32),
    "conv": the last 3 rows of the conv's input}``; decode advances the
    given cache one token, in place."""
    u0 = x @ params["w_in"].to(x.dtype)
    gate = _gelu(x @ params["w_gate"].to(x.dtype))
    conv_w = params["conv_w"].to(x.dtype)

    new_cache = None
    if mode == "decode":
        u, conv_state = _causal_conv1d(u0, conv_w, cache["conv"])
        a, b = _rglru_gates(params, u)
        h = a[:, 0] * cache["h"] + b[:, 0]                 # (B, R) float32
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_state)
        new_cache = {"h": cache["h"], "conv": cache["conv"]}
        hs = h[:, None]
    else:
        u, conv_state = _causal_conv1d(u0, conv_w)
        r, i, c = _rglru_gate_inputs(params, u)
        # h_t for h_{-1} = 0 in u's dtype, and the last step's h in float32
        hs, h_last = rglru_scan_gated(r, i, u, c)
        if mode == "prefill":   # a copy: no view keeps the conv alive
            new_cache = {"h": h_last, "conv": conv_state.clone()}
    y = (hs.to(x.dtype) * gate) @ params["w_out"].to(x.dtype)
    return y, new_cache
