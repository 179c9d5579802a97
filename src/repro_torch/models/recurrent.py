"""The recurrent mixers: port of ``repro.models.recurrent``, the RG-LRU
(RecurrentGemma / Griffin) and xLSTM's mLSTM and sLSTM (xlstm-350m).

Each ``*_spec`` / ``*_cache_spec`` is the reference's leaves, shapes,
inits and dtypes; each ``*_apply`` runs train, prefill and decode as the
reference does, in its precision, and a decode step writes its new state
IN PLACE into the cache it is given (the reference returns new ones), as
the attention cache does (``models/lm.py``).

RG-LRU: the projections and the depthwise causal conv in the compute
dtype (the conv's four taps summed in the reference's order, so bf16
rounds where it does), the gates' ``a`` and ``b`` and the state in
float32. The gates come in two parts: ``_rglru_gate_inputs`` (the two
gate projections and sigmoids in the compute dtype, and c = -8
softplus(lam)) and ``_rglru_ab`` (their float32 tail, a and b);
``_rglru_gates`` is both, the reference's function. Train and prefill run
the tail and the recurrence over the sequence through
``kernels.rglru_scan.rglru_scan_gated`` (one hand-written kernel on the
card that writes h in the compute dtype and the last step's h; on the CPU
the tail, the reference's associative scan in PyTorch ops and the cast);
decode advances it one token in plain ops, as the reference computes it.

mLSTM: q, k, v, the input and forget gates' pre-activations (``f_pre +
1.0`` a compute-dtype add) and the output gate (``_sigmoid``, op by op)
in the compute dtype; ``_mlstm_chunk_step``, the reference's stabilized
chunkwise form, in float32 in PyTorch ops (the reference computes it in
plain einsums, no Pallas kernel), over chunks of ``chunk`` = 256 tokens
in train and prefill (a prompt longer than a chunk must be a whole number
of chunks: the reference's reshape fails otherwise, and the port raises
``ValueError``) and at T = 1 in decode.

sLSTM: the four x-projections in the compute dtype, cast to float32; the
recurrence over the whole sequence in train and prefill, and over one
token in decode, through ``kernels.slstm_scan.slstm_scan`` (one
hand-written kernel launch on the card; on the CPU the reference's step
in PyTorch ops, looped); hs cast to the compute dtype through ``wo``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan import rglru_ab as _rglru_ab
from repro_torch.kernels.rglru_scan import rglru_scan_gated
from repro_torch.kernels.slstm_scan import slstm_scan
from repro_torch.models.blocks import _project
from repro_torch.models.params import ParamSpec

NEG_INF = -1e30

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


# ----------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM, chunkwise-parallel, stabilized)
# ----------------------------------------------------------------------------

def mlstm_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.num_heads
    dh = cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, h, dh)),
        "wk": ParamSpec((d, h, dh)),
        "wv": ParamSpec((d, h, dh)),
        "wi": ParamSpec((d, h), scale=0.1),
        "wf": ParamSpec((d, h), scale=0.1),
        "wo_gate": ParamSpec((d, h, dh)),
        "wo": ParamSpec((h, dh, d)),
    }


def mlstm_cache_spec(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    return {
        "C": ParamSpec((batch, h, dh, dh), init="zeros", dtype="float32"),
        "n": ParamSpec((batch, h, dh), init="zeros", dtype="float32"),
        "m": ParamSpec((batch, h), init="zeros", dtype="float32"),
    }


def _mlstm_chunk_step(carry, inp, dh: int):
    """One chunk, the reference's function op for op in float32. carry: C
    (B, H, dk, dv), n (B, H, dk), m (B, H); inp: q, k, v (B, T, H, dh),
    i_pre, f_pre (B, T, H). Returns ((C, n, m) after the chunk, h (B, T, H,
    dh))."""
    f32 = torch.float32
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    cc = q.shape[1]
    lf = -_softplus(-f_pre.to(f32))       # log_sigmoid: (B, T, H)
    bcum = torch.cumsum(lf, dim=1)                            # inclusive
    total = bcum[:, -1]                                       # (B, H)
    ip = i_pre.to(f32)

    # intra-chunk log weights w[t, j] = bcum_t - bcum_j + ip_j (j <= t)
    w = bcum[:, :, None, :] - bcum[:, None, :, :] + ip[:, None, :, :]
    tri = torch.tril(torch.ones((cc, cc), dtype=torch.bool,
                                device=q.device))
    w = torch.where(tri[None, :, :, None], w, NEG_INF)        # (B, T, J, H)
    inter = bcum + m[:, None, :]                              # (B, T, H)
    m_t = torch.maximum(w.amax(dim=2), inter)
    # the reference's "no-op" maximum with -NEG_INF * 0.0: max(m_t, 0),
    # which cancels between num and den but moves their roundings
    m_t = torch.clamp(m_t, min=-NEG_INF * 0.0)

    wexp = torch.exp(w - m_t[:, :, None, :])
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    scores = torch.einsum("bthd,bjhd->btjh", qf, kf) * (dh ** -0.5)
    sw = scores * wexp
    num_intra = torch.einsum("btjh,bjhd->bthd", sw, vf)
    den_intra = sw.sum(dim=2)

    inter_scale = torch.exp(inter - m_t)                      # (B, T, H)
    qs = qf * dh ** -0.5
    qC = torch.einsum("bthd,bhde->bthe", qs, C)
    qn = torch.einsum("bthd,bhd->bth", qs, n)
    num = num_intra + inter_scale[..., None] * qC
    den = den_intra + inter_scale * qn
    hdn = torch.maximum(den.abs(), torch.exp(-m_t))
    h_out = num / hdn[..., None]                              # (B, T, H, dh)

    # state update
    m_next = torch.maximum(m + total,
                           (total[:, None] - bcum + ip).amax(dim=1))
    kv_w = torch.exp(total[:, None] - bcum + ip - m_next[:, None])
    decay = torch.exp(m + total - m_next)
    C_new = (decay[:, :, None, None] * C
             + torch.einsum("bthd,bthe->bhde", kv_w[..., None] * kf, vf))
    n_new = (decay[:, :, None] * n
             + torch.einsum("bth,bthd->bhd", kv_w, kf))
    return (C_new, n_new, m_next), h_out


def mlstm_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[Dict] = None,
                chunk: int = 256) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The mLSTM block on x (B, S, d). mode: train | prefill | decode.
    Train and prefill run the chunk step over chunks of ``chunk`` tokens
    (all of S where that is shorter); prefill returns the cache ``{"C",
    "n", "m"}`` (float32); decode runs the chunk step at T = 1 from the
    given cache and writes it in place."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    i_pre = x @ params["wi"].to(dt)
    f_pre = x @ params["wf"].to(dt) + 1.0
    og = _sigmoid(_project(x, params["wo_gate"]))

    new_cache = None
    if mode == "decode":
        carry = (cache["C"], cache["n"], cache["m"])
        (C, n, m), hs = _mlstm_chunk_step(carry, (q, k, v, i_pre, f_pre), dh)
        for name, value in zip(("C", "n", "m"), (C, n, m)):
            cache[name].copy_(value)
        new_cache = {name: cache[name] for name in ("C", "n", "m")}
    else:
        chunk = min(chunk, s)
        if s % chunk:
            raise ValueError(
                f"mLSTM: {s} tokens are not a whole number of {chunk}-token "
                "chunks (the reference's chunk reshape fails there too)")
        f32 = torch.float32
        carry = (x.new_zeros((b, h, dh, dh), dtype=f32),
                 x.new_zeros((b, h, dh), dtype=f32),
                 x.new_zeros((b, h), dtype=f32))
        outs = []
        for j in range(0, s, chunk):
            sl = slice(j, j + chunk)
            carry, hj = _mlstm_chunk_step(
                carry, (q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                        f_pre[:, sl]), dh)
            outs.append(hj)
        hs = torch.cat(outs, dim=1)
        if mode == "prefill":
            new_cache = dict(zip(("C", "n", "m"), carry))
    out = hs.to(dt) * og
    y = out.reshape(b, s, h * dh) @ params["wo"].to(dt).reshape(h * dh, -1)
    return y, new_cache


# ----------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with block-diagonal recurrence)
# ----------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")

def slstm_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.num_heads
    dh = cfg.resolved_head_dim
    gates: Dict[str, Any] = {}
    for g in GATES:
        gates[f"w_{g}"] = ParamSpec((d, h, dh))
        gates[f"r_{g}"] = ParamSpec((h, dh, dh), scale=0.5)
        gates[f"b_{g}"] = ParamSpec((h, dh), init="zeros")
    gates["wo"] = ParamSpec((h, dh, d))
    return gates


def slstm_cache_spec(cfg: ArchConfig, batch: int) -> Dict[str, Any]:
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    leaf = ParamSpec((batch, h, dh), init="zeros", dtype="float32")
    return {"c": leaf, "n": leaf, "h": leaf, "m": leaf}


def slstm_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The sLSTM block on x (B, S, d). mode: train | prefill | decode.
    Prefill returns the cache ``{"c", "n", "h", "m"}`` of the last position
    (float32); decode advances the given cache one token, in place."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    dt = x.dtype
    xs = [_project(x, params[f"w_{g}"]).to(torch.float32) for g in GATES]
    rs = [params[f"r_{g}"] for g in GATES]
    bs = [params[f"b_{g}"] for g in GATES]
    names = ("c", "n", "h", "m")

    new_cache = None
    if mode == "decode":
        hs, _ = slstm_scan(xs, rs, bs, tuple(cache[k] for k in names))
        new_cache = {k: cache[k] for k in names}
    else:
        hs, last = slstm_scan(xs, rs, bs)
        if mode == "prefill":
            new_cache = dict(zip(names, last))
    y = hs.to(dt).reshape(b, s, h * dh) @ params["wo"].to(dt).reshape(
        h * dh, -1)
    return y, new_cache
