"""Transformer building blocks, the dense subset: norms, RoPE, attention
(prefill through the flash-attention kernel, decode against the KV cache),
the GQA attention block (global, or local with a sliding window and a
ring-buffer cache) and the dense MLP.

Port of ``repro.models.blocks``. Parameters are the reference's dict trees
(``attn_spec`` / ``mlp_spec``); layouts are the reference's ((B, S, H, D)
activations, (d, heads, head_dim) projections). Mixed precision follows the
reference: norms and RoPE promote to float32 and cast back, attention
scores and accumulators are float32. One card has no mesh, so there are no
sharding constraints. MLA, MoE and cross-attention (``kv_override``) come
with later slices of the port.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain
from repro_torch.models.params import ParamSpec


# ----------------------------------------------------------------------------
# norms & rope
# ----------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), init="ones")}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)
            * params["scale"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

def _pick(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (the reference's chunking of
    awkward lengths)."""
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return s


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, kv_chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention. q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D);
    H % Hkv == 0; window > 0: sliding-window causal attention. Returns
    (B, Sq, H, Dv).

    On CUDA tensors it launches the flash-attention kernel
    (``ops.flash_attention``); the kernel computes equal-length self
    attention with D == Dv, with or without a window, and other cases
    raise. On CPU tensors it runs the reference's chunked scan in PyTorch
    ops, over kv chunks of the reference's size (the reference's q chunking
    does not change the result, so the scan takes every query row at
    once)."""
    sq, sk = q.shape[1], k.shape[1]
    if q.device.type == "cuda":
        if v.shape[-1] != q.shape[-1]:
            raise NotImplementedError(
                "attention with value dim != query dim on the card comes "
                "with the MLA slice")
        if sq != sk or q_offset:
            raise NotImplementedError(
                "attention with unequal or offset q / kv lengths on the "
                "card comes with the encoder-decoder slice")
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 kv_chunk=_pick(sk, kv_chunk))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache, in plain PyTorch ops (the
    reference computes it outside any kernel). q: (B, 1, H, D); caches
    (B, Smax, Hkv, D); cur_len: () valid length, on the cache's device."""
    b, _, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    f32 = torch.float32
    qr = q.reshape(b, hkv, h // hkv, d).to(f32)
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.to(f32)) * d ** -0.5
    pos = torch.arange(smax, device=q.device)
    valid = pos < cur_len
    if window > 0:
        valid &= pos >= (cur_len - window)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    return out.reshape(b, 1, h, dv).to(q.dtype)


# ----------------------------------------------------------------------------
# GQA attention block
# ----------------------------------------------------------------------------

def attn_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, h, dh)),
        "wk": ParamSpec((d, hkv, dh)),
        "wv": ParamSpec((d, hkv, dh)),
        "wo": ParamSpec((h, dh, d)),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).reshape(
        b, s, w.shape[1], w.shape[2])


def attn_apply(params: Dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ArchConfig, *, causal: bool = True, window: int = 0,
               mode: str = "train", cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention. mode: train | prefill | decode.

    Decode writes this token's K/V row into ``cache["k"]`` / ``cache["v"]``
    IN PLACE at slot ``cache["pos"]`` (the reference returns updated copies)
    and returns those same tensors with ``pos + 1``. With ``window > 0`` the
    cache is a ring of ``cache_len`` slots: position p lives at slot
    ``p % cache_len``, and decode attends to the ``min(pos + 1, cache_len)``
    slots written, every one inside the window by construction.

    A prefill longer than the window returns its last ``window`` positions'
    K/V already in their ring slots (position p at ``p % window``), where
    the reference returns all of them and its ``pad_prefill_cache`` then
    keeps the first ``window``, so that its decode attends to stale keys
    (ROADMAP §3). Up to the window the prefill cache is the reference's."""
    q = rope(_project(x, params["wq"]), positions, cfg.rope_theta)
    k = rope(_project(x, params["wk"]), positions, cfg.rope_theta)
    v = _project(x, params["wv"])

    new_cache = None
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        if window > 0:   # the ring buffer's slot, on the device: no sync
            slot = torch.remainder(cache["pos"], kc.shape[1]).reshape(1)
        else:   # the reference's dynamic_update_slice clamps it into range
            slot = torch.clamp(cache["pos"], max=kc.shape[1] - 1).reshape(1)
        kc.index_copy_(1, slot.long(), k)
        vc.index_copy_(1, slot.long(), v)
        cur = cache["pos"] + 1
        new_cache = {"k": kc, "v": vc, "pos": cur}
        out = decode_attention(q, kc, vc, torch.clamp(cur, max=kc.shape[1]))
    else:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              kv_chunk=cfg.kv_chunk)
        if mode == "prefill":
            s = k.shape[1]
            pos = torch.tensor(s, dtype=torch.int32, device=k.device)
            if 0 < window < s:
                new_cache = {"k": _ring(k, window), "v": _ring(v, window),
                             "pos": pos}
            else:
                new_cache = {"k": k, "v": v, "pos": pos}
    b, s, h, dh = out.shape
    wo = params["wo"].to(x.dtype)
    y = out.reshape(b, s, h * dh) @ wo.reshape(h * dh, wo.shape[-1])
    return y, new_cache


def _ring(t: torch.Tensor, window: int) -> torch.Tensor:
    """The last ``window`` rows (axis 1) of a sequence of S rows, position p
    at slot ``p % window``."""
    s = t.shape[1]
    return torch.roll(t[:, s - window:], shifts=(s - window) % window, dims=1)


def attn_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                    window: int = 0) -> Dict[str, Any]:
    s = min(window, max_len) if window > 0 else max_len
    kv = ParamSpec((batch, s, cfg.num_kv_heads, cfg.resolved_head_dim),
                   init="zeros")
    return {"k": kv, "v": kv,
            "pos": ParamSpec((), init="zeros", dtype="int32")}


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------

def mlp_spec(cfg: ArchConfig, d_ff: int = 0) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    spec = {"w1": ParamSpec((d, f)), "w2": ParamSpec((f, d))}
    if cfg.mlp_gated:
        spec["w3"] = ParamSpec((d, f))
    return spec


def mlp_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = x @ params["w1"].to(x.dtype)
    if cfg.mlp_gated:
        h = F.silu(h) * (x @ params["w3"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    return h @ params["w2"].to(x.dtype)
