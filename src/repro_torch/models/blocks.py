"""Transformer building blocks: norms, RoPE, attention (prefill through the
flash-attention kernel, decode against the KV cache), the GQA attention
block (global, or local with a sliding window and a ring-buffer cache),
DeepSeek-style multi-head latent attention (MLA), the dense MLP and the
mixture of experts (MoE).

Port of ``repro.models.blocks``. Parameters are the reference's dict trees
(``attn_spec`` / ``mla_spec`` / ``mlp_spec`` / ``moe_spec``); layouts are
the reference's ((B, S, H, D) activations, (d, heads, head_dim)
projections, (E, D, F) expert weights). Mixed precision follows the
reference: norms and RoPE promote to float32 and cast back, attention
scores and accumulators are float32. One card has no mesh, so there are no
sharding constraints, and the MoE runs the reference's single-shard path.
Cross-attention (``attn_apply(kv_override=)``, whisper-base's decoder over
its encoder's frames) is the reference's: q projected and not rotated, the
given K/V attended in full.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import cuda_lib, ops
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_plain,
                                                 flash_attention_trainable)
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
    """Online-softmax attention. q: (B, Sq, H, D); k: (B, Sk, Hkv, D); v:
    (B, Sk, Hkv, Dv); H % Hkv == 0; window > 0: sliding-window causal
    attention. Returns (B, Sq, H, Dv).

    On CUDA tensors it launches the flash-attention kernel
    (``ops.flash_attention``); the kernel computes self attention, with or
    without a window, and non-causal attention over a kv length of its own
    (cross-attention), at the (D, Dv) pairs it is built for (D == Dv, and
    MLA's (192, 128)); an unbuilt pair, or a causal or windowed call at
    unequal lengths, raises there, and a q offset (no caller passes one)
    raises here. On CPU tensors it runs the reference's chunked scan in
    PyTorch ops, over kv chunks of the reference's size (the reference's q
    chunking does not change the result, so the scan takes every query
    row at once).

    On the card, where autograd records and an input requires grad (a
    train forward), it runs ``flash_attention_trainable``: the same kernel
    with the backward kernel as its gradient, which raises
    NotImplementedError for a call it does not take (a window, unequal
    lengths, MLA's widths, an unbuilt head dim)."""
    sk = k.shape[1]
    if q.device.type == "cuda":
        if q_offset:
            raise NotImplementedError(
                "a q offset on the card: no caller passes one, and the "
                "kernel has none")
        if cuda_lib.needs_backward(q, k, v):
            return flash_attention_trainable(q, k, v, causal=causal,
                                             window=window)
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 kv_chunk=_pick(sk, kv_chunk))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache, in plain PyTorch ops (the
    reference computes it outside any kernel). q: (B, 1, H, D); caches
    (B, Smax, Hkv, D); cur_len: the valid length, a () tensor on the
    cache's device or an int."""
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
               mode: str = "train", cache: Optional[Dict] = None,
               kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention. mode: train | prefill | decode.

    ``kv_override``: (k, v) already projected (cross-attention over an
    encoder's output, (B, S_enc, Hkv, Dh) each), as the reference's: q is
    projected and not rotated (the reference applies RoPE only without an
    override); decode attends to the whole override through
    ``decode_attention`` and returns ``cache`` unchanged; train and prefill
    attend through ``flash_attention`` (non-causal where the caller says,
    at Sq != Sk) and return no cache.

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
    if kv_override is not None:
        q = _project(x, params["wq"])
        k, v = kv_override
        if mode == "decode":
            out, new_cache = decode_attention(q, k, v, k.shape[1]), cache
        else:
            out, new_cache = flash_attention(
                q, k, v, causal=causal, window=window,
                kv_chunk=cfg.kv_chunk), None
        return _attn_out(params, x, out), new_cache
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
    return _attn_out(params, x, out), new_cache


def _attn_out(params: Dict, x: torch.Tensor, out: torch.Tensor
              ) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", out, wo) as one matrix product."""
    b, s, h, dh = out.shape
    wo = params["wo"].to(x.dtype)
    return out.reshape(b, s, h * dh) @ wo.reshape(h * dh, wo.shape[-1])


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
# MLA (DeepSeek-style multi-head latent attention)
# ----------------------------------------------------------------------------

def mla_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.num_heads
    dh = cfg.resolved_head_dim            # nope dim (and value dim)
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    spec = {
        "wdkv": ParamSpec((d, r)),
        "wkr": ParamSpec((d, dr)),
        "kv_norm": rmsnorm_spec(r),
        "wuk": ParamSpec((r, h, dh)),
        "wuv": ParamSpec((r, h, dh)),
        "wo": ParamSpec((h, dh, d)),
    }
    if cfg.q_lora_rank > 0:
        spec["wdq"] = ParamSpec((d, cfg.q_lora_rank))
        spec["q_norm"] = rmsnorm_spec(cfg.q_lora_rank)
        spec["wuq"] = ParamSpec((cfg.q_lora_rank, h, dh + dr))
    else:
        spec["wq"] = ParamSpec((d, h, dh + dr))
    return spec


def mla_apply(params: Dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ArchConfig, *, mode: str = "train",
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention. mode: train | prefill | decode.

    The cache is the latent: ``c_kv`` (B, max_len, r) and ``k_rope`` (B,
    max_len, dr), one rope key shared by the heads. Train and prefill
    expand per-head K and V from it, k = [k_nope, k_rope over the heads]
    (B, S, H, dh + dr) and v (B, S, H, dh), and attend through the flash
    kernel (its (dh + dr, dh) pair, scaled by (dh + dr)^-0.5: q's width).
    Decode is the reference's weight-absorbed form in plain ops (the
    reference computes it outside any kernel): q_nope through ``wuk`` into
    the latent space, its scores against ``c_kv`` plus q_rope's against
    ``k_rope`` in float32, the softmax, the latent output in the compute
    dtype, then ``wuv``. It writes this token's latent row IN PLACE at the
    clamped slot ``pos`` (no host sync) and returns those same tensors with
    ``pos + 1``, as ``attn_apply`` does."""
    dh, dr = cfg.resolved_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank > 0:
        cq = rmsnorm(params["q_norm"], x @ params["wdq"].to(x.dtype),
                     cfg.norm_eps)
        q = _project(cq, params["wuq"])
    else:
        q = _project(x, params["wq"])
    q_nope = q[..., :dh]
    q_rope = rope(q[..., dh:], positions, cfg.rope_theta)
    c_kv = rmsnorm(params["kv_norm"], x @ params["wdkv"].to(x.dtype),
                   cfg.norm_eps)
    k_rope = rope((x @ params["wkr"].to(x.dtype))[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0, :]          # (B, S, dr), one head

    new_cache = None
    if mode == "decode":
        cc, kr = cache["c_kv"], cache["k_rope"]
        # the reference's dynamic_update_slice clamps the slot into range
        slot = torch.clamp(cache["pos"], max=cc.shape[1] - 1).reshape(1)
        cc.index_copy_(1, slot.long(), c_kv)
        kr.index_copy_(1, slot.long(), k_rope)
        cur = cache["pos"] + 1
        new_cache = {"c_kv": cc, "k_rope": kr, "pos": cur}
        out = _mla_decode(params, q_nope, q_rope, cc, kr, cur, dh + dr)
    else:
        k_nope = _project(c_kv, params["wuk"])
        v = _project(c_kv, params["wuv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            -1, -1, k_nope.shape[2], -1)], dim=-1)
        out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                              causal=True, kv_chunk=cfg.kv_chunk)
        if mode == "prefill":
            new_cache = {"c_kv": c_kv, "k_rope": k_rope,
                         "pos": torch.tensor(x.shape[1], dtype=torch.int32,
                                             device=x.device)}
    b, s, h, _ = out.shape
    wo = params["wo"].to(x.dtype)
    y = out.reshape(b, s, h * dh) @ wo.reshape(h * dh, wo.shape[-1])
    return y, new_cache


def _mla_decode(params: Dict, q_nope: torch.Tensor, q_rope: torch.Tensor,
                cc: torch.Tensor, kr: torch.Tensor, cur: torch.Tensor,
                width: int) -> torch.Tensor:
    """One token's weight-absorbed MLA: q_nope (B, 1, H, dh) and q_rope
    (B, 1, H, dr) against the latent cache cc (B, T, r) and kr (B, T, dr),
    the first ``cur`` rows valid, scaled by ``width ** -0.5``. Returns (B,
    1, H, dh) in q's dtype."""
    dt, f32 = q_nope.dtype, torch.float32
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wuk"].to(dt))
    s = (torch.einsum("bshr,btr->bhst", q_lat.to(f32), cc.to(f32))
         + torch.einsum("bshk,btk->bhst", q_rope.to(f32), kr.to(f32))
         ) * width ** -0.5
    valid = torch.arange(cc.shape[1], device=cc.device) < cur
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhst,btr->bshr", p.to(dt), cc)
    return torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].to(dt))


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int
                   ) -> Dict[str, Any]:
    return {
        "c_kv": ParamSpec((batch, max_len, cfg.kv_lora_rank), init="zeros"),
        "k_rope": ParamSpec((batch, max_len, cfg.rope_head_dim),
                            init="zeros"),
        "pos": ParamSpec((), init="zeros", dtype="int32"),
    }


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


# ----------------------------------------------------------------------------
# Mixture of experts (the reference's single-shard path)
# ----------------------------------------------------------------------------

def moe_spec(cfg: ArchConfig) -> Dict[str, Any]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    spec = {
        "router": ParamSpec((d, e)),
        "w1": ParamSpec((e, d, f), experts=True),
        "w2": ParamSpec((e, f, d), experts=True),
        "w3": ParamSpec((e, d, f), experts=True),
    }
    if cfg.num_shared_experts > 0:
        spec["shared"] = mlp_spec(cfg, d_ff=cfg.d_ff * cfg.num_shared_experts)
    return spec


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of x's last axis and their indices, as
    ``jax.lax.top_k`` gives them: in descending order, the lower index
    first among equal values (a stable sort; ``torch.topk`` promises no
    order on ties, and bf16 router logits over 160 or 384 experts tie)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(router_logits: torch.Tensor, k: int, capacity: int):
    """The reference's dispatch (``_moe_local`` on one shard) for
    router_logits (T, E): each token's top-k experts ``idx`` (T, k) and
    their ``gates`` (the softmax of the k logits in float32, cast to the
    logits' dtype), and each assignment's row in the (E * capacity + 1)-row
    dispatch buffer, ``slots`` (k, T): expert * capacity + its place in
    that expert's queue, counted in k-major order (every token's first
    choice, then every token's second, ..., each round continuing the
    experts' counts); an assignment past the capacity is dropped to the
    trash row E * capacity (``keeps`` (k, T) False). No host sync."""
    t, e = router_logits.shape
    gates, idx = top_k(router_logits, k)
    gates = torch.softmax(gates.to(torch.float32), dim=-1).to(
        router_logits.dtype)
    experts = torch.arange(e, device=router_logits.device)
    counts = torch.zeros(e, dtype=torch.long, device=router_logits.device)
    slots, keeps = [], []
    for kk in range(k):
        local = idx[:, kk]
        onehot = (local[:, None] == experts[None, :]).long()      # (T, E)
        pos = (torch.cumsum(onehot, dim=0).gather(1, local[:, None])[:, 0]
               - 1 + counts[local])
        counts = counts + onehot.sum(dim=0)
        keep = pos < capacity
        slots.append(torch.where(keep, local * capacity + pos, e * capacity))
        keeps.append(keep)
    return gates, idx, torch.stack(slots), torch.stack(keeps)


def _moe_dispatch(x_flat: torch.Tensor, slots: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """The (rows, D) dispatch buffer: each kept assignment's token at its
    slot (a slot holds one token, so the reference's scatter-add is a
    copy there); the trash row, which sums the dropped ones, is cut off."""
    buf = torch.zeros((rows + 1, x_flat.shape[1]), dtype=x_flat.dtype,
                      device=x_flat.device)
    for kk in range(slots.shape[0]):
        buf.index_add_(0, slots[kk], x_flat)
    return buf[:-1]


def _expert_ffn(w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); weights (E, D, F) / (E, F, D): batched products, which
    the reference leaves to XLA outside any kernel. The silu is one fused
    ``F.silu``, as the dense MLP's."""
    h = F.silu(torch.bmm(x, w1)) * torch.bmm(x, w3)
    return torch.bmm(h, w2)


def _moe_combine(expert_out: torch.Tensor, slots: torch.Tensor,
                 keeps: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """sum over kk = 0 .. k - 1, in that order and in the compute dtype, of
    each token's expert output at its slot (a zero row for the trash) times
    its keep flag times its gate: the reference's three roundings."""
    d = expert_out.shape[1]
    rows = torch.cat([expert_out, expert_out.new_zeros((1, d))])
    out = expert_out.new_zeros((slots.shape[1], d))
    for kk in range(slots.shape[0]):
        contrib = rows[slots[kk]] * keeps[kk][:, None].to(rows.dtype)
        out = out + contrib * gates[:, kk:kk + 1]
    return out


def _moe_local(x_flat: torch.Tensor, router_logits: torch.Tensor, w1, w2,
               w3, *, k: int, capacity: int) -> torch.Tensor:
    """Token dispatch -> expert FFN -> weighted combine, every expert on
    this card. x_flat (T, D), router_logits (T, E); returns (T, D)."""
    e = router_logits.shape[1]
    gates, _, slots, keeps = moe_route(router_logits, k, capacity)
    expert_in = _moe_dispatch(x_flat, slots, e * capacity)
    expert_out = _expert_ffn(w1, w2, w3, expert_in.reshape(e, capacity, -1))
    return _moe_combine(expert_out.reshape(e * capacity, -1), slots, keeps,
                        gates)


def moe_apply(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's MoE on one shard: the router in the compute dtype,
    top-k dispatch at capacity ceil(T k / E * capacity_factor) (the
    reference's expression), every expert's FFN over its (capacity, D)
    buffer (at decode that reads every expert's weights, as the reference
    does), the gated combine, plus the shared experts' MLP."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    x_flat = x.reshape(-1, d)
    logits = x_flat @ params["router"].to(x.dtype)
    cap = int(math.ceil(x_flat.shape[0] * k / e * cfg.capacity_factor))
    out = _moe_local(x_flat, logits, params["w1"].to(x.dtype),
                     params["w2"].to(x.dtype), params["w3"].to(x.dtype),
                     k=k, capacity=cap)
    y = out.reshape(b, s, d)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, cfg)
    return y
