"""Batched LM serving engine: prefill -> KV cache -> greedy/sampled decode.

Port of ``repro.serving.engine`` for one device, the dense GQA models,
recurrentgemma-2b, deepseek-v2 (MLA, MoE), kimi-k2 (MoE), xlstm-350m
(mLSTM, sLSTM) and whisper-base (encoder-decoder) (``models/lm.py``):

    engine = ServingEngine(cfg, params, max_len=2080)      # runs on the GPU
    tokens = engine.generate(prompts, max_new_tokens=32)   # (B, 32) int32
    engine.stats     # prefill_ms, decode_ms_per_token, tokens_per_s

An encoder-decoder config takes the encoder's input as the reference's
engine does, ``generate(prompts, n, encoder_embeddings=emb)`` with emb
(B, encoder_seq, d_model) precomputed frame embeddings (whisper's audio
frontend is a stub in both packages); the prefill runs the encoder, and
its K/V stay in the cache for decode's cross-attention.

Prefill runs every layer's attention through the flash-attention kernel
and every RG-LRU and sLSTM layer's recurrence through its kernel, fills a
(B, max_len) KV cache (a ring of ``window`` slots for local attention, the
MLA latent ``c_kv`` / ``k_rope`` for an MLA layer, the float32 state for a
recurrent layer), and decode then attends to that cache
one token at a time, writing each new K/V row and state in place (an
sLSTM layer's through one launch of its kernel). With ``temperature > 0``
and a key (``generate(..., rng=key)``, a ``prng`` key) decode samples as
the reference's ``jax.random.categorical(fold_in(rng, i), logits /
temperature)`` does at step i: Gumbel noise -log(-log(u)) over u from
``prng.uniform`` on [tiny, 1) (jax's default "low" mode; the uniforms bit
for bit, the logs PyTorch's, within an ulp of XLA's), added to the scaled
float32 logits, then the first argmax. As in the reference, the first
token is the prefill's argmax even when sampling, and ``rng=None`` decodes
greedily. A ``mesh`` raises. ``device=None`` means the GPU; without CUDA
the engine raises rather than moving to the CPU on its own.
``device="cpu"`` runs the kernels' plain PyTorch versions.

Timing is synchronous: the device is synchronized around the prefill (which
includes growing its cache to ``max_len``) and around the decode loop, so
the recorded times are honest end-to-end times.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.devices import resolve_device
from repro_torch.models import lm
from repro_torch.models.params import to_device
from repro_torch.obs.clock import now


def make_prefill_step(cfg: ArchConfig, mesh=None, rules=None):
    def prefill(params, tokens, encoder_embeddings=None):
        logits, cache = lm.forward(params, tokens, cfg, mesh, rules,
                                   mode="prefill",
                                   encoder_embeddings=encoder_embeddings)
        return logits[:, -1], cache
    return prefill


_TINY_F32 = float(torch.finfo(torch.float32).tiny)


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in jax's default "low" mode:
    -log(-log(u)), u uniform on [tiny, 1) (the uniforms bit for bit)."""
    tiny = torch.tensor(_TINY_F32, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - tiny
    u = torch.maximum(tiny, prng.uniform(key, shape, device) * span + tiny)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the first argmax
    of Gumbel noise plus the logits, over the last axis."""
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)


def make_decode_step(cfg: ArchConfig, mesh=None, rules=None,
                     temperature: float = 0.0):
    def decode(params, cache, tokens, rng=None):
        """tokens: (B, 1) current token; ``rng`` this step's key (samples
        where ``temperature > 0``). Returns (next_token, new_cache);
        ``cache`` is updated in place and must not be reused."""
        logits, new_cache = lm.forward(params, tokens, cfg, mesh, rules,
                                       mode="decode", cache=cache)
        logits = logits[:, -1].to(torch.float32)
        if temperature > 0.0 and rng is not None:
            nxt = categorical(rng, logits / temperature)
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None].to(torch.int32), new_cache
    return decode


def pad_prefill_cache(cfg: ArchConfig, prefill_cache, batch: int,
                      max_len: int):
    """Grow a seq-sized prefill cache into a max_len decode cache. A
    local-attention ring takes the prefill's rows as they are: up to the
    window they fill slots 0 .. S - 1, as the reference's; past it the
    prefill already holds the last ``window`` positions in their ring
    slots (``blocks.attn_apply``), where the reference copies the first
    ``window`` (ROADMAP §3). An MLA layer's latent ``c_kv`` (B, S, r) and
    ``k_rope`` (B, S, dr) grow along S as a K/V cache does; the fixed-size
    recurrent states (RG-LRU's h and conv window, mLSTM's C, n, m, sLSTM's
    c, n, h, m) and an encoder-decoder's ``enc_k`` / ``enc_v`` (B,
    encoder_seq, Hkv, Dh) have equal shapes on both sides and are taken
    leaf for leaf."""
    target = lm.init_cache(cfg, batch, max_len,
                           device=prefill_cache["pos"].device)

    def merge(dst, src):
        if isinstance(dst, dict):
            return {k: merge(dst[k], src[k]) for k in dst}
        if dst.ndim == 0 or dst.shape == src.shape:
            return src.to(dst.dtype).reshape(dst.shape)
        sl = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
        dst[sl] = src[sl].to(dst.dtype)
        return dst

    return merge(target, prefill_cache)


class ServingEngine:
    """Synchronous batched engine: prefill + greedy or sampled decode on
    one device."""

    def __init__(self, cfg: ArchConfig, params, max_len: int = 512,
                 mesh=None, temperature: float = 0.0, device=None):
        if mesh is not None:
            raise NotImplementedError("one card has no mesh: sharding comes "
                                      "with the multi-card slice")
        lm.check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.max_len = max_len
        self.prefill = make_prefill_step(cfg)
        self.decode = make_decode_step(cfg, temperature=temperature)
        self.stats: Dict[str, float] = {}
        self.prefill_logits: Optional[torch.Tensor] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, prompts, max_new_tokens: int,
                 encoder_embeddings=None, rng=None) -> torch.Tensor:
        """prompts: (B, S) integer ids; ``encoder_embeddings`` (B,
        encoder_seq, d_model), which an encoder-decoder config needs (a
        ``ValueError`` without them, where the reference's cache merge
        fails); ``rng`` a ``prng`` key, from which decode step i samples
        with ``fold_in(rng, i)`` at the engine's temperature (None:
        greedy). Returns (B, max_new_tokens) int32 on the engine's device.
        Keeps the prefill's last-position logits in ``prefill_logits`` and
        the step times in ``stats``: ``prefill_ms`` (the encoder
        included), ``decode_ms_per_token`` (per decode step of the batch)
        and ``tokens_per_s`` (generated tokens over the whole call)."""
        if self.cfg.is_encdec and encoder_embeddings is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder model: "
                             "generate needs encoder_embeddings")
        prompts = torch.as_tensor(prompts, device=self.device)
        if encoder_embeddings is not None:
            encoder_embeddings = torch.as_tensor(encoder_embeddings,
                                                 device=self.device)
        b = prompts.shape[0]
        with torch.inference_mode():
            self._sync()
            t0 = now()
            last_logits, cache = self.prefill(self.params, prompts,
                                              encoder_embeddings)
            cache = pad_prefill_cache(self.cfg, cache, b, self.max_len)
            tok = torch.argmax(last_logits.to(torch.float32), dim=-1)
            out = [tok[:, None].to(torch.int32)]
            self._sync()
            t1 = now()
            for i in range(max_new_tokens - 1):
                step_rng = prng.fold_in(rng, i) if rng is not None else None
                nxt, cache = self.decode(self.params, cache, out[-1],
                                         step_rng)
                out.append(nxt)
            self._sync()
            t2 = now()
        self.prefill_logits = last_logits
        self.stats = {
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / max(max_new_tokens - 1,
                                                         1),
            "tokens_per_s": b * max_new_tokens / (t2 - t0),
        }
        return torch.cat(out, dim=1)
