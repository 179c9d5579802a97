"""Deterministic, checkpoint-resumable synthetic data pipelines.

Port of ``repro.data.synthetic``. No dataset ships offline, so both
pipelines generate their batches from (seed, step, shard): the batch at
step k is a function of one key alone, ``PRNGKey(hash((seed, step, shard))
& 0x7FFFFFFF)`` for ``TokenStream`` and ``PRNGKey(hash((seed, step, shard,
7)) & 0x7FFFFFFF)`` for ``ImageStream`` (Python hashes a tuple of ints the
same way in every process), and the pipeline state is the step counter, so
a restart at step k reproduces the same batches.

``TokenStream``: LM token batches with Zipf-ish marginals and a
deterministic successor map (so a model can reduce its loss on them), the
reference's bit for bit on every device: the uniforms and the Bernoulli
mix are ``repro_torch.prng``'s, the affine map onto [1e-6, 1) and the
exponential are XLA's CPU arithmetic (``xla_exp``: the Cephes polynomial
with fused multiply-adds, which ``torch.exp`` is not), and the successor
map wraps in int32 as the reference's does at a vocabulary past 44,488.

``ImageStream``: class-conditional oriented gratings.

Drawn as the reference draws them (``repro_torch.prng``): the labels from
``randint`` bit for bit, the phases from ``uniform`` bit for bit, the noise
from ``normal`` (at most 3 float32 ulps from jax's); the gratings go
through ``sin`` / ``cos``, which agree with XLA's to a few float32 ulps.
The LM ``TokenStream`` comes with LM training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.devices import resolve_device


@dataclasses.dataclass
class ImageStream:
    """Batches of ``global_batch // num_shards`` frames (B, hw, hw,
    channels) in [0, 1] with int32 labels, on ``device``: the GPU unless
    asked otherwise (``device="cpu"``); raises without one."""
    hw: int = 32
    channels: int = 3
    num_classes: int = 10
    global_batch: int = 128
    seed: int = 0
    step: int = 0
    shard: int = 0
    num_shards: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def next_batch(self) -> Dict[str, torch.Tensor]:
        b = make_image_batch(prng.PRNGKey(
            hash((self.seed, self.step, self.shard, 7)) & 0x7FFFFFFF),
            self.local_batch, self.hw, self.channels, self.num_classes,
            self.device)
        self.step += 1
        return b


def make_image_batch(key, batch: int, hw: int, channels: int,
                     num_classes: int, device=None) -> Dict[str, torch.Tensor]:
    """Class-conditional oriented-grating images in [0, 1] + noise, and
    their labels, in the reference's operation order."""
    k1, k2, k3 = prng.split(key, 3)
    labels = prng.randint(k1, (batch,), 0, num_classes, device)
    ar = torch.arange(hw, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    angles = labels.to(torch.float32) * (math.pi / num_classes)
    freq = 0.4 + 0.15 * (labels % 3).to(torch.float32)
    phase = prng.uniform(k2, (batch,), device) * 2 * math.pi
    grid = (xx[None] * torch.cos(angles)[:, None, None]
            + yy[None] * torch.sin(angles)[:, None, None])
    img = 0.5 + 0.5 * torch.sin(freq[:, None, None] * grid
                                + phase[:, None, None])
    img = img[..., None].expand(*img.shape, channels)
    noise = 0.1 * prng.normal(k3, tuple(img.shape), device)
    return {"image": torch.clamp(img + noise, 0.0, 1.0), "label": labels}


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the float64
    product of two float32 values is exact, and the float64 sum rounds to
    float32 as the fused op does (one double rounding; every one of 3M
    inputs tested gave XLA's bits)."""
    f64 = torch.float64
    b = b.to(f64) if isinstance(b, torch.Tensor) else b
    c = c.to(f64) if isinstance(c, torch.Tensor) else c
    return (a.to(f64) * b + c).to(torch.float32)


# XLA's float32 exp on the CPU (the Cephes polynomial, llvm_ir_runtime's
# vectorised exp): the input clamped, n = floor(x log2(e) + 1/2), x - n
# ln(2) in two parts, a degree-5 polynomial, times 2^n; each step a fused
# multiply-add. The constants are float32.
_EXP_CLAMP = 88.72283935546875
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 e^x as XLA computes it on the CPU, bit for bit."""
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    x = torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP)
    n = torch.floor(_fma(x, f32(_EXP_LOG2E), f32(0.5)))
    x = _fma(n, f32(-_EXP_C1), x)
    x = _fma(n, f32(-_EXP_C2), x)
    z = x * x
    y = torch.full_like(x, f32(_EXP_POLY[0]))
    for coef in _EXP_POLY[1:]:
        y = _fma(y, x, f32(coef))
    y = _fma(y, z, x) + 1.0
    return torch.ldexp(y, n.to(torch.int32)).to(torch.float32)


@dataclasses.dataclass
class TokenStream:
    """Batches of ``global_batch // num_shards`` sequences of ``seq_len``
    int32 tokens and their next-token labels, on ``device``: the GPU
    unless asked otherwise (``device="cpu"``); raises without one."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0                 # checkpointable pipeline state
    shard: int = 0
    num_shards: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def state_dict(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, st: Dict) -> None:
        self.step = int(st["step"])
        self.seed = int(st["seed"])

    def next_batch(self) -> Dict[str, torch.Tensor]:
        b = make_lm_batch(prng.PRNGKey(
            hash((self.seed, self.step, self.shard)) & 0x7FFFFFFF),
            self.local_batch, self.seq_len, self.vocab_size, self.device)
        self.step += 1
        return b


def make_lm_batch(key, batch: int, seq: int, vocab: int, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Zipf-ish marginal + a deterministic bigram successor map: int32
    ``tokens`` (batch, seq) and ``labels`` (the tokens rolled by one)."""
    k1, k2 = prng.split(key)
    lo = torch.tensor(1e-6, dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - lo
    u = torch.maximum(lo, _fma(prng.uniform(k1, (batch, seq), device), span,
                               lo))
    base = (xla_exp(-3.0 * u) * vocab).to(torch.int64) % vocab
    # (base * 48271 + 12345) in wrapping int32, then the floor modulo
    succ = (base * 48271 + 12345) & 0xFFFFFFFF
    succ = torch.remainder(succ - ((succ >> 31) << 32), vocab)
    mix = prng.bernoulli(k2, 0.7, (batch, seq), device)
    toks = torch.where(mix, torch.roll(succ, 1, dims=1), base)
    labels = torch.roll(toks, -1, dims=1)
    return {"tokens": toks.to(torch.int32), "labels": labels.to(torch.int32)}
