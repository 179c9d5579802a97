"""Deterministic, checkpoint-resumable synthetic image batches.

Port of ``repro.data.synthetic``'s vision half. No dataset ships offline,
so ``ImageStream`` generates class-conditional oriented gratings from
(seed, step, shard): the batch at step k is a function of the key
``PRNGKey(hash((seed, step, shard, 7)) & 0x7FFFFFFF)`` alone (Python hashes
a tuple of ints the same way in every process), and the pipeline state is
the step counter, so a restart at step k reproduces the same batches.

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
