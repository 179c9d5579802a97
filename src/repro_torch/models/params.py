"""Parameter specs, seeded init, and the numpy bridge to the JAX tree.

Port of ``repro.models.params`` for the vision models: a tree of
``ParamSpec`` leaves gives shapes and init. Parameters are nested dicts of
tensors in the reference's layouts (HWIO conv weights, NHWC data at the
public functions); any layout change happens inside a forward.
``from_numpy`` / ``to_numpy`` carry a JAX parameter tree across (as
``jax.tree.map(np.asarray, params)``) and back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0        # multiplier on 1/sqrt(fan_in) for "normal"


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0] or 1


def init_tree(generator: torch.Generator, spec_tree, *, device=None,
              dtype=torch.float32):
    """Materialize a spec tree. Leaves are drawn from ``generator`` (a CPU
    generator) in sorted-key order, then moved to ``device``: one seed gives
    the same weights on every device."""
    if isinstance(spec_tree, ParamSpec):
        s = spec_tree
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        std = s.scale / _fan_in(s.shape) ** 0.5
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32)
        return (w * std).to(device=device, dtype=dtype)
    return {k: init_tree(generator, spec_tree[k], device=device, dtype=dtype)
            for k in sorted(spec_tree)}


def from_numpy(tree, device: Optional[torch.device] = None):
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (copies; the layouts are the reference's)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)


def to_numpy(state):
    """Inverse of ``from_numpy``: tensors -> numpy arrays on the host."""
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    return state.detach().cpu().numpy()


def to_device(tree, device: torch.device):
    """Move every tensor of a parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
