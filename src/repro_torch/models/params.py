"""Parameter specs, seeded init, and the numpy bridge to the JAX tree.

Port of ``repro.models.params``: a tree of ``ParamSpec`` leaves gives
shapes, init and (optionally) a per-leaf dtype; ``stack_specs`` prepends the
layer-stack axis of a run of identical layers, as the reference does for its
scan. Parameters are nested dicts of tensors in the reference's layouts
(HWIO conv weights, NHWC data, (d, heads, head_dim) projections, the stacked
``body`` axis first); any layout change happens inside a forward.
``from_numpy`` / ``to_numpy`` carry a JAX parameter tree across (as
``jax.tree.map(np.asarray, params)``, NamedTuples such as ``ChipMaps``
field by field) and back. The logical sharding axes of
the reference's specs have no counterpart: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0        # multiplier on 1/sqrt(fan_in) for "normal"
    dtype: Optional[str] = None   # override the tree-wide dtype (e.g. "int32")
    stacked: bool = False     # leading axis is a layer stack (stack_specs)
    experts: bool = False     # an expert axis leads, after any layer stack


def stack_specs(spec_tree, n: int):
    """Prepend a layer-stack axis of size n to every spec. The init scale
    keeps the reference's fan-in over the stacked shape."""
    if isinstance(spec_tree, ParamSpec):
        return dataclasses.replace(spec_tree, shape=(n,) + spec_tree.shape,
                                   stacked=True)
    return {k: stack_specs(v, n) for k, v in spec_tree.items()}


def _fan_in(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0] or 1


def _init_leaf(generator: torch.Generator, s: ParamSpec, device, dtype):
    dt = getattr(torch, s.dtype) if s.dtype else dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    std = s.scale / _fan_in(s.shape) ** 0.5
    lead = int(s.stacked) + int(s.experts)   # axes drawn slice by slice
    if not lead:
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * std).to(device=device, dtype=dt)
    # one layer (and one expert) slice at a time: the float32 draw never
    # exceeds one slice (kimi-k2's (384, 7168, 2048) expert leaf at once
    # would take 22.5 GB of float32 beside the model)
    out = torch.empty(s.shape, dtype=dt, device=device)
    slices = out.view(-1, *s.shape[lead:])
    for i in range(slices.shape[0]):
        w = torch.randn(s.shape[lead:], generator=generator,
                        dtype=torch.float32, device=generator.device)
        slices[i].copy_(w * std)
    return out


def init_tree(generator: torch.Generator, spec_tree, *, device=None,
              dtype=torch.float32):
    """Materialize a spec tree. Leaves are drawn in float32 from
    ``generator``, on the generator's device, in sorted-key order, one leaf
    (and one layer, and one expert, of a stacked or expert leaf) at a time,
    cast to the leaf's dtype
    and placed on ``device``. A CPU generator gives the same weights on
    every device; a CUDA generator draws billions of parameters on the card
    without a host copy (different numbers from the same seed)."""
    if isinstance(spec_tree, ParamSpec):
        return _init_leaf(generator, spec_tree, device, dtype)
    return {k: init_tree(generator, spec_tree[k], device=device, dtype=dtype)
            for k in sorted(spec_tree)}


def _spec_leaves(spec_tree):
    if isinstance(spec_tree, ParamSpec):
        return [spec_tree]
    return [s for k in sorted(spec_tree) for s in _spec_leaves(spec_tree[k])]


def init_tree_from_key(key, spec_tree, *, device=None, dtype=torch.float32):
    """Materialize a spec tree as the reference's ``init_tree(key, ...)``
    draws it: ``prng.split(key, n)`` over the n leaves in sorted-key order,
    each "normal" leaf ``prng.normal(k, shape) * scale / sqrt(fan_in)`` in
    float32 (within 3 ulps of ``jax.random.normal``; a stacked leaf is
    drawn whole, as the reference draws it), cast to its dtype, on
    ``device``."""
    keys = iter(prng.split(key, len(_spec_leaves(spec_tree))))

    def one(s: ParamSpec):
        k = next(keys)
        dt = getattr(torch, s.dtype) if s.dtype else dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        std = s.scale / _fan_in(s.shape) ** 0.5
        return (prng.normal(k, s.shape, device) * std).to(dt)

    def walk(tree):
        if isinstance(tree, ParamSpec):
            return one(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}

    return walk(spec_tree)


def _tuple_like(tree, items):
    """``items`` as ``tree``'s tuple type: a NamedTuple (``ChipMaps``,
    ``DriftMaps``) keeps its type and fields."""
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def from_numpy(tree, device: Optional[torch.device] = None):
    """Nested dicts (and tuples, a NamedTuple keeping its type) of numpy
    arrays -> the same tree of tensors on ``device`` (copies; the layouts
    are the reference's)."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _tuple_like(tree, (from_numpy(v, device) for v in tree))
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def to_numpy(state):
    """Inverse of ``from_numpy``: tensors -> numpy arrays on the host."""
    if isinstance(state, dict):
        return {k: to_numpy(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return _tuple_like(state, (to_numpy(v) for v in state))
    return state.detach().cpu().numpy()


def to_device(tree, device: torch.device):
    """Move every tensor of a parameter tree (dicts, and tuples such as a
    ``ChipMaps`` in ``params["chip"]``) to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _tuple_like(tree, (to_device(v, device) for v in tree))
    return tree.to(device)
