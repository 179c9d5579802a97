"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``).

* atomic: write to ``step_N.tmp/`` then rename — a crash mid-write never
  corrupts the latest checkpoint;
* keep-K garbage collection;
* async: the device->host copy happens synchronously (cheap), the disk
  write on a background thread so the caller keeps stepping.

Format, the reference's as it is: one ``.npz`` per tree (flattened with
'/'-joined keys: dict keys, ``__i`` for the i-th item of a list or tuple,
``__empty__`` for an empty container) plus a JSON manifest (step, extra,
tree names). The two packages read each other's checkpoints.

A tree is dicts, lists and tuples (NamedTuples such as ``ChipMaps`` /
``DriftMaps`` rebuild from their fields) over leaves: tensors, numpy
arrays and Python scalars. On restore the template's dtypes rule: a tensor
comes back as a tensor of its dtype on the template's device (bf16, which
``.npz`` cannot hold, is stored widened to float32), a numpy leaf as numpy
(int64 counters stay int64) and a Python scalar as a 0-d array of the
matching numpy dtype. The reference's elastic-remesh ``shardings=``
argument of ``restore`` is not ported yet: it waits for the port's
sharded serving.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _to_native(arr) -> np.ndarray:
    """A leaf as a numpy array ``.npz`` can hold: tensors come to the host,
    bf16 (and any other dtype numpy lacks) widened to float32 — the restore
    casts back to the template's dtype, so this is lossless for bf16."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                         torch.float8_e5m2):
            arr = arr.to(torch.float32)
        return arr.numpy()
    return np.asarray(arr)


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _rebuild(template, vals):
    """A list or tuple like ``template`` holding ``vals`` (NamedTuples
    construct from positional fields, not from one iterable)."""
    if hasattr(type(template), "_fields"):
        return type(template)(*vals)
    return type(template)(vals)


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``,
    trees of its structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [_tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        if len(tree) == 0:
            out[prefix + "__empty__"] = np.zeros((0,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
        if len(tree) == 0:
            out[prefix + "__empty__"] = np.zeros((0,))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat: Dict[str, Any], prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return _rebuild(template, [
            _unflatten_into(v, flat, f"{prefix}__{i}/")
            for i, v in enumerate(template)])
    return flat[prefix.rstrip("/")]


def _template_dtype(leaf):
    """The numpy dtype a restored host leaf comes back as (None = keep the
    stored one). Python scalars in a template (an int frame clock, a float
    energy counter) restore as 0-d arrays of the matching numpy dtype."""
    dt = getattr(leaf, "dtype", None)
    if dt is not None:
        return dt
    if isinstance(leaf, bool):
        return np.dtype(bool)
    if isinstance(leaf, int):
        return np.dtype(np.int64)
    if isinstance(leaf, float):
        return np.dtype(np.float64)
    return None


def _restore_leaf(value, template):
    """A stored array as its template's leaf: a tensor of the template's
    dtype on its device, or a numpy array of its dtype."""
    value = np.asarray(value)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(value)).to(
            dtype=template.dtype, device=template.device)
    dt = _template_dtype(template)
    return value if dt is None else value.astype(dt)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict] = None) -> None:
        """trees: name -> tree (e.g. {"fleet": ...}). Blocks only on the
        device->host copy; with ``async_write`` the disk IO runs on a
        background thread."""
        host_trees = {name: _tree_map(_to_native, t)
                      for name, t in trees.items()}
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_trees, extra or {}))
            self._thread.start()
        else:
            self._write(step, host_trees, extra or {})

    def _write(self, step: int, host_trees, extra: Dict) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for name, tree in host_trees.items():
            np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "extra": extra,
                       "trees": sorted(host_trees)}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the background write in flight, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict:
        """The saved manifest (step, extra, tree names) without restoring
        arrays — a restorer reads this first when the template's shapes
        depend on saved metadata (a fleet registry's chip count)."""
        path = os.path.join(self.dir, f"step_{step}", "manifest.json")
        with open(path) as f:
            return json.load(f)

    def restore(self, step: int, templates: Dict[str, Any]):
        """templates: name -> tree of leaves giving the structure, dtypes
        and (tensors) devices. Returns ``(trees, extra)``."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name, template in templates.items():
            with np.load(os.path.join(path, f"{name}.npz")) as data:
                flat = {k: data[k] for k in data.files}
            tree = _unflatten_into(template, flat)
            out[name] = _tree_map(_restore_leaf, tree, template)
        return out, manifest["extra"]
