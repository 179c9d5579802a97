"""SGD train and eval loops for the P2M sparse-BNN vision models.

Port of ``repro.train.vision``: one step rule, key folding and hardware-eval
accounting shared by ``python -m repro_torch.launch.train`` and
``python -m repro_torch.train_p2m_vision``.

The gradient is taken with ``torch.autograd.grad`` under the same cuDNN
flags as the forward (TF32 off): the backward convs run inside
``autograd.grad`` and read the flags at that time, so a forward-only
context would leave them on cuDNN's TF32 default. The parameters never
leave their device; the loss is read on the host only where it is logged.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.models import vision


def _leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """The floating-point tensors of a nested dict, with their key paths
    (a ``ChipMaps`` tuple in ``params["p2m"]["chip"]`` is no leaf: nothing
    trains it, as its gradient in the reference is zero)."""
    if isinstance(tree, dict):
        return [leaf for k in tree
                for leaf in _leaves(tree[k], prefix + (k,))]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [(prefix, tree)]
    return []


def _replace(tree, new: Dict[tuple, torch.Tensor], prefix=()):
    if isinstance(tree, dict):
        return {k: _replace(v, new, prefix + (k,)) for k, v in tree.items()}
    return new.get(prefix, tree)


def value_and_grad(params: Dict, batch: Dict, cfg: vision.VisionConfig, key
                   ) -> Tuple[torch.Tensor, Dict, Dict[tuple, torch.Tensor]]:
    """``vision.loss_fn`` and its gradient: ``(loss, aux, grads)``, loss
    and aux detached, grads keyed by each leaf's path, None where the loss
    does not reach the leaf (the reference's zero gradient), forward and
    backward with cuDNN's TF32 off."""
    live = {path: t.detach().requires_grad_(True)
            for path, t in _leaves(params)}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        loss, aux = vision.loss_fn(_replace(params, live), batch, cfg, key)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
    return loss.detach(), _detach(aux), dict(zip(live, grads))


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def make_step(cfg: vision.VisionConfig, lr: float = 3e-3):
    """The SGD train step ``(params, batch, key) -> (params, loss, aux)``:
    ``w - lr * g`` on every leaf the loss reaches (any other keeps its
    value), then the BN running stats of the train-mode forward folded
    into the tree. Pure: the parameters passed in are left as they are."""

    def step(params, batch, key):
        loss, aux, grads = value_and_grad(params, batch, cfg, key)
        with torch.no_grad():
            new = {path: t - lr * grads[path]
                   for path, t in _leaves(params) if grads[path] is not None}
        params = vision.apply_bn_state(_replace(params, new),
                                       aux.pop("bn_state", None))
        return params, loss, aux

    return step


def fit(params, cfg: vision.VisionConfig, stream, steps: int,
        lr: float = 3e-3, key=None, log_every: Optional[int] = None,
        log_fn: Callable[[str], None] = print,
        history: Optional[list] = None):
    """Plain-SGD training through the SensorFrontend. ``key`` (a host key,
    default ``PRNGKey(42)``) is folded per step and reaches the frontend:
    the Fig. 8 flips when ``cfg.p2m.noise_p_*`` are set. Every
    ``log_every`` steps the loss, accuracy and P2M sparsity are read on the
    host, logged, and appended to ``history`` when one is given."""
    key = key if key is not None else prng.PRNGKey(42)  # analysis: waive=no-host-rng
    step = make_step(cfg, lr)
    for i in range(steps):
        params, loss, aux = step(params, stream.next_batch(),
                                 prng.fold_in(key, i))
        if log_every and (i + 1) % log_every == 0:
            rec = {"step": i + 1, "loss": float(loss),
                   "acc": float(aux["acc"]),
                   "p2m_sparsity": float(aux["p2m_sparsity"])}
            log_fn(f"step {i + 1:4d}  loss {rec['loss']:.4f}  "
                   f"acc {rec['acc'] * 100:5.1f}%  "
                   f"p2m sparsity {rec['p2m_sparsity'] * 100:5.1f}%")
            if history is not None:
                history.append(rec)
    return params


def evaluate(params, cfg: vision.VisionConfig, stream, n_batches: int = 4,
             backend: Optional[str] = None, key=None) -> Tuple[float, int]:
    """Accuracy over ``n_batches`` through the given frontend backend:
    ``(accuracy, n_examples)``. Pass ``key`` for the stochastic backends
    (``device``, ``cuda``); it is folded per batch."""
    correct, total = 0.0, 0
    with torch.no_grad():
        for j in range(n_batches):
            b = stream.next_batch()
            k = prng.fold_in(key, j) if key is not None else None
            logits, _, _ = vision.forward(params, b["image"], cfg,
                                          backend=backend, key=k)
            correct += float(torch.sum(torch.argmax(logits, -1)
                                       == b["label"]))
            total += b["label"].shape[0]
    return correct / total, total
