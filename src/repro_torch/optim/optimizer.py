"""Optimizers: AdamW / SGD-momentum, with the memory-reduced state options.

Port of ``repro.optim.optimizer``:
  * ``factored_second_moment``: Adafactor-style row/col factorization of
    the Adam second moment for >= 2-D params (O(n + m) state instead of
    O(n m));
  * ``momentum_dtype``: the first moment stored in bf16, or none at all
    (``use_momentum=False``: pure Adafactor).

A tree is the parameters' nested dicts; the state's ``mu`` and ``nu``
mirror it, each leaf a tensor, a ``(row, col)`` pair (factored) or ``()``
(no state), as the reference's pytrees hold them, so a checkpoint crosses
over in the reference's format. Every leaf's update follows the
reference's order of operations: the gradient cast to float32 and scaled
by the clip, the moments, the bias corrections, the rsqrt, weight decay,
the step; scalars (the learning rate, the norm, the corrections) are 0-d
float32 tensors on the parameters' device, so a step never reads the host.
The port's element-wise ops round where XLA's fused ones may contract a
multiply-add, so a leaf lands within float32 ulps of the reference's.

``apply_updates`` writes the new values into the parameter and state
tensors it was given, one leaf at a time, so a step holds one leaf's
temporaries and not a second copy of the model and its moments (the
reference donates the same buffers to its jitted step); it returns the
same trees. With ``finite`` (a 0-d bool tensor) it keeps the old leaf
wherever the step is not finite (the train step's NaN guard).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import OptimizerConfig


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


@dataclasses.dataclass
class OptState:
    step: torch.Tensor   # () int32
    mu: Any              # first moment (or () leaves: no momentum)
    nu: Any              # second moment: a tensor, a (row, col) pair or ()


def leafwise(fn: Callable, params, *trees):
    """``fn(p, *leaves)`` over the tensors of ``params`` (nested dicts) and
    the leaves of ``trees`` at the same keys, in sorted-key order (the
    order of ``leaves``); the same dict tree of results."""
    if isinstance(params, dict):
        return {k: leafwise(fn, params[k], *(t[k] for t in trees))
                for k in sorted(params)}
    return fn(params, *trees)


def leaves(tree):
    """The leaves of a nested dict in sorted-key order (the reference's
    pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _pick(tree, i: int):
    return leafwise(lambda t: t[i], tree)


def _factorable(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _init_nu(p: torch.Tensor, cfg: OptimizerConfig):
    if cfg.name != "adamw":
        return ()
    f32 = dict(dtype=torch.float32, device=p.device)
    if cfg.factored_second_moment and _factorable(p):
        return (torch.zeros(p.shape[:-1], **f32),        # row: reduce last
                torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
    return torch.zeros(p.shape, **f32)


def _init_mu(p: torch.Tensor, cfg: OptimizerConfig):
    if not cfg.use_momentum:
        return ()
    return torch.zeros(p.shape, dtype=getattr(torch, cfg.momentum_dtype),
                       device=p.device)


def init_opt_state(params, cfg: OptimizerConfig) -> OptState:
    device = leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=leafwise(lambda p: _init_mu(p, cfg), params),
        nu=leafwise(lambda p: _init_nu(p, cfg), params))


def _update_nu(nu, g2: torch.Tensor, b2: float):
    if isinstance(nu, tuple) and len(nu) == 2:
        row, col = nu
        row = b2 * row + (1 - b2) * torch.mean(g2, dim=-1)
        col = b2 * col + (1 - b2) * torch.mean(g2, dim=-2)
        return (row, col)
    return b2 * nu + (1 - b2) * g2


def _nu_rsqrt(nu, eps: float):
    """rsqrt(v_hat); for the factored case three broadcastable factors
    (rsqrt(row), rsqrt(col), sqrt(mean_row)), never the full tensor."""
    if isinstance(nu, tuple) and len(nu) == 2:
        row, col = nu
        denom = torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=1e-30)
        return (torch.rsqrt(row + eps)[..., :, None],
                torch.rsqrt(col + eps)[..., None, :],
                torch.sqrt(denom)[..., None])
    return torch.rsqrt(nu + eps)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sums of squares, added leaf by leaf in the
    reference's order."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _keep(new, old, finite: Optional[torch.Tensor]):
    """``new`` where the step is finite, else ``old``, written into ``old``.
    Leaves are tensors, (row, col) pairs or ()."""
    if isinstance(new, tuple):
        return tuple(_keep(n, o, finite) for n, o in zip(new, old))
    if finite is not None:
        new = torch.where(finite, new, old)
    return old.copy_(new)


def apply_updates(params, grads, state: OptState, cfg: OptimizerConfig, *,
                  finite: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place. Returns (params, state, metrics): the
    trees it was given, updated. ``finite``: keep the old values where it
    is False (no host read)."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = (torch.minimum(one, cfg.grad_clip / torch.clamp(gnorm,
                                                            min=1e-12))
             if cfg.grad_clip > 0 else one)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        p32 = p.to(torch.float32)
        if cfg.name == "adamw":
            if cfg.use_momentum:
                mu_new = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
                m_hat = mu_new / bc1
            else:           # pure Adafactor: no first moment held
                mu_new = ()
                m_hat = g
            nu_new = _update_nu(nu, torch.square(g), cfg.b2)
            rs = _nu_rsqrt(tuple(t / bc2 for t in nu_new)
                           if isinstance(nu_new, tuple) else nu_new / bc2,
                           cfg.eps)
            if isinstance(rs, tuple):   # factored: multiply per factor
                upd_ = m_hat
                for f in rs:
                    upd_ = upd_ * f
            else:
                upd_ = m_hat * rs
            del g, m_hat, rs
            upd_ = upd_ + cfg.weight_decay * p32
            new_p = p32 - lr * upd_
            mu_out = mu_new if isinstance(mu_new, tuple) \
                else mu_new.to(mu.dtype)
            return (_keep(new_p.to(p.dtype), p, finite),
                    _keep(mu_out, mu, finite),
                    _keep(nu_new, nu, finite))
        # SGD + momentum
        mu_new = cfg.b1 * mu.to(torch.float32) + g
        new_p = p32 - lr * mu_new - lr * cfg.weight_decay * p32
        return (_keep(new_p.to(p.dtype), p, finite),
                _keep(mu_new.to(mu.dtype), mu, finite), ())

    out = leafwise(upd, params, grads, state.mu, state.nu)
    new_step = step if finite is None else torch.where(finite, step,
                                                       state.step)
    state.step.copy_(new_step)
    return (_pick(out, 0), OptState(state.step, _pick(out, 1), _pick(out, 2)),
            {"lr": lr, "grad_norm": gnorm})
