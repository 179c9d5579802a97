"""Hoyer-regularized binary activation (paper §2.3, Eqs. 1-2).

Port of ``repro.core.hoyer``: the clip, the Hoyer extremum (the dynamic
spike threshold), the regularizer, the spike with its straight-through
gradient on the clip window, and the effective threshold.

The clip takes jax's gradient at its edges: ``jnp.clip`` (a maximum, then
a minimum) passes half of the gradient at z = 0 and at z = 1, where
``torch.clamp`` passes all of it. The Hoyer sums take a clipped map, so
they sum z for |z|: the same values, and ``jnp.abs``'s gradient there (+g,
also at 0, where ``torch.abs`` passes 0).
"""
from __future__ import annotations

import torch

# the clip's bounds: 0-dim CPU tensors, which a binary op takes beside a
# tensor on any device (a Python float would make them a clamp)
_ZERO, _ONE = torch.zeros(()), torch.ones(())


def clip01(z: torch.Tensor) -> torch.Tensor:
    """clip(z, 0, 1) as ``jnp.clip``: a maximum, then a minimum, each of
    which splits a tie's gradient in half."""
    return torch.minimum(torch.maximum(z, _ZERO), _ONE)


def hoyer_extremum(z_clip: torch.Tensor, axis=None,
                   keepdims: bool = False) -> torch.Tensor:
    """E(z) = sum(z^2)/sum(|z|) of a clipped map (|z| = z). Global by
    default; ``axis``/``keepdims`` give per-example thresholds."""
    if axis is None:
        num = torch.sum(torch.square(z_clip))
        den = torch.sum(z_clip)
    else:
        num = torch.sum(torch.square(z_clip), dim=axis, keepdim=keepdims)
        den = torch.sum(z_clip, dim=axis, keepdim=keepdims)
    return num / torch.clamp(den, min=1e-9)


def hoyer_regularizer(z_clip: torch.Tensor) -> torch.Tensor:
    """H(z) = (sum|z|)^2 / sum(z^2) of a clipped map (|z| = z); minimized
    by sparse z."""
    num = torch.square(torch.sum(z_clip))
    den = torch.sum(torch.square(z_clip))
    return num / torch.clamp(den, min=1e-9)


class _Spike(torch.autograd.Function):
    """o = 1[z >= threshold]; backward ``g * 1[0 <= z <= 1]`` (the clip's
    derivative) for z and a zero gradient for the threshold, as the
    reference's custom VJP."""

    @staticmethod
    def forward(ctx, z, threshold):
        ctx.save_for_backward(z)
        ctx.thr_shape = threshold.shape
        return (z >= threshold).to(z.dtype)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        mask = ((z >= 0.0) & (z <= 1.0)).to(g.dtype)
        g_thr = None
        if ctx.needs_input_grad[1]:
            g_thr = g.new_zeros(ctx.thr_shape)
        return g * mask, g_thr


def spike(z: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """o = 1[z >= threshold], straight-through gradient on the clip window."""
    return _Spike.apply(z, threshold)


def hoyer_spike(u: torch.Tensor, v_th: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1+2: ``(binary output, hoyer_loss term)`` at the global
    threshold E(z_clip) * v_th. The threshold is held constant (detached,
    as the reference stops its gradient); gradients reach ``u`` and
    ``v_th`` through the spike's window and the regularizer."""
    z = u / torch.clamp(v_th, min=1e-6)
    zc = clip01(z)
    o = spike(z, hoyer_extremum(zc).detach())
    return o, hoyer_regularizer(zc)


def effective_threshold(u: torch.Tensor, v_th: torch.Tensor) -> torch.Tensor:
    """The normalized dynamic threshold E(z_clip) (for hardware mapping)."""
    z = u / torch.clamp(v_th, min=1e-6)
    return hoyer_extremum(clip01(z))
