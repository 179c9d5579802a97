"""Hoyer-regularized binary activation (paper §2.3, Eqs. 1-2).

Port of ``repro.core.hoyer`` for inference: the clip, the Hoyer extremum
(the dynamic spike threshold), the regularizer, the spike and the
effective threshold. The spike is forward only: its straight-through
gradient comes with training.
"""
from __future__ import annotations

import torch


def clip01(z: torch.Tensor) -> torch.Tensor:
    return torch.clamp(z, 0.0, 1.0)


def hoyer_extremum(z_clip: torch.Tensor, axis=None,
                   keepdims: bool = False) -> torch.Tensor:
    """E(z) = sum(z^2)/sum(|z|). Global by default; ``axis``/``keepdims``
    give per-example thresholds."""
    if axis is None:
        num = torch.sum(torch.square(z_clip))
        den = torch.sum(torch.abs(z_clip))
    else:
        num = torch.sum(torch.square(z_clip), dim=axis, keepdim=keepdims)
        den = torch.sum(torch.abs(z_clip), dim=axis, keepdim=keepdims)
    return num / torch.clamp(den, min=1e-9)


def hoyer_regularizer(z_clip: torch.Tensor) -> torch.Tensor:
    """H(z) = (sum|z|)^2 / sum(z^2); minimized by sparse z."""
    num = torch.square(torch.sum(torch.abs(z_clip)))
    den = torch.sum(torch.square(z_clip))
    return num / torch.clamp(den, min=1e-9)


def spike(z: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """o = 1[z >= threshold]. Forward only: the reference's straight-through
    gradient on the clip window (a custom VJP) comes with training."""
    return (z >= threshold).to(z.dtype)


def hoyer_spike(u: torch.Tensor, v_th: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 1+2: ``(binary output, hoyer_loss term)`` at the global
    threshold E(z_clip) (held constant, as the reference stops its
    gradient)."""
    z = u / torch.clamp(v_th, min=1e-6)
    zc = clip01(z)
    o = spike(z, hoyer_extremum(zc).detach())
    return o, hoyer_regularizer(zc)


def effective_threshold(u: torch.Tensor, v_th: torch.Tensor) -> torch.Tensor:
    """The normalized dynamic threshold E(z_clip) (for hardware mapping)."""
    z = u / torch.clamp(v_th, min=1e-6)
    return hoyer_extremum(clip01(z))
