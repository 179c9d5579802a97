"""Int8 gradient compression with error feedback.

Port of ``repro.optim.compression``. Quantizing each gradient tensor to
int8 with one scale halves the bytes a data-parallel all-reduce moves in
bf16; the residual (the quantization error) is fed back into the next
step's gradient, so the scheme is unbiased over time (error-feedback SGD,
Karimireddy et al. 2019). The codes and scales are the reference's bit for
bit: the same float32 ops in the same order, ``torch.round`` rounding half
to even as ``jnp.round`` does.

One card has no all-reduce; the reference's ``Trainer`` never passes the
residuals either (ROADMAP §3), so ``grad_compression`` changes nothing in a
``Trainer`` run of either package. ``make_train_step``'s step takes
residuals and compresses as the reference's does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.p2m import QMAX_INT8
from repro_torch.optim.optimizer import leafwise, leaves


def compress_int8(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q_int8, scale, new_residual). g + residual ~= q * scale."""
    g32 = g.to(torch.float32) + residual
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-30) / QMAX_INT8
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_residual = g32 - q.to(torch.float32) * scale
    return q, scale, new_residual


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def tree_compress(grads, residuals):
    """Compress a whole gradient tree. Returns (q_tree, scale_tree, res)."""
    out = leafwise(compress_int8, grads, residuals)
    return tuple(leafwise(lambda t, i=i: t[i], out) for i in range(3))


def tree_decompress(q_tree, scale_tree):
    return leafwise(decompress_int8, q_tree, scale_tree)


def init_residuals(params):
    return leafwise(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_bytes(params) -> Tuple[int, int]:
    """(bf16 all-reduce bytes, int8 all-reduce bytes) for napkin math."""
    n = sum(p.numel() for p in leaves(params))
    return 2 * n, n
