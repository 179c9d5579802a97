"""The RG-LRU's linear recurrence: a hand-written Hopper kernel beside its
plain version.

``rglru_scan(a, b)`` takes a, b (B, S, R) float32 and returns h (B, S, R)
float32 with ``h[:, t] = a[:, t] * h[:, t - 1] + b[:, t]`` from h = 0: the
scan of ``repro.models.recurrent.rglru_apply`` in train and prefill mode
(``jax.lax.associative_scan`` with the combine ``(a1 a2, a2 b1 + b2)``,
recurrent.py:97-103). No TPU kernel computes it: the reference leaves it to
XLA outside any Pallas kernel. On the card it is ``csrc/rglru_scan.cu``
(one thread a (b, r) channel walking S in float32 FMAs, loads run ahead of
the chain; bound by its bytes); its launches are counted in
``rglru_scan.launches`` and in ``cuda_lib.launch_counts()``.

``rglru_scan_plain`` is ``jax.lax.associative_scan``'s odd / even
recursion in PyTorch ops, product for product, so on the CPU it matches
the reference to float32 rounding. It is what CPU tensors run, and what the
card's kernel is held against. A CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_launch, on_cpu, stream_of


def _combine(first: Tuple[torch.Tensor, torch.Tensor],
             second: Tuple[torch.Tensor, torch.Tensor]):
    """Two steps of the recurrence as one: (a1 a2, a2 b1 + b2)."""
    (a1, b1), (a2, b2) = first, second
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows of ``even`` at 0, 2, 4, ... and of ``odd`` at 1, 3, ... of axis
    1 (``even`` as long as ``odd`` or one longer)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a: torch.Tensor, b: torch.Tensor):
    n = a.shape[1]
    if n < 2:
        return a, b
    reduced = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    odd_a, odd_b = _scan(*reduced)
    if n % 2 == 0:
        even_a, even_b = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                                  (a[:, 2::2], b[:, 2::2]))
    else:
        even_a, even_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, S, R) of the recurrence over axis 1 from h = 0, in PyTorch ops:
    the reference's associative scan (its ``b`` part is h)."""
    return _scan(a, b)[1]


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"want a, b (B, S, R) of one shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a, b must be float32, got {a.dtype}, {b.dtype}")


@cuda_lib.kernel_wrapper
def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, S, R) float32 with h[:, t] = a[:, t] h[:, t - 1] + b[:, t]: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(a, b)
    if on_cpu(a, b):
        return rglru_scan_plain(a, b)
    batch, seq, width = a.shape
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    check_launch(cuda_lib.load_rglru().rglru_scan(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, seq, width,
        stream_of(a.device)), "rglru_scan")
    rglru_scan.launches += 1
    return out


cuda_lib.register(rglru_scan)
