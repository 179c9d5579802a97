"""The RG-LRU's linear recurrence: a hand-written Hopper kernel beside its
plain version, with and without the gates' float32 tail fused in front.

``rglru_scan(a, b)`` takes a, b (B, S, R) float32 and returns h (B, S, R)
float32 with ``h[:, t] = a[:, t] * h[:, t - 1] + b[:, t]`` from h = 0: the
scan of ``repro.models.recurrent.rglru_apply`` in train and prefill mode
(``jax.lax.associative_scan`` with the combine ``(a1 a2, a2 b1 + b2)``,
recurrent.py:97-103). ``rglru_scan_gated(r, i, u, c)`` computes a and b
from the gates first (``rglru_ab``: log a = c r, a = e^(log a), b =
sqrt(clamp(1 - a^2)) (i u), i u in u's dtype; c = -8 softplus(lam)) and
returns (h in u's dtype, the last step's h in float32): what a train or
prefill RG-LRU layer needs of the recurrence. No TPU kernel computes
either: the reference leaves both to XLA outside any Pallas kernel. On the
card both are ``csrc/rglru_scan.cu``, one kernel in two instances
(``rglru_scan_kernel<float, false>`` and ``rglru_scan_kernel<T, true>``,
T the compute dtype): blocks of 32 channels walk S in chunks that their
warps reduce in parallel and fold in order, each operand read once;
bound by its bytes. Their launches are counted in ``rglru_scan.launches``,
``rglru_scan_gated.launches`` and ``cuda_lib.launch_counts()``.

``rglru_scan_plain`` is ``jax.lax.associative_scan``'s odd / even
recursion in PyTorch ops, product for product, so on the CPU it matches
the reference to float32 rounding; ``rglru_scan_gated_plain`` is the eager
chain ``rglru_ab``, ``rglru_scan_plain``, the cast. They are what CPU
tensors run, and what the card's kernels are held against. A CUDA tensor
launches the kernel or raises.
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


# the compute dtypes of the gated instance, by the library's dtype code
_GATED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CTYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}


def kernel_symbol(gated_dtype=None) -> str:
    """The kernel instance a call launches, as the profiler names it:
    ``rglru_scan``'s (``gated_dtype`` None) or ``rglru_scan_gated``'s for
    operands of ``gated_dtype``."""
    if gated_dtype is None:
        return "rglru_scan_kernel<float, false>"
    return f"rglru_scan_kernel<{_CTYPES[gated_dtype]}, true>"


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


def rglru_ab(r: torch.Tensor, i: torch.Tensor, u: torch.Tensor,
             c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's a and b (float32) from the gates r, i and the input
    u (B, S, R) in the compute dtype and c = -8 softplus(lam) (R,) float32:
    log a = c r, a = e^(log a), b = sqrt(clamp(1 - e^(2 log a), 1e-12, 1))
    (i u), i u formed in u's dtype; the reference's ``_rglru_gates`` tail,
    op by op."""
    f32 = torch.float32
    log_a = c * r.to(f32)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))
    return a, beta * (i * u).to(f32)


def rglru_scan_gated_plain(r: torch.Tensor, i: torch.Tensor,
                           u: torch.Tensor, c: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h in u's dtype, h of the last step float32 (B, R)): ``rglru_ab``,
    the plain scan, the cast."""
    h = rglru_scan_plain(*rglru_ab(r, i, u, c))
    return h.to(u.dtype), h[:, -1].clone()


def _check_gated(r: torch.Tensor, i: torch.Tensor, u: torch.Tensor,
                 c: torch.Tensor) -> None:
    if r.ndim != 3 or not r.shape == i.shape == u.shape \
            or tuple(c.shape) != r.shape[2:]:
        raise ValueError(f"want r, i, u (B, S, R) of one shape and c (R,), "
                         f"got {tuple(r.shape)}, {tuple(i.shape)}, "
                         f"{tuple(u.shape)}, {tuple(c.shape)}")
    if u.dtype not in _GATED_DTYPES or not r.dtype == i.dtype == u.dtype \
            or c.dtype != torch.float32:
        raise TypeError(f"r, i, u must share float32 or bfloat16 and c be "
                        f"float32, got {r.dtype}, {i.dtype}, {u.dtype}, "
                        f"{c.dtype}")


@cuda_lib.kernel_wrapper
def rglru_scan_gated(r: torch.Tensor, i: torch.Tensor, u: torch.Tensor,
                     c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over a and b of ``rglru_ab(r, i, u, c)``: (h (B, S, R)
    in u's dtype, h of the last step (B, R) float32). The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check_gated(r, i, u, c)
    if on_cpu(r, i, u, c):
        return rglru_scan_gated_plain(r, i, u, c)
    batch, seq, width = u.shape
    r, i, u, c = r.contiguous(), i.contiguous(), u.contiguous(), \
        c.contiguous()
    hs = torch.empty_like(u)
    h_last = torch.empty((batch, width), dtype=torch.float32,
                         device=u.device)
    check_launch(cuda_lib.load_rglru().rglru_scan_gated(
        r.data_ptr(), i.data_ptr(), u.data_ptr(), c.data_ptr(),
        hs.data_ptr(), h_last.data_ptr(), _GATED_DTYPES[u.dtype], batch, seq,
        width, stream_of(u.device)), "rglru_scan_gated")
    rglru_scan_gated.launches += 1
    return hs, h_last


cuda_lib.register(rglru_scan, rglru_scan_gated)
