"""The sLSTM's recurrence: a hand-written Hopper kernel beside its plain
version.

``slstm_scan(xs, rs, bs, carry)`` runs the recurrence of
``repro.models.recurrent.slstm_apply`` over a sequence: from the four
gates' float32 pre-activations ``xs`` = (x_z, x_i, x_f, x_o), each (B, S,
H, dh), the recurrent weights ``rs`` (four (H, dh, dh)) and biases ``bs``
(four (H, dh)), in float32 or bfloat16 (cast exactly to float32), and the
carry (c, n, h, m), four (B, H, dh) float32 (zeros where None), it returns
hs (B, S, H, dh) float32 and the last step's carry: a given carry's
tensors (a decode step's cache), written in place, or new ones. Each step
is the reference's ``_slstm_step`` (recurrent.py:267-286) in its order:
pre_g = x_g + (h r_g + b_g); z = tanh, f_log = log_sigmoid, o = sigmoid;
m_new = max(f_log + m, i_log); the two exponentials; c, n, and h = o c /
max(n, 1). No TPU kernel computes it: the
reference's recurrence is a ``jax.lax.scan`` that XLA compiles into one
loop, outside any Pallas kernel. On the card it is
``csrc/slstm_scan.cu``'s ``slstm_cluster_kernel<W, R>`` (W the weights'
dtype, R the rows of a row group rounded up to 1, 2, 4 or 8): a cluster
of blocks a (head, row group), each block holding its columns of the
head's four weight matrices in shared memory for the whole sequence, h
exchanged between the blocks through distributed shared memory each step
(``design`` says what a call launches); one launch for the whole
sequence, counted in ``slstm_scan.launches`` and
``cuda_lib.launch_counts()``. It takes an even head dim from 16 to 256
and raises for any other, on the CPU too.

``slstm_scan_plain`` is the reference's step in PyTorch ops, looped over
S: what CPU tensors run, and what the card's kernel is held against. A
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_launch, on_cpu, stream_of

MIN_DH, MAX_DH = 16, 256         # the kernel's head dims (even)
# the design's limits (csrc/slstm_scan.cu): blocks a cluster, the columns a
# larger cluster must leave a block, batch rows a row group, warps a block,
# shared memory a block (227 KB) and the bytes of one lane's weight chunk
MAX_CLUSTER, MIN_COLS, MAX_ROWS, MAX_WARPS = 8, 32, 8, 8
SMEM_BYTES, CHUNK_BYTES = 232_448, 16
# the weights' dtypes, by the library's dtype code
_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CTYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x), that is -(max(-x, 0) +
    log1p(e^-|x|))."""
    return -(torch.clamp(-x, min=0) + torch.log1p(torch.exp(-torch.abs(x))))


def slstm_step_plain(xg: Sequence[torch.Tensor], rs: Sequence[torch.Tensor],
                     bs: Sequence[torch.Tensor], carry: Carry
                     ) -> Carry:
    """One step of the reference's ``_slstm_step``: xg four (B, H, dh)
    float32 pre-activations, rs / bs the float32 weights and biases, carry
    (c, n, h, m). Returns the new carry."""
    c, n, hp, m = carry

    def pre(j):
        return xg[j] + (torch.einsum("bhd,hde->bhe", hp, rs[j]) + bs[j])

    z = torch.tanh(pre(0))
    i_log = pre(1)
    f_log = _log_sigmoid(pre(2))
    o = 1 / (1 + torch.exp(-pre(3)))
    m_new = torch.maximum(f_log + m, i_log)
    i_s = torch.exp(i_log - m_new)
    f_s = torch.exp(f_log + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _zero_carry(x: torch.Tensor) -> Carry:
    b, _, h, dh = x.shape
    return tuple(x.new_zeros((b, h, dh)) for _ in range(4))


def slstm_scan_plain(xs: Sequence[torch.Tensor], rs: Sequence[torch.Tensor],
                     bs: Sequence[torch.Tensor],
                     carry: Optional[Carry] = None) -> Tuple[torch.Tensor,
                                                             Carry]:
    """(hs (B, S, H, dh) float32, the last carry): ``slstm_step_plain``
    looped over S from ``carry`` (zeros where None)."""
    f32 = torch.float32
    r32 = [r.to(f32) for r in rs]
    b32 = [b.to(f32) for b in bs]
    state = _zero_carry(xs[0]) if carry is None else tuple(carry)
    hs = []
    for t in range(xs[0].shape[1]):
        state = slstm_step_plain([x[:, t] for x in xs], r32, b32, state)
        hs.append(state[2])
    return torch.stack(hs, dim=1), state


def _check(xs, rs, bs, carry) -> None:
    if not len(xs) == len(rs) == len(bs) == 4 or (
            carry is not None and len(carry) != 4):
        raise ValueError("want four pre-activations, weights and biases "
                         "(z, i, f, o) and a carry of four (c, n, h, m)")
    shape = tuple(xs[0].shape)
    if len(shape) != 4 or any(tuple(x.shape) != shape for x in xs):
        raise ValueError(f"want x (B, S, H, dh) of one shape, got "
                         f"{[tuple(x.shape) for x in xs]}")
    b, s, h, dh = shape
    if s < 1:
        raise ValueError("want a sequence of at least one step")
    if dh % 2 or not MIN_DH <= dh <= MAX_DH:
        raise ValueError(f"the sLSTM kernel takes an even head dim from "
                         f"{MIN_DH} to {MAX_DH}, got {dh}")
    if any(tuple(r.shape) != (h, dh, dh) for r in rs) or any(
            tuple(bb.shape) != (h, dh) for bb in bs):
        raise ValueError(f"want r (H, dh, dh) and b (H, dh) at H {h}, dh "
                         f"{dh}, got {[tuple(r.shape) for r in rs]}, "
                         f"{[tuple(bb.shape) for bb in bs]}")
    if carry is not None and any(tuple(t.shape) != (b, h, dh)
                                 for t in carry):
        raise ValueError(f"want a carry of (B, H, dh) = {(b, h, dh)}, got "
                         f"{[tuple(t.shape) for t in carry]}")
    state = () if carry is None else tuple(carry)
    if any(t.dtype != torch.float32 for t in (*xs, *state)):
        raise TypeError("the pre-activations and the carry must be float32")
    wd = rs[0].dtype
    if wd not in _W_DTYPES or any(t.dtype != wd for t in (*rs, *bs)):
        raise TypeError(f"r and b must share float32 or bfloat16, got "
                        f"{[t.dtype for t in (*rs, *bs)]}")


def _row_groups(batch: int) -> Tuple[int, int, int]:
    """(groups, rows, slots): the fewest row groups of at most MAX_ROWS
    batch rows, the rows of the largest, and the rows its instance
    computes (rows rounded up to 1, 2, 4 or 8)."""
    groups = -(-batch // MAX_ROWS)
    rows = -(-batch // groups)
    return groups, rows, next(n for n in (1, 2, 4, 8) if rows <= n)


def design(batch: int, heads: int, dh: int, w_dtype: torch.dtype) -> dict:
    """What a call at (batch, heads, head dim, weight dtype) launches, as
    the library's ``slstm_scan_design`` reports it: ``cluster`` blocks a
    (head, row group), each owning ``cols`` columns of all four gates (the
    cluster's last block what is left of dh); ``groups`` row groups of up
    to ``rows`` batch rows, computed as ``slots`` rows; ``warps`` (8
    columns each) and ``threads`` a block, ``smem_bytes`` of dynamic
    shared memory a block (the weights in 16-byte chunks of one column,
    then two h buffers and their two mbarriers), ``blocks`` and the
    ``grid`` (cluster, heads, groups). The cluster is the largest of 1, 2,
    4, 8 that leaves a block ``MIN_COLS`` columns, raised where the
    weights would not fit. Raises for what the kernel does not take."""
    if w_dtype not in _W_DTYPES:
        raise TypeError(f"r and b must share float32 or bfloat16, got "
                        f"{w_dtype}")
    if dh % 2 or not MIN_DH <= dh <= MAX_DH:
        raise ValueError(f"the sLSTM kernel takes an even head dim from "
                         f"{MIN_DH} to {MAX_DH}, got {dh}")
    if batch < 1 or not 1 <= heads <= 65535:
        raise ValueError(f"want a batch of at least 1 and 1 to 65535 heads, "
                         f"got {batch}, {heads}")
    groups, rows, slots = _row_groups(batch)
    w_size = torch.finfo(w_dtype).bits // 8
    chunks = -(-dh * w_size // CHUNK_BYTES)
    cluster = 1
    while cluster < MAX_CLUSTER and dh >= 2 * cluster * MIN_COLS:
        cluster *= 2
    while True:
        cols = -(-dh // cluster)
        warps = -(-cols // 8)
        smem = warps * chunks * 32 * CHUNK_BYTES + 2 * dh * slots * 4 + 16
        if smem <= SMEM_BYTES and warps <= MAX_WARPS:
            break
        if cluster >= MAX_CLUSTER:
            raise ValueError(f"no cluster of at most {MAX_CLUSTER} holds "
                             f"head dim {dh} in {w_dtype}")
        cluster *= 2
    return dict(cluster=cluster, cols=cols, rows=rows, slots=slots,
                groups=groups, warps=warps, threads=32 * warps,
                smem_bytes=smem, blocks=cluster * heads * groups,
                grid=(cluster, heads, groups))


# what slstm_scan_design reports, in its order
LIBRARY_DESIGN_FIELDS = ("cluster", "cols", "rows", "slots", "groups",
                         "warps", "threads", "smem_bytes", "blocks",
                         "max_active_clusters")


def library_design(batch: int, heads: int, dh: int,
                   w_dtype: torch.dtype) -> dict:
    """The design the library launches at this shape
    (``LIBRARY_DESIGN_FIELDS``: ``design``'s fields, and the clusters of it
    the current card holds at once, ``cudaOccupancyMaxActiveClusters``;
    builds the library, needs a card)."""
    out = (ctypes.c_int * len(LIBRARY_DESIGN_FIELDS))()
    n = cuda_lib.load_slstm().slstm_scan_design(
        batch, heads, dh, _W_DTYPES.get(w_dtype, -1), out)
    if n != len(LIBRARY_DESIGN_FIELDS):
        raise ValueError(f"no sLSTM kernel for batch {batch}, heads {heads}"
                         f", head dim {dh}, {w_dtype} (code {n})")
    return dict(zip(LIBRARY_DESIGN_FIELDS, out))


def kernel_symbol(w_dtype: torch.dtype, batch: int) -> str:
    """The kernel instance a call with weights of ``w_dtype`` at ``batch``
    rows launches, as the profiler names it."""
    return (f"slstm_cluster_kernel<{_CTYPES[w_dtype]}, "
            f"{_row_groups(batch)[2]}>")


@cuda_lib.kernel_wrapper
def slstm_scan(xs: Sequence[torch.Tensor], rs: Sequence[torch.Tensor],
               bs: Sequence[torch.Tensor], carry: Optional[Carry] = None, *,
               sm_ids: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Carry]:
    """(hs (B, S, H, dh) float32, the last carry (c, n, h, m)): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. A given
    carry (contiguous) is advanced in place and returned; without one the
    recurrence starts from zeros and the last carry is new. ``sm_ids``, an
    int32 CUDA tensor of ``design(...)["blocks"]`` elements, receives the
    SM each block ran on (block (rank, head, group) at rank + C (head + H
    group))."""
    _check(xs, rs, bs, carry)
    state = () if carry is None else tuple(carry)
    if any(not t.is_contiguous() for t in state):
        raise ValueError("the carry is written in place: it must be "
                         "contiguous")
    if on_cpu(*xs, *rs, *bs, *state):
        if sm_ids is not None:
            raise ValueError("sm_ids is the card's: CPU tensors run the "
                             "plain version")
        hs, last = slstm_scan_plain(xs, rs, bs, carry)
        for dst, src in zip(state, last):
            dst.copy_(src)
        return hs, state or last
    b, s, h, dh = xs[0].shape
    if sm_ids is not None and (
            sm_ids.dtype != torch.int32 or not sm_ids.is_contiguous()
            or sm_ids.device != xs[0].device
            or sm_ids.numel() != design(b, h, dh, rs[0].dtype)["blocks"]):
        raise ValueError("want sm_ids an int32 tensor of one element a "
                         "block on the operands' card")
    xs = [x.contiguous() for x in xs]
    rs = [r.contiguous() for r in rs]
    bs = [bb.contiguous() for bb in bs]
    # no carry: the kernel starts from zeros (null carry_in, no fill)
    dst = state or tuple(xs[0].new_empty((b, h, dh)) for _ in range(4))
    hs = torch.empty_like(xs[0])
    args = cuda_lib.SlstmArgs()
    for j in range(4):
        args.x[j], args.r[j], args.b[j] = (xs[j].data_ptr(),
                                           rs[j].data_ptr(),
                                           bs[j].data_ptr())
        args.carry_in[j] = state[j].data_ptr() if state else None
        args.carry_out[j] = dst[j].data_ptr()
    args.hs = hs.data_ptr()
    args.batch, args.seq, args.heads, args.dh = b, s, h, dh
    args.sm_ids = None if sm_ids is None else sm_ids.data_ptr()
    check_launch(cuda_lib.load_slstm().slstm_scan(
        ctypes.byref(args), _W_DTYPES[rs[0].dtype], stream_of(hs.device)),
        "slstm_scan")
    slstm_scan.launches += 1
    return hs, dst


cuda_lib.register(slstm_scan)


def _slstm_dots(xs, rs, bs, carry=None, sm_ids=None):
    """The four recurrent products of each step and head, for the op
    census: h (B, dh) x r_g (dh, dh), S x H times a gate, in float32."""
    b, s, h, dh = xs[0].shape
    return tuple(cuda_lib.Dot((s, h, b, dh), (dh, dh), "float32", "float32")
                 for _ in range(4))


cuda_lib.declare_dots({slstm_scan: _slstm_dots})
