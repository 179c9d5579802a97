"""Flash attention: the hand-written Hopper kernels beside their plain version.

Port of ``repro.kernels.flash_attention.flash_attention_pallas`` (``_kernel``,
``pallas_call`` at flash_attention.py:92) as ``csrc/flash_attention.cu``:
online-softmax attention with float32 scores and accumulator, the scale
applied to the float32 scores, ``NEG_INF`` masking with the reference's
``m_safe`` / ``alpha`` guards, p rounded to v's type for the P.V product (the
row sum takes the float32 p), and the output ``acc / max(l, 1e-30)`` in q's
type. With ``causal`` the kernel never visits a kv tile that lies wholly in
the future of its q tile, and with a sliding ``window`` (key j visible to
query i only where i - j < window, ``repro.models.blocks.flash_attention``'s
local attention) none that lies wholly behind its window.

The reference wrapper (``repro.kernels.ops.flash_attention``) repeats the kv
heads and pads D to 128 lanes: both are TPU layout choices. Here the kernel
reads q (B, Sq, H, D), k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv) in place
through their strides and indexes kv head ``h // (H / Hkv)`` itself; any
length works (a ragged tail is masked). Sq and Sk may differ in a
non-causal call without a window (whisper-base's cross-attention over its
1500 encoder frames, which ``repro.models.blocks.flash_attention``
computes and the Pallas kernel, at one S, does not): the q tiles count Sq,
the kv tiles, the key mask and K's and V's loads Sk; a causal or windowed
call at unequal lengths has no caller in either package and raises. The
scale is D^-0.5 over q's width, as the reference's
``blocks.flash_attention`` takes it. One kernel serves each
(dtype, D, Dv, window or not), with no switch:
- bfloat16, D == Dv at 16, 32, 64, 80, 112, 128, 256, and (D 192, Dv 128),
  deepseek-v2's MLA pair: ``flash_wgmma_kernel<D, W>`` (TMA, an mbarrier
  ring, wgmma; 128-row q tiles and 128-row kv tiles, 80-row at D 256,
  where the work items come longest first from a counter; a tile row is
  ceil(D / 64) boxes of 64 columns whose tensor map ends at column D, so
  D 80's and 112's second box and D 16's and 32's only one read zeros
  past the head, never the next head of a packed projection; D / 16
  k-steps of the first product, an N = Dv second product; D 192 is built
  only with Dv 128, its K and V tiles of their own widths in 2 stages; at
  D 112 a consumer chains its work items, issuing the next item's first
  scores with this item's last product; ``design`` reports each
  instance's layout). A
  tensor map the CUDA driver refuses raises through ``check_launch``:
  there is no fallback to another kernel;
- float32, D == Dv at 16, 32, 64, 80, 128: ``flash_ffma_kernel<D, W>``
  (IEEE FFMA, never TF32; 8 warps each own 16 of a block's 128 q rows, K
  and V come by cp.async under the other product in tiles of 64 kv rows).
  Float32 at D 112 or 256 and any other (D, Dv) pair have no kernel (no
  served config needs them) and raise.
W is ``true`` for a call whose window hides some key and ``false``
otherwise (no window, or one of Sk keys or more, which computes the same
function): the window is a template flag, so the instances without it keep
the code they had before it. ``kernel_symbol`` asks the library which one
a call launches.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; any other device raises, and
there is no fallback: a CUDA tensor launches the kernel or raises. Its
launches are counted in ``flash_attention.launches`` (and in
``cuda_lib.launch_counts()``, which covers every kernel of the port).

``flash_attention_bwd`` is the gradient on the card (dq, dk, dv from q,
k, v and the output's upstream gradient), a kernel of its own
library (``csrc/flash_attention_bwd.cu``) that replaces no TPU kernel: the
Pallas kernel has no backward, and the reference trains through XLA's
autodiff of its chunked scan. Its plain version
``flash_attention_bwd_plain`` is autograd through
``flash_attention_plain``. ``flash_attention_trainable`` is the
``torch.autograd.Function`` whose forward is ``flash_attention`` and whose
backward is ``flash_attention_bwd``, for the instances ``BWD_HEAD_DIMS``
(causal or not, Sq == Sk, no window, D == Dv); ``check_backward`` raises
``NotImplementedError`` for any other call.

``flash_attention_plain`` is the port's counterpart of
``repro.kernels.ref.flash_attention_ref`` computed with the kernel's own
arithmetic (online softmax over kv tiles, p rounded to v's type). It also
computes what ``repro.models.blocks.flash_attention`` computes on the CPU:
a sliding ``window``, a ``q_offset`` and unequal q / kv lengths or head
dims.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.cuda_lib import check_launch, on_cpu, stream_of

NEG_INF = -1e30
BLOCK_KV = 64                     # the plain version's kv chunk
# the (head dim, value dim) pairs the kernels are built for, by dtype: q
# and k of width D, v and the output of width Dv; Dv == D but for
# deepseek-v2's MLA (128 nope + 64 rope columns of q and k over a 128-wide
# v); D 112 is kimi-k2's head
HEAD_DIM_PAIRS = {
    torch.bfloat16: ((16, 16), (32, 32), (64, 64), (80, 80), (112, 112),
                     (128, 128), (192, 128), (256, 256)),
    torch.float32: ((16, 16), (32, 32), (64, 64), (80, 80), (128, 128))}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims the backward kernel is built for, by dtype: stablelm-3b's
# 80 and granite-8b's 128 in bf16, the reduced configs' 16 in float32
BWD_HEAD_DIMS = {torch.bfloat16: (80, 128), torch.float32: (16,)}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0,
                          kv_chunk: int = BLOCK_KV) -> torch.Tensor:
    """Online-softmax attention in PyTorch ops, one kv chunk at a time.

    q (B, Sq, H, D); k (B, Sk, Hkv, D); v (B, Sk, Hkv, Dv); H % Hkv == 0.
    Query row i sits at position ``q_offset + i``; ``window > 0`` also masks
    keys ``window`` or more positions behind it. Returns (B, Sq, H, Dv) in
    q's dtype."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5
    f32 = torch.float32
    qg = q.reshape(b, sq, hkv, g, d).to(f32)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dv), dtype=f32, device=q.device)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((b, sq, hkv, g), dtype=f32, device=q.device)
    for k0 in range(0, sk, kv_chunk):
        kj = k[:, k0:k0 + kv_chunk].to(f32)                 # (B, C, Hkv, D)
        vj = v[:, k0:k0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kj) * scale
        k_pos = k0 + torch.arange(kj.shape[1], device=q.device)
        mask = torch.ones((sq, kj.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f32), vj.to(f32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"want q (B, Sq, H, D), k (B, Sk, Hkv, D) and v "
                         f"(B, Sk, Hkv, Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")


def _check_card_operands(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, window: int = 0,
                         causal: bool = False) -> None:
    if q.shape[1] != k.shape[1] and (causal or window):
        raise ValueError(f"q length {q.shape[1]} != kv length {k.shape[1]}: "
                         f"the kernel takes unequal lengths only without "
                         f"causal and window (got causal={causal}, "
                         f"window={window})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    pairs = HEAD_DIM_PAIRS[q.dtype]
    if (q.shape[3], v.shape[3]) not in pairs:
        raise ValueError(f"head dim {q.shape[3]} with value dim {v.shape[3]}"
                         f": no {q.dtype} flash kernel is built for it (the "
                         f"(D, Dv) pairs built: {pairs})")
    if not 0 <= window < 2 ** 31:
        raise ValueError(f"window {window} is not 0 (none) or a length")
    vec = 16 // q.element_size()      # elements in one 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(t.stride(i) % vec for i in range(3)) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be unit-stride and 16-byte "
                             f"aligned (strides {t.stride()})")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("batch * heads exceeds the kernel's grid (65535)")


@cuda_lib.kernel_wrapper
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k (B, Sk, Hkv, D) and v (B, Sk,
    Hkv, Dv), H % Hkv == 0, scaled by D^-0.5; ``window > 0`` also hides
    keys ``window`` or more positions behind a query. Returns (B, Sq, H,
    Dv) in q's dtype: the CUDA kernel for CUDA tensors (which takes Sq !=
    Sk only without causal and window, and raises otherwise), the plain
    version for CPU tensors."""
    _check_shapes(q, k, v)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check_card_operands(q, k, v, window, causal)
    b, s, h, d = q.shape
    dv = v.shape[3]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    geom = cuda_lib.FlashGeom(
        b, s, h, k.shape[2], int(causal), d ** -0.5,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], window, k.shape[1])
    lib = cuda_lib.load_flash()
    check_launch(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], d, dv, ctypes.byref(geom),
        stream_of(q.device)),
        "flash_attention")
    flash_attention.launches += 1
    return out


def check_backward(dtype: torch.dtype, head_dim: int, v_dim: int = 0, *,
                   window: int = 0, q_len: int = 0, kv_len: int = 0) -> None:
    """Raise NotImplementedError for an attention call on the card whose
    gradient ``flash_attention_bwd`` does not compute: a window, unequal q
    and kv lengths, a value dim other than the head dim (MLA's (192,
    128)), or a (dtype, head dim) outside ``BWD_HEAD_DIMS``."""
    dims = BWD_HEAD_DIMS.get(dtype, ())
    why = None
    if window:
        why = f"a sliding window ({window})"
    elif q_len != kv_len:
        why = f"q length {q_len} != kv length {kv_len} (cross-attention)"
    elif v_dim and v_dim != head_dim:
        why = f"head dim {head_dim} over value dim {v_dim} (MLA)"
    elif head_dim not in dims:
        why = f"{dtype} at head dim {head_dim} (built: {BWD_HEAD_DIMS})"
    if why:
        raise NotImplementedError(
            f"flash_attention_bwd: no backward kernel for {why}; it is "
            f"ROADMAP item 16")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True):
    """(dq, dk, dv) of ``flash_attention_plain(q, k, v, causal=causal)``
    against the upstream gradient ``dout``: autograd through the plain
    version taken in float32 whatever the inputs' dtype, then cast to it
    (a window and a q offset, which the kernel does not take, are not
    arguments). In bf16, autograd through the plain version's cast of p
    would round dp to bf16 as well, which swamps the small gradient of a
    query that sees few keys (the first rows of a causal call: 0.34 of
    such a dq row's RMS at S 130, D 128, against the float64 gradient;
    the kernel's arithmetic 0.013)."""
    with torch.enable_grad():
        live = [t.detach().to(torch.float32).requires_grad_(True)
                for t in (q, k, v)]
        out = flash_attention_plain(*live, causal=causal)
        grads = torch.autograd.grad(out, live, dout.to(torch.float32))
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


@cuda_lib.kernel_wrapper
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=causal)`` against
    its output's upstream gradient ``dout``: q, dout (B, S, H, D), k, v
    (B, S, Hkv, D), no window. The CUDA kernels (the dq pass with the row
    statistics, then the dk / dv pass) for CUDA tensors at
    ``BWD_HEAD_DIMS`` (else NotImplementedError), the plain version for
    CPU tensors."""
    _check_shapes(q, k, v)
    if on_cpu(q, k, v, dout):
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal)
    check_backward(q.dtype, q.shape[3], v.shape[3], q_len=q.shape[1],
                   kv_len=k.shape[1])
    if any(t.dtype != q.dtype for t in (k, v, dout)) \
            or dout.shape != q.shape:
        raise ValueError(f"dout must be q's shape {tuple(q.shape)} and "
                         f"every operand its dtype {q.dtype}")
    b, s, h, d = q.shape
    # contiguous rows on 16-byte boundaries (the bf16 kernels copy 16 bytes
    # at a time)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    q, k, v, dout = (t.clone() if t.data_ptr() % 16 else t
                     for t in (q, k, v, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    geom = cuda_lib.FlashBwdGeom(b, s, h, k.shape[2], int(causal), d ** -0.5)
    lib = cuda_lib.load_flash_bwd()
    check_launch(lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _DTYPE_CODES[q.dtype], d,
        ctypes.byref(geom), stream_of(q.device)), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def backward_symbols(dtype: torch.dtype, head_dim: int) -> tuple:
    """The two kernels ``flash_attention_bwd`` launches for CUDA operands
    of this dtype and head dim, as the profiler names them: the dq pass
    and the dk / dv pass (builds the library)."""
    lib = cuda_lib.load_flash_bwd()
    names = [lib.flash_attention_bwd_kernel(_DTYPE_CODES.get(dtype, -1),
                                            head_dim, which)
             for which in (0, 1)]
    if None in names:
        raise ValueError(f"no flash backward kernel for {dtype}, head dim "
                         f"{head_dim}")
    return tuple(n.decode() for n in names)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. The
    inputs are saved through ``ctx.save_for_backward`` (the output is not:
    the backward recomputes its row statistics), so under
    ``torch.utils.checkpoint`` they are the recomputed forward's."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """``flash_attention`` with a gradient: the forward kernel, and
    ``flash_attention_bwd`` in the backward. Raises NotImplementedError
    (``check_backward``) for a call the backward kernel does not take,
    before any launch."""
    check_backward(q.dtype, q.shape[3], v.shape[3], window=window,
                   q_len=q.shape[1], kv_len=k.shape[1])
    return _FlashAttention.apply(q, k, v, causal)


def kernel_symbol(dtype: torch.dtype, head_dim: int, window: int = 0,
                  seq: int = 2 ** 31 - 1, v_dim: int = 0) -> str:
    """The kernel instance ``flash_attention`` launches for CUDA operands
    of this dtype, head dim and value dim (0: the head dim), with or
    without a window, at kv length ``seq`` (a window of ``seq`` keys or
    more hides none, and the instance without it runs), as the library
    dispatches and the profiler names it, e.g. ``flash_wgmma_kernel<256,
    true>``, or ``flash_wgmma_kernel<192, false>`` for MLA's (192, 128)
    (builds the library)."""
    dv = v_dim or head_dim
    name = cuda_lib.load_flash().flash_attention_kernel(
        _DTYPE_CODES.get(dtype, -1), head_dim, dv, window, seq)
    if name is None:
        raise ValueError(f"no flash kernel for {dtype}, head dim {head_dim}"
                         f", value dim {dv}")
    return name.decode()


# what flash_attention_design reports of a kernel instance, in its order
DESIGN_FIELDS = ("q_rows", "kv_rows", "stages", "ping_pong", "dynamic",
                 "chained")


def design(dtype: torch.dtype, head_dim: int, v_dim: int = 0) -> dict:
    """The design of the kernel ``flash_attention`` launches for CUDA
    operands of this dtype, head dim and value dim (0: the head dim), as
    the library reports it (``DESIGN_FIELDS``): q and kv rows a tile, K/V
    stages, whether the consumers take turns, whether the work items come
    from a counter, whether a consumer chains its items (the next item's
    first scores issued with this one's last product; builds the
    library)."""
    dv = v_dim or head_dim
    out = (ctypes.c_int * len(DESIGN_FIELDS))()
    n = cuda_lib.load_flash().flash_attention_design(
        _DTYPE_CODES.get(dtype, -1), head_dim, dv, out)
    if n != len(DESIGN_FIELDS):
        raise ValueError(f"no flash kernel for {dtype}, head dim {head_dim}"
                         f", value dim {dv}")
    return dict(zip(DESIGN_FIELDS, out))


cuda_lib.register(flash_attention, flash_attention_bwd)


def _attention_dots(q, k, v, *, causal: bool = True, window: int = 0):
    """The two products of each (batch, head), for the op census: scores
    Q K^T (Sq, D) x (D, Sk) and the output P V (Sq, Sk) x (Sk, Dv), at
    their full shapes (a causal kernel skips the key tiles above the
    diagonal, a windowed one those behind the window too)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dtype = str(q.dtype).removeprefix("torch.")
    return (cuda_lib.Dot((b, h, sq, d), (d, sk), dtype, "float32"),
            cuda_lib.Dot((b, h, sq, sk), (sk, v.shape[3]), dtype, "float32"))


def _attention_bwd_dots(q, k, v, dout, *, causal: bool = True):
    """The five products of the gradient of each (batch, head), at their
    full shapes: S = Q K^T and dP = dO V^T (Sq, D) x (D, Sk), dV = P^T dO
    and dK = dS^T Q (Sk, Sq) x (Sq, D), dQ = dS K (Sq, Sk) x (Sk, D) (the
    kernel computes S and dP twice more: for the row statistics and in
    the dq pass)."""
    b, s, h, d = q.shape
    dtype = str(q.dtype).removeprefix("torch.")
    score = cuda_lib.Dot((b, h, s, d), (d, s), dtype, "float32")
    grad = cuda_lib.Dot((b, h, s, s), (s, d), dtype, "float32")
    return (score, score, grad, grad, grad)


cuda_lib.declare_dots({flash_attention: _attention_dots,
                       flash_attention_bwd: _attention_bwd_dots})
