"""The P2M in-pixel layer's CUDA kernels, each beside its plain version.

Port of every P2M kernel of ``repro.kernels.p2m_conv`` (csrc/p2m_kernels.cu):

  kernel A (``p2m_phase_a_implicit``) — implicit im2col + the packed
      two-phase MAC: u = g(x·w⁺) - g(x·w⁻) and per-tile Hoyer partials
      (sum |z_clip|, sum z_clip²) with z = u / v_th.
  int8 kernel A (``p2m_phase_a_implicit_q8``) — the same with the patch
      values quantized to the 1/128 grid as they enter shared memory, an
      exact int32 MAC against the int8 packed weights (an s8 tensor-core
      product) and one dequant multiply per column before the curve.
  explicit kernel A (``p2m_phase_a``) — kernel A over the rows of a
      materialised (N, K) patch matrix (the reference's regression surface).
  host-free combine (``combine_hoyer_partials``) — theta from the partials,
      by a deterministic ``torch.sum`` on the device.
  kernel B (``p2m_phase_b``) — u -> voltage -> switching probability ->
      folded majority -> Bernoulli draw, with the draw words hashed
      in-kernel from the key, plus per-tile (sum, min, max) of V_CONV.
      Its chip operand is the (4, C) per-channel rows or the (4, N_pix, C)
      per-pixel map, as is the fused kernels'.
  fused streaming kernel (``p2m_fused_stream``) and its int8 twin
      (``p2m_fused_stream_q8``, int8 kernel A's MAC) — A and B
      in one pass at a carried theta, plus fresh Hoyer partials, V partials
      and per-tile per-channel draw counts.
  legacy fused kernel (``p2m_conv``) — explicit patch rows through the
      device chain at a GIVEN theta (the pre-split baseline); its warps own
      whole row tiles where the library's ``p2m_conv_warp_tiles(n)`` says
      so, its blocks share each tile below that.

Each wrapper runs its CUDA kernel for a CUDA tensor and its plain PyTorch
version (``*_plain``) for a CPU tensor; any other device raises. There is no
fallback: a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in ``<wrapper>.launches`` (``cuda_lib.launch_counts()`` reads
them with every other kernel's of the port). The partials (one row per tile
of patch rows, their count from the library's ``p2m_partial_rows``; kernel
B's one per warp tile of u rows, from ``p2m_phase_b_partial_rows``) are a
layout choice of the kernels; the contract is what
the ``combine_*`` functions return. The int8 fused kernel keeps the f32 fused kernel's three partial
outputs (the reference packs them into one 128-lane stats row per block, a
TPU layout choice), so ``combine_hoyer_partials`` /
``combine_v_conv_partials`` and the rate-row sum serve both precisions and
``combine_q8_stream_stats`` has no counterpart here.

The ``*_fleet`` wrappers run kernels A (f32, int8), B and fused (f32, int8)
for G chips in one launch, the chip axis a grid dimension of the kernel
(frames (G, B, H, W, Cin), theta (G,), chan (G, 4, C), a draw key a chip);
chip g's rows of each output are the single-chip call's on its operands bit
for bit, and each plain version (``*_fleet_plain``) is the single-chip plain
version a chip at a time. ``combine_fleet_*`` give each chip's statistics.

The plain versions are the port's counterparts of ``repro.kernels.ref``'s
P2M oracles: the same function in plain tensor ops. Their int8 MAC
accumulates in int32, as the kernels' does.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mtj as mtj_model
from repro_torch.core import p2m as p2m_core
from repro_torch.core import pixel as pixel_model
from repro_torch.devices import to_device_async
from repro_torch.kernels import blocking, cuda_lib
from repro_torch.kernels.cuda_lib import check_launch as _launch
from repro_torch.kernels.cuda_lib import on_cpu as _on_cpu
from repro_torch.kernels.cuda_lib import stream_of as _stream
from repro_torch.variation.chip import (CHAN_LOGIT_GAIN, CHAN_LOGIT_OFFSET,
                                        CHAN_ROWS, CHAN_U_GAIN, CHAN_U_OFFSET,
                                        identity_operands)

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# draw words (the kernels hash them in-register; this is the plain version)
# ---------------------------------------------------------------------------

def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64: every
    product is masked back to 32 bits (a wrapped int64 product keeps its
    low 32 bits right)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def draw_bits(key, n: int, c: int, device=None) -> torch.Tensor:
    """The (n, c) uint16 draw words of ``key`` (held as int32): two
    murmur3 rounds over ``(index + 0x9E3779B9) ^ key`` — bit-exact with
    ``repro.kernels.ops.draw_bits`` and with the kernels' in-register hash."""
    k0, k1 = (int(w) for w in prng.key_data(key))
    idx = (torch.arange(n * c, dtype=torch.int64, device=device)
           + 0x9E3779B9) & _M32
    h = _fmix32(idx ^ k0)
    h = _fmix32(h ^ k1)
    return (h & 0xFFFF).to(torch.int32).reshape(n, c)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU tensors, and the reference on the card)
# ---------------------------------------------------------------------------

def pack_phase_weights(wm: torch.Tensor) -> torch.Tensor:
    """(K, C) signed weights -> the (K, 2C) packed two-phase operand."""
    return p2m_core.relu_split_pack(wm)


def _gather_patches(images: torch.Tensor, kernel: int, stride: int
                    ) -> torch.Tensor:
    """SAME im2col: (B, H, W, Cin) -> (B*H'*W', k*k*Cin) rows, tap-major and
    channel-minor, so an HWIO weight reshapes straight onto the columns."""
    b, h, w, cin = images.shape
    ho, wo = blocking.conv_out_hw(h, stride), blocking.conv_out_hw(w, stride)
    x = blocking.pad_same(images, kernel, stride)
    rows, cols = (ho - 1) * stride + 1, (wo - 1) * stride + 1
    taps = [x[:, di:di + rows:stride, dj:dj + cols:stride, :]
            for di in range(kernel) for dj in range(kernel)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kernel * kernel * cin)


def _subtract(a: torch.Tensor, c_out: int,
              pixel_params: pixel_model.PixelCircuitParams) -> torch.Tensor:
    """Packed MAC (N, 2C) -> u: the per-phase curve, then the difference."""
    g = pixel_model.get_curve(pixel_params.curve, pixel_params)
    return g(a[:, :c_out]) - g(a[:, c_out:])


def _phase_a_epilogue(a: torch.Tensor, v_th: torch.Tensor, c_out: int,
                      pixel_params: pixel_model.PixelCircuitParams):
    """Packed MAC (N, 2C) -> (u, (1, 2) Hoyer partials)."""
    u = _subtract(a, c_out, pixel_params)
    zc = torch.clamp(u / torch.clamp(v_th.reshape(()), min=1e-6), 0.0, 1.0)
    partials = torch.stack([torch.sum(torch.abs(zc)),
                            torch.sum(torch.square(zc))]).reshape(1, 2)
    return u, partials


def p2m_phase_a_implicit_plain(images, w_packed, v_th, *, kernel: int,
                               stride: int,
                               pixel_params=pixel_model.DEFAULT_PIXEL):
    """Kernel A's function in PyTorch ops: ``(u (N, C), partials (1, 2))``."""
    a = _gather_patches(images, kernel, stride) @ w_packed
    return _phase_a_epilogue(a, v_th, w_packed.shape[1] // 2, pixel_params)


def _q8_mac(x: torch.Tensor, wq_packed: torch.Tensor,
            dequant_row: torch.Tensor) -> torch.Tensor:
    """The int8 packed MAC: quantize the rows, an exact int32 sum over the
    K taps (as the kernels' MAC sums; PyTorch has no integer matmul on the
    card), then the per-column dequant. The sums stay below 2^24, so the
    float32 they convert to is exact."""
    xq = p2m_core.quantize_acts_q8(x).to(torch.int32)
    wq = wq_packed.to(torch.int32)
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.int32,
                      device=x.device)
    for k in range(wq.shape[0]):
        acc += xq[:, k:k + 1] * wq[k]
    return acc.to(torch.float32) * dequant_row.reshape(1, -1)


def p2m_phase_a_implicit_q8_plain(images, wq_packed, dequant_row, v_th, *,
                                  kernel: int, stride: int,
                                  pixel_params=pixel_model.DEFAULT_PIXEL):
    """int8 kernel A's function in PyTorch ops: ``(u (N, C), partials (1, 2))``."""
    a = _q8_mac(_gather_patches(images, kernel, stride), wq_packed,
                dequant_row)
    return _phase_a_epilogue(a, v_th, wq_packed.shape[1] // 2, pixel_params)


def p2m_phase_a_plain(patches, w_packed, v_th, *,
                      pixel_params=pixel_model.DEFAULT_PIXEL):
    """Explicit kernel A's function: ``(u (N, C), partials (1, 2))`` from an
    (N, K) patch matrix."""
    return _phase_a_epilogue(patches @ w_packed, v_th,
                             w_packed.shape[1] // 2, pixel_params)


def device_chain_q(u: torch.Tensor, theta: torch.Tensor,
                   chan: Optional[torch.Tensor],
                   pixel_params=pixel_model.DEFAULT_PIXEL,
                   mtj_params=mtj_model.DEFAULT_MTJ):
    """(u, theta, chip rows) -> ``(q, v)``: the folded-majority activation
    probability and the subtractor voltage, in the kernels' order. ``chan``
    is the (4, C) per-channel rows or the (4, N_pix, C) per-pixel operand:
    u's rows are frame-major and pixel-minor, so a reshape to
    (frames, N_pix, C) lines each row up with its pixel's operand and the
    same expressions broadcast (a per-pixel map constant across pixels
    gives the (4, C) path's values bit for bit)."""
    if chan is None:
        chan = identity_operands(u.shape[1], device=u.device)
    flat_shape = None
    if chan.ndim == 3:
        flat_shape = u.shape
        u = u.reshape(-1, chan.shape[1], chan.shape[2])
    u = u * chan[CHAN_U_GAIN] + chan[CHAN_U_OFFSET]
    v = pixel_model.conv_voltage(u, theta.reshape(()), pixel_params)
    p_sw = mtj_model.switching_probability(
        v, mtj_params.write_pulse_ps, mtj_params,
        logit_offset=chan[CHAN_LOGIT_OFFSET],
        logit_gain=chan[CHAN_LOGIT_GAIN])
    q = mtj_model.majority_prob_poly(p_sw, mtj_params.n_redundant,
                                     mtj_params.majority)
    if flat_shape is not None:
        q, v = q.reshape(flat_shape), v.reshape(flat_shape)
    return q, v


def _v_partials(v: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.sum(v), torch.min(v), torch.max(v)]).reshape(
        1, 3)


def p2m_phase_b_plain(u, theta, key, *, chan=None,
                      pixel_params=pixel_model.DEFAULT_PIXEL,
                      mtj_params=mtj_model.DEFAULT_MTJ):
    """Kernel B's function in PyTorch ops: ``(acts (N, C), partials (1, 3))``."""
    q, v = device_chain_q(u, theta, chan, pixel_params, mtj_params)
    bits = draw_bits(key, u.shape[0], u.shape[1], device=u.device)
    return mtj_model.bernoulli_from_bits(bits, q), _v_partials(v)


def _stream_from_u(u, hoyer_partials, theta, key, chan, pixel_params,
                   mtj_params):
    acts, v_partials = p2m_phase_b_plain(
        u, theta, key, chan=chan, pixel_params=pixel_params,
        mtj_params=mtj_params)
    return (acts, hoyer_partials, v_partials,
            torch.sum(acts, dim=0, keepdim=True))


def p2m_fused_stream_plain(images, w_packed, v_th, theta, key, chan=None, *,
                           kernel: int, stride: int,
                           pixel_params=pixel_model.DEFAULT_PIXEL,
                           mtj_params=mtj_model.DEFAULT_MTJ):
    """The fused kernel's function in PyTorch ops: ``(acts, hoyer (1, 2),
    v (1, 3), rates (1, C))``."""
    u, hoyer_partials = p2m_phase_a_implicit_plain(
        images, w_packed, v_th, kernel=kernel, stride=stride,
        pixel_params=pixel_params)
    return _stream_from_u(u, hoyer_partials, theta, key, chan, pixel_params,
                          mtj_params)


def p2m_fused_stream_q8_plain(images, wq_packed, dequant_row, v_th, theta,
                              key, chan=None, *, kernel: int, stride: int,
                              pixel_params=pixel_model.DEFAULT_PIXEL,
                              mtj_params=mtj_model.DEFAULT_MTJ):
    """The int8 fused kernel's function: the outputs of the f32 one."""
    u, hoyer_partials = p2m_phase_a_implicit_q8_plain(
        images, wq_packed, dequant_row, v_th, kernel=kernel, stride=stride,
        pixel_params=pixel_params)
    return _stream_from_u(u, hoyer_partials, theta, key, chan, pixel_params,
                          mtj_params)


def p2m_conv_plain(patches, w_packed, theta, key, *,
                   pixel_params=pixel_model.DEFAULT_PIXEL,
                   mtj_params=mtj_model.DEFAULT_MTJ):
    """The legacy fused kernel's function: (N, C) draws of the explicit
    patch rows at the given theta (identity channel rows)."""
    u = _subtract(patches @ w_packed, w_packed.shape[1] // 2, pixel_params)
    q, _ = device_chain_q(u, theta, None, pixel_params, mtj_params)
    bits = draw_bits(key, u.shape[0], u.shape[1], device=u.device)
    return mtj_model.bernoulli_from_bits(bits, q)


# ---------------------------------------------------------------------------
# combines: per-block partials -> the aux statistics
# ---------------------------------------------------------------------------

def combine_hoyer_partials(partials: torch.Tensor,
                           v_th: torch.Tensor) -> torch.Tensor:
    """theta = sum z_clip² / sum |z_clip| * v_th, on the partials' device."""
    abs_sum = torch.sum(partials[:, 0])
    sq_sum = torch.sum(partials[:, 1])
    return sq_sum / torch.clamp(abs_sum, min=1e-9) * v_th.reshape(())


def combine_v_conv_partials(partials: torch.Tensor, n_valid: int,
                            c_valid: int) -> dict:
    """Per-block (sum, min, max) -> the ``v_conv_*`` aux stats."""
    return {"v_conv_mean": torch.sum(partials[:, 0]) / (n_valid * c_valid),
            "v_conv_min": torch.min(partials[:, 1]),
            "v_conv_max": torch.max(partials[:, 2])}


def combine_fleet_hoyer_partials(partials: torch.Tensor,
                                 v_th: torch.Tensor) -> torch.Tensor:
    """(G, tiles, 2) partials -> each chip's theta (G,), a chip at a time
    by ``combine_hoyer_partials``: a sum over the tile axis of the (G,
    tiles) stack takes another order than one chip's (PyTorch sizes its
    reduction blocks by the output count), and kernel B's draws compare
    against theta, so it must be the single-chip call's bit for bit."""
    return torch.stack([combine_hoyer_partials(p, v_th) for p in partials])


def combine_fleet_v_conv_partials(partials: torch.Tensor, n_valid: int,
                                  c_valid: int) -> dict:
    """(G, tiles, 3) partials -> each chip's ``v_conv_*`` stats (G,); the
    mean's sum in the stack's order (within float32 rounding of the
    single-chip call's), min and max exactly."""
    return {"v_conv_mean": (torch.sum(partials[..., 0], dim=-1)
                            / (n_valid * c_valid)),
            "v_conv_min": torch.amin(partials[..., 1], dim=-1),
            "v_conv_max": torch.amax(partials[..., 2], dim=-1)}


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def physics_args(pixel_params: pixel_model.PixelCircuitParams,
                 mtj_params: mtj_model.MTJParams) -> cuda_lib.P2MPhysics:
    """The kernels' physics argument, built from the frozen dataclasses
    (ctypes rounds each value to float32, as JAX rounds a Python constant).
    The majority polynomial's binomial coefficients C(n, k), k <= n, are
    exact in float32 for n <= 24 (C(24, 12) < 2^24)."""
    n = mtj_params.n_redundant
    if not 0 < n <= 24:
        raise ValueError("the kernels' binomial coefficients are exact for "
                         f"n_redundant <= 24, got {n}")
    v0, v1, l0, l1, slope_lo, slope_hi = mtj_model.logit_fit(mtj_params)
    binom = (ctypes.c_float * 25)(*(math.comb(n, k) for k in range(n + 1)))
    return cuda_lib.P2MPhysics(
        curve=pixel_model.CURVE_IDS[pixel_params.curve],
        n_redundant=mtj_params.n_redundant, majority=mtj_params.majority,
        saturation=pixel_params.saturation, half_vdd=0.5 * pixel_params.vdd,
        v_sw=pixel_params.v_sw, volts_per_unit=pixel_params.volts_per_unit,
        v_max=pixel_model.v_conv_max(pixel_params), v0=v0, v1=v1, l0=l0, l1=l1,
        slope_lo=slope_lo, slope_hi=slope_hi,
        env_factor=mtj_model.envelope_factor(mtj_params.write_pulse_ps,
                                             mtj_params),
        binom=binom)


def _conv_geom(images: torch.Tensor, w_packed: torch.Tensor, kernel: int,
               stride: int) -> cuda_lib.ConvGeom:
    if kernel % 2 == 0:
        raise ValueError(
            f"implicit im2col only supports odd kernel sizes (got "
            f"kernel={kernel}): even kernels cannot reproduce SAME "
            "convolution placement")
    if images.ndim != 4:
        raise ValueError(f"images must be (B, H, W, Cin), got "
                         f"{tuple(images.shape)}")
    b, h, w, cin = images.shape
    kk = kernel * kernel * cin
    if w_packed.ndim != 2 or w_packed.shape[0] != kk or w_packed.shape[1] % 2:
        raise ValueError(f"w_packed must be ({kk}, 2C), got "
                         f"{tuple(w_packed.shape)}")
    (pt, _), (pl, _) = blocking.same_pads(h, w, kernel, stride)
    return cuda_lib.ConvGeom(
        batch=b, h=h, w=w, cin=cin, ho=blocking.conv_out_hw(h, stride),
        wo=blocking.conv_out_hw(w, stride), kernel=kernel, stride=stride,
        pad_top=pt, pad_left=pl, c_out=w_packed.shape[1] // 2)


def _check_f32(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_scalar(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got "
                             f"{tuple(t.shape)}")


@functools.lru_cache(maxsize=16)
def _identity_chan(c: int, device: torch.device) -> torch.Tensor:
    """The identity rows, made once per (C, device): the nominal chip's
    serving step then launches no kernels to build them."""
    return identity_operands(c, device=device)


def _check_chan(chan: Optional[torch.Tensor], n: int, c: int,
                device) -> torch.Tensor:
    """The chip rows of a call with n rows of u: None (the identity rows),
    the (4, C) per-channel rows or the (4, N_pix, C) per-pixel operand,
    whose pixel count must divide n (whole frames)."""
    if chan is None:
        return _identity_chan(c, device)
    if chan.ndim == 2 and tuple(chan.shape) == (CHAN_ROWS, c):
        return chan
    if chan.ndim == 3 and chan.shape[0] == CHAN_ROWS and chan.shape[2] == c:
        n_pix = chan.shape[1]
        if n_pix < 1 or n % n_pix:
            raise ValueError(f"per-pixel chan of {n_pix} pixels does not "
                             f"divide the {n} rows of u into whole frames")
        return chan
    raise ValueError(f"chan must be ({CHAN_ROWS}, {c}) or ({CHAN_ROWS}, "
                     f"N_pix, {c}), got {tuple(chan.shape)}")


def _chan_entry(lib, name: str, chan: torch.Tensor):
    """The C entry point for chan's layout and its chip arguments: ``name``
    with the (4, C) rows, ``name_pix`` with the per-pixel map and its
    pixel count."""
    if chan.ndim == 3:
        return getattr(lib, f"{name}_pix"), (chan.data_ptr(), chan.shape[1])
    return getattr(lib, name), (chan.data_ptr(),)


def _key_words(key):
    k0, k1 = prng.key_data(key)
    return ctypes.c_uint32(int(k0)), ctypes.c_uint32(int(k1))


def _phase_a_outputs(lib, n: int, c: int, device):
    """Kernel A's outputs: u (N, C) and one Hoyer partial row per row
    tile of the kernel."""
    tiles = lib.p2m_partial_rows(n)
    return (torch.empty((n, c), dtype=torch.float32, device=device),
            torch.empty((tiles, 2), dtype=torch.float32, device=device))


def _fused_outputs(lib, n: int, c: int, device):
    """The fused kernels' outputs: acts (N, C) and, per row tile, the Hoyer
    partials (2), the V partials (3) and the per-channel draw counts (C)."""
    tiles = lib.p2m_partial_rows(n)
    return tuple(torch.empty(shape, dtype=torch.float32, device=device)
                 for shape in ((n, c), (tiles, 2), (tiles, 3), (tiles, c)))


@cuda_lib.kernel_wrapper
def p2m_phase_a_implicit(images: torch.Tensor, w_packed: torch.Tensor,
                         v_th: torch.Tensor, *, kernel: int, stride: int,
                         pixel_params=pixel_model.DEFAULT_PIXEL):
    """Kernel A. images (B, H, W, Cin) unpadded float32 in [0, 1]; w_packed
    (k*k*Cin, 2C) from ``pack_phase_weights``; v_th one float32 value.
    Returns ``(u (B*H'*W', C), hoyer_partials (G, 2))``."""
    geom = _conv_geom(images, w_packed, kernel, stride)
    if _on_cpu(images, w_packed, v_th):
        return p2m_phase_a_implicit_plain(images, w_packed, v_th,
                                          kernel=kernel, stride=stride,
                                          pixel_params=pixel_params)
    _check_f32(images=images, w_packed=w_packed, v_th=v_th)
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    u, partials = _phase_a_outputs(lib, geom.batch * geom.ho * geom.wo,
                                   geom.c_out, images.device)
    _launch(lib.p2m_phase_a_implicit(
        images.data_ptr(), w_packed.data_ptr(), v_th.data_ptr(),
        u.data_ptr(), partials.data_ptr(), ctypes.byref(geom),
        ctypes.byref(physics_args(pixel_params, mtj_model.DEFAULT_MTJ)),
        _stream(images.device)), "p2m_phase_a_implicit")
    p2m_phase_a_implicit.launches += 1
    return u, partials


@cuda_lib.kernel_wrapper
def p2m_phase_b(u: torch.Tensor, theta: torch.Tensor, key, *,
                chan: Optional[torch.Tensor] = None,
                pixel_params=pixel_model.DEFAULT_PIXEL,
                mtj_params=mtj_model.DEFAULT_MTJ):
    """Kernel B. u (N, C) float32; theta one float32 value ON THE DEVICE
    (read by the kernel, so no host sync sits between A and B); key the
    host-side key whose two words seed the in-kernel draw hash; chan the
    optional (4, C) per-channel rows or (4, N_pix, C) per-pixel operand
    (row r of u reads pixel ``r % N_pix``). Returns ``(acts (N, C) {0,1},
    v_partials (G, 3))``."""
    if u.ndim != 2:
        raise ValueError(f"u must be (N, C), got {tuple(u.shape)}")
    n, c = u.shape
    chan = _check_chan(chan, n, c, u.device)
    if _on_cpu(u, theta, chan):
        return p2m_phase_b_plain(u, theta, key, chan=chan,
                                 pixel_params=pixel_params,
                                 mtj_params=mtj_params)
    _check_f32(u=u, theta=theta, chan=chan)
    _check_scalar(theta=theta)
    if n * c >= 2 ** 31:
        raise ValueError(f"{n * c} elements exceed the kernel's int32 index")
    lib = cuda_lib.load()
    acts = torch.empty((n, c), dtype=torch.float32, device=u.device)
    partials = torch.empty((lib.p2m_phase_b_partial_rows(n, c), 3),
                           dtype=torch.float32, device=u.device)
    k0, k1 = _key_words(key)
    entry, chan_args = _chan_entry(lib, "p2m_phase_b", chan)
    _launch(entry(
        u.data_ptr(), theta.data_ptr(), *chan_args, acts.data_ptr(),
        partials.data_ptr(), n * c, c, k0, k1,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(u.device)), "p2m_phase_b")
    p2m_phase_b.launches += 1
    return acts, partials


@cuda_lib.kernel_wrapper
def p2m_fused_stream(images: torch.Tensor, w_packed: torch.Tensor,
                     v_th: torch.Tensor, theta: torch.Tensor, key,
                     chan: Optional[torch.Tensor] = None, *, kernel: int,
                     stride: int, pixel_params=pixel_model.DEFAULT_PIXEL,
                     mtj_params=mtj_model.DEFAULT_MTJ):
    """The fused streaming kernel: A's gather and MAC, then B's chain on the
    in-register u at the CARRIED theta (one float32 value on the device).
    Returns ``(acts (N, C), hoyer_partials (G, 2), v_partials (G, 3),
    rate_partials (G, C))`` — the fresh Hoyer partials feed the caller's
    drift guard; the rate rows sum to the per-channel draw counts. With
    theta pinned to the exact path's theta the draws equal A -> B's. chan
    as kernel B's."""
    geom = _conv_geom(images, w_packed, kernel, stride)
    chan = _check_chan(chan, geom.batch * geom.ho * geom.wo, geom.c_out,
                       images.device)
    if _on_cpu(images, w_packed, v_th, theta, chan):
        return p2m_fused_stream_plain(
            images, w_packed, v_th, theta, key, chan, kernel=kernel,
            stride=stride, pixel_params=pixel_params, mtj_params=mtj_params)
    _check_f32(images=images, w_packed=w_packed, v_th=v_th, theta=theta,
               chan=chan)
    _check_scalar(v_th=v_th, theta=theta)
    lib = cuda_lib.load()
    dev = images.device
    acts, hoyer, vpart, rates = _fused_outputs(
        lib, geom.batch * geom.ho * geom.wo, geom.c_out, dev)
    k0, k1 = _key_words(key)
    entry, chan_args = _chan_entry(lib, "p2m_fused_stream", chan)
    _launch(entry(
        images.data_ptr(), w_packed.data_ptr(), v_th.data_ptr(),
        theta.data_ptr(), *chan_args, acts.data_ptr(), hoyer.data_ptr(),
        vpart.data_ptr(), rates.data_ptr(), ctypes.byref(geom), k0, k1,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(dev)), "p2m_fused_stream")
    p2m_fused_stream.launches += 1
    return acts, hoyer, vpart, rates


def _check_int8(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_dequant(dequant_row: torch.Tensor, c2: int) -> None:
    if dequant_row.numel() != c2:
        raise ValueError(f"dequant_row must hold {c2} values, got "
                         f"{tuple(dequant_row.shape)}")


def _rows_shape(patches: torch.Tensor, w_packed: torch.Tensor):
    """(N, K, C) of an explicit-patch call."""
    if patches.ndim != 2:
        raise ValueError(f"patches must be (N, K), got {tuple(patches.shape)}")
    n, kk = patches.shape
    if w_packed.ndim != 2 or w_packed.shape[0] != kk or w_packed.shape[1] % 2:
        raise ValueError(f"w_packed must be ({kk}, 2C), got "
                         f"{tuple(w_packed.shape)}")
    return n, kk, w_packed.shape[1] // 2


@cuda_lib.kernel_wrapper
def p2m_phase_a_implicit_q8(images: torch.Tensor, wq_packed: torch.Tensor,
                            dequant_row: torch.Tensor, v_th: torch.Tensor, *,
                            kernel: int, stride: int,
                            pixel_params=pixel_model.DEFAULT_PIXEL):
    """int8 kernel A. images as kernel A's; wq_packed (k*k*Cin, 2C) int8 and
    dequant_row (1, 2C) float32 from ``ops.quantize_frontend_weights``.
    Returns ``(u (B*H'*W', C), hoyer_partials (G, 2))``: kernel B consumes
    this u unchanged."""
    geom = _conv_geom(images, wq_packed, kernel, stride)
    _check_dequant(dequant_row, 2 * geom.c_out)
    if _on_cpu(images, wq_packed, dequant_row, v_th):
        return p2m_phase_a_implicit_q8_plain(
            images, wq_packed, dequant_row, v_th, kernel=kernel,
            stride=stride, pixel_params=pixel_params)
    _check_f32(images=images, dequant_row=dequant_row, v_th=v_th)
    _check_int8(wq_packed=wq_packed)
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    u, partials = _phase_a_outputs(lib, geom.batch * geom.ho * geom.wo,
                                   geom.c_out, images.device)
    _launch(lib.p2m_phase_a_implicit_q8(
        images.data_ptr(), wq_packed.data_ptr(), dequant_row.data_ptr(),
        v_th.data_ptr(), u.data_ptr(), partials.data_ptr(),
        ctypes.byref(geom),
        ctypes.byref(physics_args(pixel_params, mtj_model.DEFAULT_MTJ)),
        _stream(images.device)), "p2m_phase_a_implicit_q8")
    p2m_phase_a_implicit_q8.launches += 1
    return u, partials


@cuda_lib.kernel_wrapper
def p2m_fused_stream_q8(images: torch.Tensor, wq_packed: torch.Tensor,
                        dequant_row: torch.Tensor, v_th: torch.Tensor,
                        theta: torch.Tensor, key,
                        chan: Optional[torch.Tensor] = None, *, kernel: int,
                        stride: int, pixel_params=pixel_model.DEFAULT_PIXEL,
                        mtj_params=mtj_model.DEFAULT_MTJ):
    """The int8 fused streaming kernel: int8 kernel A's MAC, then B's chain
    at the CARRIED theta. Same outputs as ``p2m_fused_stream``; with theta
    pinned to the exact int8 path's theta the draws equal int8 A -> B's.
    chan as kernel B's."""
    geom = _conv_geom(images, wq_packed, kernel, stride)
    _check_dequant(dequant_row, 2 * geom.c_out)
    chan = _check_chan(chan, geom.batch * geom.ho * geom.wo, geom.c_out,
                       images.device)
    if _on_cpu(images, wq_packed, dequant_row, v_th, theta, chan):
        return p2m_fused_stream_q8_plain(
            images, wq_packed, dequant_row, v_th, theta, key, chan,
            kernel=kernel, stride=stride, pixel_params=pixel_params,
            mtj_params=mtj_params)
    _check_f32(images=images, dequant_row=dequant_row, v_th=v_th,
               theta=theta, chan=chan)
    _check_int8(wq_packed=wq_packed)
    _check_scalar(v_th=v_th, theta=theta)
    lib = cuda_lib.load()
    dev = images.device
    acts, hoyer, vpart, rates = _fused_outputs(
        lib, geom.batch * geom.ho * geom.wo, geom.c_out, dev)
    k0, k1 = _key_words(key)
    entry, chan_args = _chan_entry(lib, "p2m_fused_stream_q8", chan)
    _launch(entry(
        images.data_ptr(), wq_packed.data_ptr(), dequant_row.data_ptr(),
        v_th.data_ptr(), theta.data_ptr(), *chan_args, acts.data_ptr(),
        hoyer.data_ptr(), vpart.data_ptr(), rates.data_ptr(),
        ctypes.byref(geom), k0, k1,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(dev)), "p2m_fused_stream_q8")
    p2m_fused_stream_q8.launches += 1
    return acts, hoyer, vpart, rates


@cuda_lib.kernel_wrapper
def p2m_phase_a(patches: torch.Tensor, w_packed: torch.Tensor,
                v_th: torch.Tensor, *,
                pixel_params=pixel_model.DEFAULT_PIXEL):
    """Explicit-patch kernel A: patches (N, K) float32 (``ops.im2col``),
    w_packed (K, 2C). Returns ``(u (N, C), hoyer_partials (G, 2))``, equal
    to kernel A's on the same rows (same MAC loop, same row blocks)."""
    n, kk, c = _rows_shape(patches, w_packed)
    if _on_cpu(patches, w_packed, v_th):
        return p2m_phase_a_plain(patches, w_packed, v_th,
                                 pixel_params=pixel_params)
    _check_f32(patches=patches, w_packed=w_packed, v_th=v_th)
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    u, partials = _phase_a_outputs(lib, n, c, patches.device)
    _launch(lib.p2m_phase_a(
        patches.data_ptr(), w_packed.data_ptr(), v_th.data_ptr(),
        u.data_ptr(), partials.data_ptr(), n, kk, c,
        ctypes.byref(physics_args(pixel_params, mtj_model.DEFAULT_MTJ)),
        _stream(patches.device)), "p2m_phase_a")
    p2m_phase_a.launches += 1
    return u, partials


@cuda_lib.kernel_wrapper
def p2m_conv(patches: torch.Tensor, w_packed: torch.Tensor,
             theta: torch.Tensor, key, *,
             pixel_params=pixel_model.DEFAULT_PIXEL,
             mtj_params=mtj_model.DEFAULT_MTJ) -> torch.Tensor:
    """The legacy fused kernel: patches (N, K) float32, w_packed (K, 2C),
    theta one float32 value on the device, key the host key of the draw
    hash. Returns the (N, C) {0, 1} draws; at kernel A's theta they equal
    the pinned-theta fused kernel's, on either of the library's paths
    (``cuda_lib.load().p2m_conv_warp_tiles(n)``: 1 for warp-owned tiles)."""
    n, kk, c = _rows_shape(patches, w_packed)
    if _on_cpu(patches, w_packed, theta):
        return p2m_conv_plain(patches, w_packed, theta, key,
                              pixel_params=pixel_params,
                              mtj_params=mtj_params)
    _check_f32(patches=patches, w_packed=w_packed, theta=theta)
    _check_scalar(theta=theta)
    if n * c >= 2 ** 31:
        raise ValueError(f"{n * c} elements exceed the kernel's int32 index")
    lib = cuda_lib.load()
    chan = _identity_chan(c, patches.device)
    acts = torch.empty((n, c), dtype=torch.float32, device=patches.device)
    k0, k1 = _key_words(key)
    _launch(lib.p2m_conv(
        patches.data_ptr(), w_packed.data_ptr(), theta.data_ptr(),
        chan.data_ptr(), acts.data_ptr(), n, kk, c, k0, k1,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(patches.device)), "p2m_conv")
    p2m_conv.launches += 1
    return acts


# ---------------------------------------------------------------------------
# the chip axis: G chips' calls in one launch
# ---------------------------------------------------------------------------
#
# Each fleet wrapper takes its single-chip wrapper's operands with a leading
# chip axis (frames (G, B, H, W, Cin), u (G, N, C), theta (G,), chan
# (G, 4, C), one draw key a chip) and returns its outputs with one: the
# partials (G, tiles of one chip, 2 | 3 | C). Row g of every output is the
# single-chip call on chip g's operands bit for bit. The plain version is
# that definition: the single-chip plain version a chip at a time.

def _plain_fleet(fn, per_chip):
    """Stack the outputs of ``fn(*args)`` over the chips' argument tuples."""
    outs = [fn(*args) for args in per_chip]
    return tuple(torch.stack(col) for col in zip(*outs))


def _chip_rows_of(chan: Optional[torch.Tensor], g: int, c: int, device):
    """Chip i's (4, C) rows of a fleet's (G, 4, C) ``chan``, or the
    identity rows (None: every chip nominal)."""
    if chan is None:
        return [identity_operands(c, device=device)] * g
    return list(chan)


def p2m_phase_a_implicit_fleet_plain(images, w_packed, v_th, *, kernel: int,
                                     stride: int,
                                     pixel_params=pixel_model.DEFAULT_PIXEL):
    """Fleet kernel A's function: kernel A's plain version a chip at a
    time, stacked."""
    return _plain_fleet(functools.partial(
        p2m_phase_a_implicit_plain, kernel=kernel, stride=stride,
        pixel_params=pixel_params), [(x, w_packed, v_th) for x in images])


def p2m_phase_a_implicit_q8_fleet_plain(
        images, wq_packed, dequant_row, v_th, *, kernel: int, stride: int,
        pixel_params=pixel_model.DEFAULT_PIXEL):
    """Fleet int8 kernel A's function, a chip at a time."""
    return _plain_fleet(functools.partial(
        p2m_phase_a_implicit_q8_plain, kernel=kernel, stride=stride,
        pixel_params=pixel_params),
        [(x, wq_packed, dequant_row, v_th) for x in images])


def p2m_phase_b_fleet_plain(u, theta, keys, *, chan=None,
                            pixel_params=pixel_model.DEFAULT_PIXEL,
                            mtj_params=mtj_model.DEFAULT_MTJ):
    """Fleet kernel B's function: kernel B's plain version on chip i's u,
    theta, key and rows, stacked."""
    g, _, c = u.shape
    rows = _chip_rows_of(chan, g, c, u.device)
    return _plain_fleet(
        lambda ui, th, k, ch: p2m_phase_b_plain(
            ui, th, k, chan=ch, pixel_params=pixel_params,
            mtj_params=mtj_params),
        [(u[i], theta.reshape(g)[i], keys[i], rows[i]) for i in range(g)])


def p2m_fused_stream_fleet_plain(images, w_packed, v_th, theta, keys,
                                 chan=None, *, kernel: int, stride: int,
                                 pixel_params=pixel_model.DEFAULT_PIXEL,
                                 mtj_params=mtj_model.DEFAULT_MTJ):
    """The fleet fused kernel's function, a chip at a time."""
    g, c = images.shape[0], w_packed.shape[1] // 2
    rows = _chip_rows_of(chan, g, c, images.device)
    return _plain_fleet(
        lambda x, th, k, ch: p2m_fused_stream_plain(
            x, w_packed, v_th, th, k, ch, kernel=kernel, stride=stride,
            pixel_params=pixel_params, mtj_params=mtj_params),
        [(images[i], theta.reshape(g)[i], keys[i], rows[i])
         for i in range(g)])


def p2m_fused_stream_q8_fleet_plain(images, wq_packed, dequant_row, v_th,
                                    theta, keys, chan=None, *, kernel: int,
                                    stride: int,
                                    pixel_params=pixel_model.DEFAULT_PIXEL,
                                    mtj_params=mtj_model.DEFAULT_MTJ):
    """The fleet int8 fused kernel's function, a chip at a time."""
    g, c = images.shape[0], wq_packed.shape[1] // 2
    rows = _chip_rows_of(chan, g, c, images.device)
    return _plain_fleet(
        lambda x, th, k, ch: p2m_fused_stream_q8_plain(
            x, wq_packed, dequant_row, v_th, th, k, ch, kernel=kernel,
            stride=stride, pixel_params=pixel_params,
            mtj_params=mtj_params),
        [(images[i], theta.reshape(g)[i], keys[i], rows[i])
         for i in range(g)])


def fleet_key_words(keys, device) -> torch.Tensor:
    """The (G, 2) words of G host draw keys on ``device``, one copy that
    does not wait for the device (int32 bit patterns, read by the kernels
    as uint32)."""
    words = np.stack([prng.key_data(k) for k in keys]).astype(np.uint32)
    return to_device_async(words.view(np.int32), device)


def _fleet_geom(images: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                stride: int):
    """(G, one chip's ConvGeom) of a (G, B, H, W, Cin) fleet call."""
    if images.ndim != 5:
        raise ValueError(f"fleet frames must be (G, B, H, W, Cin), got "
                         f"{tuple(images.shape)}")
    return images.shape[0], _conv_geom(images[0], w_packed, kernel, stride)


@functools.lru_cache(maxsize=16)
def _identity_fleet_chan(g: int, c: int, device: torch.device):
    return identity_operands(c, device=device).expand(
        g, CHAN_ROWS, c).contiguous()


def _check_fleet_chan(chan: Optional[torch.Tensor], g: int, c: int,
                      device) -> torch.Tensor:
    """The chips' rows: None (every chip nominal) or (G, 4, C)."""
    if chan is None:
        return _identity_fleet_chan(g, c, device)
    if tuple(chan.shape) != (g, CHAN_ROWS, c):
        raise ValueError(f"fleet chan must be ({g}, {CHAN_ROWS}, {c}), got "
                         f"{tuple(chan.shape)}")
    return chan


def _check_fleet(g: int, keys=None, **tensors: torch.Tensor) -> None:
    """Per-chip operands hold one value (theta) or key a chip."""
    for name, t in tensors.items():
        if t.numel() != g:
            raise ValueError(f"{name} must hold {g} values, got "
                             f"{tuple(t.shape)}")
    if keys is not None and len(keys) != g:
        raise ValueError(f"{len(keys)} keys for {g} chips")


def _fleet_outputs(lib, g: int, n: int, c: int, device, stats=(2,)):
    """(G, N, C) and, per chip, one row a tile of each width in ``stats``."""
    tiles = lib.p2m_partial_rows(n)
    return (torch.empty((g, n, c), dtype=torch.float32, device=device),
            *(torch.empty((g, tiles, k), dtype=torch.float32, device=device)
              for k in stats))


@cuda_lib.kernel_wrapper
def p2m_phase_a_implicit_fleet(images: torch.Tensor, w_packed: torch.Tensor,
                               v_th: torch.Tensor, *, kernel: int,
                               stride: int,
                               pixel_params=pixel_model.DEFAULT_PIXEL):
    """Kernel A over G chips' frames (G, B, H, W, Cin) in one launch.
    Returns ``(u (G, B*H'*W', C), hoyer_partials (G, tiles, 2))``."""
    g, geom = _fleet_geom(images, w_packed, kernel, stride)
    if _on_cpu(images, w_packed, v_th):
        return p2m_phase_a_implicit_fleet_plain(
            images, w_packed, v_th, kernel=kernel, stride=stride,
            pixel_params=pixel_params)
    _check_f32(images=images, w_packed=w_packed, v_th=v_th)
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    u, partials = _fleet_outputs(lib, g, geom.batch * geom.ho * geom.wo,
                                 geom.c_out, images.device)
    _launch(lib.p2m_phase_a_implicit_fleet(
        images.data_ptr(), w_packed.data_ptr(), v_th.data_ptr(),
        u.data_ptr(), partials.data_ptr(), ctypes.byref(geom), g,
        ctypes.byref(physics_args(pixel_params, mtj_model.DEFAULT_MTJ)),
        _stream(images.device)), "p2m_phase_a_implicit_fleet")
    p2m_phase_a_implicit_fleet.launches += 1
    return u, partials


@cuda_lib.kernel_wrapper
def p2m_phase_a_implicit_q8_fleet(images: torch.Tensor,
                                  wq_packed: torch.Tensor,
                                  dequant_row: torch.Tensor,
                                  v_th: torch.Tensor, *, kernel: int,
                                  stride: int,
                                  pixel_params=pixel_model.DEFAULT_PIXEL):
    """int8 kernel A over G chips' frames in one launch: the outputs of
    ``p2m_phase_a_implicit_fleet``."""
    g, geom = _fleet_geom(images, wq_packed, kernel, stride)
    _check_dequant(dequant_row, 2 * geom.c_out)
    if _on_cpu(images, wq_packed, dequant_row, v_th):
        return p2m_phase_a_implicit_q8_fleet_plain(
            images, wq_packed, dequant_row, v_th, kernel=kernel,
            stride=stride, pixel_params=pixel_params)
    _check_f32(images=images, dequant_row=dequant_row, v_th=v_th)
    _check_int8(wq_packed=wq_packed)
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    u, partials = _fleet_outputs(lib, g, geom.batch * geom.ho * geom.wo,
                                 geom.c_out, images.device)
    _launch(lib.p2m_phase_a_implicit_q8_fleet(
        images.data_ptr(), wq_packed.data_ptr(), dequant_row.data_ptr(),
        v_th.data_ptr(), u.data_ptr(), partials.data_ptr(),
        ctypes.byref(geom), g,
        ctypes.byref(physics_args(pixel_params, mtj_model.DEFAULT_MTJ)),
        _stream(images.device)), "p2m_phase_a_implicit_q8_fleet")
    p2m_phase_a_implicit_q8_fleet.launches += 1
    return u, partials


@cuda_lib.kernel_wrapper
def p2m_phase_b_fleet(u: torch.Tensor, theta: torch.Tensor, keys, *,
                      chan: Optional[torch.Tensor] = None,
                      pixel_params=pixel_model.DEFAULT_PIXEL,
                      mtj_params=mtj_model.DEFAULT_MTJ):
    """Kernel B over G chips in one launch: u (G, N, C), theta (G,) on the
    device, ``keys`` G host keys (their words go to the device in one
    copy), chan the chips' (G, 4, C) rows or None (every chip nominal).
    Returns ``(acts (G, N, C), v_partials (G, tiles, 3))``."""
    if u.ndim != 3:
        raise ValueError(f"fleet u must be (G, N, C), got {tuple(u.shape)}")
    g, n, c = u.shape
    chan = _check_fleet_chan(chan, g, c, u.device)
    _check_fleet(g, keys, theta=theta)
    if _on_cpu(u, theta, chan):
        return p2m_phase_b_fleet_plain(u, theta, keys, chan=chan,
                                       pixel_params=pixel_params,
                                       mtj_params=mtj_params)
    _check_f32(u=u, theta=theta, chan=chan)
    lib = cuda_lib.load()
    acts = torch.empty((g, n, c), dtype=torch.float32, device=u.device)
    partials = torch.empty((g, lib.p2m_phase_b_partial_rows(n, c), 3),
                           dtype=torch.float32, device=u.device)
    words = fleet_key_words(keys, u.device)
    _launch(lib.p2m_phase_b_fleet(
        u.data_ptr(), theta.data_ptr(), chan.data_ptr(), words.data_ptr(),
        acts.data_ptr(), partials.data_ptr(), n, c, g,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(u.device)), "p2m_phase_b_fleet")
    p2m_phase_b_fleet.launches += 1
    return acts, partials


def _fused_fleet(wrapper, images, weights, v_th, theta, keys, chan, kernel,
                 stride, pixel_params, mtj_params, plain):
    """The two fused fleet wrappers' shared body: ``weights`` the packed f32
    weights, or the int8 weights and their dequant row; ``wrapper`` the
    calling wrapper, whose C entry of the same name it launches."""
    name = wrapper.__name__
    g, geom = _fleet_geom(images, weights[0], kernel, stride)
    chan = _check_fleet_chan(chan, g, geom.c_out, images.device)
    _check_fleet(g, keys, theta=theta)
    if _on_cpu(images, *weights, v_th, theta, chan):
        return plain(images, *weights, v_th, theta, keys, chan,
                     kernel=kernel, stride=stride, pixel_params=pixel_params,
                     mtj_params=mtj_params)
    _check_f32(images=images, v_th=v_th, theta=theta, chan=chan,
               **({"w_packed": weights[0]} if len(weights) == 1
                  else {"dequant_row": weights[1]}))
    if len(weights) == 2:
        _check_int8(wq_packed=weights[0])
    _check_scalar(v_th=v_th)
    lib = cuda_lib.load()
    dev = images.device
    acts, hoyer, vpart, rates = _fleet_outputs(
        lib, g, geom.batch * geom.ho * geom.wo, geom.c_out, dev,
        stats=(2, 3, geom.c_out))
    words = fleet_key_words(keys, dev)
    _launch(getattr(lib, name)(
        images.data_ptr(), *(t.data_ptr() for t in weights), v_th.data_ptr(),
        theta.data_ptr(), chan.data_ptr(), words.data_ptr(), acts.data_ptr(),
        hoyer.data_ptr(), vpart.data_ptr(), rates.data_ptr(),
        ctypes.byref(geom), g,
        ctypes.byref(physics_args(pixel_params, mtj_params)),
        _stream(dev)), name)
    wrapper.launches += 1
    return acts, hoyer, vpart, rates


@cuda_lib.kernel_wrapper
def p2m_fused_stream_fleet(images: torch.Tensor, w_packed: torch.Tensor,
                           v_th: torch.Tensor, theta: torch.Tensor, keys,
                           chan: Optional[torch.Tensor] = None, *,
                           kernel: int, stride: int,
                           pixel_params=pixel_model.DEFAULT_PIXEL,
                           mtj_params=mtj_model.DEFAULT_MTJ):
    """The fused streaming kernel over G chips in one launch, each chip at
    its own carried theta (G,) with its own key and (4, C) rows. Returns
    ``(acts (G, N, C), hoyer (G, tiles, 2), v (G, tiles, 3), rates (G,
    tiles, C))``."""
    return _fused_fleet(p2m_fused_stream_fleet, images, (w_packed,), v_th,
                        theta, keys, chan, kernel, stride, pixel_params,
                        mtj_params, p2m_fused_stream_fleet_plain)


@cuda_lib.kernel_wrapper
def p2m_fused_stream_q8_fleet(images: torch.Tensor, wq_packed: torch.Tensor,
                              dequant_row: torch.Tensor, v_th: torch.Tensor,
                              theta: torch.Tensor, keys,
                              chan: Optional[torch.Tensor] = None, *,
                              kernel: int, stride: int,
                              pixel_params=pixel_model.DEFAULT_PIXEL,
                              mtj_params=mtj_model.DEFAULT_MTJ):
    """The int8 fused streaming kernel over G chips in one launch: the
    outputs of ``p2m_fused_stream_fleet``."""
    _check_dequant(dequant_row, wq_packed.shape[-1])
    return _fused_fleet(p2m_fused_stream_q8_fleet, images,
                        (wq_packed, dequant_row), v_th, theta, keys, chan,
                        kernel, stride, pixel_params, mtj_params,
                        p2m_fused_stream_q8_fleet_plain)


cuda_lib.register(p2m_phase_a_implicit, p2m_phase_b, p2m_fused_stream,
                  p2m_phase_a_implicit_q8, p2m_fused_stream_q8, p2m_phase_a,
                  p2m_conv, p2m_phase_a_implicit_fleet,
                  p2m_phase_a_implicit_q8_fleet, p2m_phase_b_fleet,
                  p2m_fused_stream_fleet, p2m_fused_stream_q8_fleet)


# the patch-row MAC each kernel computes, for the op census: implicit
# kernels (A, fused, their int8 twins, each also over a chip axis) one
# (N, K) x (K, 2C) product of the frames' patch rows (G, N, K with a chip
# axis), the explicit-patch kernels (explicit A, legacy) one of their
# patch matrix; int8 operands sum in int32 (MacQ8Mma), float32 ones in
# float32. Kernel B computes no product.

def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _mac_dot(rows, weights: torch.Tensor) -> cuda_lib.Dot:
    return cuda_lib.Dot(tuple(rows), tuple(weights.shape),
                        _dtype_name(weights),
                        "int32" if weights.dtype == torch.int8 else "float32")


def _implicit_dots(images, weights, *args, kernel: int, stride: int, **kw):
    *chips, b, h, w, _ = images.shape
    n = b * blocking.conv_out_hw(h, stride) * blocking.conv_out_hw(w, stride)
    return (_mac_dot((*chips, n, weights.shape[0]), weights),)


def _explicit_dots(patches, weights, *args, **kw):
    return (_mac_dot(patches.shape, weights),)


cuda_lib.declare_dots({
    **dict.fromkeys((p2m_phase_a_implicit, p2m_fused_stream,
                     p2m_phase_a_implicit_q8, p2m_fused_stream_q8,
                     p2m_phase_a_implicit_fleet,
                     p2m_phase_a_implicit_q8_fleet, p2m_fused_stream_fleet,
                     p2m_fused_stream_q8_fleet), _implicit_dots),
    p2m_phase_a: _explicit_dots, p2m_conv: _explicit_dots})
