"""The port's CUDA kernels on the card (``-m cuda``; they skip without one).

This file imports neither jax nor the reference package, so it runs on a
machine that has only PyTorch with CUDA:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
tensors: u at atol 3e-6 (the MAC sums in another order), theta at rtol
1e-5, draws by the word-boundary rule (tanhf/expf inside the kernel and in
PyTorch's ops may differ by ulps), and against its siblings bit for bit:
the fused kernels at a pinned theta equal A -> B at both precisions, int8
equals f32 on power-of-two grid inputs, explicit kernel A equals implicit
kernel A, and the legacy kernel at A's theta equals the pinned fused kernel.
The row-tile kernels, and kernel B and the three kernel A instances with
their warp-owned tiles, are also held there at widths the serving shape
does not reach (C 48, 40, 30 and 1, N not a multiple of the 16-row tile,
K 75) and at the ImageNet frame size, launch to launch bit for bit (f32
kernel A and the legacy kernel on both sides of the tile count where
their warps start to own their tiles); the int8 kernels' MAC is checked
to run on the s8 tensor cores (IMMA in the library's machine code), and
the device chain at other MTJ counts.
The chip axis: each of the five fleet instances (kernels A f32 and int8,
B, fused f32 and int8 over G chips in one launch) equals the single-chip
call on each chip's operands bit for bit (N not a multiple of 16 too), and
the fleet frontend launches as many kernels at G 4 as at G 1.
An aging chip (``repro_torch.lifetime``): kernel B and the fused kernel
on its (4, C) rows at two ages, bit for bit against their plain versions;
an aging, calibrated vgg_tiny engine card vs CPU by ``chip_smoke.py``'s
rules; a refresh launches no kernel.
The vision train step is held against the CPU on the card (one step of
vgg_tiny stage by stage, ``chip_smoke.train_vs_cpu``), with the TF32 flag
of a conv's backward and the max-pool gradient's ties on binary maps.
The engine tests show each main path launches its own kernels and no
other: f32 A / B / f32 fused on the f32 engine, int8 A / B / int8 fused on
an engine whose tile table picks int8, and one flash-attention launch per
layer (no P2M kernel) on the LM engine; ``obs`` adds no launch, and a
deferred exact stream step dispatches without a host sync.

The flash-attention kernels are held against their plain version at
max-abs 2e-2 for bf16 outputs (bf16 output rounding plus another kv-tile
summation order) and 2e-5 for float32 (the summation order alone): the
wgmma kernel (bf16, D 64, 80 and 128) at S 1 to 2048, MHA and GQA 4:1, 7:1
and 16:1, the mma.sync kernel at D 16 and 32 and the FFMA kernel at D 16
to 128, D 80 included; with a sliding window every instance, and D 256
(recurrentgemma-2b, 10 heads over 1) with and without one, its run-time
schedule with fewer work items than SMs and over several rounds (two
launches in a row equal bit for bit), and a window that hides no key
running the instance without it. The RG-LRU scan kernel is held against
its plain version (an associative scan) at 1e-5 with a near 1, its gated
instance bit for bit against the unfused chain it replaces (bf16 and
float32, ragged widths and lengths), and reduced recurrentgemma-2b's
engine on the card against the CPU engine inside and past its window.
deepseek-v2's and kimi-k2's instances, (D 192, Dv 128) and D 112, are held
against the plain version at their served prefills, ragged and strided;
an unbuilt (D, Dv) pair raises; reduced deepseek-v2 and kimi-k2 in bf16 at
the full models' attention widths launch one flash kernel a layer in a
generate and match a card train-mode forward, and the MoE routing of tied
bf16 logits on the card equals the CPU's without a host sync. Both flash
routes take unequal q and kv lengths (non-causal, no window) at every
(D, Dv) they are built for, ragged on both sides, and reduced
whisper-base's engine (encoder, decoder, cross-attention) on the card
launches one flash kernel an encoder layer and two a decoder layer in the
prefill and equals the CPU engine. The sLSTM
recurrence kernel (xlstm-350m) is held against its plain version at 1e-4
at dh 16 to 256 (float32 and bf16 weights, B 1 to 9, one to four heads,
ragged columns, from a drawn carry and from none), each launch is the
design ``slstm_scan.design`` reports (its cluster's blocks on SMs of their
own), one-token calls that advance the carry in place equal one sequence
call bit for bit, and reduced xlstm-350m's engine on the card launches it
once in the prefill and once a decode step and equals the CPU engine.
LM training: the flash backward kernel (float32 D 16, bf16 D 80 and 128)
against its plain version (autograd through the plain forward in float32)
at ragged lengths, causal and not, MHA and GQA, deterministic from launch to
launch; a train forward through ``blocks.flash_attention`` launching the
forward and backward kernels (the forward twice under checkpointing, the
same gradient bits); the calls the backward does not take (a window,
unequal lengths, MLA's widths, another head dim) and every kernel wrapper
without a backward refusing operands that autograd records; one AdamW step
of reduced stablelm-3b and granite-8b (remat) on the card against the
CPU; the Trainer refusing configs whose kernels have no backward; and
sampled decoding on the card against the CPU.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.kernels import autotune, cuda_lib
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import p2m_conv as tk
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import slstm_scan as ss
from repro_torch.models import lm as tlm
from repro_torch.models import vision as tv
from repro_torch.serving import ServingEngine, VisionEngine

GEOMETRIES = [(3, 2, 32, 32), (3, 1, 16, 16), (3, 3, 18, 18), (5, 2, 12, 12),
              (3, 2, 15, 15), (3, 2, 14, 10), (5, 3, 13, 11)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU "
                    "mode (run with -m cuda on the card)")
    return torch.device("cuda")


def _assert_word_boundary(acts, q, bits, max_flips=8):
    acts, q, bits = acts.cpu(), q.cpu().double(), bits.cpu().double()
    mismatch = acts != (bits / 65536.0 < q).to(acts.dtype)
    assert int(mismatch.sum()) <= max_flips
    near = (q * 65536.0 - bits).abs() <= 1.0
    assert not bool((mismatch & ~near).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,h,w", GEOMETRIES)
def test_kernels_match_plain_on_card(cuda_device, kernel, stride, h, w):
    rng = np.random.default_rng(0)
    images = torch.tensor(rng.uniform(size=(4, h, w, 3)),
                          dtype=torch.float32, device=cuda_device)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, 32)) * 0.3,
                      dtype=torch.float32)
    wp = tk.pack_phase_weights(wt).to(cuda_device)
    v_th = torch.ones((), device=cuda_device)
    key = prng.PRNGKey(5)
    cuda_lib.reset_launch_counts()
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, kernel=kernel,
                                    stride=stride)
    u_p, hp_p = tk.p2m_phase_a_implicit_plain(images, wp, v_th,
                                              kernel=kernel, stride=stride)
    torch.testing.assert_close(u, u_p, rtol=0, atol=3e-6)
    theta = tk.combine_hoyer_partials(hp, v_th)
    torch.testing.assert_close(theta, tk.combine_hoyer_partials(hp_p, v_th),
                               rtol=1e-5, atol=0)
    acts, _ = tk.p2m_phase_b(u, theta, key)
    q, _ = tk.device_chain_q(u, theta, None)
    _assert_word_boundary(acts, q, tk.draw_bits(key, *u.shape))
    acts_f, hf, _, rf = tk.p2m_fused_stream(images, wp, v_th, theta, key,
                                            kernel=kernel, stride=stride)
    assert torch.equal(acts_f, acts)
    assert torch.equal(tk.combine_hoyer_partials(hf, v_th), theta)
    assert torch.equal(rf.sum(0), acts_f.sum(0))
    counts = cuda_lib.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "p2m_phase_a_implicit": 1, "p2m_phase_b": 1, "p2m_fused_stream": 1}


def _grid_inputs(rng, kernel, h, w, c=32):
    """Integer * 2^-9 weights with +-127 pinned per channel and 1/128-grid
    frames: both MACs are exact at either precision."""
    w_int = rng.integers(-126, 127, size=(kernel * kernel * 3, c))
    w_int[0, :], w_int[1, :] = 127, -127
    frames = rng.integers(0, 128, size=(4, h, w, 3)) / 128.0
    return ((w_int * 2.0 ** -9).astype(np.float32),
            frames.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,stride,h,w", GEOMETRIES)
def test_new_kernels_match_plain_on_card(cuda_device, kernel, stride, h, w):
    rng = np.random.default_rng(1)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(4, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, 32)) * 0.3,
                      dtype=torch.float32)
    wp = tk.pack_phase_weights(wt).to(dev)
    wq, dq = ops.quantize_frontend_weights(wp)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(6)
    kw = dict(kernel=kernel, stride=stride)
    cuda_lib.reset_launch_counts()

    # int8 kernel A, on uniform and on 1/256-grid frames
    grid256 = torch.tensor(rng.integers(0, 257, size=(4, h, w, 3)) / 256.0,
                           dtype=torch.float32, device=dev)
    for frames in (images, grid256):
        u8, hp8 = tk.p2m_phase_a_implicit_q8(frames, wq, dq, v_th, **kw)
        u8_p, hp8_p = tk.p2m_phase_a_implicit_q8_plain(frames, wq, dq, v_th,
                                                       **kw)
        torch.testing.assert_close(u8, u8_p, rtol=0, atol=3e-6)
        torch.testing.assert_close(tk.combine_hoyer_partials(hp8, v_th),
                                   tk.combine_hoyer_partials(hp8_p, v_th),
                                   rtol=1e-5, atol=0)
    # int8 fused at the int8 theta == int8 A -> B
    u8, hp8 = tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, **kw)
    theta8 = tk.combine_hoyer_partials(hp8, v_th)
    acts8, _ = tk.p2m_phase_b(u8, theta8, key)
    acts8_f, hf8, _, rf8 = tk.p2m_fused_stream_q8(images, wq, dq, v_th,
                                                  theta8, key, **kw)
    assert torch.equal(acts8_f, acts8)
    assert torch.equal(tk.combine_hoyer_partials(hf8, v_th), theta8)
    assert torch.equal(rf8.sum(0), acts8_f.sum(0))
    u8_p, _ = tk.p2m_phase_a_implicit_q8_plain(images, wq, dq, v_th, **kw)
    _assert_word_boundary(acts8_f, tk.device_chain_q(u8_p, theta8, None)[0],
                          tk.draw_bits(key, *u8.shape))

    # power-of-two grid: int8 == f32 bit for bit
    wg, fg = _grid_inputs(rng, kernel, h, w)
    wpg = tk.pack_phase_weights(torch.from_numpy(wg)).to(dev)
    wqg, dqg = ops.quantize_frontend_weights(wpg)
    fg = torch.from_numpy(fg).to(dev)
    assert torch.equal(tk.p2m_phase_a_implicit_q8(fg, wqg, dqg, v_th, **kw)[0],
                       tk.p2m_phase_a_implicit(fg, wpg, v_th, **kw)[0])
    th = torch.tensor(0.7, device=dev)
    assert torch.equal(
        tk.p2m_fused_stream_q8(fg, wqg, dqg, v_th, th, key, **kw)[0],
        tk.p2m_fused_stream(fg, wpg, v_th, th, key, **kw)[0])

    # explicit A == implicit A; legacy at A's theta == pinned fused
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    theta = tk.combine_hoyer_partials(hp, v_th)
    patches = ops.im2col(images, kernel, stride).contiguous()
    ue, he = tk.p2m_phase_a(patches, wp, v_th)
    assert torch.equal(ue, u) and torch.equal(he, hp)
    ue_p, _ = tk.p2m_phase_a_plain(patches, wp, v_th)
    torch.testing.assert_close(ue, ue_p, rtol=0, atol=3e-6)
    acts_f = tk.p2m_fused_stream(images, wp, v_th, theta, key, **kw)[0]
    acts_l = tk.p2m_conv(patches, wp, theta, key)
    assert torch.equal(acts_l, acts_f)
    _assert_word_boundary(acts_l, tk.device_chain_q(ue_p, theta, None)[0],
                          tk.draw_bits(key, *u.shape))
    counts = cuda_lib.launch_counts()
    assert counts["p2m_phase_a_implicit_q8"] == 4
    assert counts["p2m_fused_stream_q8"] == 2
    assert counts["p2m_phase_a"] == 1 and counts["p2m_conv"] == 1


# (batch, h, w, kernel, stride, C) for the row-tile kernels: C 48 (two
# channel passes), N not a multiple of the 16-row tile (126, 20, 200), C not
# a multiple of 4 (the tensor-core product's padded columns), K 75 (three
# k-steps of 32), one channel, and the ImageNet frame size
TILE_GEOMETRIES = [(4, 16, 16, 3, 1, 48), (3, 13, 11, 3, 2, 32),
                   (1, 7, 9, 3, 2, 40), (2, 10, 10, 3, 1, 30),
                   (2, 12, 12, 5, 2, 48), (1, 5, 5, 3, 1, 1),
                   (16, 224, 224, 3, 2, 32)]


def _draw_rule(acts, q, bits):
    """chip_smoke.py's word-boundary rule: at most max(8, 1e-3 N) flips."""
    _assert_word_boundary(acts, q, bits, max_flips=max(8, acts.numel() // 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,kernel,stride,c", TILE_GEOMETRIES)
def test_row_tile_kernels_at_odd_widths_and_imagenet(cuda_device, b, h, w,
                                                     kernel, stride, c):
    """The fused kernels (f32 and int8 on the tensor cores) against A -> B
    bit for bit and against the plain versions, at widths and row counts the
    serving shape does not reach; launched twice, every output and partial
    is bit-identical."""
    rng = np.random.default_rng(c + h)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
                      dtype=torch.float32)
    wp = tk.pack_phase_weights(wt).to(dev)
    wq, dq = ops.quantize_frontend_weights(wp)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(9)
    kw = dict(kernel=kernel, stride=stride)
    for a_fn, a_plain, f_fn in (
            (lambda: tk.p2m_phase_a_implicit(images, wp, v_th, **kw),
             lambda: tk.p2m_phase_a_implicit_plain(images, wp, v_th, **kw),
             lambda th: tk.p2m_fused_stream(images, wp, v_th, th, key, **kw)),
            (lambda: tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, **kw),
             lambda: tk.p2m_phase_a_implicit_q8_plain(images, wq, dq, v_th,
                                                      **kw),
             lambda th: tk.p2m_fused_stream_q8(images, wq, dq, v_th, th, key,
                                               **kw))):
        u, hp = a_fn()
        u_p, hp_p = a_plain()
        assert hp.shape[0] == -(-u.shape[0] // 16)
        torch.testing.assert_close(u, u_p, rtol=0, atol=3e-6)
        theta = tk.combine_hoyer_partials(hp, v_th)
        torch.testing.assert_close(
            theta, tk.combine_hoyer_partials(hp_p, v_th), rtol=1e-5, atol=0)
        acts, _ = tk.p2m_phase_b(u, theta, key)
        first = f_fn(theta)
        acts_f, hf, vf, rf = first
        assert torch.equal(acts_f, acts)
        assert torch.equal(hf, hp)
        assert torch.equal(tk.combine_hoyer_partials(hf, v_th), theta)
        assert torch.equal(rf.sum(0), acts_f.sum(0))
        _draw_rule(acts_f, tk.device_chain_q(u_p, theta, None)[0],
                   tk.draw_bits(key, *u.shape))
        v_k = tk.combine_v_conv_partials(vf, *u.shape)
        _, v_p = tk.p2m_phase_b_plain(u_p, theta, key)
        v_plain = tk.combine_v_conv_partials(v_p, *u.shape)
        for name, val in v_k.items():
            torch.testing.assert_close(val, v_plain[name], rtol=1e-5,
                                       atol=1e-5)
        again = f_fn(theta)
        for x, y in zip(first, again):
            assert torch.equal(x, y)
        assert all(torch.equal(x, y) for x, y in zip((u, hp), a_fn()))
    patches = ops.im2col(images, kernel, stride).contiguous()
    ue, he = tk.p2m_phase_a(patches, wp, v_th)
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    assert torch.equal(ue, u) and torch.equal(he, hp)
    theta = tk.combine_hoyer_partials(hp, v_th)
    assert torch.equal(tk.p2m_conv(patches, wp, theta, key),
                       tk.p2m_fused_stream(images, wp, v_th, theta, key,
                                           **kw)[0])


# int8 kernel A's warps own their tiles from 1024 tiles (16,384 rows) on:
# C 30 (a channel group of the product half empty) and C 48 at K 75 there
WARP_TILE_GEOMETRIES = TILE_GEOMETRIES + [(16, 64, 64, 3, 2, 30),
                                          (16, 64, 64, 5, 2, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,kernel,stride,c", WARP_TILE_GEOMETRIES)
def test_warp_tile_kernels_at_odd_widths_and_imagenet(cuda_device, b, h, w,
                                                      kernel, stride, c):
    """Kernel B and int8 kernel A, whose warps own whole row tiles (int8 A
    where the tiles fill the card). B writes ``p2m_phase_b_partial_rows``
    partial rows, its V statistics sit within 1e-5 of the plain version's
    on (4, C) rows that are not the identity, and two launches give equal
    draws and partials. int8 A's u is the plain version's at atol 3e-6, its
    Hoyer rows equal the int8 fused kernel's, and two launches are
    bit-identical."""
    rng = np.random.default_rng(c + h + 1)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
                      dtype=torch.float32)
    wq, dq = ops.quantize_frontend_weights(tk.pack_phase_weights(wt).to(dev))
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(13)
    kw = dict(kernel=kernel, stride=stride)

    u8, hp8 = tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, **kw)
    u8_p, hp8_p = tk.p2m_phase_a_implicit_q8_plain(images, wq, dq, v_th, **kw)
    torch.testing.assert_close(u8, u8_p, rtol=0, atol=3e-6)
    theta8 = tk.combine_hoyer_partials(hp8, v_th)
    torch.testing.assert_close(theta8, tk.combine_hoyer_partials(hp8_p, v_th),
                               rtol=1e-5, atol=0)
    assert torch.equal(
        tk.p2m_fused_stream_q8(images, wq, dq, v_th, theta8, key, **kw)[1],
        hp8)
    assert all(torch.equal(x, y) for x, y in zip(
        (u8, hp8), tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, **kw)))

    n = u8.shape[0]
    chan = torch.tensor(np.stack([1.0 + 0.1 * rng.normal(size=c),
                                  0.02 * rng.normal(size=c),
                                  1.0 + 0.1 * rng.normal(size=c),
                                  0.2 * rng.normal(size=c)]),
                        dtype=torch.float32, device=dev)
    acts, vp = tk.p2m_phase_b(u8, theta8, key, chan=chan)
    assert vp.shape == (cuda_lib.load().p2m_phase_b_partial_rows(n, c), 3)
    _draw_rule(acts, tk.device_chain_q(u8, theta8, chan)[0],
               tk.draw_bits(key, n, c))
    v_k = tk.combine_v_conv_partials(vp, n, c)
    v_p = tk.combine_v_conv_partials(
        tk.p2m_phase_b_plain(u8, theta8, key, chan=chan)[1], n, c)
    for name, val in v_k.items():
        torch.testing.assert_close(val, v_p[name], rtol=0, atol=1e-5)
    acts2, vp2 = tk.p2m_phase_b(u8, theta8, key, chan=chan)
    assert torch.equal(acts2, acts) and torch.equal(vp2, vp)


# f32 kernel A's warps own their tiles from the library's crossover (768
# tiles) on: the geometries above on both sides of it, and two with N not a
# multiple of 16 beyond it (C 30 at stride 1; C 48 at K 75)
F32_A_GEOMETRIES = WARP_TILE_GEOMETRIES + [(17, 61, 61, 3, 1, 30),
                                           (17, 61, 65, 5, 2, 48)]


def _rows(b, h, w, kernel, stride):
    return b * -(-h // stride) * -(-w // stride)


@pytest.mark.cuda
def test_f32_kernel_a_geometries_cover_both_paths(cuda_device):
    """The library runs block-shared tiles at some of F32_A_GEOMETRIES and
    warp-owned ones at others, N not a multiple of 16 among the latter."""
    lib = cuda_lib.load()
    warp = {g: bool(lib.p2m_phase_a_warp_tiles(_rows(*g[:5]), 0))
            for g in F32_A_GEOMETRIES}
    assert any(warp.values()) and not all(warp.values())
    assert any(w and _rows(*g[:5]) % 16 for g, w in warp.items())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,kernel,stride,c", F32_A_GEOMETRIES)
def test_f32_kernel_a_on_both_sides_of_the_crossover(cuda_device, b, h, w,
                                                     kernel, stride, c):
    """f32 kernel A, implicit and explicit, on whichever path the library
    picks at this N: u within 3e-6 of the plain version and theta within
    rtol 1e-5, ``p2m_partial_rows`` Hoyer rows equal to the f32 fused
    kernel's bit for bit, explicit A equal to implicit A bit for bit, the
    fused kernel at A's theta equal to A -> B, and two launches of each
    bit-identical."""
    rng = np.random.default_rng(c + h + 2)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
                      dtype=torch.float32)
    wp = tk.pack_phase_weights(wt).to(dev)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(17)
    kw = dict(kernel=kernel, stride=stride)
    patches = ops.im2col(images, kernel, stride).contiguous()

    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    n = u.shape[0]
    assert n == _rows(b, h, w, kernel, stride)
    assert hp.shape == (cuda_lib.load().p2m_partial_rows(n), 2)
    u_p, hp_p = tk.p2m_phase_a_implicit_plain(images, wp, v_th, **kw)
    torch.testing.assert_close(u, u_p, rtol=0, atol=3e-6)
    theta = tk.combine_hoyer_partials(hp, v_th)
    torch.testing.assert_close(theta, tk.combine_hoyer_partials(hp_p, v_th),
                               rtol=1e-5, atol=0)
    ue, he = tk.p2m_phase_a(patches, wp, v_th)
    assert torch.equal(ue, u) and torch.equal(he, hp)
    ue_p, he_p = tk.p2m_phase_a_plain(patches, wp, v_th)
    torch.testing.assert_close(ue, ue_p, rtol=0, atol=3e-6)
    torch.testing.assert_close(tk.combine_hoyer_partials(he, v_th),
                               tk.combine_hoyer_partials(he_p, v_th),
                               rtol=1e-5, atol=0)

    acts, _ = tk.p2m_phase_b(u, theta, key)
    acts_f, hf, _, _ = tk.p2m_fused_stream(images, wp, v_th, theta, key, **kw)
    assert torch.equal(hf, hp)
    assert torch.equal(acts_f, acts)
    for again in (tk.p2m_phase_a_implicit(images, wp, v_th, **kw),
                  tk.p2m_phase_a(patches, wp, v_th)):
        assert torch.equal(again[0], u) and torch.equal(again[1], hp)


# the legacy kernel's warps own their tiles from the library's crossover on
# (p2m_conv_warp_tiles): F32_A_GEOMETRIES, and C 48 at K 75 with N not a
# multiple of 16 beyond it
LEGACY_GEOMETRIES = F32_A_GEOMETRIES + [(17, 81, 85, 5, 2, 48)]


@pytest.mark.cuda
def test_legacy_kernel_geometries_cover_both_paths(cuda_device):
    """The library runs the legacy kernel's block-shared tiles
    (``legacy_conv_kernel``) at some of LEGACY_GEOMETRIES and warp-owned
    ones (``legacy_warp_kernel``) at others, among the latter N not a
    multiple of 16 at C 30 and at C 48 with K 75; the ImageNet frame size
    is one of them."""
    lib = cuda_lib.load()
    warp = {g: bool(lib.p2m_conv_warp_tiles(_rows(*g[:5])))
            for g in LEGACY_GEOMETRIES}
    assert any(warp.values()) and not all(warp.values())
    assert {g[5] for g, w in warp.items() if w and _rows(*g[:5]) % 16} \
        >= {30, 48}
    assert any(w and g[3] == 5 for g, w in warp.items())
    assert warp[(16, 224, 224, 3, 2, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,kernel,stride,c", LEGACY_GEOMETRIES)
def test_legacy_kernel_on_both_sides_of_the_crossover(cuda_device, b, h, w,
                                                      kernel, stride, c):
    """The legacy kernel on whichever path the library picks at this N: at
    kernel A's theta and at two pinned ones its draws equal the pinned-theta
    fused kernel's bit for bit, hold to the plain version
    (``p2m_conv_plain``'s u and chain) by the word-boundary rule, and two
    launches are bit-identical."""
    rng = np.random.default_rng(c + h + 3)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wt = torch.tensor(rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
                      dtype=torch.float32)
    wp = tk.pack_phase_weights(wt).to(dev)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(19)
    kw = dict(kernel=kernel, stride=stride)
    patches = ops.im2col(images, kernel, stride).contiguous()
    n = patches.shape[0]
    assert n == _rows(b, h, w, kernel, stride)

    _, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    u_p, _ = tk.p2m_phase_a_plain(patches, wp, v_th)
    for theta in (tk.combine_hoyer_partials(hp, v_th),
                  torch.tensor(0.05, device=dev),
                  torch.tensor(0.6, device=dev)):
        acts = tk.p2m_conv(patches, wp, theta, key)
        assert acts.shape == (n, c)
        assert torch.equal(
            acts, tk.p2m_fused_stream(images, wp, v_th, theta, key, **kw)[0])
        _draw_rule(acts, tk.device_chain_q(u_p, theta, None)[0],
                   tk.draw_bits(key, n, c))
        assert torch.equal(tk.p2m_conv(patches, wp, theta, key), acts)


@pytest.mark.cuda
def test_int8_fused_kernel_runs_on_the_tensor_cores(cuda_device):
    """The int8 kernels' MAC (int8 kernel A, its block-shared and its
    warp-owned kernel, and the int8 fused kernel) is an s8 tensor-core
    product (IMMA in their machine code; the fused kernel in both chip
    layouts' kernels, and the chip axis's three int8 instances), no other
    P2M kernel runs IMMA and none runs HMMA
    (the f32 MACs use no TF32); the int8 fused draws and Hoyer partials
    equal int8 kernel A -> B bit for bit."""
    mma = cuda_lib.tensor_core_census(cuda_lib.build())
    q8 = {k: v for k, v in mma.items() if "MacQ8Mma" in k}
    # the single-chip kernels (fused in both chip layouts) and the chip
    # axis's (block-shared A, warp-owned A and fused over FleetRows)
    assert sorted("fused_stream" in k for k in q8) == [False] * 4 + [True] * 3
    assert sum("FleetRows" in k for k in q8) == 3
    assert all("phase_a_kernel" in k or "phase_a_q8_warp_kernel" in k
               or "phase_a_q8_fleet_warp_kernel" in k
               or "fused_stream_kernel" in k or "fused_stream_pix_kernel" in k
               for k in q8)
    assert all(imma >= 1 for imma, _ in q8.values())
    assert all(hmma == 0 for _, hmma in mma.values())
    assert all(v == (0, 0) for k, v in mma.items() if k not in q8)

    rng = np.random.default_rng(4)
    images = torch.tensor(rng.uniform(size=(16, 32, 32, 3)),
                          dtype=torch.float32, device=cuda_device)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(27, 32)) * 0.3, dtype=torch.float32)).to(cuda_device)
    wq, dq = ops.quantize_frontend_weights(wp)
    v_th = torch.ones((), device=cuda_device)
    key = prng.PRNGKey(2)
    u8, hp8 = tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, kernel=3,
                                         stride=2)
    for theta in (tk.combine_hoyer_partials(hp8, v_th),
                  torch.tensor(0.05, device=cuda_device),
                  torch.tensor(0.6, device=cuda_device)):
        acts8, _ = tk.p2m_phase_b(u8, theta, key)
        acts_f, hf, _, _ = tk.p2m_fused_stream_q8(images, wq, dq, v_th, theta,
                                                  key, kernel=3, stride=2)
        assert torch.equal(acts_f, acts8) and torch.equal(hf, hp8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mtj", [5, 8, 12, 24])
def test_device_chain_at_other_mtj_counts(cuda_device, n_mtj):
    """The majority polynomial reads its binomials from the host; n 8 runs
    an unrolled copy of the loop the other counts run. Kernel B against the
    plain version, and the fused and legacy kernels against B bit for bit,
    at each count."""
    from repro_torch.core import mtj as mtj_model
    mtj = dataclasses.replace(mtj_model.DEFAULT_MTJ, n_redundant=n_mtj)
    rng = np.random.default_rng(n_mtj)
    images = torch.tensor(rng.uniform(size=(4, 16, 16, 3)),
                          dtype=torch.float32, device=cuda_device)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(27, 32)) * 0.3, dtype=torch.float32)).to(cuda_device)
    v_th = torch.ones((), device=cuda_device)
    key = prng.PRNGKey(n_mtj)
    kw = dict(kernel=3, stride=2)
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    theta = tk.combine_hoyer_partials(hp, v_th)
    acts, _ = tk.p2m_phase_b(u, theta, key, mtj_params=mtj)
    q, _ = tk.device_chain_q(u, theta, None, mtj_params=mtj)
    _assert_word_boundary(acts, q, tk.draw_bits(key, *u.shape))
    assert torch.equal(tk.p2m_fused_stream(images, wp, v_th, theta, key,
                                           mtj_params=mtj, **kw)[0], acts)
    patches = ops.im2col(images, 3, 2).contiguous()
    assert torch.equal(tk.p2m_conv(patches, wp, theta, key, mtj_params=mtj),
                       acts)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mtj", [5, 8, 12, 24])
def test_legacy_warp_tiles_at_other_mtj_counts(cuda_device, n_mtj):
    """The legacy kernel's warp-owned tiles compile the polynomial of 8 MTJs
    (majority 4) in and read any other count from the host: at each count,
    above the crossover, the draws equal the pinned-theta fused kernel's
    bit for bit and hold to the plain chain by the word-boundary rule."""
    from repro_torch.core import mtj as mtj_model
    mtj = dataclasses.replace(mtj_model.DEFAULT_MTJ, n_redundant=n_mtj)
    rng = np.random.default_rng(n_mtj + 1)
    images = torch.tensor(rng.uniform(size=(17, 61, 61, 3)),
                          dtype=torch.float32, device=cuda_device)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(27, 32)) * 0.3, dtype=torch.float32)).to(cuda_device)
    v_th = torch.ones((), device=cuda_device)
    key = prng.PRNGKey(n_mtj + 1)
    kw = dict(kernel=3, stride=1)
    patches = ops.im2col(images, 3, 1).contiguous()
    n = patches.shape[0]
    assert cuda_lib.load().p2m_conv_warp_tiles(n)
    theta = tk.combine_hoyer_partials(
        tk.p2m_phase_a_implicit(images, wp, v_th, **kw)[1], v_th)
    acts = tk.p2m_conv(patches, wp, theta, key, mtj_params=mtj)
    assert torch.equal(acts, tk.p2m_fused_stream(images, wp, v_th, theta, key,
                                                 mtj_params=mtj, **kw)[0])
    u_p, _ = tk.p2m_phase_a_plain(patches, wp, v_th)
    _draw_rule(acts, tk.device_chain_q(u_p, theta, None, mtj_params=mtj)[0],
               tk.draw_bits(key, n, 32))


F32_PATH = {"p2m_phase_a_implicit", "p2m_phase_b", "p2m_fused_stream"}
INT8_PATH = {"p2m_phase_a_implicit_q8", "p2m_phase_b", "p2m_fused_stream_q8"}


def _run_engine(engine):
    frames = torch.rand(4, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(1))
    cuda_lib.reset_launch_counts()
    out = engine.classify(frames)
    list(engine.stream([frames, frames]))
    assert out["probs"].device.type == "cuda"
    assert bool(torch.isfinite(out["probs"]).all())
    return cuda_lib.launch_counts()


@pytest.mark.cuda
def test_engine_main_path_launches_every_kernel(cuda_device, monkeypatch):
    monkeypatch.setattr(autotune, "_TABLE", {})
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    engine = VisionEngine(cfg, tv.init_params(0, cfg), microbatch=4)
    counts = _run_engine(engine)
    assert {k for k, v in counts.items() if v} == F32_PATH
    assert counts["p2m_fused_stream"] == engine.fused_step_count >= 1


@pytest.mark.cuda
def test_obs_adds_no_launch_and_defers_the_exact_step(cuda_device,
                                                      monkeypatch):
    """``obs`` changes no output and adds no launch on the card; a deferred
    exact microbatch queued behind a long sleep kernel returns from its
    dispatch with its probe's event not done (no host sync)."""
    import repro_torch.obs as obs_mod
    monkeypatch.setattr(autotune, "_TABLE", {})
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    params = tv.init_params(0, cfg)
    frames = torch.rand(8, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device)
    runs = []
    for obs in (None, obs_mod.Obs()):
        eng = VisionEngine(cfg, params, microbatch=4, fused_stream=False,
                           obs=obs)
        cuda_lib.reset_launch_counts()
        outs = list(eng.stream([frames, frames]))
        runs.append((eng, outs, cuda_lib.launch_counts()))
    (_, outs_a, counts_a), (eng, outs_b, counts_b) = runs
    assert counts_a == counts_b and counts_a["p2m_phase_b"] == 4
    for a, b in zip(outs_a, outs_b):
        for k in ("labels", "probs", "theta_used", "stream_fused"):
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    eng._classify(frames[:4], None, advance=True, fused=False, defer=True)
    probe = eng._batch_probes[-1]
    assert not probe.poll()
    assert probe.wait() > 0 and probe.token is None
    eng._pending.drain()


@pytest.mark.cuda
def test_int8_engine_launches_the_int8_kernels(cuda_device, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(autotune, "_TABLE", {})
    autotune.put(4 * 16 * 16, 27, 32, autotune.TileChoice(precision="int8"))
    table = tmp_path / "tiles.json"
    autotune.save_table(str(table))
    autotune.clear()
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    engine = VisionEngine(cfg, tv.init_params(0, cfg), microbatch=4,
                          tile_table=str(table))
    counts = _run_engine(engine)
    assert {k for k, v in counts.items() if v} == INT8_PATH
    assert counts["p2m_fused_stream_q8"] == engine.fused_step_count >= 1


# --- the chip operand: non-identity (4, C) rows and the per-pixel map -----

# (b, h, w, kernel, stride, c): the serving shape, odd widths (C 48, N not a
# multiple of 16, a pixel count that is not a power of two) and ImageNet
PIXEL_GEOMETRIES = [(16, 32, 32, 3, 2, 32), (4, 13, 11, 5, 3, 32),
                    (3, 15, 15, 3, 1, 48), (16, 224, 224, 3, 2, 32)]


def _chip_rows(rng, *shape):
    """Random non-identity chip rows: (4, C) or (4, N_pix, C)."""
    return np.stack([1.0 + 0.1 * rng.normal(size=shape),
                     0.05 * rng.normal(size=shape),
                     1.0 + 0.1 * rng.normal(size=shape),
                     0.3 * rng.normal(size=shape)]).astype(np.float32)


def _chan_layout_outputs(images, wp, v_th, key, chan, kw):
    """Kernel B on kernel A's u, and both fused kernels at A's theta, all
    with ``chan``: each kernel's draws and V partials (and the fused ones'
    rates), with the plain versions' q of the same u."""
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    theta = tk.combine_hoyer_partials(hp, v_th)
    wq, dq = ops.quantize_frontend_weights(wp)
    u8, hp8 = tk.p2m_phase_a_implicit_q8(images, wq, dq, v_th, **kw)
    theta8 = tk.combine_hoyer_partials(hp8, v_th)
    acts_b, vp_b = tk.p2m_phase_b(u, theta, key, chan=chan)
    f32 = tk.p2m_fused_stream(images, wp, v_th, theta, key, chan, **kw)
    q8 = tk.p2m_fused_stream_q8(images, wq, dq, v_th, theta8, key, chan, **kw)
    b8 = tk.p2m_phase_b(u8, theta8, key, chan=chan)
    return dict(u=u, theta=theta, b=(acts_b, vp_b), f32=f32, q8=q8, b8=b8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,kernel,stride,c", PIXEL_GEOMETRIES)
def test_chip_rows_in_every_layout_on_card(cuda_device, b, h, w, kernel,
                                           stride, c):
    """Kernel B and both fused kernels with random (4, C) rows and with a
    random (4, N_pix, C) per-pixel map: draws by the word-boundary rule
    against the plain versions, V partials within 1e-5, the fused kernels
    at A's theta equal to A -> B bit for bit with the same chan, and a
    per-pixel map constant across pixels equal to the (4, C) path bit for
    bit (draws, V partials and rates)."""
    rng = np.random.default_rng(c + h)
    dev = cuda_device
    images = torch.tensor(rng.uniform(size=(b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
        dtype=torch.float32)).to(dev)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(21)
    kw = dict(kernel=kernel, stride=stride)
    n_pix = ops.conv_out_hw(h, stride) * ops.conv_out_hw(w, stride)
    rows = torch.tensor(_chip_rows(rng, c), device=dev)
    layouts = {"rows": rows,
               "pixel": torch.tensor(_chip_rows(rng, n_pix, c), device=dev),
               "const": rows[:, None, :].expand(4, n_pix, c).contiguous()}
    outs = {}
    for name, chan in layouts.items():
        o = outs[name] = _chan_layout_outputs(images, wp, v_th, key, chan, kw)
        n = o["u"].shape[0]
        bits = tk.draw_bits(key, n, c)
        acts_b, vp_b = o["b"]
        _draw_rule(acts_b, tk.device_chain_q(o["u"], o["theta"], chan)[0],
                   bits)
        v_k = tk.combine_v_conv_partials(vp_b, n, c)
        v_p = tk.combine_v_conv_partials(tk.p2m_phase_b_plain(
            o["u"], o["theta"], key, chan=chan)[1], n, c)
        for stat, val in v_k.items():
            torch.testing.assert_close(val, v_p[stat], rtol=0, atol=1e-5)
        for fused, (acts_ab, vp_ab) in ((o["f32"], o["b"]),
                                        (o["q8"], o["b8"])):
            assert torch.equal(fused[0], acts_ab), name
            assert torch.equal(fused[3].sum(0), fused[0].sum(0))
            v_f = tk.combine_v_conv_partials(fused[2], n, c)
            for stat, val in tk.combine_v_conv_partials(vp_ab, n, c).items():
                torch.testing.assert_close(v_f[stat], val, rtol=0, atol=1e-5)
    for part in ("b", "b8", "f32", "q8"):
        for x, y in zip(outs["const"][part], outs["rows"][part]):
            assert torch.equal(x, y), part
    assert not torch.equal(outs["pixel"]["b"][0], outs["rows"]["b"][0])


@pytest.mark.cuda
def test_chan_layouts_refused_on_card(cuda_device):
    """A per-pixel map whose pixel count does not divide the rows, or rows
    of the wrong width, raise before any launch."""
    dev = cuda_device
    u = torch.rand((64, 8), device=dev)
    theta = torch.ones((), device=dev)
    cuda_lib.reset_launch_counts()
    with pytest.raises(ValueError, match="whole frames"):
        tk.p2m_phase_b(u, theta, prng.PRNGKey(0),
                       chan=torch.ones((4, 48, 8), device=dev))
    with pytest.raises(ValueError, match="chan must be"):
        tk.p2m_phase_b(u, theta, prng.PRNGKey(0),
                       chan=torch.ones((4, 16, 9), device=dev))
    assert cuda_lib.launch_counts()["p2m_phase_b"] == 0


@pytest.mark.cuda
def test_calibrated_engine_launches_the_kernels_with_the_chip(cuda_device,
                                                              monkeypatch):
    """A sampled, calibrated chip served on the card: the calibration and
    the sampled chip match the CPU's (trim within 8 * span / 2^iters), the
    f32 path launches A, B and fused, and each step's draws follow the
    chip's (4, C) rows by the word-boundary rule."""
    from repro_torch.core import p2m as tp2m
    from repro_torch.frontend import backends
    from repro_torch.variation import VariationConfig, calibrate
    from repro_torch.variation.chip import channel_operands
    monkeypatch.setattr(autotune, "_TABLE", {})
    vcfg = VariationConfig(sigma_logit_offset=0.4, sigma_pixel_offset=0.25,
                           sigma_pixel_gain=0.05, sigma_column=0.15)
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny", variation=vcfg,
                          chip_id=3)
    params = tv.init_params(0, cfg)
    frames = torch.rand((4, 32, 32, 3),
                        generator=torch.Generator().manual_seed(5))
    art = calibrate(params["p2m"], cfg.p2m, vcfg, frames, chip_id=3)
    art_cpu = calibrate(tv.init_params(0, cfg, device="cpu")["p2m"],
                        cfg.p2m, vcfg, frames, chip_id=3, device="cpu")
    assert art.trim.device.type == "cuda"
    torch.testing.assert_close(art.trim.cpu(), art_cpu.trim, rtol=0,
                               atol=8 * 2.0 / 2 ** 16)
    engine = VisionEngine(cfg, params, microbatch=4, calibration=art)
    assert engine.params["p2m"]["cal_trim"].device.type == "cuda"
    counts = _run_engine(engine)
    assert {k for k, v in counts.items() if v} == F32_PATH
    chip = backends._sampled_chip(cfg.frontend, frames.to(cuda_device).device)
    chan = channel_operands(chip, engine.params["p2m"]["cal_trim"])
    key = prng.PRNGKey(9)
    x = frames.to(cuda_device)
    o, aux = backends.cuda_backend(cfg.frontend, engine.params["p2m"], x, key)
    wq = tp2m.quantize_weights(engine.params["p2m"]["w"], 4)
    u, _ = tk.p2m_phase_a_implicit_plain(
        x, tk.pack_phase_weights(wq.reshape(27, 32)),
        engine.params["p2m"]["v_th"], kernel=3, stride=2)
    _draw_rule(o.reshape(-1, 32), tk.device_chain_q(u, aux["theta"], chan)[0],
               tk.draw_bits(key, u.shape[0], 32))


# --- an aging chip ----------------------------------------------------------

LIFETIME_VPROFILE = dict(sigma_logit_offset=0.4, sigma_pixel_offset=0.25,
                         sigma_pixel_gain=0.05, sigma_column=0.15)
LIFETIME_DPROFILE = dict(sigma_logit_offset=0.2, sigma_logit_gain=0.05,
                         sigma_r_p=0.03, sigma_tmr=0.03, tmr_retention=0.01,
                         sigma_pixel_gain=0.03, pixel_gain_aging=0.01,
                         sigma_pixel_offset=0.15, tau_frames=100.0,
                         temp_amplitude_c=10.0, temp_period_frames=512.0)


@pytest.mark.cuda
@pytest.mark.parametrize("age", [3e2, 1e5])
def test_aged_rows_in_kernels_b_and_fused_on_card(cuda_device, age):
    """A sampled chip aged to ``age`` with the trim linspace(-0.1, 0.1, C),
    folded into the (4, C) rows, at the serving shape: kernel B's draws
    equal its plain version's bit for bit and its V_CONV min / max too
    (the mean within 1e-5: another summation order); the fused kernel at
    A's theta equals A -> B bit for bit and its plain version's draws."""
    from repro_torch import lifetime as tlt
    from repro_torch.variation import VariationConfig, sample_chip
    from repro_torch.variation.chip import channel_operands
    dev = cuda_device
    chip = sample_chip(VariationConfig(**LIFETIME_VPROFILE), 32, 8, 5,
                       device=dev)
    dcfg = tlt.DriftConfig(**LIFETIME_DPROFILE)
    maps = tlt.sample_drift_maps(dcfg, 32, 8, 5, device=dev)
    chan = channel_operands(tlt.evolve_chip(chip, maps, age, dcfg=dcfg),
                            torch.linspace(-0.1, 0.1, 32, device=dev))
    rng = np.random.default_rng(int(age))
    images = torch.tensor(rng.uniform(size=(16, 32, 32, 3)),
                          dtype=torch.float32, device=dev)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(27, 32)) * 0.3, dtype=torch.float32)).to(dev)
    v_th = torch.ones((), device=dev)
    key = prng.PRNGKey(23)
    kw = dict(kernel=3, stride=2)
    u, hp = tk.p2m_phase_a_implicit(images, wp, v_th, **kw)
    theta = tk.combine_hoyer_partials(hp, v_th)
    acts, vp = tk.p2m_phase_b(u, theta, key, chan=chan)
    acts_p, vp_p = tk.p2m_phase_b_plain(u, theta, key, chan=chan)
    assert torch.equal(acts, acts_p)
    n = u.shape[0]
    v_k = tk.combine_v_conv_partials(vp, n, 32)
    v_p = tk.combine_v_conv_partials(vp_p, n, 32)
    assert torch.equal(v_k["v_conv_min"], v_p["v_conv_min"])
    assert torch.equal(v_k["v_conv_max"], v_p["v_conv_max"])
    torch.testing.assert_close(v_k["v_conv_mean"], v_p["v_conv_mean"],
                               rtol=0, atol=1e-5)
    fused = tk.p2m_fused_stream(images, wp, v_th, theta, key, chan, **kw)
    assert torch.equal(fused[0], acts)
    fused_p = tk.p2m_fused_stream_plain(images, wp, v_th, theta, key, chan,
                                        **kw)
    assert torch.equal(fused[0], fused_p[0])


def _aging_engines(cuda_device, policy):
    from repro_torch import lifetime as tlt
    from repro_torch.variation import VariationConfig, calibrate
    vcfg = VariationConfig(**LIFETIME_VPROFILE)
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny", variation=vcfg,
                          chip_id=3)
    params = tv.init_params(0, cfg, device=cuda_device)
    cal = torch.rand((8, 32, 32, 3),
                     generator=torch.Generator().manual_seed(7))
    art = calibrate(params["p2m"], cfg.p2m, vcfg, cal, chip_id=3, iters=12,
                    device=cuda_device)
    kw = dict(microbatch=16, drift=tlt.DriftConfig(**LIFETIME_DPROFILE),
              schedule=policy, calibration_frames=cal)
    engine = VisionEngine(cfg, params, device=cuda_device, calibration=art,
                          **kw)
    from repro_torch.models import params as tp
    cpu = torch.device("cpu")
    engine_cpu = VisionEngine(cfg, tp.to_device(engine.params, cpu),
                              device=cpu, **kw)
    return cfg, engine, engine_cpu


@pytest.mark.cuda
def test_aging_engine_on_card_matches_the_cpu(cuda_device, monkeypatch):
    """An aging, calibrated vgg_tiny engine refreshed every 32 frames,
    card vs CPU by ``chip_smoke.py``'s rules: the card launches A, B and
    fused and no refresh launches a P2M kernel; ages and refresh steps
    equal; every step's aged (4, C) rows within 1e-6 relative to max(|row|,
    1) at the card's trim; every trim within 8 bisection steps; the
    classify by ``compare_with_cpu`` on the step's aged chip."""
    from repro_torch.lifetime import SchedulePolicy
    cs = _chip_smoke()
    monkeypatch.setattr(autotune, "_TABLE", {})
    policy = SchedulePolicy(period_frames=32, cal_iters=12)
    cfg, engine, engine_cpu = _aging_engines(cuda_device, policy)
    gen = torch.Generator().manual_seed(8)
    frames = [torch.rand((16, 32, 32, 3), generator=gen) for _ in range(5)]
    cuda_lib.reset_launch_counts()
    outs, states, _, refresh_launches, _ = cs.lifetime_run(engine, frames,
                                                          cuda_device)
    counts = cuda_lib.launch_counts()
    assert {k for k, v in counts.items() if v} == F32_PATH
    assert refresh_launches == [0, 0]
    outs_cpu, states_cpu, _, _, _ = cs.lifetime_run(
        engine_cpu, frames, torch.device("cpu"))
    assert [a for a, _ in states] == [a for a, _ in states_cpu]
    assert ([o["lifetime_recal_fired"] for o in outs]
            == [o["lifetime_recal_fired"] for o in outs_cpu]
            == [0.0, 1.0, 0.0, 1.0, 0.0])
    for (age, trim), (_, trim_cpu) in zip(states, states_cpu):
        rows = cs.aged_rows(engine, age, trim).cpu()
        rows_cpu = cs.aged_rows(engine_cpu, age, trim.cpu())
        assert float(((rows - rows_cpu).abs()
                      / rows_cpu.abs().clamp(min=1.0)).max()) <= 1e-6
        torch.testing.assert_close(trim.cpu(), trim_cpu, rtol=0,
                                   atol=8 * 2.0 / 2 ** 12)
    st = engine.lifetime
    assert st.trim.device.type == cuda_device.type and st.age_frames == 80
    params0 = {**engine.params, "p2m": {
        **engine.params["p2m"], "cal_trim": states[0][1],
        "chip": engine._evolve(st.chip0, st.maps, 0)}}
    cs.compare_with_cpu(cfg, params0, frames, outs[0], [], cuda_device,
                        "f32")


@pytest.mark.cuda
def test_refresh_launches_no_p2m_kernel(cuda_device, monkeypatch):
    """A refresh runs the plain chain on the stored u: no P2M kernel
    launches, and the trim it solves lies on the card."""
    from repro_torch.lifetime import SchedulePolicy
    monkeypatch.setattr(autotune, "_TABLE", {})
    _, engine, _ = _aging_engines(cuda_device,
                                  SchedulePolicy(period_frames=8, cal_iters=6))
    st = engine.lifetime
    aged = engine._evolve(st.chip0, st.maps, 10 ** 4)
    cuda_lib.reset_launch_counts()
    trim = engine._scheduler.recalibrate(aged)
    fleet = engine._scheduler.recalibrate_fleet(
        type(aged)(*(torch.stack([m, m]) for m in aged)))
    assert all(v == 0 for v in cuda_lib.launch_counts().values())
    assert trim.device.type == cuda_device.type
    assert tuple(fleet.shape) == (2, 32)
    assert torch.equal(fleet[0], fleet[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_weights_on_the_card_equal_the_cpus(cuda_device, bits):
    """On CUDA a Python-float divisor is applied as a multiply by its
    reciprocal, up to an ulp off. At max|w| = 0.34280804, m * (1 / 7) and
    m / 7 differ by an ulp, and weights at or next to a rounding boundary
    of the 4-bit grid (12 of those below) would quantize to the next
    step. The port divides by a tensor: the card's quantized weights, and
    the int8 packed scales, equal the CPU's bit for bit."""
    from repro_torch.core import p2m as tp2m
    m = np.float32(0.34280804)
    base = ((np.arange(-7, 7, dtype=np.float32) + np.float32(0.5))
            * np.float32(m / np.float32(7))).astype(np.float32)
    w = torch.tensor(np.concatenate([
        base, np.nextafter(base, np.float32(np.inf)),
        np.nextafter(base, np.float32(-np.inf)), [m]]))
    recip = torch.tensor(m) * (torch.tensor(1.0) / 7.0)
    assert int((torch.round(w / recip)
                != torch.round(w / (torch.tensor(m) / 7.0))).sum()) == 12
    rng = np.random.default_rng(bits)
    big = torch.tensor(rng.normal(size=(3, 3, 512, 512)) * 0.02,
                       dtype=torch.float32)
    for x in (w, big):
        assert torch.equal(tp2m.quantize_weights(x.to(cuda_device),
                                                 bits).cpu(),
                           tp2m.quantize_weights(x, bits))
    wm = big.reshape(-1)[:27 * 64].reshape(27, 64).abs()
    for a, b in zip(tp2m.quantize_packed_weights(wm.to(cuda_device)),
                    tp2m.quantize_packed_weights(wm)):
        assert torch.equal(a.cpu(), b)


# --- the vision train step -------------------------------------------------

def _chip_smoke():
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
def test_train_step_matches_the_cpu(cuda_device, monkeypatch):
    """One step of vgg_tiny (the Fig. 8 flips on) card vs CPU by
    ``chip_smoke.train_vs_cpu``: the flip words bit for bit, every stage
    from the CPU's input (maps by the 4-ulp threshold rule, EMA stats at
    1e-5, each leaf's gradient from the CPU's cotangent at 1e-4 of its RMS,
    held to the exact float64 one, and with cuDNN's TF32 on in the
    backward visibly off the gated card gradient), the whole step's loss
    where the card spiked every unit as the CPU did."""
    from repro_torch.core import p2m as tp2m
    from repro_torch.data import ImageStream
    cs = _chip_smoke()
    monkeypatch.setattr(autotune, "_TABLE", {})
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny", frontend_backend="analog",
                          p2m=tp2m.P2MConfig(noise_p_fail=0.01,
                                             noise_p_false=0.01))
    params = tv.init_params(0, cfg, device=cuda_device)
    batch = ImageStream(global_batch=16, device=cuda_device).next_batch()
    out = cs.train_vs_cpu(cfg, params, batch, prng.PRNGKey(3), cuda_device)
    assert out["flip_words_equal"] == 2 * 16 * 16 * 16 * 32
    assert out["max_grad_rel_err_tf32"] >= cs.TF32_VISIBLE
    for row in out["stages"].values():
        assert all(h["ok"] for h in row["grad_rel_err"].values())


@pytest.mark.cuda
def test_tf32_in_the_backward_follows_the_flags_at_backward_time(
        cuda_device):
    """A conv's backward runs inside ``autograd.grad`` and reads cuDNN's
    TF32 flag then, not at the forward: the forward under TF32 off, the
    backward with TF32 on moves the weight gradient off the CPU's; the
    backward under the same flags as the forward (``train.vision``) holds
    it at 1e-4 of its RMS."""
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    lp = {"w": torch.tensor(rng.normal(size=(3, 3, 64, 64)) * 0.06,
                            dtype=torch.float32),
          "bn_scale": torch.ones(64), "bn_bias": torch.zeros(64),
          "bn_mean": torch.zeros(64), "bn_var": torch.ones(64),
          "v_th": torch.tensor(1.0)}
    x = torch.tensor(rng.uniform(size=(16, 64, 16, 16)) > 0.7,
                     dtype=torch.float32)
    cot = torch.tensor(rng.normal(size=(16, 64, 16, 16)),
                       dtype=torch.float32)
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    _, g_cpu = cs.stage_vjp(cfg, "conv0", 0, lp, x, None, cot, 1e-8, False)
    lp_dev = {k: v.to(cuda_device) for k, v in lp.items()}
    args = (cfg, "conv0", 0, lp_dev, x.to(cuda_device), None,
            cot.to(cuda_device), 1e-8)
    _, g_off = cs.stage_vjp(*args, False)
    _, g_on = cs.stage_vjp(*args, True)
    assert cs._rel_err(g_cpu["w"], g_off["w"]) <= cs.TRAIN_GRAD_TOL
    assert cs._rel_err(g_cpu["w"], g_on["w"]) >= cs.TF32_VISIBLE


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(16, 16), (7, 7), (5, 8), (1, 3)])
def test_max_pool_gradient_ties_go_where_the_cpu_sends_them(cuda_device, h,
                                                            w):
    """On binary maps every 2x2 window is a tie; the CPU (as XLA's
    select-and-scatter) sends its gradient to the first maximum in
    row-major order, and so must the card, ceil_mode's partial windows at
    odd sizes included."""
    rng = np.random.default_rng(h * 31 + w)
    x = torch.tensor(rng.uniform(size=(4, 8, h, w)) > 0.5,
                     dtype=torch.float32)
    g = torch.tensor(rng.normal(size=tv._maxpool(x).shape),
                     dtype=torch.float32)
    grads = []
    for dev in (torch.device("cpu"), cuda_device):
        xd = x.to(dev).requires_grad_(True)
        (gx,) = torch.autograd.grad(tv._maxpool(xd), xd,
                                    grad_outputs=g.to(dev))
        grads.append(gx.cpu())
    assert torch.equal(grads[0], grads[1])

# (batch, seq, heads, kv_heads, head_dim, dtype, causal): the LM serving
# geometry and the odd ones chip_smoke.py also checks; then the wgmma
# kernel at D 128 at S 1, 100, 128, 129 and 2048, causal and not, GQA 4:1
# (granite-8b), 7:1 (yi-34b) and 16:1 (glm4-9b); then D 80 (stablelm-3b);
# then the wgmma kernel at D 64 and 80 over S 1, 77, 128, 129 (one row
# past a tile), 1000 (a ragged tail) and 2048, causal and not, MHA and GQA
# 4:1; then the wgmma kernel at D 16 and 32 and the FFMA kernel at every
# head dim over the same lengths, causal and not, MHA, GQA 4:1 and 7:1
FLASH_GEOMETRIES = [(4, 2048, 32, 8, 128, torch.bfloat16, True),
                    (2, 77, 4, 4, 64, torch.bfloat16, True),
                    (2, 256, 8, 2, 128, torch.float32, False),
                    (1, 1000, 32, 8, 128, torch.bfloat16, True),
                    (2, 100, 4, 2, 16, torch.float32, True),
                    (1, 130, 2, 1, 32, torch.bfloat16, False),
                    (3, 1, 4, 2, 64, torch.bfloat16, True),
                    (1, 65, 8, 8, 128, torch.float32, True),
                    (2, 1, 32, 8, 128, torch.bfloat16, True),
                    (1, 1, 8, 2, 128, torch.bfloat16, False),
                    (2, 100, 8, 2, 128, torch.bfloat16, False),
                    (2, 100, 56, 8, 128, torch.bfloat16, True),
                    (1, 128, 56, 8, 128, torch.bfloat16, True),
                    (2, 128, 32, 2, 128, torch.bfloat16, False),
                    (1, 129, 32, 2, 128, torch.bfloat16, True),
                    (2, 129, 56, 8, 128, torch.bfloat16, False),
                    (1, 2048, 56, 8, 128, torch.bfloat16, True),
                    (1, 2048, 32, 2, 128, torch.bfloat16, False),
                    (1, 2048, 32, 32, 80, torch.bfloat16, True),
                    (2, 100, 4, 4, 80, torch.bfloat16, False),
                    (1, 130, 4, 2, 80, torch.float32, True),
                    (1, 77, 8, 8, 80, torch.float32, False)] + [
    (1 if s >= 1000 else 2, s, 8, hkv, d, torch.bfloat16, causal)
    for d, s, causal, hkv in itertools.product(
        (64, 80), (1, 77, 128, 129, 1000, 2048), (True, False), (8, 2))] + [
    (1 if s >= 1000 else 2, s, h, hkv, d, dtype, causal)
    for (dtype, d), s, causal, (h, hkv) in itertools.product(
        [(torch.bfloat16, 16), (torch.bfloat16, 32)]
        + [(torch.float32, d) for d in (16, 32, 64, 80, 128)],
        (1, 77, 128, 129, 1000, 2048), (True, False),
        ((8, 8), (8, 2), (14, 2)))]
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the largest error of an output row over that row's RMS, so that a fault in
# the small late causal rows cannot hide under the absolute limit
FLASH_ROW_TOL = {torch.bfloat16: 1e-1, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,dtype,causal", FLASH_GEOMETRIES)
def test_flash_kernel_matches_plain_on_card(cuda_device, b, s, h, hkv, d,
                                            dtype, causal):
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device, dtype)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention.launches == 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt()
    assert float(row_err.max()) <= FLASH_ROW_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [
    *((d, torch.bfloat16) for d in (16, 32, 64, 80, 112, 128, 256)),
    *((d, torch.float32) for d in (16, 80, 128))])
def test_flash_kernel_reads_strided_operands(cuda_device, d, dtype):
    """q, k, v sliced out of one packed projection (no copies) give the
    same result as contiguous copies, bit for bit, through the wgmma
    kernel's tensor maps and the FFMA kernel's row loads. At D 80 and 112
    a tile row's second 64-column box reaches 48 and 16 columns past the
    head, and at D 16 and 32 the one box 48 and 32, into the next heads
    of the projection: the map ends at column D, so those columns arrive
    as zeros."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, 96, 4 + 2 * 2, d), generator=gen).to(
        cuda_device, dtype)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_flash_dispatch_has_one_kernel_per_dtype_and_head_dim(cuda_device):
    """bf16 goes to the wgmma kernel at every (D, Dv) pair, float32 to the
    FFMA kernel; the MLA pair (192, 128) is ``flash_wgmma_kernel<192, W>``,
    the only D 192 instance; a profiled call at each (dtype, D, Dv) shows
    that kernel ran (and no other flash kernel)."""
    from torch.profiler import ProfilerActivity, profile
    bf16, f32 = torch.bfloat16, torch.float32
    want = {bf16: "flash_wgmma_kernel", f32: "flash_ffma_kernel"}
    for dtype, symbol in want.items():
        for d, dv in fa.HEAD_DIM_PAIRS[dtype]:
            for window, flag in ((0, "false"), (300, "true")):
                assert fa.kernel_symbol(dtype, d, window, v_dim=dv) == \
                    f"{symbol}<{d}, {flag}>"
    assert fa.kernel_symbol(bf16, 112) == "flash_wgmma_kernel<112, false>"
    for dtype, d, dv in ((bf16, 48, 48), (f32, 256, 256), (f32, 112, 112),
                         (bf16, 192, 192), (bf16, 128, 64),
                         (f32, 192, 128)):
        with pytest.raises(ValueError, match="no flash kernel"):
            fa.kernel_symbol(dtype, d, v_dim=dv)
    for dtype in want:
        for (d, dv), window in itertools.product(fa.HEAD_DIM_PAIRS[dtype],
                                                 (0, 100)):
            q = torch.randn((1, 256, 8, d), device=cuda_device, dtype=dtype)
            k = torch.randn((1, 256, 2, d), device=cuda_device, dtype=dtype)
            v = torch.randn((1, 256, 2, dv), device=cuda_device, dtype=dtype)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fa.flash_attention(q, k, v, causal=True, window=window)
                torch.cuda.synchronize()
            names = [e.key for e in prof.key_averages() if "flash" in e.key]
            assert len(names) == 1 and fa.kernel_symbol(
                dtype, d, window, v_dim=dv) in names[0], (dtype, d, window,
                                                          names)


@pytest.mark.cuda
def test_flash_library_tensor_cores(cuda_device):
    """Every flash_wgmma_kernel instance (each (D, Dv) pair, with and
    without a window) runs wgmma (HGMMA) and no mma.sync (HMMA); the
    float32 kernel runs neither (IEEE FFMA, no TF32)."""
    census = cuda_lib.tensor_core_census(cuda_lib.build(cuda_lib.FLASH),
                                         ("HMMA", "HGMMA"))
    wgmma = {k: v for k, v in census.items() if "flash_wgmma_kernel" in k}
    ffma = {k: v for k, v in census.items() if "flash_ffma_kernel" in k}
    assert len(wgmma) == 2 * len(fa.HEAD_DIM_PAIRS[torch.bfloat16])
    assert len(ffma) == 2 * len(fa.HEAD_DIM_PAIRS[torch.float32])
    assert len(census) == len(wgmma) + len(ffma)
    for d in (112, 192, 256):
        assert sum(f"ILi{d}E" in k for k in wgmma) == 2
    assert all(hmma == 0 and hgmma >= 1 for hmma, hgmma in wgmma.values())
    assert all(v == (0, 0) for v in ffma.values())


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 64, 4, 64), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.float(), k)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48], k[..., :48], k[..., :48])
    # an unbuilt (D, Dv) pair raises, naming the pairs; MLA's launches
    with pytest.raises(ValueError, match=r"value dim 32.*\(192, 128\)"):
        fa.flash_attention(q, k, k[..., :32].contiguous())
    q192 = torch.zeros((1, 64, 4, 192), device=cuda_device,
                       dtype=torch.bfloat16)
    k192 = torch.zeros((1, 64, 2, 192), device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="value dim 192"):
        fa.flash_attention(q192, k192, k192)
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q192, k192, k192[..., :128].contiguous())
    assert fa.flash_attention.launches == 1
    assert tuple(out.shape) == (1, 64, 4, 128)
    q256 = torch.zeros((1, 64, 4, 256), device=cuda_device)
    k256 = torch.zeros((1, 64, 2, 256), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 256"):   # float32
        fa.flash_attention(q256, k256, k256, window=16)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=-1)
    with pytest.raises(ValueError, match="unit-stride"):
        fa.flash_attention(q[..., ::2], k[..., ::2], k[..., ::2])
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :, :3], k, k)
    with pytest.raises(ValueError, match="several devices"):
        fa.flash_attention(q, k.cpu(), k)


@pytest.mark.cuda
def test_lm_engine_launches_flash_once_per_layer(cuda_device, monkeypatch):
    """The card's engine launches the kernel once per layer and never
    reaches the plain version; it agrees with the CPU engine."""
    from repro_torch.models import blocks
    cfg = dataclasses.replace(reduced(get_arch("granite-8b")), num_kv_heads=2,
                              num_layers=3)
    params = tlm.init_params(0, cfg)              # float32, on the CPU
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, params, max_len=48)
    cuda_lib.reset_launch_counts()
    with monkeypatch.context() as m:
        def refuse(*args, **kwargs):
            raise AssertionError("the plain version ran on the card path")
        m.setattr(fa, "flash_attention_plain", refuse)
        m.setattr(blocks, "flash_attention_plain", refuse)
        out = engine.generate(prompts, 6)
    counts = cuda_lib.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {"flash_attention": 3}
    cpu = ServingEngine(cfg, params, max_len=48, device="cpu")
    assert torch.equal(out.cpu(), cpu.generate(prompts, 6))
    torch.testing.assert_close(engine.prefill_logits.cpu(),
                               cpu.prefill_logits, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_model_attention_refuses_what_the_kernel_does_not_compute(
        cuda_device):
    """No silent plain fallback on the card: a (D, Dv) pair no kernel is
    built for raises, a causal call at unequal lengths raises (naming the
    rule) and so does a q offset; a window launches the kernel (its
    windowed instance), and so do MLA's (192, 128) and a non-causal call
    at unequal lengths (the cross-attention)."""
    from repro_torch.models import blocks
    q = torch.zeros((1, 32, 4, 16), device=cuda_device)
    k = torch.zeros((1, 32, 2, 16), device=cuda_device)
    cuda_lib.reset_launch_counts()
    blocks.flash_attention(q, k, k, causal=True, window=8)
    assert cuda_lib.launch_counts()["flash_attention"] == 1
    with pytest.raises(ValueError, match="value dim 8"):
        blocks.flash_attention(q, k, k[..., :8].contiguous(), causal=True)
    bf16 = torch.bfloat16
    cuda_lib.reset_launch_counts()
    out = blocks.flash_attention(
        torch.zeros((1, 32, 4, 192), device=cuda_device, dtype=bf16),
        torch.zeros((1, 32, 4, 192), device=cuda_device, dtype=bf16),
        torch.zeros((1, 32, 4, 128), device=cuda_device, dtype=bf16),
        causal=True)
    assert cuda_lib.launch_counts()["flash_attention"] == 1
    assert tuple(out.shape) == (1, 32, 4, 128)
    with pytest.raises(ValueError, match="unequal lengths only without"):
        blocks.flash_attention(q[:, :16], k, k, causal=True)
    with pytest.raises(NotImplementedError, match="q offset"):
        blocks.flash_attention(q, k, k, causal=True, q_offset=4)
    cuda_lib.reset_launch_counts()
    blocks.flash_attention(q, k, k, causal=True)
    out = blocks.flash_attention(q[:, :16], k, k, causal=False)
    assert cuda_lib.launch_counts()["flash_attention"] == 2
    assert tuple(out.shape) == (1, 16, 4, 16)


# (Sq, Sk): kv longer and shorter than q, each ragged against the 128-row q
# tiles and the 64-, 80- and 128-row kv tiles, one row of queries, and
# whisper-base's three prefill geometries at a reduced batch (the encoder's
# 1500 frames, 11 x 128 + 92, ragged on both sides at once; the cross
# block's 224 queries over them)
UNEQUAL_LENGTHS = [(8, 24), (24, 8), (130, 1500), (1500, 130), (1, 77),
                   (77, 1), (200, 129), (1500, 1500), (224, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", UNEQUAL_LENGTHS)
@pytest.mark.parametrize("dtype,d,dv", [
    *((torch.bfloat16, d, dv) for d, dv in fa.HEAD_DIM_PAIRS[torch.bfloat16]),
    *((torch.float32, d, dv) for d, dv in fa.HEAD_DIM_PAIRS[torch.float32])])
def test_flash_kernels_take_unequal_lengths(cuda_device, sq, sk, dtype, d,
                                            dv):
    """Both routes, at every (D, Dv) they are built for, non-causal over a
    kv length of its own: one launch, against the plain version on the
    same card tensors (max-abs and the row gate); a kernel that mapped or
    masked K and V at Sq would drop or zero keys, far outside both."""
    gen = torch.Generator().manual_seed(sq * 7 + sk + d)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device, dtype)
               for shape in ((2, sq, 4, d), (2, sk, 2, d), (2, sk, 2, dv)))
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q, k, v, causal=False)
    assert fa.flash_attention.launches == 1
    plain = fa.flash_attention_plain(q, k, v, causal=False)
    assert out.dtype == dtype and tuple(out.shape) == (2, sq, 4, dv)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt()
    assert float(row_err.max()) <= FLASH_ROW_TOL[dtype]
    # the keys past Sq count: the same queries over the first Sq keys only
    # give another answer
    if sk > sq and sq > 1:
        short = fa.flash_attention(q, k[:, :sq].contiguous(),
                                   v[:, :sq].contiguous(), causal=False)
        assert float((short.float() - out.float()).abs().max()) > 0.1


@pytest.mark.cuda
def test_whisper_engine_on_card_matches_the_cpu(cuda_device, monkeypatch):
    """Reduced whisper-base (float32, D 16: ``flash_ffma_kernel<16,
    false>``) on the card against the CPU engine: in the prefill one flash
    launch an encoder layer and two a decoder layer (its self-attention,
    causal, and its cross-attention over the 24 frames at Sq != Sk), none
    in decode, the plain version never run; greedy tokens equal, prefill
    logits within 1e-4."""
    cfg = reduced(get_arch("whisper-base"))
    params = tlm.init_params(0, cfg)              # float32, on the CPU
    prompts = torch.randint(0, cfg.vocab_size, (2, 10),
                            generator=torch.Generator().manual_seed(10))
    emb = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                      generator=torch.Generator().manual_seed(11))
    engine = ServingEngine(cfg, params, max_len=20)
    cuda_lib.reset_launch_counts()
    with monkeypatch.context() as m:
        from repro_torch.models import blocks

        def refuse(*args, **kwargs):
            raise AssertionError("the plain version ran on the card path")
        m.setattr(fa, "flash_attention_plain", refuse)
        m.setattr(blocks, "flash_attention_plain", refuse)
        out = engine.generate(prompts, 6, encoder_embeddings=emb)
    assert {k: v for k, v in cuda_lib.launch_counts().items() if v} == {
        "flash_attention": cfg.encoder_layers + 2 * cfg.num_layers}
    cpu = ServingEngine(cfg, params, max_len=20, device="cpu")
    assert torch.equal(out.cpu(), cpu.generate(prompts, 6,
                                               encoder_embeddings=emb))
    torch.testing.assert_close(engine.prefill_logits.cpu(),
                               cpu.prefill_logits, rtol=0, atol=1e-4)


# --- deepseek-v2 and kimi-k2: the (192, 128) and D 112 flash instances, MLA
# and MoE on the card ------------------------------------------------------

# (batch, seq, heads, kv_heads, head_dim, value_dim, causal, window):
# deepseek-v2's MLA prefill (B 4, S 2048, 128 heads, qk 192 over v 128) and
# kimi-k2's (64 heads over 8, D 112), then small and ragged lengths, S 1,
# one row past a tile, GQA, non-causal, and each with a window
FLASH_PAIR_GEOMETRIES = [
    (4, 2048, 128, 128, 192, 128, True, 0),
    (4, 2048, 64, 8, 112, 112, True, 0),
    (2, 77, 4, 4, 192, 128, True, 0),
    (1, 1000, 8, 8, 192, 128, True, 0),
    (2, 129, 8, 2, 192, 128, False, 0),
    (3, 1, 4, 4, 192, 128, True, 0),
    (1, 2048, 16, 16, 192, 128, False, 0),
    (1, 500, 4, 4, 192, 128, True, 100),
    (2, 77, 8, 8, 112, 112, True, 0),
    (1, 1000, 14, 2, 112, 112, True, 0),
    (2, 129, 8, 2, 112, 112, False, 0),
    (3, 1, 4, 2, 112, 112, True, 0),
    (1, 2048, 16, 2, 112, 112, False, 0),
    (1, 1000, 8, 2, 112, 112, True, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,dv,causal,window",
                         FLASH_PAIR_GEOMETRIES)
def test_mla_and_d112_flash_kernels_match_plain_on_card(
        cuda_device, b, s, h, hkv, d, dv, causal, window):
    gen = torch.Generator().manual_seed(s + d + window)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv)))
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, s, h, dv)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[torch.bfloat16])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt()
    assert float(row_err.max()) <= FLASH_ROW_TOL[torch.bfloat16]


def _hold_flash_to_plain(q, k, v, causal, window):
    """One launch of the kernel on (q, k, v), held to the plain version at
    the bf16 gates (max-abs, and the row error over the row's RMS)."""
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == plain.shape
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[q.dtype])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt().clamp_min(1e-30)
    assert float(row_err.max()) <= FLASH_ROW_TOL[q.dtype]


# D 112 at its kv tiles' boundaries: S one short of, at and one past one,
# two and five tiles (the design's kv rows), causal and not, and windows
# one short of and one past a tile, whose back edge crosses every tile
# boundary: (tiles, offset, causal, window tiles, window offset)
D112_TILE_CASES = [(1, -1, True, 0, 0), (1, 0, True, 0, 0),
                   (1, 1, True, 0, 0), (2, -1, False, 0, 0),
                   (2, 0, True, 0, 0), (2, 1, True, 0, 0),
                   (2, 1, False, 0, 0), (5, 3, True, 1, -1),
                   (5, 3, True, 1, 1), (5, -1, False, 2, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,offset,causal,w_tiles,w_offset",
                         D112_TILE_CASES)
def test_d112_flash_kernel_at_its_kv_tile_boundaries(
        cuda_device, tiles, offset, causal, w_tiles, w_offset):
    rows = fa.design(torch.bfloat16, 112)["kv_rows"]
    s = tiles * rows + offset
    window = w_tiles * rows + w_offset if w_tiles else 0
    gen = torch.Generator().manual_seed(s + window)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
               for shape in ((2, s, 8, 112), (2, s, 2, 112), (2, s, 2, 112)))
    _hold_flash_to_plain(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["linear", "random"])
def test_d112_flash_kernel_over_the_whole_exponent_range(cuda_device,
                                                         sweep):
    """Scores whose exponents e^(scale (s - m)) = 2^x sweep x from 0 to
    below -126 along each row, where exp2 underflows: "linear" gives key j
    the score -0.955 j (x = -0.13 j, every row's max at key 0), "random"
    scales q by 14 (a raw-score spread of ~950). Across ex2's whole range
    and its underflow the kernel holds to the plain version at the bf16
    gates."""
    gen = torch.Generator().manual_seed(31)
    s = 1000
    q = torch.randn((2, s, 8, 112), generator=gen) * 0.01
    k = torch.randn((2, s, 2, 112), generator=gen) * 0.01
    v = torch.randn((2, s, 2, 112), generator=gen)
    if sweep == "linear":
        q[..., 0] = 1.0
        k[..., 0] = -0.955 * torch.arange(s, dtype=torch.float32)[:, None]
    else:
        q, k = q * 1400.0, k * 100.0
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    for causal in (True, False):
        _hold_flash_to_plain(q, k, v, causal, 0)


@pytest.mark.cuda
def test_flash_design_names_each_instance(cuda_device):
    """``fa.design`` reports each built instance's layout: 128-row q
    tiles; 128-row kv tiles but at D 256 (80 rows, work from a counter, no
    turns); the consumers' turns from D 64 to 192; D 112 alone chains its
    work items; float32's 64-row kv tiles; an unbuilt pair raises."""
    for d, dv in fa.HEAD_DIM_PAIRS[torch.bfloat16]:
        got = fa.design(torch.bfloat16, d, dv)
        assert tuple(got) == fa.DESIGN_FIELDS and got["q_rows"] == 128
        assert got["kv_rows"] == (80 if d == 256 else 128)
        assert got["dynamic"] == (d == 256)
        assert got["ping_pong"] == (32 < d < 256)
        assert got["chained"] == (d == 112)
        assert got["stages"] == (2 if d in (192, 256) else 3)
    assert fa.design(torch.float32, 128)["kv_rows"] == 64
    with pytest.raises(ValueError, match="no flash kernel"):
        fa.design(torch.bfloat16, 96)


@pytest.mark.cuda
def test_mla_flash_reads_strided_operands(cuda_device):
    """MLA's k and v sliced out of one packed (192 + 128)-wide projection
    and q out of a wider one (no copies) give the contiguous copies'
    result bit for bit: V's tensor map ends at its own 128 columns."""
    gen = torch.Generator().manual_seed(4)
    bf16 = torch.bfloat16
    kv = torch.randn((2, 96, 4, 320), generator=gen).to(cuda_device, bf16)
    qp = torch.randn((2, 96, 4, 256), generator=gen).to(cuda_device, bf16)
    q, k, v = qp[..., :192], kv[..., :192], kv[..., 192:]
    assert not (q.is_contiguous() or k.is_contiguous() or v.is_contiguous())
    out = fa.flash_attention(q, k, v, causal=True)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    assert torch.equal(out, ref)


def _served_reduced(name: str):
    """reduced deepseek-v2 / kimi-k2 in bf16 at the full models' attention
    widths (MLA qk 192 over v 128; head dim 112), so the card runs the
    instances the full models launch."""
    cfg = reduced(get_arch(name))
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    if cfg.kv_lora_rank:
        over.update(head_dim=128, rope_head_dim=64)
    else:
        over.update(head_dim=112)
    return dataclasses.replace(cfg, **over)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_engines_launch_flash_once_per_layer(cuda_device, monkeypatch,
                                                 name):
    """The card's engine runs every MLA or attention layer's prefill through
    the kernel (one launch a layer, nothing else of the port, never the
    plain version); the prefill logits and every decode step's equal a
    card train-mode forward over the tokens so far (teacher forcing, the
    same kernels) within 0.0625."""
    from repro_torch.models import blocks
    cfg = _served_reduced(name)
    params = tlm.init_params(0, cfg, device=cuda_device)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    engine = ServingEngine(cfg, params, max_len=48)
    cuda_lib.reset_launch_counts()
    with monkeypatch.context() as m:
        def refuse(*args, **kwargs):
            raise AssertionError("the plain version ran on the card path")
        m.setattr(fa, "flash_attention_plain", refuse)
        m.setattr(blocks, "flash_attention_plain", refuse)
        out = engine.generate(prompts, 4)
    counts = cuda_lib.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "flash_attention": cfg.num_layers}
    with torch.inference_mode():
        for i in range(4):
            seq = torch.cat([prompts, out[:, :i].to(prompts.dtype)], 1)
            ref = tlm.forward(params, seq, cfg)[0][:, -1].float()
            if i == 0:
                got = engine.prefill_logits.float()
            else:
                got = _decode_logits(engine, cfg, params, prompts, out, i)
            assert float((got - ref).abs().max()) <= 0.0625


def _decode_logits(engine, cfg, params, prompts, tokens, i):
    """The logits of decode step i (fed tokens[:, :i]) from a fresh
    prefill of ``prompts``."""
    from repro_torch.serving.engine import pad_prefill_cache
    with torch.inference_mode():
        _, cache = engine.prefill(params, prompts)
        cache = pad_prefill_cache(cfg, cache, prompts.shape[0],
                                  engine.max_len)
        for j in range(i):
            logits, cache = tlm.forward(params, tokens[:, j:j + 1], cfg,
                                        mode="decode", cache=cache)
    return logits[:, -1].float()


@pytest.mark.cuda
def test_moe_route_on_card_equals_cpu_without_host_sync(cuda_device):
    """The routing of a bf16 logit matrix with exact ties (columns 3 and
    5 equal) on the card equals the CPU's, index for index and slot for
    slot (the stable sort orders ties by index on both), and runs without
    a device-to-host copy."""
    from repro_torch.models import blocks
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn((4096, 160), generator=gen).to(torch.bfloat16)
    logits[:, 5] = logits[:, 3]
    cpu = blocks.moe_route(logits, 6, 192)
    on_card = logits.to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a host sync raises
    try:
        card = blocks.moe_route(on_card, 6, 192)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


# --- recurrentgemma-2b: the windowed and D 256 flash kernels, the RG-LRU
# scan, the hybrid engine ---------------------------------------------------

# (batch, seq, heads, kv_heads, head_dim, dtype, causal, window):
# recurrentgemma-2b's prefill (D 256, 10 heads over 1, the 2048 window
# masking nothing at S 2048) and where the window masks (S 8192); D 256 at
# a ragged length, without a window, at S 1 and non-causal; every other
# instance with a window: a row that sees only itself, windows one short of
# and equal to a 64-row kv tile, windows across several 128-row tiles,
# ragged tails, MHA and GQA
FLASH_WINDOW_GEOMETRIES = [
    (4, 2048, 10, 1, 256, torch.bfloat16, True, 2048),
    (1, 8192, 10, 1, 256, torch.bfloat16, True, 2048),
    (2, 1000, 10, 1, 256, torch.bfloat16, True, 300),
    (2, 300, 10, 1, 256, torch.bfloat16, True, 0),
    (3, 1, 4, 2, 256, torch.bfloat16, True, 16),
    (1, 200, 4, 1, 256, torch.bfloat16, False, 63),
    (1, 1000, 32, 8, 64, torch.bfloat16, True, 300),
    (2, 77, 4, 4, 64, torch.bfloat16, True, 1),
    (1, 129, 4, 2, 128, torch.bfloat16, True, 64),
    (1, 2048, 8, 8, 80, torch.bfloat16, True, 100),
    (2, 500, 4, 2, 16, torch.bfloat16, True, 63),
    (1, 300, 8, 2, 32, torch.bfloat16, False, 200),
    (1, 1000, 4, 1, 16, torch.float32, True, 16),
    (2, 300, 4, 1, 16, torch.float32, True, 63),
    (1, 1000, 8, 2, 80, torch.float32, True, 300),
    (1, 130, 4, 4, 128, torch.float32, True, 1),
    (1, 257, 4, 2, 64, torch.float32, False, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,dtype,causal,window",
                         FLASH_WINDOW_GEOMETRIES)
def test_windowed_and_d256_flash_kernels_match_plain_on_card(
        cuda_device, b, s, h, hkv, d, dtype, causal, window):
    gen = torch.Generator().manual_seed(s + window)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device, dtype)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    fa.flash_attention.launches = 0
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == 1
    plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[dtype])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt()
    assert float(row_err.max()) <= FLASH_ROW_TOL[dtype]


# D 256's schedule (work items from a counter, longest first) where there
# are fewer items than SMs (B 1, S 256: 20), and where the items make 2
# and 3 rounds of the static pairs on 132 SMs (528 and 792 items), each
# launched twice in a row: the counter is back at 0 after a launch, so the
# second equals the first bit for bit
FLASH_D256_SCHEDULES = [(1, 256, 10, 1), (4, 1536, 11, 1), (6, 1536, 11, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv", FLASH_D256_SCHEDULES)
def test_d256_flash_schedule_matches_plain_on_card(cuda_device, b, s, h,
                                                   hkv):
    gen = torch.Generator().manual_seed(b * s + h)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
               for shape in ((b, s, h, 256), (b, s, hkv, 256),
                             (b, s, hkv, 256)))
    out = fa.flash_attention(q, k, v, causal=True, window=100)
    again = fa.flash_attention(q, k, v, causal=True, window=100)
    assert torch.equal(out, again)
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=100)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[torch.bfloat16])
    row_err = (out.float() - plain.float()).abs().amax(dim=-1) / \
        plain.float().square().mean(dim=-1).sqrt()
    assert float(row_err.max()) <= FLASH_ROW_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2048, 4096])
def test_a_window_that_hides_no_key_runs_the_unwindowed_instance(
        cuda_device, window):
    """recurrentgemma-2b's prefill at S 2048: a window of S keys or more
    hides none, so the library names ``flash_wgmma_kernel<256, false>`` as
    the call's kernel (``chip_smoke.py``'s ``flash`` line at this geometry
    checks that a profiled call ran it), and the call equals the one
    without a window bit for bit and the plain version."""
    bf16 = torch.bfloat16
    assert fa.kernel_symbol(bf16, 256, window, 2048) == \
        "flash_wgmma_kernel<256, false>"
    assert fa.kernel_symbol(bf16, 256, window, window + 1) == \
        "flash_wgmma_kernel<256, true>"
    gen = torch.Generator().manual_seed(window)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda_device, bf16)
               for shape in ((4, 2048, 10, 256), (4, 2048, 1, 256),
                             (4, 2048, 1, 256)))
    out = fa.flash_attention(q, k, v, causal=True, window=window)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=True))
    plain = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), plain.float(), rtol=0,
                               atol=FLASH_TOL[bf16])


# the kernel's float32 FMAs against the plain version's associative scan:
# two summation orders of h up to ~5 differ by ~2.3e-6 (measured on the CPU
# in float64 at S 2048 with a up to 1 - 6e-8)
RGLRU_TOL = 1e-5


def rglru_operands(b, s, r, device, seed=0):
    """a = exp(-8 softplus(lam) r) with softplus(lam) in [0.001, 0.1] (a
    near 1: the carry is most of h) and b = sqrt(1 - a^2) x, so h stays
    O(1) over any length."""
    gen = torch.Generator().manual_seed(seed)
    sp = torch.rand(r, generator=gen) * 0.099 + 0.001
    a = torch.exp(-8 * sp * torch.rand(b, s, r, generator=gen))
    x = torch.randn(b, s, r, generator=gen)
    return a.to(device), (torch.sqrt(1 - a * a) * x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(4, 2048, 2560), (3, 1000, 300),
                                   (1, 1, 64), (2, 17, 1)])
def test_rglru_scan_matches_plain_on_card(cuda_device, b, s, r):
    a, x = rglru_operands(b, s, r, cuda_device)
    rs.rglru_scan.launches = 0
    out = rs.rglru_scan(a, x)
    assert rs.rglru_scan.launches == 1
    plain = rs.rglru_scan_plain(a, x)
    torch.testing.assert_close(out, plain, rtol=0, atol=RGLRU_TOL)
    if s > 1:   # the carry matters at these gates: h = b misses by far more
        assert float((x - plain).abs().max()) > 100 * RGLRU_TOL


def gated_operands(b, s, r, dtype, device, seed=0):
    """r and i sigmoids, u normal in ``dtype``; c = -8 softplus(lam) in
    [-0.8, -0.008], so a = e^(c r) lies in (0.45, 1) and the carry
    matters."""
    gen = torch.Generator().manual_seed(seed)
    rg, ig = (torch.sigmoid(torch.randn(b, s, r, generator=gen)).to(
        device=device, dtype=dtype) for _ in range(2))
    u = torch.randn(b, s, r, generator=gen).to(device=device, dtype=dtype)
    c = (-0.008 - 0.792 * torch.rand(r, generator=gen)).to(device)
    return rg, ig, u, c


# the serving shape, ragged widths and lengths (S 1000 and 130 are not
# multiples of the kernel's 64-step chunk), one step, one channel
GATED_SHAPES = [(4, 2048, 2560), (3, 1000, 300), (1, 1, 64), (2, 17, 1),
                (2, 130, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,r", GATED_SHAPES)
def test_rglru_scan_gated_equals_the_unfused_chain_on_card(cuda_device, b,
                                                           s, r, dtype):
    """Bit for bit the chain it replaces on the same card tensors (the
    gates' tail, ``rglru_scan``, the cast, h of the last step), and against
    its plain version h_last at RGLRU_TOL and hs within one ulp of the
    dtype (or RGLRU_TOL where that is larger)."""
    rg, ig, u, c = gated_operands(b, s, r, dtype, cuda_device, seed=s + r)
    cuda_lib.reset_launch_counts()
    hs, h_last = rs.rglru_scan_gated(rg, ig, u, c)
    assert {k: v for k, v in cuda_lib.launch_counts().items() if v} == {
        "rglru_scan_gated": 1}
    assert hs.dtype == dtype and hs.shape == u.shape
    assert h_last.dtype == torch.float32 and h_last.shape == (b, r)
    h = rs.rglru_scan(*rs.rglru_ab(rg, ig, u, c))
    assert torch.equal(hs, h.to(dtype)) and torch.equal(h_last, h[:, -1])
    hs_p, last_p = rs.rglru_scan_gated_plain(rg, ig, u, c)
    torch.testing.assert_close(h_last, last_p, rtol=0, atol=RGLRU_TOL)
    _, e = torch.frexp(torch.maximum(hs.float().abs(), hs_p.float().abs()))
    bits = 8 if dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - bits)
    assert bool(((hs.float() - hs_p.float()).abs()
                 <= torch.clamp(ulp, min=RGLRU_TOL)).all())


@pytest.mark.cuda
def test_rglru_scan_gated_refuses_what_it_does_not_take(cuda_device):
    rg, ig, u, c = gated_operands(1, 8, 4, torch.bfloat16, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        rs.rglru_scan_gated(rg.half(), ig.half(), u.half(), c)
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan_gated(rg, ig, u, c.double())
    with pytest.raises(TypeError, match="share"):
        rs.rglru_scan_gated(rg, ig.float(), u, c)
    with pytest.raises(ValueError, match="one shape"):
        rs.rglru_scan_gated(rg, ig[:, :4], u, c)
    with pytest.raises(ValueError, match="one shape"):
        rs.rglru_scan_gated(rg, ig, u, c[:3])
    with pytest.raises(ValueError, match="several devices"):
        rs.rglru_scan_gated(rg, ig, u, c.cpu())


@pytest.mark.cuda
def test_rglru_scan_refuses_what_it_does_not_take(cuda_device):
    a = torch.rand(1, 8, 4, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rs.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError, match="one shape"):
        rs.rglru_scan(a, a[:, :4])
    with pytest.raises(ValueError, match="several devices"):
        rs.rglru_scan(a, a.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("prompt", [12, 24])
def test_hybrid_engine_on_card_matches_the_cpu(cuda_device, monkeypatch,
                                               prompt):
    """Reduced recurrentgemma-2b (float32: the FFMA kernel's D 16
    instances, window 16) on the card against the CPU engine, inside the
    window and past it: the gated scan and the flash kernel launch on every
    prefill and the plain versions never run; greedy tokens equal, prefill
    logits within 1e-4."""
    from repro_torch.models import blocks
    cfg = reduced(get_arch("recurrentgemma-2b"))
    params = tlm.init_params(0, cfg)              # float32, on the CPU
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt),
                            generator=torch.Generator().manual_seed(prompt))
    engine = ServingEngine(cfg, params, max_len=40)
    cuda_lib.reset_launch_counts()
    with monkeypatch.context() as m:
        def refuse(*args, **kwargs):
            raise AssertionError("a plain version ran on the card path")
        m.setattr(fa, "flash_attention_plain", refuse)
        m.setattr(blocks, "flash_attention_plain", refuse)
        m.setattr(rs, "rglru_scan_plain", refuse)
        m.setattr(rs, "rglru_scan_gated_plain", refuse)
        out = engine.generate(prompts, 6)
    counts = cuda_lib.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "flash_attention": 1, "rglru_scan_gated": 2}
    cpu = ServingEngine(cfg, params, max_len=40, device="cpu")
    assert torch.equal(out.cpu(), cpu.generate(prompts, 6))
    torch.testing.assert_close(engine.prefill_logits.cpu(),
                               cpu.prefill_logits, rtol=0, atol=1e-4)


# --- xlstm-350m: the sLSTM recurrence kernel --------------------------------

# the kernel's dot sums dh float32 products in order, the plain version's
# cuBLAS product in another (~1e-7 of |pre| a step); the recurrence is
# stabilized (|h| <= 1, f_s <= 1), so over 2048 steps that stays far under
SLSTM_TOL = 1e-4


def slstm_operands(b, s, h, dh, w_dtype, device, seed=0):
    """x_g normal, r_g at the spec's init (0.5 / sqrt(h dh)), b_g normal /
    2, in ``w_dtype``; a drawn carry (n >= 0.5)."""
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(b, s, h, dh, generator=gen).to(device)
          for _ in range(4)]
    rs_ = [(0.5 / (h * dh) ** 0.5 * torch.randn(h, dh, dh, generator=gen)
            ).to(device=device, dtype=w_dtype) for _ in range(4)]
    bs = [(0.5 * torch.randn(h, dh, generator=gen)).to(device=device,
                                                       dtype=w_dtype)
          for _ in range(4)]
    carry = [torch.randn(b, h, dh, generator=gen) for _ in range(4)]
    carry[1] = carry[1].abs() + 0.5
    return xs, rs_, bs, tuple(t.to(device) for t in carry)


# xlstm-350m's prefill (dh 256, bf16 weights: a cluster of 8), the reduced
# configs' dh 16 (float32 weights: a cluster of 1), a ragged head count and
# one decode step; float32 weights at dh 256 (128 KB a block); B 1, 5 and 9
# (instances of 1 and 8 rows; two row groups), one head; dh 64 and 128
# (clusters of 2 and 4); ragged columns (dh 254 and 130: the cluster's last
# block owns fewer) and a head dim that is not whole weight chunks (dh 18)
SLSTM_SHAPES = [(4, 2048, 4, 256, torch.bfloat16),
                (2, 37, 4, 16, torch.float32),
                (3, 100, 3, 64, torch.bfloat16),
                (4, 1, 4, 256, torch.bfloat16),
                (4, 2048, 4, 256, torch.float32),
                (1, 300, 4, 256, torch.bfloat16),
                (5, 200, 2, 128, torch.bfloat16),
                (9, 120, 2, 64, torch.float32),
                (4, 500, 1, 256, torch.bfloat16),
                (2, 60, 2, 254, torch.float32),
                (2, 40, 3, 130, torch.float32),
                (3, 50, 2, 18, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh,w_dtype", SLSTM_SHAPES)
def test_slstm_scan_matches_plain_on_card(cuda_device, b, s, h, dh,
                                          w_dtype):
    """hs and the last carry against the plain version from a drawn carry
    (advanced in place), one launch; from no carry too."""
    xs, rs_, bs, carry = slstm_operands(b, s, h, dh, w_dtype, cuda_device,
                                        seed=s + dh)
    state = tuple(t.clone() for t in carry)
    cuda_lib.reset_launch_counts()
    hs, last = ss.slstm_scan(xs, rs_, bs, state)
    assert {k: v for k, v in cuda_lib.launch_counts().items() if v} == {
        "slstm_scan": 1}
    assert all(a is b_ for a, b_ in zip(last, state))
    hs_p, last_p = ss.slstm_scan_plain(xs, rs_, bs, carry)
    torch.testing.assert_close(hs, hs_p, rtol=0, atol=SLSTM_TOL)
    for got, want in zip(last, last_p):
        torch.testing.assert_close(got, want, rtol=0, atol=SLSTM_TOL)
    hs0, _ = ss.slstm_scan(xs, rs_, bs)
    torch.testing.assert_close(hs0, ss.slstm_scan_plain(xs, rs_, bs)[0],
                               rtol=0, atol=SLSTM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,dh,w_dtype", SLSTM_SHAPES)
def test_slstm_launch_is_its_design_on_card(cuda_device, b, s, h, dh,
                                            w_dtype):
    """The library launches what ``design`` says (the same fields, and at
    least one such cluster fits on the card), and a launch's blocks all
    report an SM: a cluster's blocks on SMs of their own."""
    want = ss.design(b, h, dh, w_dtype)
    got = ss.library_design(b, h, dh, w_dtype)
    assert got.pop("max_active_clusters") >= 1
    assert got == {k: v for k, v in want.items() if k != "grid"}
    xs, rs_, bs, _ = slstm_operands(b, min(s, 8), h, dh, w_dtype,
                                    cuda_device)
    sm_ids = torch.full((want["blocks"],), -1, dtype=torch.int32,
                        device=cuda_device)
    hs, _ = ss.slstm_scan(xs, rs_, bs, sm_ids=sm_ids)
    torch.testing.assert_close(hs, ss.slstm_scan_plain(xs, rs_, bs)[0],
                               rtol=0, atol=SLSTM_TOL)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    ids = sm_ids.cpu().view(want["groups"], h, want["cluster"])
    assert bool(((ids >= 0) & (ids < sms)).all())
    assert all(len(set(c.tolist())) == want["cluster"]
               for c in ids.reshape(-1, want["cluster"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dh,w_dtype", [(16, torch.float32),
                                        (256, torch.bfloat16)])
def test_slstm_decode_steps_equal_the_sequence_call_on_card(cuda_device, dh,
                                                            w_dtype):
    """Eight one-token calls writing the carry in place equal one eight-step
    call bit for bit (the same per-step arithmetic), the carry's tensors
    kept."""
    xs, rs_, bs, carry = slstm_operands(2, 8, 4, dh, w_dtype, cuda_device)
    state = tuple(t.clone() for t in carry)
    hs, last = ss.slstm_scan(xs, rs_, bs, carry)
    for t in range(8):
        h_t, out = ss.slstm_scan([x[:, t:t + 1] for x in xs], rs_, bs, state)
        assert all(a is b for a, b in zip(out, state))
        assert torch.equal(h_t[:, 0], hs[:, t])
    assert all(torch.equal(a, b) for a, b in zip(state, last))


@pytest.mark.cuda
def test_slstm_scan_refuses_what_it_does_not_take(cuda_device):
    xs, rs_, bs, _ = slstm_operands(1, 4, 2, 16, torch.bfloat16,
                                    cuda_device)
    with pytest.raises(ValueError, match="even head dim"):
        ss.slstm_scan([x[..., :15] for x in xs], [r[:, :15, :15] for r in rs_],
                      [b[:, :15] for b in bs])
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        ss.slstm_scan(xs, [r.half() for r in rs_], [b.half() for b in bs])
    with pytest.raises(TypeError, match="float32"):
        ss.slstm_scan([x.bfloat16() for x in xs], rs_, bs)
    with pytest.raises(ValueError, match="several devices"):
        ss.slstm_scan(xs, rs_, [b.cpu() for b in bs])
    with pytest.raises(ValueError, match="contiguous"):
        ss.slstm_scan(xs, rs_, bs, [torch.zeros(1, 16, 2, device=cuda_device)
                                    .transpose(1, 2) for _ in range(4)])


@pytest.mark.cuda
def test_xlstm_engine_on_card_matches_the_cpu(cuda_device, monkeypatch):
    """Reduced xlstm-350m (float32, dh 16) on the card against the CPU
    engine: one sLSTM launch in the prefill and one a decode step, the
    plain version never run, no other kernel; greedy tokens equal, prefill
    logits within 1e-4."""
    cfg = reduced(get_arch("xlstm-350m"))
    params = tlm.init_params(0, cfg)              # float32, on the CPU
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(16))
    engine = ServingEngine(cfg, params, max_len=24)
    cuda_lib.reset_launch_counts()
    with monkeypatch.context() as m:
        def refuse(*args, **kwargs):
            raise AssertionError("a plain version ran on the card path")
        m.setattr(ss, "slstm_scan_plain", refuse)
        out = engine.generate(prompts, 6)
    assert {k: v for k, v in cuda_lib.launch_counts().items() if v} == {
        "slstm_scan": 6}
    cpu = ServingEngine(cfg, params, max_len=24, device="cpu")
    assert torch.equal(out.cpu(), cpu.generate(prompts, 6))
    torch.testing.assert_close(engine.prefill_logits.cpu(),
                               cpu.prefill_logits, rtol=0, atol=1e-4)


# --- the chip axis: G chips in one launch ----------------------------------

# (G, b, h, w, kernel, stride, c): the serving shape at G 4 (kernel A's
# warp-owned tiles over the four chips' 1,024 tiles; one chip's 256 run
# block-shared) and G 1, a per-chip N not a multiple of the 16-row tile
# (3 x 7 x 6 = 126 rows), C 48 at K 75, and ImageNet at G 2 (kernel B's
# 16-row warp tiles)
FLEET_GEOMETRIES = [(4, 16, 32, 32, 3, 2, 32), (1, 16, 32, 32, 3, 2, 32),
                    (4, 3, 13, 11, 3, 2, 32), (3, 2, 13, 11, 5, 3, 48),
                    (2, 16, 224, 224, 3, 2, 32)]


def fleet_operands(rng, g, b, h, w, kernel, c, dev):
    """Frames (G, B, H, W, 3), packed weights, the chips' random (G, 4, C)
    rows and G keys."""
    images = torch.tensor(rng.uniform(size=(g, b, h, w, 3)),
                          dtype=torch.float32, device=dev)
    wp = tk.pack_phase_weights(torch.tensor(
        rng.normal(size=(kernel * kernel * 3, c)) * 0.3,
        dtype=torch.float32)).to(dev)
    chan = torch.tensor(np.stack([_chip_rows(rng, c) for _ in range(g)]),
                        device=dev)
    keys = [prng.fold_in(prng.PRNGKey(40), i) for i in range(g)]
    return images, wp, chan, keys


@pytest.mark.cuda
@pytest.mark.parametrize("g,b,h,w,kernel,stride,c", FLEET_GEOMETRIES)
def test_fleet_kernels_equal_single_chip_calls(cuda_device, g, b, h, w,
                                               kernel, stride, c):
    """Each of the five fleet instances: chip row g of every output (u and
    the Hoyer partials, theta, kernel B's acts and V partials, the fused
    kernels' acts, Hoyer, V and rate partials at a pinned theta, at both
    precisions) equals the single-chip call on chip g's operands bit for
    bit, and one launch serves all G chips."""
    rng = np.random.default_rng(g * 100 + c + h)
    dev = cuda_device
    images, wp, chan, keys = fleet_operands(rng, g, b, h, w, kernel, c, dev)
    wq, dq = ops.quantize_frontend_weights(wp)
    v_th = torch.tensor(0.8, device=dev)
    kw = dict(kernel=kernel, stride=stride)
    cuda_lib.reset_launch_counts()
    u_f, hp_f = tk.p2m_phase_a_implicit_fleet(images, wp, v_th, **kw)
    u8_f, hp8_f = tk.p2m_phase_a_implicit_q8_fleet(images, wq, dq, v_th, **kw)
    theta_f = tk.combine_fleet_hoyer_partials(hp_f, v_th)
    theta8_f = tk.combine_fleet_hoyer_partials(hp8_f, v_th)
    b_f = tk.p2m_phase_b_fleet(u_f, theta_f, keys, chan=chan)
    f32_f = tk.p2m_fused_stream_fleet(images, wp, v_th, theta_f, keys, chan,
                                      **kw)
    q8_f = tk.p2m_fused_stream_q8_fleet(images, wq, dq, v_th, theta8_f, keys,
                                        chan, **kw)
    counts = cuda_lib.launch_counts()
    assert all(counts[name] == 1 for name in (
        "p2m_phase_a_implicit_fleet", "p2m_phase_a_implicit_q8_fleet",
        "p2m_phase_b_fleet", "p2m_fused_stream_fleet",
        "p2m_fused_stream_q8_fleet"))
    for i in range(g):
        u, hp = tk.p2m_phase_a_implicit(images[i], wp, v_th, **kw)
        u8, hp8 = tk.p2m_phase_a_implicit_q8(images[i], wq, dq, v_th, **kw)
        theta = tk.combine_hoyer_partials(hp, v_th)
        theta8 = tk.combine_hoyer_partials(hp8, v_th)
        assert torch.equal(u_f[i], u) and torch.equal(hp_f[i], hp)
        assert torch.equal(u8_f[i], u8) and torch.equal(hp8_f[i], hp8)
        assert torch.equal(theta_f[i], theta)
        assert torch.equal(theta8_f[i], theta8)
        for x, y in zip((b_f[0][i], b_f[1][i]),
                        tk.p2m_phase_b(u, theta, keys[i], chan=chan[i])):
            assert torch.equal(x, y)
        for x, y in zip((t[i] for t in f32_f), tk.p2m_fused_stream(
                images[i], wp, v_th, theta, keys[i], chan[i], **kw)):
            assert torch.equal(x, y)
        for x, y in zip((t[i] for t in q8_f), tk.p2m_fused_stream_q8(
                images[i], wq, dq, v_th, theta8, keys[i], chan[i], **kw)):
            assert torch.equal(x, y)
    # the plain versions (the single-chip plain a chip at a time)
    u_p, hp_p = tk.p2m_phase_a_implicit_fleet(images.cpu(), wp.cpu(),
                                              v_th.cpu(), **kw)
    assert float((u_f.cpu() - u_p).abs().max()) <= 3e-6


@pytest.mark.cuda
def test_fleet_frontend_launches_as_one_chip(cuda_device, monkeypatch):
    """The fleet frontend's exact step launches one kernel A and one kernel
    B, its fused step one fused kernel, at G 1 and G 4 alike, at either
    precision; aux carries a leading G."""
    monkeypatch.setattr(autotune, "_TABLE", {})
    rng = np.random.default_rng(9)
    dev = cuda_device
    w = torch.tensor(rng.normal(size=(3, 3, 3, 32)) * 0.3,
                     dtype=torch.float32, device=dev)
    v_th = torch.ones((), device=dev)
    for precision, a_name, f_name in (
            ("f32", "p2m_phase_a_implicit_fleet", "p2m_fused_stream_fleet"),
            ("int8", "p2m_phase_a_implicit_q8_fleet",
             "p2m_fused_stream_q8_fleet")):
        for g in (1, 4):
            images, _, chan, keys = fleet_operands(rng, g, 16, 32, 32, 3, 32,
                                                   dev)
            cuda_lib.reset_launch_counts()
            acts, aux = ops.p2m_frontend_fleet(images, w, v_th, keys,
                                               chan=chan, precision=precision)
            ops.p2m_frontend_fused_fleet(images, w, v_th, aux["theta"], keys,
                                         chan=chan, precision=precision)
            counts = {k: v for k, v in cuda_lib.launch_counts().items() if v}
            assert counts == {a_name: 1, "p2m_phase_b_fleet": 1, f_name: 1}
            assert acts.shape == (g, 16, 16, 16, 32)
            assert all(v.shape == (g,) for v in aux.values())


@pytest.mark.cuda
def test_card_census_launches_what_the_cpu_census_calls(cuda_device,
                                                        monkeypatch):
    """The analysis layer's card census: every entry point's kernel
    launches on the card (the wrappers' counts, and the port's kernels in a
    ``torch.profiler`` profile of one call) equal the CPU census's kernel
    calls; ``fleet.g2`` launches what ``fleet.g1`` does (one kernel A and
    one B); the ADC-less ``frontend.cuda`` step launches no cuDNN
    convolution and no product."""
    from repro_torch.analysis import census
    monkeypatch.setattr(autotune, "_TABLE", {})
    cpu = census.collect()
    # the card census in a fresh interpreter: in the test's own process
    # every profiler session could lose the port's kernels' device events
    card = census.collect_in_child(device=cuda_device)
    assert sorted(card) == sorted(cpu)
    assert census.card_failures(cpu, card) == []
    one_a_one_b = {"p2m_phase_a_implicit_fleet": 1, "p2m_phase_b_fleet": 1}
    assert card["fleet.g1"]["launches"] == one_a_one_b
    assert card["fleet.g2"]["launches"] == one_a_one_b
    assert card["quant.fused_q8"]["launches"] == {"p2m_fused_stream_q8": 1}


# --- LM training on the card: the flash backward kernel and the guard -------

# (dtype, head dim) of each backward instance
BWD_INSTANCES = [("float32", 16), ("bfloat16", 80), ("bfloat16", 128)]
# (B, S, H, Hkv): ragged tails (S 77, 130), GQA 2:1 and 4:1
BWD_GEOMETRIES = [(2, 77, 4, 4), (1, 130, 8, 2), (2, 64, 4, 1)]
# the largest error of a gradient row (over D) over that row's RMS; a row
# whose RMS is under 1e-3 of the largest row's over the largest row's RMS
# instead (a query that sees one key has a gradient at ~0, rounding on
# both sides): float32, the summation order; bf16, both sides round the
# gradients to bf16 (2^-8 each; the plain version takes its gradient in
# float32) (chip_smoke.FLASH_BWD_TOL, chip_smoke.grad_row_err)
BWD_TOL = {"float32": 1e-4, "bfloat16": 0.1}


def _grad_err(got, ref) -> float:
    got, ref = got.float(), ref.float()
    rms = ref.square().mean(dim=-1).sqrt()
    top = rms.max()
    if float(top) == 0.0:          # a gradient that is 0 everywhere
        return float((got - ref).abs().max())
    scale = torch.where(rms > 1e-3 * top, rms, top)
    return float(((got - ref).abs().amax(dim=-1) / scale).max())


def _bwd_operands(b, s, h, hkv, d, dtype, device, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(device, dtype)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                               (b, s, h, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", BWD_INSTANCES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv", BWD_GEOMETRIES)
def test_flash_backward_kernel_matches_plain_on_card(cuda_device, dtype, d,
                                                     causal, b, s, h, hkv):
    q, k, v, do = _bwd_operands(b, s, h, hkv, d, getattr(torch, dtype),
                                cuda_device)
    cuda_lib.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, do, causal=causal)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["flash_attention_bwd"] == 1
    ref = fa.flash_attention_bwd_plain(q, k, v, do, causal=causal)
    for name, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        assert g_.dtype == q.dtype and g_.shape == r_.shape
        assert bool(torch.isfinite(g_).all()), name
        assert _grad_err(g_, r_) <= BWD_TOL[dtype], name
    # deterministic: no atomics, a second launch gives the same bits
    again = fa.flash_attention_bwd(q, k, v, do, causal=causal)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", BWD_INSTANCES)
def test_flash_attention_gradient_runs_the_kernels(cuda_device, dtype, d):
    """A train forward on the card (``blocks.flash_attention`` with inputs
    that require grad) launches the forward kernel, and its backward the
    backward kernel; under ``torch.utils.checkpoint`` the forward runs
    again in the backward, and the gradients are the same bits."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import blocks
    q, k, v, do = _bwd_operands(2, 96, 4, 2, d, getattr(torch, dtype),
                                cuda_device)
    grads = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        cuda_lib.reset_launch_counts()

        def attend(q_, k_, v_):
            return blocks.flash_attention(q_, k_, v_, causal=True)

        out = (checkpoint(attend, *leaves, use_reentrant=False) if remat
               else attend(*leaves))
        out.backward(do)
        counts = cuda_lib.launch_counts()
        assert counts["flash_attention"] == 1 + remat
        assert counts["flash_attention_bwd"] == 1
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    ref = fa.flash_attention_bwd_plain(q, k, v, do, causal=True)
    for g_, r_ in zip(grads[0], ref):
        assert _grad_err(g_, r_) <= BWD_TOL[dtype]


@pytest.mark.cuda
def test_flash_backward_refuses_what_it_does_not_take(cuda_device):
    """A train forward that would need a backward the kernel does not
    compute raises before any launch: a window, unequal lengths, MLA's
    (192, 128), an unbuilt head dim or dtype."""
    from repro_torch.models import blocks
    bf16, f32 = torch.bfloat16, torch.float32

    def operands(sq, sk, d, dv, dtype):
        q = torch.randn(1, sq, 2, d, device=cuda_device, dtype=dtype)
        k = torch.randn(1, sk, 2, d, device=cuda_device, dtype=dtype)
        v = torch.randn(1, sk, 2, dv, device=cuda_device, dtype=dtype)
        return q.requires_grad_(True), k, v

    cases = [(operands(64, 64, 80, 80, bf16), dict(causal=True, window=16)),
             (operands(8, 24, 80, 80, bf16), dict(causal=False)),
             (operands(64, 64, 192, 128, bf16), dict(causal=True)),
             (operands(64, 64, 64, 64, bf16), dict(causal=True)),
             (operands(64, 64, 80, 80, f32), dict(causal=True))]
    for (q, k, v), kw in cases:
        cuda_lib.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="ROADMAP item 16"):
            blocks.flash_attention(q, k, v, **kw)
        assert not any(cuda_lib.launch_counts().values())
        with torch.no_grad():     # without a gradient each still serves
            blocks.flash_attention(q, k, v, **kw)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_operands_autograd_records(cuda_device):
    """Every card kernel without a backward refuses CUDA operands while
    autograd records one that requires grad (its output would have no
    graph); the check comes before the operands' own."""
    x = torch.ones(2, 8, 4, device=cuda_device, requires_grad=True)
    y = torch.ones(2, 8, 4, device=cuda_device)
    calls = [lambda: fa.flash_attention(x[..., None].expand(2, 8, 4, 16),
                                        y[..., None].expand(2, 8, 4, 16),
                                        y[..., None].expand(2, 8, 4, 16)),
             lambda: rs.rglru_scan(x, y),
             lambda: rs.rglru_scan_gated(x, y, y, y[0, 0]),
             lambda: ss.slstm_scan([x] * 4, [y] * 4, [y] * 4),
             lambda: tk.p2m_phase_a_implicit(x, y, y, kernel=3, stride=1),
             lambda: tk.p2m_phase_b(x, y, prng.PRNGKey(0))]
    for call in calls:
        cuda_lib.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            call()
        assert not any(cuda_lib.launch_counts().values())


def _train_cfg(arch, **over):
    return dataclasses.replace(reduced(get_arch(arch)), **over)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat", [("stablelm-3b", "none"),
                                        ("granite-8b", "full")])
def test_lm_train_step_on_card_matches_cpu(cuda_device, arch, remat):
    """One AdamW step of a reduced config (float32, D 16) on the card
    against the same step on the CPU: loss and grad norm within 1e-5
    relative, every parameter within 1e-6 of its leaf's largest entry
    plus 1e-4 of lr (Adam's division by sqrt(v) where a gradient entry is
    small); one forward launch an attention layer (two under remat) and
    one backward launch."""
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data import TokenStream
    from repro_torch.optim.optimizer import init_opt_state, leaves
    from repro_torch.train import make_train_step
    cfg = _train_cfg(arch, remat=remat)
    ocfg = OptimizerConfig(warmup_steps=1, total_steps=4, lr=1e-2)
    out = {}
    from repro_torch.models.params import to_device
    for dev in (cuda_device, torch.device("cpu")):
        # the same weights on both sides (drawn on the host)
        params = to_device(tlm.init_params(0, cfg), dev)
        batch = TokenStream(cfg.vocab_size, 64, 4, device=dev).next_batch()
        cuda_lib.reset_launch_counts()
        p, _, m = make_train_step(cfg, ocfg)(
            params, init_opt_state(params, ocfg), batch)
        out[dev.type] = (p, m, cuda_lib.launch_counts())
    (pc, mc, counts), (pp, mp, _) = out["cuda"], out["cpu"]
    n_attn = cfg.num_layers
    assert counts["flash_attention"] == n_attn * (2 if remat != "none"
                                                  else 1)
    assert counts["flash_attention_bwd"] == n_attn
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mp[key])) <= 1e-5 * abs(
            float(mp[key]))
    for a, b in zip(leaves(pc), leaves(pp)):
        tol = 1e-6 * float(b.abs().max()) + 1e-4 * ocfg.lr
        assert float((a.cpu() - b).abs().max()) <= tol


@pytest.mark.cuda
def test_trainer_refuses_a_config_without_backward_kernels(cuda_device):
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import TokenStream
    from repro_torch.train import Trainer
    for arch, kernel in (("recurrentgemma-2b", "rglru_scan_gated"),
                         ("xlstm-350m", "slstm_scan"),
                         ("deepseek-v2-236b", "MLA")):
        cfg = reduced(get_arch(arch))
        stream = TokenStream(cfg.vocab_size, 16, 2, device=cuda_device)
        with pytest.raises(NotImplementedError, match=kernel):
            Trainer(RunConfig(arch=cfg), stream, device=cuda_device,
                    checkpoints=False)
        assert stream.step == 0


@pytest.mark.cuda
def test_sampled_generate_on_card_matches_cpu(cuda_device):
    """Temperature sampling on the card: reduced glm4-9b (float32) gives
    the CPU's tokens at the same key, but where the CPU's top-2 margin of
    noise plus scaled logits is within 1e-4 (none at this seed: the
    first such token would end the comparison)."""
    cfg = reduced(get_arch("glm4-9b"))
    params = tlm.init_params(0, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (3, 12),
                            generator=torch.Generator().manual_seed(2),
                            dtype=torch.int32)
    toks = {}
    for dev in (cuda_device, "cpu"):
        eng = ServingEngine(cfg, params, max_len=40, temperature=0.8,
                            device=dev)
        toks[str(dev)] = eng.generate(prompts, 12,
                                      rng=prng.PRNGKey(3)).cpu()
    assert torch.equal(toks[str(cuda_device)], toks["cpu"])
