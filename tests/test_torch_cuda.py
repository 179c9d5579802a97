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
The engine tests show each main path launches its own kernels and no
other: f32 A / B / f32 fused on the f32 engine, int8 A / B / int8 fused on
an engine whose tile table picks int8.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.kernels import autotune
from repro_torch.kernels import ops
from repro_torch.kernels import p2m_conv as tk
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine

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
    tk.reset_launch_counts()
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
    counts = tk.launch_counts()
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
    tk.reset_launch_counts()

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
    counts = tk.launch_counts()
    assert counts["p2m_phase_a_implicit_q8"] == 4
    assert counts["p2m_fused_stream_q8"] == 2
    assert counts["p2m_phase_a"] == 1 and counts["p2m_conv"] == 1


F32_PATH = {"p2m_phase_a_implicit", "p2m_phase_b", "p2m_fused_stream"}
INT8_PATH = {"p2m_phase_a_implicit_q8", "p2m_phase_b", "p2m_fused_stream_q8"}


def _run_engine(engine):
    frames = torch.rand(4, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(1))
    tk.reset_launch_counts()
    out = engine.classify(frames)
    list(engine.stream([frames, frames]))
    assert out["probs"].device.type == "cuda"
    assert bool(torch.isfinite(out["probs"]).all())
    return tk.launch_counts()


@pytest.mark.cuda
def test_engine_main_path_launches_every_kernel(cuda_device, monkeypatch):
    monkeypatch.setattr(autotune, "_TABLE", {})
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    engine = VisionEngine(cfg, tv.init_params(0, cfg), microbatch=4)
    counts = _run_engine(engine)
    assert {k for k, v in counts.items() if v} == F32_PATH
    assert counts["p2m_fused_stream"] == engine.fused_step_count >= 1


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
