"""The port's CUDA kernels on the card (``-m cuda``; they skip without one).

This file imports neither jax nor the reference package, so it runs on a
machine that has only PyTorch with CUDA:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
tensors: u at atol 3e-6 (the MAC sums in another order), theta at rtol
1e-5, draws by the word-boundary rule (tanhf/expf inside the kernel and in
PyTorch's ops may differ by ulps), and the fused kernel at a pinned theta
equal to A -> B bit for bit. The engine test shows the main path launches
every kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
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
    assert tk.launch_counts() == {"p2m_phase_a_implicit": 1,
                                  "p2m_phase_b": 1, "p2m_fused_stream": 1}


@pytest.mark.cuda
def test_engine_main_path_launches_every_kernel(cuda_device):
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    engine = VisionEngine(cfg, tv.init_params(0, cfg), microbatch=4)
    frames = torch.rand(4, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(1))
    tk.reset_launch_counts()
    out = engine.classify(frames)
    list(engine.stream([frames, frames]))
    counts = tk.launch_counts()
    assert counts["p2m_phase_a_implicit"] >= 1 and counts["p2m_phase_b"] >= 1
    assert counts["p2m_fused_stream"] == engine.fused_step_count >= 1
    assert out["probs"].device.type == "cuda"
    assert bool(torch.isfinite(out["probs"]).all())
