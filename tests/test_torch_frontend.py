"""The port's ``ideal``, ``analog`` and ``device`` SensorFrontend backends
against the JAX package, and the slice served through ``VisionEngine``.

The same numpy frames and weights and the same key go through
``repro.frontend.SensorFrontend`` and ``repro_torch.frontend.SensorFrontend``
(``device="cpu"``). The threefry words are bit-exact, so a binary
activation may differ in two places only, in at most 1e-3 of the elements:
for ``ideal`` / ``analog`` where z lies within 4 float32 ulps (relative) of
the Hoyer threshold (the convs sum in another order); for ``device`` where
one of a neuron's uniforms lies within 1e-6 of its switching probability.
theta and the Hoyer loss agree at rtol 1e-5, the V_CONV stats at atol 1e-5.

The whole slice: ``VisionEngine(backend="device", device="cpu")`` against
the reference's ``VisionEngine(backend="device")`` on vgg_tiny and resnet20
with the same weights, seed and frames, for ``classify`` and a
three-microbatch ``stream``; ``ideal`` and ``analog`` through
``models.vision.forward(backend=...)``. At these seeds every frontend draw
agrees (checked through the per-frame activation counts), so probs agree
at 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import frontend as jf
from repro.core import energy as j_energy
from repro.core import mtj as j_mtj
from repro.core import p2m as j_p2m
from repro.core import pixel as j_pixel
from repro.frontend import backends as j_backends
from repro.models import vision as jv
from repro.serving import VisionEngine as JaxEngine
from repro_torch import frontend as tf
from repro_torch import prng
from repro_torch.core import energy as t_energy
from repro_torch.core import mtj as t_mtj
from repro_torch.core import p2m as t_p2m
from repro_torch.kernels import ops as t_ops
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine
from repro_torch.variation import chip as t_chip

ROOT = Path(__file__).resolve().parents[1]
THETA_RTOL = 1e-5
HOYER_RTOL = 1e-5
V_CONV_ATOL = 1e-5
# a differing binary unit must sit this close to its threshold (relative)
THRESHOLD_ULPS_REL = 4 * np.finfo(np.float32).eps
# a differing device vote must have a uniform this close to its P_sw
DRAW_EDGE = 1e-6
MAX_MISMATCH_FRAC = 1e-3
PROBS_ATOL = 1e-5


def _inputs(seed, b=2, hw=16, scale=0.27):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32)) * scale).astype(np.float32)
    return x, w, np.float32(rng.uniform(0.7, 1.3))


def _key(seed):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    return kj, np.asarray(jax.random.key_data(kj))


def _run_both(backend, x, w, v_th, key_seed, noise=0.0, with_key=True):
    pj = dataclasses.replace(j_p2m.P2MConfig(), noise_p_fail=noise,
                             noise_p_false=noise)
    pt = t_p2m.P2MConfig(noise_p_fail=noise, noise_p_false=noise)
    fj = jf.SensorFrontend(jf.FrontendConfig(p2m=pj, backend=backend))
    ft = tf.SensorFrontend(tf.FrontendConfig(p2m=pt, backend=backend))
    kj, kt = _key(key_seed) if with_key else (None, None)
    oj, aj = fj({"w": jnp.asarray(w), "v_th": jnp.asarray(v_th)},
                jnp.asarray(x), key=kj)
    ot, at = ft({"w": torch.from_numpy(w), "v_th": torch.tensor(v_th)},
                torch.from_numpy(x), key=kt)
    return (np.asarray(oj), aj), (ot.numpy(), at), kj, pj


def _near_threshold(backend, x, w, v_th, pcfg):
    """Where z lies within 4 ulps of the reference's Hoyer threshold."""
    if backend == "ideal":
        wq = j_p2m.quantize_weights(jnp.asarray(w), pcfg.weight_bits)
        u = j_p2m.phase_conv(jnp.asarray(x), wq, pcfg.stride)
    else:
        u = j_p2m.hardware_conv(jnp.asarray(x), jnp.asarray(w), pcfg)
    z = np.asarray(u) / max(float(v_th), 1e-6)
    thr = float(jv.hoyer.hoyer_extremum(jv.hoyer.clip01(jnp.asarray(z))))
    return np.abs(z - thr) <= THRESHOLD_ULPS_REL * max(abs(thr), 1.0)


def _near_draw_edge(x, w, v_th, pcfg, kj):
    """Where one of a neuron's uniforms lies within 1e-6 of its P_sw."""
    u = j_p2m.hardware_conv(jnp.asarray(x), jnp.asarray(w), pcfg)
    theta = j_backends._theta(u, jnp.asarray(v_th))
    v = j_pixel.conv_voltage(u, theta, pcfg.pixel)
    p_sw = np.asarray(j_mtj.switching_probability(
        v, pcfg.mtj.write_pulse_ps, pcfg.mtj))
    n = pcfg.mtj.n_redundant
    unif = np.asarray(jax.random.uniform(kj, p_sw.shape + (n,)))
    return (np.abs(unif - p_sw[..., None]) < DRAW_EDGE).any(axis=-1)


def _check_aux(aj, at):
    assert set(at) == set(aj)
    np.testing.assert_allclose(float(at["theta"]), float(aj["theta"]),
                               rtol=THETA_RTOL)
    np.testing.assert_allclose(float(at["hoyer_loss"]),
                               float(aj["hoyer_loss"]), rtol=HOYER_RTOL)
    for k in ("v_conv_mean", "v_conv_min", "v_conv_max"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=0,
                                   atol=V_CONV_ATOL, err_msg=k)


def _check_acts(oj, ot, allowed):
    assert ot.shape == oj.shape and ot.dtype == np.float32
    diff = ot != oj
    assert diff.sum() <= MAX_MISMATCH_FRAC * diff.size
    assert not (diff & ~allowed).any(), "activation differs off the edge"
    return int(diff.sum())


@pytest.mark.parametrize("seed", [0, 3])
def test_ideal_backend_matches_reference(seed):
    x, w, v_th = _inputs(seed)
    (oj, aj), (ot, at), _, pj = _run_both("ideal", x, w, v_th, seed)
    _check_aux(aj, at)
    _check_acts(oj, ot, _near_threshold("ideal", x, w, v_th, pj))


@pytest.mark.parametrize("noise,with_key", [(0.0, False), (0.0, True),
                                            (0.05, True), (0.05, False)])
def test_analog_backend_matches_reference(noise, with_key):
    x, w, v_th = _inputs(1)
    (oj, aj), (ot, at), _, pj = _run_both("analog", x, w, v_th, 1,
                                          noise=noise, with_key=with_key)
    _check_aux(aj, at)
    _check_acts(oj, ot, _near_threshold("analog", x, w, v_th, pj))
    if noise and with_key:
        # the Fig. 8 flips ran: the map is not the noiseless one
        (o0, _), _, _, _ = _run_both("analog", x, w, v_th, 1)
        assert (oj != o0).any()


@pytest.mark.parametrize("seed", [0, 5])
def test_device_backend_matches_reference(seed):
    x, w, v_th = _inputs(seed)
    (oj, aj), (ot, at), kj, pj = _run_both("device", x, w, v_th, seed)
    _check_aux(aj, at)
    _check_acts(oj, ot, _near_draw_edge(x, w, v_th, pj, kj))
    for k in ("activated_fraction", "reset_pulses", "read_energy_pj",
              "reset_energy_pj", "sparsity"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(at["channel_rates"].numpy(),
                               np.asarray(aj["channel_rates"]), atol=1e-6)


def test_registry():
    assert tf.list_backends() == ["analog", "cuda", "device", "ideal"]
    assert tf.differentiable_backends() == ["analog", "ideal"]
    assert tf.differentiable_backends() == [
        b for b in jf.differentiable_backends() if b in tf.list_backends()]
    fe = tf.SensorFrontend(tf.FrontendConfig(backend="device"))
    params = fe.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.rand((1, 8, 8, 3), generator=torch.Generator()
                        .manual_seed(1))
    with pytest.raises(ValueError, match="key="):
        fe(params, frames)
    # every backend takes a chip (a ChipMaps, or its fields as a plain
    # tuple) and a trim; ``ideal`` models no device and ignores both
    chip = tuple(t_chip.sample_chip(t_chip.VariationConfig(
        sigma_logit_offset=0.5), 32, 8, 1, device="cpu"))
    for mode in ("ideal", "analog", "device", "cuda"):
        acts, _ = fe({**params, "chip": chip, "cal_trim": torch.zeros(32)},
                     frames, key=prng.PRNGKey(0), mode=mode)
        assert acts.shape == (1, 4, 4, 32)
    nominal, _ = fe(params, frames, key=prng.PRNGKey(0), mode="ideal")
    with_chip, _ = fe({**params, "chip": chip}, frames, key=prng.PRNGKey(0),
                      mode="ideal")
    assert torch.equal(with_chip, nominal)
    with pytest.raises(KeyError):
        tf.SensorFrontend(tf.FrontendConfig(backend="pallas"))


@pytest.mark.parametrize("backend", ["ideal", "analog"])
def test_differentiable_backends_are_forward_only_for_now(backend):
    """``ideal`` and ``analog`` are registered differentiable, as in the
    reference. (The name dates from before the spike's straight-through
    backward.) Now the activation map, Fig. 8 flips included, carries a
    gradient to ``w`` and ``v_th``, as the Hoyer loss does; its values are
    held to ``jax.grad`` in ``tests/test_torch_train.py``."""
    pcfg = t_p2m.P2MConfig(noise_p_fail=0.05, noise_p_false=0.05)
    fe = tf.SensorFrontend(tf.FrontendConfig(p2m=pcfg, backend=backend))
    params = fe.init(torch.Generator().manual_seed(0), device="cpu")
    params["w"].requires_grad_(True)
    params["v_th"].requires_grad_(True)
    frames = torch.rand((2, 8, 8, 3), generator=torch.Generator()
                        .manual_seed(1))
    acts, aux = fe(params, frames, key=prng.PRNGKey(0))
    assert acts.grad_fn is not None
    assert aux["hoyer_loss"].grad_fn is not None
    g_w, g_vth = torch.autograd.grad(acts.sum(), [params["w"],
                                                 params["v_th"]])
    assert bool(torch.isfinite(g_w).all()) and bool((g_w != 0).any())
    assert bool(torch.isfinite(g_vth)) and float(g_vth) != 0.0


@pytest.mark.parametrize("backend", ["ideal", "analog", "device"])
def test_census_one_packed_conv_and_no_kernel(backend, monkeypatch):
    """The census of ``frontend.{ideal,analog,device}`` (one conv, no
    kernel): each backend calls ``phase_conv`` once, and no wrapper of
    ``kernels.ops`` at all."""
    import inspect
    calls = []
    conv = t_p2m.phase_conv

    def counted(x, w, stride):
        calls.append(tuple(w.shape))
        return conv(x, w, stride)

    def refuse(*a, **k):
        raise AssertionError("a kernels.ops wrapper was called")

    monkeypatch.setattr(t_p2m, "phase_conv", counted)
    for name, obj in vars(t_ops).items():
        if inspect.isfunction(obj):
            monkeypatch.setattr(t_ops, name, refuse)
    fe = tf.SensorFrontend(tf.FrontendConfig(backend=backend))
    params = fe.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.rand((2, 8, 8, 3), generator=torch.Generator()
                        .manual_seed(1))
    fe(params, frames, key=prng.PRNGKey(0))
    packed = 32 if backend == "ideal" else 64      # one 2C-channel conv
    assert calls == [(3, 3, 3, packed)]


def test_hetero_majority_equals_poly_for_identical_devices():
    p = np.random.default_rng(7).uniform(size=(256,)).astype(np.float32)
    p[:2] = (0.0, 1.0)
    for n, m in ((8, 4), (5, 3), (6, 2)):
        pt = torch.from_numpy(p)
        devices = pt[:, None].expand(-1, n)
        poly = t_mtj.majority_prob_poly(pt, n, m).numpy()
        for fn in (t_mtj.majority_prob_hetero, t_mtj.majority_prob_hetero_dp):
            np.testing.assert_allclose(fn(devices, m).numpy(), poly, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("spec_kw", [{}, dict(h_in=32, w_in=32, h_out=8,
                                             w_out=8)])
def test_energy_report_matches_reference(spec_kw):
    got = t_energy.energy_report(t_energy.FrameSpec(**spec_kw))
    want = j_energy.energy_report(j_energy.FrameSpec(**spec_kw))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    if not spec_kw:     # the paper's VGG16 ImageNet figures
        assert got["bandwidth_reduction"] == pytest.approx(6.0)
        assert got["comm_improvement"] == pytest.approx(8.5, abs=0.05)


def test_frontend_init_defaults_to_the_gpu():
    """No device= means the GPU: without one ``init`` raises and names the
    way to ask for the CPU; ``device="cpu"`` is explicit."""
    fe = tf.SensorFrontend(tf.FrontendConfig(backend="device"))
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert fe.init(gen)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fe.init(gen)
    params = fe.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["w"].device.type == params["v_th"].device.type == "cpu"


def test_quickstart_runs_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.quickstart",
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "['analog', 'cuda', 'device', 'ideal']" in out
    for line in ("bandwidth reduction: 6.0x", "communication:       8.5x",
                 "P_sw(0.8 V, 700 ps) = 0.9240"):
        assert line in out, line


# --- the whole slice ----------------------------------------------------------

def _configs(arch, **p2m_kw):
    return (jv.VisionConfig(name="t", arch=arch, num_classes=10,
                            p2m=j_p2m.P2MConfig(**p2m_kw)),
            tv.VisionConfig(name="t", arch=arch, num_classes=10,
                            p2m=t_p2m.P2MConfig(**p2m_kw)))


def _params(arch, seed=0):
    cfg_j, _ = _configs(arch)
    pj = jv.init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, tp.from_numpy(jax.tree.map(np.asarray, pj))


def _frames(b, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(size=(b, 32, 32, 3))).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _compare_outputs(oj, ot, n_frontend):
    assert set(ot) == set(oj)
    # identical frontend draws: the per-frame activation counts agree
    np.testing.assert_allclose(float(ot["activated_fraction"]),
                               float(oj["activated_fraction"]),
                               rtol=0, atol=0.5 / n_frontend)
    np.testing.assert_array_equal(_np(ot["labels"]), np.asarray(oj["labels"]))
    np.testing.assert_allclose(_np(ot["probs"]), np.asarray(oj["probs"]),
                               rtol=0, atol=PROBS_ATOL)
    for k in ("theta", "v_conv_mean", "v_conv_min", "v_conv_max",
              "p2m_sparsity"):
        np.testing.assert_allclose(float(ot[k]), float(oj[k]),
                                   rtol=THETA_RTOL, err_msg=k)
    np.testing.assert_allclose(_np(ot["channel_rates"]),
                               np.asarray(oj["channel_rates"]), atol=1e-6)
    for k in ("sensor_latency_us", "sensor_fps"):
        assert float(ot[k]) == pytest.approx(float(oj[k]), rel=1e-12)


@pytest.fixture(scope="module", params=["vgg_tiny", "resnet20"])
def model(request):
    arch = request.param
    return (arch, *_configs(arch), *_params(arch))


def test_device_engine_classify_matches_reference(model):
    arch, cfg_j, cfg_t, pj, pt = model
    frames = _frames(4, seed=0)
    ej = JaxEngine(cfg_j, pj, backend="device", seed=3)
    et = VisionEngine(cfg_t, pt, backend="device", seed=3, device="cpu")
    for _ in range(2):     # the frame counter advances the key identically
        oj, ot = ej.classify(jnp.asarray(frames)), et.classify(frames)
        _compare_outputs(oj, ot, 16 * 16 * 32)


def test_device_engine_stream_matches_reference(model):
    """Three microbatches, each its own folded key; off the ``cuda``
    backend every step is exact and carries no stream telemetry."""
    arch, cfg_j, cfg_t, pj, pt = model
    frames = np.concatenate([_frames(2, 1, 0.1), _frames(2, 2),
                             _frames(2, 3, 0.5)])
    ej = JaxEngine(cfg_j, pj, backend="device", microbatch=2)
    et = VisionEngine(cfg_t, pt, backend="device", device="cpu",
                      microbatch=2)
    (oj,) = list(ej.stream([jnp.asarray(frames)]))
    (ot,) = list(et.stream([frames]))
    _compare_outputs(oj, ot, 6 * 16 * 16 * 32)
    assert "stream_fused" not in ot and "theta_used" not in ot
    assert et.fused_step_count == 0
    with pytest.raises(ValueError, match="cuda"):
        VisionEngine(cfg_t, pt, backend="device", device="cpu",
                     fused_stream=True)


@pytest.mark.parametrize("backend,noise", [("ideal", 0.0), ("analog", 0.0),
                                           ("analog", 0.05)])
def test_ideal_and_analog_forward_match_reference(model, backend, noise):
    arch, _, _, pj, pt = model
    cfg_j, cfg_t = _configs(arch, noise_p_fail=noise, noise_p_false=noise)
    frames = _frames(3, seed=4)
    kj, kt = _key(2)
    lj, _, aj = jv.forward(pj, jnp.asarray(frames), cfg_j, key=kj,
                            backend=backend)
    with torch.no_grad():
        lt, _, at = tv.forward(pt, torch.from_numpy(frames), cfg_t, key=kt,
                                backend=backend)
    np.testing.assert_allclose(float(at["p2m_sparsity"]),
                               float(aj["p2m_sparsity"]), rtol=0,
                               atol=0.5 / (3 * 16 * 16 * 32))
    np.testing.assert_allclose(_np(at["channel_rates"]),
                               np.asarray(aj["channel_rates"]), atol=1e-6)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(at["theta"]), float(aj["theta"]),
                               rtol=THETA_RTOL)
