"""The port's models and serving engine against the JAX package.

* the parameter bridge (``from_numpy`` / ``to_numpy``) and the model specs;
* the eval backbone (vgg_tiny, resnet20) layer by layer on identical
  inputs: a binary unit may differ only within a few ulps of its
  per-example threshold (the convs sum in another order), and logits agree
  when no unit differs;
* the slice: ``VisionEngine(backend="cuda", device="cpu")`` against
  ``VisionEngine(backend="pallas")`` with the same weights, seed and frames,
  for ``classify`` and a three-microbatch fused ``stream`` at three drift
  tolerances. At these seeds every frontend draw agrees (checked through
  the per-frame activation counts), so probs agree to float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import vision as jv
from repro.serving import VisionEngine as JaxEngine
from repro_torch import prng
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine

# logits of a float32 backbone whose convs sum in another order
LOGIT_ATOL = 1e-5
# a differing binary unit must sit this close to its threshold (relative)
THRESHOLD_ULPS_REL = 4 * np.finfo(np.float32).eps


def _configs(arch):
    return (jv.VisionConfig(name="t", arch=arch, num_classes=10),
            tv.VisionConfig(name="t", arch=arch, num_classes=10))


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


def test_param_bridge_round_trip():
    pj, pt = _params("vgg_tiny")
    back = tp.to_numpy(pt)
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert b.dtype == np.asarray(a).dtype


@pytest.mark.parametrize("arch", ["vgg16", "vgg_tiny", "resnet18",
                                  "resnet20"])
def test_model_spec_shapes_match(arch):
    cfg_j, cfg_t = _configs(arch)
    shapes_j = jax.tree.map(lambda s: tuple(s.shape), jv.model_spec(cfg_j),
                            is_leaf=lambda s: hasattr(s, "axes"))
    shapes_t = jax.tree.map(lambda s: tuple(s.shape), tv.model_spec(cfg_t),
                            is_leaf=lambda s: isinstance(s, tp.ParamSpec))
    assert shapes_t == shapes_j
    params = tv.init_params(0, cfg_t)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes_j


def _layer_pairs(arch, pj, pt, x_nhwc):
    """Run the backbone layer by layer, each layer fed the REFERENCE's
    input on both sides. Yields (ref_out, port_out_nhwc, ref z, ref thr) for
    binary layers and returns the reference's final features."""
    bits = 4

    def both(lp_j, lp_t, x, binary=True):
        oj, _, _ = jv._conv_apply(lp_j, jnp.asarray(x), 1, bits,
                                  binary=binary)
        ot, _, _ = tv._conv_apply(lp_t, torch.tensor(x).permute(0, 3, 1, 2),
                               1, bits, binary=binary)
        return np.asarray(oj), _np(ot.permute(0, 2, 3, 1))

    def z_thr(lp_j, x):
        w = jv.p2m.quantize_weights(lp_j["w"], bits)
        y = jax.lax.conv_general_dilated(
            jnp.asarray(x), w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        y = (y - lp_j["bn_mean"]) / jnp.sqrt(lp_j["bn_var"] + 1e-5)
        y = y * lp_j["bn_scale"] + lp_j["bn_bias"]
        z = y / jnp.maximum(lp_j["v_th"], 1e-6)
        thr = jv.hoyer.hoyer_extremum(jv.hoyer.clip01(z), axis=(1, 2, 3),
                                      keepdims=True)
        return np.asarray(z), np.asarray(thr)

    checks = []
    x = x_nhwc
    if arch.startswith("vgg"):
        i = 0
        for item in jv._VGG_PLANS[arch]:
            if item == "M":
                if x.shape[1] > 1:
                    xj = np.asarray(jv._maxpool(jnp.asarray(x)))
                    xt = _np(tv._maxpool(torch.tensor(x).permute(
                        0, 3, 1, 2)).permute(0, 2, 3, 1))
                    np.testing.assert_array_equal(xt, xj)
                    x = xj
                continue
            name = f"conv{i}"
            oj, ot = both(pj["layers"][name], pt["layers"][name], x)
            checks.append((oj, ot, *z_thr(pj["layers"][name], x)))
            x = oj
            i += 1
    else:
        for name in sorted(pj["layers"]):
            bj, bt = pj["layers"][name], pt["layers"][name]
            h1j, h1t = both(bj["c1"], bt["c1"], x)
            checks.append((h1j, h1t, *z_thr(bj["c1"], x)))
            h2j, h2t = both(bj["c2"], bt["c2"], h1j)
            checks.append((h2j, h2t, *z_thr(bj["c2"], h1j)))
            sc = x
            if "proj" in bj:
                scj, sct = both(bj["proj"], bt["proj"], x, binary=False)
                np.testing.assert_allclose(sct, scj, rtol=1e-5, atol=1e-5)
                sc = scj
            x = h2j + sc
    return checks, x


@pytest.mark.parametrize("arch", ["vgg_tiny", "resnet20"])
def test_backbone_eval_parity(arch):
    pj, pt = _params(arch, seed=1)
    cfg_j, cfg_t = _configs(arch)
    rng = np.random.default_rng(2)
    acts = (rng.uniform(size=(2, 8, 8, 32)) < 0.25).astype(np.float32)
    checks, feat_j = _layer_pairs(arch, pj, pt, acts)
    flips = 0
    for oj, ot, z, thr in checks:
        diff = oj != ot
        flips += int(diff.sum())
        near = np.abs(z - thr) <= THRESHOLD_ULPS_REL * np.maximum(
            np.abs(thr), 1.0)
        assert not (diff & ~near).any(), "binary unit differs off-threshold"
    # the port's whole backbone from the same frontend activations
    with torch.no_grad():
        feat_t, _, _ = tv._backbone(pt, torch.from_numpy(acts).permute(
            0, 3, 1, 2), cfg_t)
    logits_t = _np(feat_t @ pt["head"]["w"] + pt["head"]["b"])
    logits_j = np.asarray(jnp.mean(jnp.asarray(feat_j), axis=(1, 2))
                          @ pj["head"]["w"] + pj["head"]["b"])
    if flips == 0:
        np.testing.assert_allclose(logits_t, logits_j, rtol=0,
                                   atol=LOGIT_ATOL)


def _compare_outputs(oj, ot, n_frontend):
    assert set(ot) == set(oj)
    np.testing.assert_array_equal(_np(ot["labels"]), np.asarray(oj["labels"]))
    np.testing.assert_allclose(_np(ot["probs"]), np.asarray(oj["probs"]),
                               rtol=0, atol=1e-6)
    # identical frontend draws: the per-frame activation counts agree
    np.testing.assert_allclose(float(ot["activated_fraction"]),
                               float(oj["activated_fraction"]),
                               rtol=0, atol=0.5 / n_frontend)
    for k in ("theta", "theta_used", "v_conv_mean", "v_conv_min",
              "v_conv_max", "p2m_sparsity"):
        if k in oj:
            np.testing.assert_allclose(float(ot[k]), float(oj[k]),
                                       rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(ot["channel_rates"]),
                               np.asarray(oj["channel_rates"]), atol=1e-6)
    for k in ("sensor_latency_us", "sensor_fps"):
        assert float(ot[k]) == pytest.approx(float(oj[k]), rel=1e-12)


@pytest.fixture(scope="module")
def tiny():
    pj, pt = _params("vgg_tiny")
    return (*_configs("vgg_tiny"), pj, pt)


def test_classify_matches_reference_engine(tiny):
    cfg_j, cfg_t, pj, pt = tiny
    frames = _frames(4, seed=0)
    ej = JaxEngine(cfg_j, pj, backend="pallas", seed=3)
    et = VisionEngine(cfg_t, pt, backend="cuda", seed=3, device="cpu")
    for _ in range(2):     # the frame counter advances the key identically
        oj, ot = ej.classify(jnp.asarray(frames)), et.classify(frames)
        _compare_outputs(oj, ot, 16 * 16 * 32)


@pytest.mark.parametrize("tol", [0.0, 0.05, 1e9])
def test_stream_matches_reference_engine(tiny, tol):
    cfg_j, cfg_t, pj, pt = tiny
    frames = np.concatenate([_frames(2, 1, 0.1), _frames(2, 2),
                             _frames(2, 3, 0.1)])
    kw = dict(microbatch=2, fused_stream=True, fused_theta_tol=tol)
    ej = JaxEngine(cfg_j, pj, backend="pallas", **kw)
    et = VisionEngine(cfg_t, pt, backend="cuda", device="cpu", **kw)
    (oj,) = list(ej.stream([jnp.asarray(frames)]))
    (ot,) = list(et.stream([frames]))
    _compare_outputs(oj, ot, 6 * 16 * 16 * 32)
    assert (et.fused_step_count, et.fused_fallback_count) == \
        (ej.fused_step_count, ej.fused_fallback_count)
    assert et.fused_step_count == 2
    np.testing.assert_allclose(float(ot["stream_fused"]),
                               float(oj["stream_fused"]), rtol=1e-6)


def test_engine_defaults_to_the_gpu():
    """No device= means the GPU; without one the engine refuses to move to
    the CPU on its own and names the way to ask for it."""
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    params = tv.init_params(0, cfg)
    if torch.cuda.is_available():
        assert VisionEngine(cfg, params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            VisionEngine(cfg, params)


def test_engine_refuses_unported_options():
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    params = tv.init_params(0, cfg)
    with pytest.raises(TypeError):
        VisionEngine(cfg, params, device="cpu", mesh=None)
    # obs= and sync_timing= are served (the telemetry slice)
    assert VisionEngine(cfg, params, device="cpu", obs=None,
                        sync_timing=True)._obs is None
    # drift= is served (the lifetime slice): None is no aging at all
    assert VisionEngine(cfg, params, device="cpu", drift=None).lifetime \
        is None
    with pytest.raises(KeyError):
        VisionEngine(cfg, params, backend="pallas", device="cpu")
    # a programmed trim is served (the variation slice): a zero trim is the
    # nominal chip bit for bit
    trimmed = {**params, "p2m": {**params["p2m"],
                                 "cal_trim": torch.zeros(32)}}
    frames = torch.from_numpy(_frames(1, 0))
    with torch.no_grad():
        nominal = tv.forward(params, frames, cfg, key=prng.PRNGKey(0))[0]
        assert torch.equal(tv.forward(trimmed, frames, cfg,
                                      key=prng.PRNGKey(0))[0], nominal)


def test_port_init_is_seeded():
    cfg = tv.VisionConfig(name="t", arch="vgg_tiny")
    a, b = tv.init_params(5, cfg), tv.init_params(5, cfg)
    c = tv.init_params(6, cfg)
    assert torch.equal(a["p2m"]["w"], b["p2m"]["w"])
    assert not torch.equal(a["p2m"]["w"], c["p2m"]["w"])
