"""The port's device variation and calibration against the JAX package.

Tolerances and why:

* ``sample_chip``: every map within 4 float32 ulps of the reference's
  (``prng.normal`` is within 3 of ``jax.random.normal``, and the chip's
  maps are one multiply-add of it; for a map ``1 + sigma * n``, ulps of
  the larger of the map and its term ``sigma * n``); the subtractor offset
  with correlated
  column noise within 4 ulps of the column sum's own scale (``sigma`` times
  the sum of |kernel tap x noise|: XLA's convolution adds the taps in
  another order, which cancels where the sum is near zero);
* ``identity_chip``, ``channel_operands`` and ``pixel_operands`` on fed
  maps within 1 ulp (a channel mean of 8 summed in another order);
  ``device_chain`` at rtol 1e-6 and ``noise_maps`` at 1e-6 (XLA and
  PyTorch transcendentals differ by ulps);
* the ``analog`` and ``device`` backends with a fed chip and a trim: the
  threefry words bit for bit, and an activation may differ only where a
  uniform lies within 1e-6 of its probability (or, for ``analog``, z within
  4 ulps of the Hoyer threshold); the ``cuda`` backend's plain path with a
  chip against the reference's ``pallas`` backend in interpret mode by the
  word-boundary rule of ``tests/draw_asserts.py``;
* ``calibrate`` on vgg_tiny's frontend: each channel's trim within
  8 * span / 2^iters of the reference's (the rates sum in another order,
  so a bisection step near the target may go the other way, a few LSBs),
  ``rate_err_before`` / ``rate_err_after`` within 1e-6 of the reference's
  chain on the port's u, theta, chip and trim, averaged in float64 (the
  reference's float32 mean is a sequential sum, 2.5e-6 off at this size,
  the port's 1e-7);
* ``yield_sweep`` at 8 chips: the yield fractions equal, the error figures
  at rtol 1e-5 (above 4 ulps of 1: a fail rate is 1 - q of a q near 1),
  the read margin within 1e-6 V;
* ``VisionEngine(calibration=)`` under ``tests/test_torch_vision.py``'s
  rules; a zero profile and a zero trim bit for bit the nominal path on
  every backend.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draw_asserts import assert_draws_match_modulo_word_boundary
from repro import frontend as jf
from repro.core import mtj as j_mtj
from repro.core import p2m as j_p2m
from repro.core import pixel as j_pixel
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import vision as jv
from repro.serving import VisionEngine as JaxEngine
from repro.variation.calibrate import calibrate as j_calibrate
from repro.variation.calibrate import channel_rates as j_channel_rates
from repro.variation.calibrate import solve_trim as j_solve_trim
from repro.variation.calibrate import target_rates as j_target_rates
from repro.variation import chip as j_chip
from repro.variation import yield_analysis as j_yield
from repro_torch import frontend as tf
from repro_torch import prng
from repro_torch.core import p2m as t_p2m
from repro_torch.frontend import backends as t_backends
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine
from repro_torch.variation.calibrate import CalibrationArtifact
from repro_torch.variation.calibrate import apply_calibration
from repro_torch.variation.calibrate import calibrate as t_calibrate
from repro_torch.variation.calibrate import channel_rates as t_channel_rates
from repro_torch.variation.calibrate import solve_trim as t_solve_trim
from repro_torch.variation.calibrate import target_rates as t_target_rates
from repro_torch.variation import chip as t_chip
from repro_torch.variation import yield_analysis as t_yield

F32_EPS = np.finfo(np.float32).eps
NORMAL_ULPS = 4
DRAW_EDGE = 1e-6
THRESHOLD_ULPS_REL = 4 * F32_EPS
MAX_MISMATCH_FRAC = 1e-3
# a fail rate is 1 - q of a q near 1: an ulp of q is an ulp of 1 in it, so
# the error figures hold at rtol 1e-5 above 4 float32 ulps of 1
YIELD_ATOL = 4 * 2.0 ** -23
# BENCH_variation.json's profile (sigma scale 1.0)
PROFILE = dict(sigma_column=0.15, sigma_logit_offset=0.4,
               sigma_logit_slope=0.05, sigma_pixel_gain=0.05,
               sigma_pixel_offset=0.25, sigma_r_p=0.05, sigma_tmr=0.05)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _configs(**kw):
    return j_chip.VariationConfig(**kw), t_chip.VariationConfig(**kw)


def _fed(chip_j):
    """The reference's maps as the port's ChipMaps."""
    return t_chip.ChipMaps(*(_t(m) for m in chip_j))


def _assert_ulps(got, want, n_ulps, scale=None, msg=""):
    """|got - want| within n_ulps float32 ulps of max(|want|, scale)."""
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= n_ulps * ulp), msg


def _column_scale(vcfg, n, chip_id):
    """sigma_column * sum_j |k_j * eps_(i+j)| + |offset term|: the scale of
    the column sum at each channel, from the reference's own draws."""
    key = jax.random.fold_in(jax.random.PRNGKey(vcfg.chip_seed), chip_id)
    ks = jax.random.split(key, 7)
    eps = np.abs(np.asarray(jax.random.normal(ks[6], (n,)), np.float64))
    po = np.abs(vcfg.sigma_pixel_offset
                * np.asarray(jax.random.normal(ks[5], (n,)), np.float64))
    r = max(int(3.0 * vcfg.column_corr), 1)
    d = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (d / max(vcfg.column_corr, 1e-6)) ** 2)
    k = k / np.sqrt(np.sum(k ** 2))
    idx = (np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :]) % n
    return vcfg.sigma_column * (eps[idx] @ np.abs(k)) + po


# --- the chip --------------------------------------------------------------

@pytest.mark.parametrize("profile", [
    PROFILE, dict(sigma_logit_offset=0.3, chip_seed=5),
    dict(sigma_column=0.3, column_corr=9.0, sigma_pixel_offset=0.1),
    dict(sigma_column=0.2, column_corr=0.2, sigma_r_p=0.5, sigma_tmr=0.5,
         sigma_logit_slope=0.9)], ids=["bench", "offset", "wide", "narrow"])
@pytest.mark.parametrize("c,chip_id", [(32, 3), (5, 11), (8, 0)])
def test_sample_chip_matches_reference(profile, c, chip_id):
    """Including column noise whose kernel radius exceeds the channel count
    (C 5 and 8 against r 12 and 27: the circle wraps more than once)."""
    vj, vt = _configs(**profile)
    want = j_chip.sample_chip(vj, c, 8, chip_id)
    got = t_chip.sample_chip(vt, c, 8, chip_id, device="cpu")
    assert type(got) is t_chip.ChipMaps
    for name in t_chip.ChipMaps._fields[:-1]:
        w_ = np.asarray(getattr(want, name))
        assert tuple(getattr(got, name).shape) == w_.shape
        # a map 1 + sigma * n: ulps of the draw's term before the 1 is added
        scale = None if name == "mtj_logit_offset" else np.abs(w_ - 1.0)
        _assert_ulps(getattr(got, name), w_, NORMAL_ULPS, scale, name)
    scale = (_column_scale(vj, c, chip_id) if vj.sigma_column > 0
             else None)
    _assert_ulps(got.pixel_offset, want.pixel_offset, NORMAL_ULPS, scale,
                 "pixel_offset")


def test_sample_chip_defaults_to_the_gpu_and_stacks_chips():
    """No device= means the GPU (raising without one); ``sample_chips``
    draws every chip of a fleet at once, row g equal to chip g bit for
    bit; a zero profile samples the identity chip."""
    vcfg = t_chip.VariationConfig(**PROFILE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_chip.sample_chip(vcfg, 8, 8, 0)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_chip.identity_chip(8, 8)
    ids = [0, 4, 9]
    stack = t_chip.sample_chips(vcfg, 16, 8, ids, device="cpu")
    for g, cid in enumerate(ids):
        one = t_chip.sample_chip(vcfg, 16, 8, cid, device="cpu")
        assert all(torch.equal(a[g], b) for a, b in zip(stack, one))
    zero = t_chip.sample_chip(t_chip.VariationConfig(), 16, 8, 2,
                              device="cpu")
    for a, b in zip(zero, t_chip.identity_chip(16, 8, device="cpu")):
        assert torch.equal(a, b)


def test_variation_entry_points_default_to_the_gpu(tiny):
    """``calibrate``, ``chip_stats``, ``yield_sweep`` and ``accuracy_sweep``
    run on the GPU unless asked otherwise: without one each raises and
    names ``device="cpu"``; with one their results lie on it."""
    _, cfg_t, _, pt, frames = tiny
    calls = {
        "calibrate": lambda: t_calibrate(pt["p2m"], cfg_t.p2m,
                                         cfg_t.variation, frames[:1],
                                         iters=2).trim,
        "chip_stats": lambda: t_yield.chip_stats(
            cfg_t.variation, 0, 32)["fail_worst"],
        "yield_sweep": lambda: t_yield.yield_sweep(cfg_t.variation, (1.0,),
                                                   2, 32),
        "accuracy_sweep": lambda: t_yield.accuracy_sweep(
            pt, cfg_t, [], vcfg=cfg_t.variation, sigmas=(), n_chips=1,
            calibration_frames=None, key=prng.PRNGKey(0))}
    for name, call in calls.items():
        if torch.cuda.is_available():
            out = call()
            if isinstance(out, torch.Tensor):
                assert out.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()


def test_operands_match_reference():
    vj, _ = _configs(**PROFILE)
    chip_j = j_chip.sample_chip(vj, 32, 8, 3)
    chip_t = _fed(chip_j)
    trim = np.random.default_rng(0).normal(size=32).astype(np.float32) * 0.1
    for a, b in zip(t_chip.identity_chip(32, 8, device="cpu"),
                    j_chip.identity_chip(32, 8)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(_np(t_chip.identity_operands(32)),
                                  np.asarray(j_chip.identity_operands(32)))
    for t_trim, j_trim in ((None, None), (_t(trim), jnp.asarray(trim))):
        rows_t = t_chip.channel_operands(chip_t, t_trim)
        rows_j = j_chip.channel_operands(chip_j, j_trim)
        assert rows_t.dtype == torch.float32
        _assert_ulps(rows_t, rows_j, 1)
        pix_t = t_chip.pixel_operands(chip_t, 64, t_trim)
        pix_j = j_chip.pixel_operands(chip_j, 64, j_trim)
        assert tuple(pix_t.shape) == pix_j.shape == (4, 64, 32)
        _assert_ulps(pix_t, pix_j, 1)


def test_device_chain_and_noise_maps_match_reference():
    vj, _ = _configs(**PROFILE)
    chip_j = j_chip.sample_chip(vj, 16, 8, 2)
    chip_t = _fed(chip_j)
    rng = np.random.default_rng(1)
    u = (rng.normal(size=(2, 4, 4, 16)) * 0.5).astype(np.float32)
    trim = (rng.normal(size=16) * 0.1).astype(np.float32)
    pcfg = j_p2m.P2MConfig()
    for t_trim, j_trim in ((None, None), (_t(trim), jnp.asarray(trim))):
        v_t, p_t = t_chip.device_chain(_t(u), torch.tensor(0.3), chip_t,
                                       t_trim, pcfg.pixel, pcfg.mtj)
        v_j, p_j = j_chip.device_chain(jnp.asarray(u), jnp.asarray(0.3),
                                       chip_j, j_trim, pcfg.pixel, pcfg.mtj)
        assert tuple(p_t.shape) == p_j.shape == (2, 4, 4, 16, 8)
        np.testing.assert_allclose(_np(v_t), np.asarray(v_j), rtol=1e-6)
        np.testing.assert_allclose(_np(p_t), np.asarray(p_j), rtol=1e-6,
                                   atol=1e-7)
    for got, want in zip(t_chip.noise_maps(chip_t),
                         j_chip.noise_maps(chip_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=1e-6)


# --- the backends ------------------------------------------------------------

def _frontend_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 32)) * 0.27).astype(np.float32)
    return x, w, np.float32(1.0)


def _run_backend(backend, params_extra_j, params_extra_t, x, w, v_th,
                 key_seed, vcfg=None):
    pj, pt = j_p2m.P2MConfig(), t_p2m.P2MConfig()
    vj, vt = (None, None) if vcfg is None else _configs(**vcfg)
    fj = jf.SensorFrontend(jf.FrontendConfig(p2m=pj, backend=backend,
                                             variation=vj, chip_id=3))
    ft = tf.SensorFrontend(tf.FrontendConfig(p2m=pt, backend=backend,
                                             variation=vt, chip_id=3))
    kj = jax.random.fold_in(jax.random.PRNGKey(key_seed), 1)
    kt = np.asarray(jax.random.key_data(kj))
    oj, aj = fj({"w": jnp.asarray(w), "v_th": jnp.asarray(v_th),
                 **params_extra_j}, jnp.asarray(x), key=kj)
    ot, at = ft({"w": _t(w), "v_th": torch.tensor(v_th), **params_extra_t},
                _t(x), key=kt)
    return (np.asarray(oj), aj), (_np(ot), at), kj, kt


def _extras(with_chip, with_trim, c=32):
    vj, _ = _configs(**PROFILE)
    chip_j = j_chip.sample_chip(vj, c, 8, 5)
    trim = (np.random.default_rng(2).normal(size=c) * 0.2).astype(np.float32)
    ej, et = {}, {}
    if with_chip:
        ej["chip"], et["chip"] = chip_j, _fed(chip_j)
    if with_trim:
        ej["cal_trim"], et["cal_trim"] = jnp.asarray(trim), _t(trim)
    return ej, et, chip_j


def _check_aux(aj, at):
    np.testing.assert_allclose(float(at["theta"]), float(aj["theta"]),
                               rtol=1e-5)
    for k in ("v_conv_mean", "v_conv_min", "v_conv_max"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def _check_acts(oj, ot, allowed):
    diff = ot != oj
    assert diff.sum() <= max(2, MAX_MISMATCH_FRAC * diff.size)
    assert not (diff & ~allowed).any(), "activation differs off the edge"


@pytest.mark.parametrize("with_chip,with_trim", [(True, False), (True, True),
                                                 (False, True)])
def test_device_backend_with_chip_matches_reference(with_chip, with_trim):
    x, w, v_th = _frontend_inputs(0)
    ej, et, chip_j = _extras(with_chip, with_trim)
    (oj, aj), (ot, at), kj, kt = _run_backend("device", ej, et, x, w, v_th, 4)
    _check_aux(aj, at)
    pcfg = j_p2m.P2MConfig()
    u = j_p2m.hardware_conv(jnp.asarray(x), jnp.asarray(w), pcfg)
    theta = jf.backends._theta(u, jnp.asarray(v_th))
    chip = chip_j if with_chip else j_chip.identity_chip(32, 8)
    _, p_dev = j_chip.device_chain(u, theta, chip, ej.get("cal_trim"),
                                   pcfg.pixel, pcfg.mtj)
    # the words: the port's uniforms of the key are jax's bit for bit
    unif_j = np.asarray(jax.random.uniform(kj, p_dev.shape))
    np.testing.assert_array_equal(_np(prng.uniform(kt, p_dev.shape)), unif_j)
    near = (np.abs(unif_j - np.asarray(p_dev)) < DRAW_EDGE).any(axis=-1)
    _check_acts(oj, ot, near)


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_analog_backend_with_chip_matches_reference(noise):
    """The Fig. 8 flips drawn from the chip's noise maps, combined with the
    configured scalars as 1 - (1 - a)(1 - b)."""
    x, w, v_th = _frontend_inputs(1)
    ej, et, chip_j = _extras(True, True)
    pj = dataclasses.replace(j_p2m.P2MConfig(), noise_p_fail=noise,
                             noise_p_false=noise)
    pt = t_p2m.P2MConfig(noise_p_fail=noise, noise_p_false=noise)
    fj = jf.SensorFrontend(jf.FrontendConfig(p2m=pj, backend="analog"))
    ft = tf.SensorFrontend(tf.FrontendConfig(p2m=pt, backend="analog"))
    kj = jax.random.fold_in(jax.random.PRNGKey(6), 1)
    kt = np.asarray(jax.random.key_data(kj))
    oj, aj = fj({"w": jnp.asarray(w), "v_th": jnp.asarray(v_th), **ej},
                jnp.asarray(x), key=kj)
    ot, at = ft({"w": _t(w), "v_th": torch.tensor(v_th), **et}, _t(x),
                key=kt)
    _check_aux(aj, at)
    u = j_p2m.hardware_conv(jnp.asarray(x), jnp.asarray(w), pj)
    z = np.asarray(u) / float(v_th)
    thr = float(jv.hoyer.hoyer_extremum(jv.hoyer.clip01(jnp.asarray(z))))
    near = np.abs(z - thr) <= THRESHOLD_ULPS_REL * max(abs(thr), 1.0)
    p_fail, p_false = (np.asarray(m) for m in j_chip.noise_maps(
        chip_j, pj.mtj, pj.pixel))
    p_fail = 1.0 - (1.0 - p_fail) * (1.0 - noise)
    p_false = 1.0 - (1.0 - p_false) * (1.0 - noise)
    k1, k2 = jax.random.split(kj)
    for k, p in ((k1, p_fail), (k2, p_false)):
        unif = np.asarray(jax.random.uniform(k, oj.shape))
        np.testing.assert_array_equal(
            _np(prng.uniform(np.asarray(jax.random.key_data(k)), oj.shape)),
            unif)
        near |= np.abs(unif - p) < DRAW_EDGE
    _check_acts(oj, _np(ot), near)
    assert (np.asarray(oj) != np.asarray(fj({"w": jnp.asarray(w),
                                             "v_th": jnp.asarray(v_th)},
                                            jnp.asarray(x), key=kj)[0])).any()


@pytest.mark.parametrize("with_chip,with_trim", [(True, True),
                                                 (False, True)])
def test_cuda_backend_with_chip_matches_pallas(with_chip, with_trim):
    """The ``cuda`` backend's plain path folds chip and trim into the (4, C)
    rows as the reference's ``pallas`` backend does (interpret mode)."""
    x, w, v_th = _frontend_inputs(2)
    ej, et, chip_j = _extras(with_chip, with_trim)
    pj = j_p2m.P2MConfig()
    fj = jf.SensorFrontend(jf.FrontendConfig(p2m=pj, backend="pallas"))
    ft = tf.SensorFrontend(tf.FrontendConfig(p2m=t_p2m.P2MConfig(),
                                             backend="cuda"))
    kj = jax.random.fold_in(jax.random.PRNGKey(8), 1)
    kt = np.asarray(jax.random.key_data(kj))
    oj, aj = fj({"w": jnp.asarray(w), "v_th": jnp.asarray(v_th), **ej},
                jnp.asarray(x), key=kj)
    ot, at = ft({"w": _t(w), "v_th": torch.tensor(v_th), **et}, _t(x),
                key=kt)
    for k in ("theta", "v_conv_mean", "v_conv_min", "v_conv_max"):
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   err_msg=k)
    chip = chip_j if with_chip else j_chip.identity_chip(32, 8)
    chan = j_chip.channel_operands(chip, ej.get("cal_trim"))
    wq = j_p2m.quantize_weights(jnp.asarray(w), 4)
    u = j_ref.p2m_phase_a_ref(j_ops.im2col(jnp.asarray(x), 3, 2),
                              wq.reshape(27, 32), jnp.asarray(v_th),
                              block_n=128)[0]
    q_ref, _ = j_ref._device_chain_q(u, aj["theta"], chan, pj.pixel, pj.mtj)
    bits = j_ops.draw_bits(kj, u.shape[0], 32)
    assert_draws_match_modulo_word_boundary(_np(ot).reshape(-1, 32), q_ref,
                                            bits)
    assert_draws_match_modulo_word_boundary(np.asarray(oj).reshape(-1, 32),
                                            q_ref, bits)


@pytest.mark.parametrize("backend", ["ideal", "analog", "device", "cuda"])
def test_zero_profile_and_zero_trim_are_the_nominal_path(backend):
    """A profile with every sigma 0 is no chip, and a zero trim (on the
    identity chip) changes no bit: each backend's activations and aux equal
    the nominal call's bit for bit."""
    pcfg = t_p2m.P2MConfig(noise_p_fail=0.01, noise_p_false=0.01)
    fe = tf.SensorFrontend(tf.FrontendConfig(p2m=pcfg, backend=backend))
    fe0 = tf.SensorFrontend(tf.FrontendConfig(
        p2m=pcfg, backend=backend, variation=t_chip.VariationConfig(),
        chip_id=4))
    params = fe.init(torch.Generator().manual_seed(0), device="cpu")
    frames = torch.rand((2, 16, 16, 3),
                        generator=torch.Generator().manual_seed(1))
    key = prng.PRNGKey(5)
    o, aux = fe(params, frames, key=key)
    for f, p in ((fe0, params),
                 (fe, {**params, "cal_trim": torch.zeros(32)})):
        o2, aux2 = f(p, frames, key=key)
        assert torch.equal(o2, o)
        assert set(aux2) == set(aux)
        for k in aux:
            assert torch.equal(torch.as_tensor(aux2[k]),
                               torch.as_tensor(aux[k])), k


def test_sampled_chip_is_kept_and_params_chip_wins():
    """The config's chip is sampled once per (profile, chip, device), and a
    ChipMaps in ``params["chip"]`` overrides it."""
    cfg = tf.FrontendConfig(variation=t_chip.VariationConfig(**PROFILE),
                            chip_id=2)
    cpu = torch.device("cpu")
    a = t_backends._sampled_chip(cfg, cpu)
    assert t_backends._sampled_chip(cfg, cpu) is a
    for x, y in zip(a, t_chip.sample_chip(cfg.variation, 32, 8, 2,
                                          device="cpu")):
        assert torch.equal(x, y)
    other = t_chip.identity_chip(32, 8, device="cpu")
    assert t_backends._resolve_chip(cfg, {"chip": other}, cpu) is other
    # a chip in the params moves with them (VisionEngine, calibrate)
    moved = tp.to_device({"chip": other, "pair": tuple(other[:2])}, cpu)
    assert type(moved["chip"]) is t_chip.ChipMaps
    assert type(moved["pair"]) is tuple and len(moved["pair"]) == 2
    assert t_backends._resolve_chip(tf.FrontendConfig(), {}, cpu) is None


# --- calibration, yield, serving ------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    vj, vt = _configs(**PROFILE)
    cfg_j = jv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            variation=vj, chip_id=3)
    cfg_t = tv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            variation=vt, chip_id=3)
    pj = jv.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tp.from_numpy(jax.tree.map(np.asarray, pj))
    frames = np.random.default_rng(3).uniform(
        size=(4, 32, 32, 3)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, frames


def _ref_stages(pj, cfg_j, frames):
    """The reference calibrate's operands: u, theta and the sampled chip."""
    u = j_p2m.hardware_conv(jnp.asarray(frames), pj["p2m"]["w"], cfg_j.p2m)
    theta = jf.backends._theta(u, pj["p2m"]["v_th"])
    chip = j_chip.sample_chip(cfg_j.variation, 32, 8, cfg_j.chip_id)
    return u, theta, chip


def _mean64(q):
    q = np.asarray(q, np.float64)
    return q.reshape(-1, q.shape[-1]).mean(0)


def _ref_rates64(u, theta, chip, trim, pcfg):
    """The reference's per-channel rates (its chain and heterogeneous
    majority) averaged in float64. Its own float32 mean sums the rows in
    order (XLA:CPU), 2.5e-6 from the exact mean at vgg_tiny's 1,024 rows;
    the port's ``torch.mean`` is within 1e-7 of it."""
    _, p_dev = j_chip.device_chain(u, theta, chip, trim, pcfg.pixel,
                                   pcfg.mtj)
    return _mean64(j_mtj.majority_prob_hetero(p_dev, pcfg.mtj.majority))


def _ref_target64(u, theta, pcfg):
    v = j_pixel.conv_voltage(u, theta, pcfg.pixel)
    p_sw = j_mtj.switching_probability(v, pcfg.mtj.write_pulse_ps, pcfg.mtj)
    return _mean64(j_mtj.majority_prob_poly(p_sw, pcfg.mtj.n_redundant,
                                            pcfg.mtj.majority))


@pytest.mark.parametrize("iters,span", [(16, 2.0), (10, 1.0)])
def test_calibrate_matches_reference(tiny, iters, span):
    """The trim within 8 LSBs of the reference's; ``rate_err_before`` and
    ``rate_err_after`` within 1e-6 of the reference's chain on the port's
    operands and trim, averaged exactly (``_ref_rates64``)."""
    cfg_j, cfg_t, pj, pt, frames = tiny
    art_j = j_calibrate(pj["p2m"], cfg_j.p2m, cfg_j.variation,
                        jnp.asarray(frames), chip_id=3, iters=iters,
                        span=span)
    art_t = t_calibrate(pt["p2m"], cfg_t.p2m, cfg_t.variation,
                        torch.from_numpy(frames), chip_id=3, iters=iters,
                        span=span, device="cpu")
    assert art_t.chip_id == art_j.chip_id == 3
    assert art_t.trim.dtype == torch.float32
    np.testing.assert_allclose(_np(art_t.trim), np.asarray(art_j.trim),
                               rtol=0, atol=8 * span / 2 ** iters)
    # the reference's chain on the port's own stages: u and theta move by
    # ulps between the convs (theta at rtol 2e-6 here), which shifts rates
    # by ~1e-6 and is held by the frontend tests; this holds calibrate
    u_t = t_p2m.hardware_conv(torch.from_numpy(frames), pt["p2m"]["w"],
                              cfg_t.p2m)
    u = jnp.asarray(_np(u_t))
    theta = jnp.asarray(_np(t_backends._theta(u_t, pt["p2m"]["v_th"])))
    chip = j_chip.ChipMaps(*(jnp.asarray(_np(m)) for m in t_chip.sample_chip(
        cfg_t.variation, 32, 8, 3, device="cpu")))
    target = _ref_target64(u, theta, cfg_j.p2m)
    for k, trim in (("rate_err_before", jnp.zeros(32)),
                    ("rate_err_after", jnp.asarray(_np(art_t.trim)))):
        want = np.abs(_ref_rates64(u, theta, chip, trim, cfg_j.p2m) - target)
        np.testing.assert_allclose(_np(getattr(art_t, k)), want, rtol=0,
                                   atol=1e-6, err_msg=k)
    assert float(art_t.rate_err_after.max()) < float(
        art_t.rate_err_before.max())
    assert apply_calibration(pt["p2m"], None) is pt["p2m"]
    assert apply_calibration(pt["p2m"], art_t)["cal_trim"] is art_t.trim


def test_solve_trim_and_rates_match_reference_on_fed_operands(tiny):
    """``target_rates``, ``channel_rates`` and ``solve_trim`` on the
    reference's u, theta and chip: rates within 1e-6 of the reference's
    averaged exactly, the trim within 8 LSBs of its solve."""
    cfg_j, _, pj, pt, frames = tiny
    pcfg, pcfg_t = cfg_j.p2m, t_p2m.P2MConfig()
    u, theta, chip_j = _ref_stages(pj, cfg_j, frames)
    ref_t = t_target_rates(_t(u), _t(theta), pcfg_t)
    np.testing.assert_allclose(_np(ref_t), _ref_target64(u, theta, pcfg),
                               rtol=0, atol=1e-6)
    trim = (np.random.default_rng(4).normal(size=32) * 0.1).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(t_channel_rates(_t(u), _t(theta), _fed(chip_j), _t(trim),
                            pcfg_t)),
        _ref_rates64(u, theta, chip_j, jnp.asarray(trim), pcfg), rtol=0,
        atol=1e-6)
    got = t_solve_trim(_t(u), _t(theta), _fed(chip_j), ref_t, pcfg_t,
                       iters=12)
    want = j_solve_trim(u, theta, chip_j, j_target_rates(u, theta, pcfg),
                        pcfg, iters=12)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=8 * 2.0 / 2 ** 12)


def test_yield_sweep_matches_reference():
    vj, vt = _configs(**PROFILE)
    sigmas = (0.1, 1.0)
    rows_j = j_yield.yield_sweep(vj, sigmas, 8, 32)
    rows_t = t_yield.yield_sweep(vt, sigmas, 8, 32, device="cpu")
    for rj, rt in zip(rows_j, rows_t):
        assert set(rt) == set(rj)
        for k in ("sigma_scale", "yield_fraction",
                  "yield_fraction_calibrated"):
            assert rt[k] == rj[k], k
        np.testing.assert_allclose(rt["read_margin_min_mv"] * 1e-3,
                                   rj["read_margin_min_mv"] * 1e-3, rtol=0,
                                   atol=1e-6)
        for k in ("fail_worst", "fail_mean", "false_worst", "false_mean",
                  "fail_worst_cal", "false_worst_cal"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5,
                                       atol=YIELD_ATOL, err_msg=k)


def test_chip_stats_and_read_margin_match_reference():
    vj, vt = _configs(**PROFILE)
    got = t_yield.chip_stats(vt, 6, 32, device="cpu")
    want = j_yield.chip_stats(vj, 6, 32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=YIELD_ATOL, err_msg=k)
    chip_j = j_chip.sample_chip(vj, 32, 8, 6)
    np.testing.assert_allclose(_np(t_yield.read_margin(_fed(chip_j))),
                               np.asarray(j_yield.read_margin(chip_j)),
                               rtol=0, atol=1e-6)
    for a, b in zip(t_yield.trimmed_chip(_fed(chip_j)),
                    j_yield.trimmed_chip(chip_j)):
        _assert_ulps(a, b, 1, scale=1e-6)


def test_calibrated_engine_matches_reference_engine(tiny):
    """``VisionEngine(calibration=)`` on vgg_tiny with the sampled chip,
    the ``cuda`` backend on the CPU against the reference's ``pallas``
    engine, both programmed with the reference's artifact: labels equal,
    probs at 1e-6, the per-frame activation counts equal (the rules of
    ``tests/test_torch_vision.py``); the trim lands on the engine's
    device."""
    cfg_j, cfg_t, pj, pt, frames = tiny
    art_j = j_calibrate(pj["p2m"], cfg_j.p2m, cfg_j.variation,
                                jnp.asarray(frames), chip_id=3, iters=12)
    art_t = CalibrationArtifact(
        trim=_t(art_j.trim), rate_err_before=_t(art_j.rate_err_before),
        rate_err_after=_t(art_j.rate_err_after), chip_id=3)
    ej = JaxEngine(cfg_j, pj, backend="pallas", seed=3, calibration=art_j)
    et = VisionEngine(cfg_t, pt, backend="cuda", seed=3, device="cpu",
                      calibration=art_t)
    assert et.params["p2m"]["cal_trim"].device.type == "cpu"
    assert "cal_trim" not in pt["p2m"]
    for _ in range(2):
        oj, ot = ej.classify(jnp.asarray(frames)), et.classify(frames)
        np.testing.assert_array_equal(_np(ot["labels"]),
                                      np.asarray(oj["labels"]))
        np.testing.assert_allclose(_np(ot["probs"]), np.asarray(oj["probs"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(ot["activated_fraction"]),
                                   float(oj["activated_fraction"]), rtol=0,
                                   atol=0.5 / (4 * 16 * 16 * 32))
        np.testing.assert_allclose(_np(ot["channel_rates"]),
                                   np.asarray(oj["channel_rates"]),
                                   atol=1e-6)
    # the trim moved the map: the uncalibrated chip serves other draws
    plain = VisionEngine(cfg_t, pt, backend="cuda", seed=3, device="cpu")
    assert not torch.equal(plain.classify(frames)["channel_rates"],
                           ot["channel_rates"])


def test_accuracy_sweep_matches_reference(tiny):
    """One sigma point, one chip, calibrated and not, through the
    ``device`` backend: the words are jax's, so the accuracies agree."""
    cfg_j, cfg_t, pj, pt, frames = tiny
    labels = np.arange(4) % 10
    vj, vt = _configs(**PROFILE)
    kj = jax.random.PRNGKey(7)
    kw = dict(sigmas=(0.5,), n_chips=1)
    rows_j = j_yield.accuracy_sweep(
        pj, dataclasses.replace(cfg_j, variation=None),
        [{"image": jnp.asarray(frames), "label": jnp.asarray(labels)}],
        vcfg=vj, calibration_frames=jnp.asarray(frames), key=kj,
        cal_iters=6, **kw)
    rows_t = t_yield.accuracy_sweep(
        pt, dataclasses.replace(cfg_t, variation=None),
        [{"image": frames, "label": labels}], vcfg=vt,
        calibration_frames=torch.from_numpy(frames),
        key=np.asarray(jax.random.key_data(kj)), cal_iters=6, device="cpu",
        **kw)
    assert rows_t == rows_j
