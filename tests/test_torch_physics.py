"""The PyTorch port's physics against ``repro.core`` on identical numpy
inputs: pixel curve and voltage map, MTJ switching fit, majority fold, draw,
burst read, Hoyer threshold, weight quantization, frame latency and the
global-shutter stats — plus the anti-fork check that the port's copies of
the physics dataclasses equal the reference's field for field."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as j_energy
from repro.core import hoyer as j_hoyer
from repro.core import mtj as j_mtj
from repro.core import p2m as j_p2m
from repro.core import pixel as j_pixel
from repro.frontend import backends as j_backends
from repro.frontend import shutter as j_shutter
from repro_torch.core import energy as t_energy
from repro_torch.core import hoyer as t_hoyer
from repro_torch.core import mtj as t_mtj
from repro_torch.core import p2m as t_p2m
from repro_torch.core import pixel as t_pixel
from repro_torch.frontend import backends as t_backends
from repro_torch.frontend import shutter as t_shutter

# XLA:CPU and PyTorch evaluate tanh/exp with different polynomials: a few
# ulps of float32 at values of order 1
TRANSCENDENTAL_ATOL = 1e-6
# reductions summed in another order: relative float32 rounding
SUM_RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("ref_cls,port_cls", [
    (j_pixel.PixelCircuitParams, t_pixel.PixelCircuitParams),
    (j_mtj.MTJParams, t_mtj.MTJParams),
    (j_p2m.P2MConfig, t_p2m.P2MConfig),
    (j_energy.EnergyConstants, t_energy.EnergyConstants),
])
def test_dataclass_copies_equal_reference(ref_cls, port_cls):
    """The port keeps its own copies of the physics constants; a fork of
    any number fails here."""
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(ref_cls())


def test_derived_constants_equal_reference():
    assert t_pixel.DEFAULT_PIXEL.volts_per_unit == \
        j_pixel.DEFAULT_PIXEL.volts_per_unit
    assert t_mtj.DEFAULT_MTJ.measured_logits == j_mtj.DEFAULT_MTJ.measured_logits
    assert t_mtj.DEFAULT_MTJ.majority == j_mtj.DEFAULT_MTJ.majority
    assert t_mtj.comparator_threshold() == j_mtj.comparator_threshold()


@pytest.mark.parametrize("curve", ["ideal", "gf22_tanh"])
def test_curve_and_conv_voltage(curve):
    p_j = dataclasses.replace(j_pixel.DEFAULT_PIXEL, curve=curve)
    p_t = dataclasses.replace(t_pixel.DEFAULT_PIXEL, curve=curve)
    x = _rng(1).normal(size=(64, 32)).astype(np.float32) * 2
    g_j = np.asarray(j_pixel.get_curve(curve, p_j)(jnp.asarray(x)))
    g_t = t_pixel.get_curve(curve, p_t)(_t(x)).numpy()
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=TRANSCENDENTAL_ATOL)
    theta = np.float32(0.37)
    v_j = np.asarray(j_pixel.conv_voltage(jnp.asarray(x), jnp.asarray(theta),
                                          p_j))
    v_t = t_pixel.conv_voltage(_t(x), _t(theta), p_t).numpy()
    # affine map + clip only: identical float32 operations
    np.testing.assert_array_equal(v_t, v_j)


def test_unknown_curve_raises():
    with pytest.raises(KeyError):
        t_pixel.get_curve("nope")


def test_switching_fit_and_probability():
    v = _rng(2).uniform(0.0, 1.2, size=(128, 32)).astype(np.float32)
    gain = _rng(3).uniform(0.8, 1.2, size=(32,)).astype(np.float32)
    off = _rng(4).normal(size=(32,)).astype(np.float32) * 0.3
    l_j = np.asarray(j_mtj.switching_logit(jnp.asarray(v), logit_offset=off,
                                           logit_gain=gain))
    l_t = t_mtj.switching_logit(_t(v), logit_offset=_t(off),
                                logit_gain=_t(gain)).numpy()
    np.testing.assert_array_equal(l_t, l_j)     # piecewise-linear: exact
    for pulse in (700.0, 500.0, 900.0):
        p_j = np.asarray(j_mtj.switching_probability(jnp.asarray(v), pulse))
        p_t = t_mtj.switching_probability(_t(v), pulse).numpy()
        np.testing.assert_allclose(p_t, p_j, rtol=0,
                                   atol=TRANSCENDENTAL_ATOL)
    assert t_mtj.envelope_factor(700.0) == 1.0


def test_majority_poly_bit_exact():
    """Multiply/add only, in integer_pow's order: identical rounding."""
    p = _rng(5).uniform(size=(256, 32)).astype(np.float32)
    p[0, :4] = (0.0, 1.0, 0.5, 1e-7)
    for n, m in ((8, 4), (5, 3), (1, 1)):
        q_j = np.asarray(j_mtj.majority_prob_poly(jnp.asarray(p), n, m))
        q_t = t_mtj.majority_prob_poly(_t(p), n, m).numpy()
        np.testing.assert_array_equal(q_t, q_j)


def test_bernoulli_and_burst_read():
    rng = _rng(6)
    bits = rng.integers(0, 2 ** 16, size=(64, 32)).astype(np.uint16)
    q = rng.uniform(size=(64, 32)).astype(np.float32)
    d_j = np.asarray(j_mtj.bernoulli_from_bits(jnp.asarray(bits),
                                               jnp.asarray(q)))
    d_t = t_mtj.bernoulli_from_bits(torch.from_numpy(bits.astype(np.int32)),
                                    _t(q)).numpy()
    np.testing.assert_array_equal(d_t, d_j)
    states = (rng.uniform(size=(4, 8, 8, 32)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        t_mtj.read_voltage_divider(_t(states)).numpy(),
        np.asarray(j_mtj.read_voltage_divider(jnp.asarray(states))))
    np.testing.assert_array_equal(
        t_mtj.burst_read(_t(states)).numpy(),
        np.asarray(j_mtj.burst_read(jnp.asarray(states))))


def test_hoyer_functions():
    z = _rng(7).normal(size=(4, 6, 6, 8)).astype(np.float32)
    zc_j, zc_t = j_hoyer.clip01(jnp.asarray(z)), t_hoyer.clip01(_t(z))
    np.testing.assert_array_equal(zc_t.numpy(), np.asarray(zc_j))
    np.testing.assert_allclose(t_hoyer.hoyer_extremum(zc_t).numpy(),
                               np.asarray(j_hoyer.hoyer_extremum(zc_j)),
                               rtol=SUM_RTOL)
    np.testing.assert_allclose(
        t_hoyer.hoyer_extremum(zc_t, axis=(1, 2, 3), keepdims=True).numpy(),
        np.asarray(j_hoyer.hoyer_extremum(zc_j, axis=(1, 2, 3),
                                          keepdims=True)), rtol=SUM_RTOL)
    np.testing.assert_allclose(t_hoyer.hoyer_regularizer(zc_t).numpy(),
                               np.asarray(j_hoyer.hoyer_regularizer(zc_j)),
                               rtol=SUM_RTOL)
    v_th = np.float32(0.8)
    np.testing.assert_allclose(
        t_hoyer.effective_threshold(_t(z), _t(v_th)).numpy(),
        np.asarray(j_hoyer.effective_threshold(jnp.asarray(z),
                                               jnp.asarray(v_th))),
        rtol=SUM_RTOL)


def test_quantize_and_pack_bit_exact():
    w = _rng(8).normal(size=(3, 3, 3, 32)).astype(np.float32) * 0.3
    for bits in (4, 8, 0):
        np.testing.assert_array_equal(
            t_p2m.quantize_weights(_t(w), bits).numpy(),
            np.asarray(j_p2m.quantize_weights(jnp.asarray(w), bits)))
    np.testing.assert_array_equal(
        t_p2m.relu_split_pack(_t(w)).numpy(),
        np.asarray(j_p2m.relu_split_pack(jnp.asarray(w))))


def test_init_params_distribution():
    cfg = t_p2m.P2MConfig()
    params = t_p2m.init_params(torch.Generator().manual_seed(0), cfg)
    assert tuple(params["w"].shape) == (3, 3, 3, 32)
    assert float(params["v_th"]) == 1.0
    std = float(params["w"].std())
    assert abs(std - (2.0 / 27) ** 0.5) < 0.03


@pytest.mark.parametrize("spec_kw", [{}, dict(h_in=32, w_in=32, h_out=8,
                                             w_out=8)])
def test_frame_latency(spec_kw):
    got = t_energy.frame_latency_us(t_energy.FrameSpec(**spec_kw))
    want = j_energy.frame_latency_us(j_energy.FrameSpec(**spec_kw))
    assert got == pytest.approx(want, rel=1e-12)


def test_shutter_stats_and_v_conv_stats():
    states = (_rng(9).uniform(size=(4, 8, 8, 32)) < 0.25).astype(np.float32)
    bits_t, st_t = t_shutter.global_shutter_readout(_t(states), frames=4)
    bits_j, st_j = j_shutter.global_shutter_readout(jnp.asarray(states),
                                                    frames=4)
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    assert set(st_t) == set(st_j)
    for k in st_j:
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]),
                                   rtol=1e-6, err_msg=k)
    v = _rng(10).uniform(size=(64, 32)).astype(np.float32)
    s_t, s_j = t_backends._v_conv_stats(_t(v)), j_backends._v_conv_stats(
        jnp.asarray(v))
    for k in s_j:
        np.testing.assert_allclose(float(s_t[k]), float(s_j[k]),
                                   rtol=SUM_RTOL, err_msg=k)
