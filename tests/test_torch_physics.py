"""The PyTorch port's physics against ``repro.core`` on identical numpy
inputs: pixel curve (and its gain / offset hooks) and voltage map, the
photodiode and two-phase MAC, the packed phase conv and hardware conv, BN
folding, MTJ switching fit, reset probability, majority fold, binomial tail
and heterogeneous majority, the threefry-drawn majority vote, draw, burst
read (and its R_P / TMR hooks), Hoyer threshold and spike, weight
quantization, the bandwidth and energy functions, frame latency and the
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
from repro.lifetime import drift as j_drift
from repro.lifetime import schedule as j_schedule
from repro.variation import chip as j_chip
from repro_torch.core import energy as t_energy
from repro_torch.core import hoyer as t_hoyer
from repro_torch.core import mtj as t_mtj
from repro_torch.core import p2m as t_p2m
from repro_torch.core import pixel as t_pixel
from repro_torch.frontend import backends as t_backends
from repro_torch.frontend import shutter as t_shutter
from repro_torch.lifetime import drift as t_drift
from repro_torch.lifetime import schedule as t_schedule
from repro_torch.variation import chip as t_chip

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
    (j_chip.VariationConfig, t_chip.VariationConfig),
    (j_drift.DriftConfig, t_drift.DriftConfig),
    (j_schedule.SchedulePolicy, t_schedule.SchedulePolicy),
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


# --- the ideal / analog / device backends' physics ----------------------------

# float32 lgamma: XLA's Lanczos form and the C library's differ by up to
# two ulps at log C(8, k) (|x| < 11), which exp carries into a pmf term of
# up to ~0.3: the lgamma-based majority functions agree to 3e-6, and the
# port alone lies within 1e-6 of the float64 binomial tail
LGAMMA_ATOL = 3e-6
# majority probabilities built of multiplies and adds
MAJORITY_ATOL = 1e-6


def test_spike_and_hoyer_spike():
    u = _rng(11).normal(size=(2, 8, 8, 16)).astype(np.float32)
    v_th = np.float32(0.9)
    thr = np.float32(0.4)
    np.testing.assert_array_equal(
        t_hoyer.spike(_t(u), _t(thr)).numpy(),
        np.asarray(j_hoyer.spike(jnp.asarray(u), jnp.asarray(thr))))
    o_j, l_j = j_hoyer.hoyer_spike(jnp.asarray(u), jnp.asarray(v_th))
    o_t, l_t = t_hoyer.hoyer_spike(_t(u), _t(v_th))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=SUM_RTOL)
    z = u / v_th
    e = float(j_hoyer.hoyer_extremum(j_hoyer.clip01(jnp.asarray(z))))
    diff = o_t.numpy() != np.asarray(o_j)
    near = np.abs(z - e) <= 4 * np.finfo(np.float32).eps * max(abs(e), 1.0)
    assert not (diff & ~near).any()


def test_curve_hooks_and_pixel_mac():
    rng = _rng(12)
    x = rng.normal(size=(16, 32)).astype(np.float32) * 2
    gain = rng.uniform(0.9, 1.1, size=(32,)).astype(np.float32)
    off = rng.normal(size=(32,)).astype(np.float32) * 0.01
    for kw_j, kw_t in (({"gain": jnp.asarray(gain)}, {"gain": _t(gain)}),
                       ({"offset": jnp.asarray(off)}, {"offset": _t(off)}),
                       ({"gain": 1.05, "offset": 0.02},
                        {"gain": 1.05, "offset": 0.02})):
        g_j = j_pixel.get_curve("gf22_tanh", **kw_j)(jnp.asarray(x))
        g_t = t_pixel.get_curve("gf22_tanh", **kw_t)(_t(x))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=TRANSCENDENTAL_ATOL)
    intensity = rng.uniform(-0.2, 1.2, size=(8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        t_pixel.photodiode_discharge(_t(intensity)).numpy(),
        np.asarray(j_pixel.photodiode_discharge(jnp.asarray(intensity))))
    patches = rng.uniform(size=(10, 3, 3, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3)).astype(np.float32) * 0.3
    np.testing.assert_allclose(
        t_pixel.two_phase_mac(_t(patches), _t(w)).numpy(),
        np.asarray(j_pixel.two_phase_mac(jnp.asarray(patches),
                                         jnp.asarray(w))),
        rtol=SUM_RTOL, atol=TRANSCENDENTAL_ATOL)
    mp, mn = (rng.uniform(0, 3, size=(64, 32)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(
        t_pixel.hardware_conv_output(_t(mp), _t(mn)).numpy(),
        np.asarray(j_pixel.hardware_conv_output(jnp.asarray(mp),
                                                jnp.asarray(mn))),
        rtol=0, atol=TRANSCENDENTAL_ATOL)


@pytest.mark.parametrize("b,h,w,k,stride,cout", [
    (2, 32, 32, 3, 2, 32), (1, 13, 11, 5, 3, 8), (2, 16, 16, 3, 1, 16),
    (1, 7, 9, 1, 2, 4)])
def test_phase_conv_and_hardware_conv(b, h, w, k, stride, cout):
    rng = _rng(13)
    x = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    wt = (rng.normal(size=(k, k, 3, cout)) * 0.3).astype(np.float32)
    y_j = np.asarray(j_p2m.phase_conv(jnp.asarray(x), jnp.asarray(wt),
                                      stride))
    y_t = t_p2m.phase_conv(_t(x), _t(wt), stride).numpy()
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, rtol=SUM_RTOL, atol=1e-6)
    for a, bb in zip(t_p2m.packed_phase_conv(_t(x), _t(wt), stride),
                     j_p2m.packed_phase_conv(jnp.asarray(x), jnp.asarray(wt),
                                             stride)):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=SUM_RTOL,
                                   atol=1e-6)
    cfg_j = j_p2m.P2MConfig(out_channels=cout, kernel_size=k, stride=stride)
    cfg_t = t_p2m.P2MConfig(out_channels=cout, kernel_size=k, stride=stride)
    gain = rng.uniform(0.9, 1.1, size=(cout,)).astype(np.float32)
    off = (rng.normal(size=(cout,)) * 0.01).astype(np.float32)
    for hooks in ({}, {"curve_gain": gain}, {"out_offset": off},
                  {"curve_gain": gain, "out_offset": off}):
        u_j = j_p2m.hardware_conv(jnp.asarray(x), jnp.asarray(wt), cfg_j,
                                  **{n: jnp.asarray(v)
                                     for n, v in hooks.items()})
        u_t = t_p2m.hardware_conv(_t(x), _t(wt), cfg_t,
                                  **{n: _t(v) for n, v in hooks.items()})
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j),
                                   rtol=SUM_RTOL, atol=1e-5)


def test_fuse_batchnorm_and_output_sparsity():
    rng = _rng(14)
    w = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    gamma, beta, mean = (rng.normal(size=(8,)).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=(8,)).astype(np.float32)
    got = t_p2m.fuse_batchnorm(*map(_t, (w, gamma, beta, mean, var)))
    want = j_p2m.fuse_batchnorm(*map(jnp.asarray, (w, gamma, beta, mean,
                                                   var)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    o = (rng.uniform(size=(2, 8, 8, 8)) < 0.3).astype(np.float32)
    np.testing.assert_allclose(float(t_p2m.output_sparsity(_t(o))),
                               float(j_p2m.output_sparsity(jnp.asarray(o))),
                               rtol=SUM_RTOL)


def _binom_tail_f64(p, n, m):
    import math
    p = np.asarray(p, np.float64)
    return sum(math.comb(n, k) * p ** k * (1 - p) ** (n - k)
               for k in range(m, n + 1))


def test_majority_activation_probability_and_error_rates():
    p = _rng(15).uniform(size=(512,)).astype(np.float32)
    p[:4] = (0.0, 1.0, 0.924, 0.062)
    for n, m in ((8, 4), (5, 3), (12, 6)):
        q_t = t_mtj.majority_activation_probability(_t(p), n, m).numpy()
        q_j = np.asarray(j_mtj.majority_activation_probability(
            jnp.asarray(p), n, m))
        np.testing.assert_allclose(q_t, q_j, rtol=0, atol=LGAMMA_ATOL)
        np.testing.assert_allclose(q_t, _binom_tail_f64(p, n, m), rtol=0,
                                   atol=MAJORITY_ATOL)
    ks = np.arange(0, 9, dtype=np.float32)
    np.testing.assert_allclose(
        t_mtj._binom_pmf(_t(ks), 8, _t(p[:, None])).numpy(),
        np.asarray(j_mtj._binom_pmf(jnp.asarray(ks), 8,
                                    jnp.asarray(p[:, None]))),
        rtol=0, atol=LGAMMA_ATOL)
    for args in ((0.924, 0.062), (_t(p[:8]), _t(p[8:16]))):
        got = t_mtj.majority_error_rates(*args)
        want = j_mtj.majority_error_rates(
            *(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
              for a in args))
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=LGAMMA_ATOL)
    np.testing.assert_allclose(float(t_mtj.reset_probability()),
                               float(j_mtj.reset_probability()), rtol=0,
                               atol=TRANSCENDENTAL_ATOL)


@pytest.mark.parametrize("n,m", [(8, 4), (5, 3), (3, 2), (1, 1)])
def test_majority_prob_hetero_and_dp(n, m):
    p = _rng(16).uniform(size=(64, 4, n)).astype(np.float32)
    p[0, 0, :] = 0.0
    p[0, 1, :] = 1.0
    for fn in ("majority_prob_hetero", "majority_prob_hetero_dp"):
        q_t = getattr(t_mtj, fn)(_t(p), m).numpy()
        q_j = np.asarray(getattr(j_mtj, fn)(jnp.asarray(p), m))
        np.testing.assert_allclose(q_t, q_j, rtol=0, atol=MAJORITY_ATOL,
                                   err_msg=fn)


def test_sampled_majority_equals_reference_draws():
    """The same key and the same probabilities: the threefry words are
    bit-exact, so every vote agrees."""
    import jax
    rng = _rng(17)
    p = rng.uniform(size=(2, 6, 6, 8)).astype(np.float32)
    p_dev = rng.uniform(size=(3, 5, 8)).astype(np.float32)
    for seed in (0, 9):
        kj = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        kt = np.asarray(jax.random.key_data(kj))
        np.testing.assert_array_equal(
            t_mtj.sample_majority_activation(kt, _t(p), 8, 4).numpy(),
            np.asarray(j_mtj.sample_majority_activation(kj, jnp.asarray(p),
                                                        8, 4)))
        np.testing.assert_array_equal(
            t_mtj.sample_majority_activation_per_device(kt, _t(p_dev),
                                                        4).numpy(),
            np.asarray(j_mtj.sample_majority_activation_per_device(
                kj, jnp.asarray(p_dev), 4)))
        # identical devices: the per-device vote is the shared one
        np.testing.assert_array_equal(
            t_mtj.sample_majority_activation_per_device(
                kt, _t(p)[..., None].expand(*p.shape, 8), 4).numpy(),
            t_mtj.sample_majority_activation(kt, _t(p), 8, 4).numpy())


def test_read_voltage_divider_hooks():
    rng = _rng(18)
    states = (rng.uniform(size=(4, 8, 32)) < 0.4).astype(np.float32)
    r_p = rng.uniform(0.9, 1.1, size=(32,)).astype(np.float32)
    tmr = rng.uniform(0.8, 1.2, size=(32,)).astype(np.float32)
    for kw in ({"r_p_scale": r_p}, {"tmr_scale": tmr},
               {"r_p_scale": r_p, "tmr_scale": tmr}, {"r_p_scale": 1.1}):
        got = t_mtj.read_voltage_divider(
            _t(states), **{k: _t(v) if isinstance(v, np.ndarray) else v
                           for k, v in kw.items()})
        want = j_mtj.read_voltage_divider(
            jnp.asarray(states), **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


CIFAR_SPEC = dict(h_in=32, w_in=32, h_out=8, w_out=8)


@pytest.mark.parametrize("spec_kw", [{}, CIFAR_SPEC])
def test_bandwidth_and_energy_functions(spec_kw):
    f_t, f_j = t_energy.FrameSpec(**spec_kw), j_energy.FrameSpec(**spec_kw)
    assert f_t.bits_transmitted_in == f_j.bits_transmitted_in
    assert f_t.bits_transmitted_out == f_j.bits_transmitted_out
    for name in ("bandwidth_reduction", "paper_eq3",
                 "frontend_energy_baseline", "frontend_energy_insensor",
                 "frontend_energy_ours", "recalibration_energy_pj",
                 "comm_energy_baseline", "comm_energy_ours"):
        assert getattr(t_energy, name)(f_t) == pytest.approx(
            getattr(j_energy, name)(f_j), rel=1e-12), name
    for sp in (0.0, 0.5, 0.8, 0.97, 1.0):
        for coding in ("entropy", "csr"):
            assert t_energy.effective_bandwidth_with_sparsity(
                f_t, sp, coding) == pytest.approx(
                j_energy.effective_bandwidth_with_sparsity(f_j, sp, coding),
                rel=1e-12)


def test_variation_config_properties_equal_reference():
    """``enabled`` and ``scaled`` of the port's VariationConfig copy equal
    the reference's, on the zero profile and on a full one."""
    full = dict(sigma_logit_offset=0.4, sigma_logit_slope=0.05,
                sigma_r_p=0.05, sigma_tmr=0.05, sigma_pixel_gain=0.05,
                sigma_pixel_offset=0.25, sigma_column=0.15, column_corr=3.0,
                chip_seed=7)
    for kw in ({}, full, {"sigma_column": 0.1}):
        ref, port = j_chip.VariationConfig(**kw), t_chip.VariationConfig(**kw)
        assert port.enabled == ref.enabled
        for s in (0.0, 0.5, 2.0):
            assert (dataclasses.asdict(port.scaled(s))
                    == dataclasses.asdict(ref.scaled(s)))


def test_drift_and_schedule_properties_equal_reference():
    """``enabled`` and ``scaled`` of the port's DriftConfig copy, and
    ``enabled`` of its SchedulePolicy copy, equal the reference's."""
    full = dict(sigma_logit_offset=0.2, sigma_logit_gain=0.05,
                sigma_r_p=0.03, sigma_tmr=0.03, tmr_retention=0.01,
                sigma_pixel_gain=0.03, pixel_gain_aging=0.01,
                sigma_pixel_offset=0.15, tau_frames=100.0,
                temp_amplitude_c=10.0, temp_period_frames=512.0,
                temp_logit_per_c=-0.03, drift_seed=4)
    for kw in ({}, full, {"temp_amplitude_c": 2.0}, {"tau_frames": 5.0}):
        ref, port = j_drift.DriftConfig(**kw), t_drift.DriftConfig(**kw)
        assert port.enabled == ref.enabled
        for s in (0.0, 0.5, 2.0):
            assert (dataclasses.asdict(port.scaled(s))
                    == dataclasses.asdict(ref.scaled(s)))
    for kw in ({}, {"period_frames": 64}, {"rate_err_threshold": 0.02},
               {"period_frames": 8, "rate_err_threshold": 0.1,
                "min_interval_frames": 4, "ema": 0.7, "cal_iters": 6,
                "cal_span": 1.0}):
        ref = j_schedule.SchedulePolicy(**kw)
        port = t_schedule.SchedulePolicy(**kw)
        assert port.enabled == ref.enabled
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
