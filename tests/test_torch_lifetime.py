"""The port's sensor lifetime against the JAX package: drift, the
recalibration scheduler, the aging ``VisionEngine`` and the fleet-lifetime
analysis.

Tolerances and why:

* ``sample_drift_maps``: every direction within 3 float32 ulps of the
  reference's (``prng.normal`` is within 3 of ``jax.random.normal``); a
  stack's row g bit for bit chip g's;
* ``aging`` within 1 ulp and ``temp_excursion_c`` within 2 ulps of the
  reference's (the same float32 operands; XLA's ``log1p`` / ``sin`` and
  PyTorch's differ in the last place) at t in {0, 1, 3e2, 1e5, 1e6, 3e7};
* ``evolve_chip`` at t in {3e2, 1e5}: rtol 1e-6 with an absolute floor of
  1e-7 (one ulp of the temperature term carried into a map near zero);
  t = 0 and a zero-rate profile bit for bit (the latter the input object);
  the 0.05 floors at an extreme age bit for bit;
* ``maintenance_energy_per_frame_pj`` and each refresh's energy exactly
  (plain Python arithmetic on both sides);
* the scheduler's monitor (``observe`` / ``should_fire``) exactly: the
  same float64 numpy EMA of the same rates;
* every trim the port solves (``recalibrate``, ``recalibrate_fleet``, the
  engine's refreshes, the fleet's) within 8 * span / 2^iters of the
  reference's jitted solve: the rates sum in another order, so a bisection
  step near the target may go the other way;
* the aging engines (``cuda`` on the CPU against the reference's
  ``pallas``, ``device`` against ``device``): labels equal, probs within
  1e-6, ``channel_rates`` within 1e-6, every ``lifetime_*`` value equal;
* ``rate_error_vs_age``: the four surfaces within 1e-5 (float32 means of
  1,024 rows summed in another order, transcendentals in ulps; the trims
  agree);
* ``accuracy_vs_age``: the rows equal, and each eval's logits within 1e-5
  of the reference's on the same threefry words.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import lifetime as jlt
from repro.core import energy as j_energy
from repro.core import p2m as j_p2m
from repro.models import vision as jv
from repro.serving import VisionEngine as JaxEngine
from repro.variation import chip as j_chip
from repro_torch import lifetime as tlt
from repro_torch import prng
from repro_torch.core import energy as t_energy
from repro_torch.core import p2m as t_p2m
from repro_torch.lifetime import fleet as t_fleet
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import VisionEngine
from repro_torch.serving.vision import _merge_outputs
from repro_torch.variation import chip as t_chip

# tests/test_lifetime.py's profiles
VPROFILE = dict(sigma_logit_offset=0.4, sigma_pixel_offset=0.25,
                sigma_pixel_gain=0.05, sigma_column=0.15)
DPROFILE = dict(sigma_logit_offset=0.2, sigma_logit_gain=0.05,
                sigma_r_p=0.03, sigma_tmr=0.03, tmr_retention=0.01,
                sigma_pixel_gain=0.03, pixel_gain_aging=0.01,
                sigma_pixel_offset=0.15, tau_frames=100.0,
                temp_amplitude_c=10.0, temp_period_frames=512.0)
# BENCH_lifetime.json's drift profile
BENCH_DRIFT = dict(pixel_gain_aging=0.005, sigma_logit_gain=0.02,
                   sigma_logit_offset=0.2, sigma_pixel_gain=0.02,
                   sigma_pixel_offset=0.12, sigma_r_p=0.02, sigma_tmr=0.02,
                   tau_frames=1000.0, temp_amplitude_c=15.0,
                   temp_logit_per_c=-0.03, temp_period_frames=30000.0,
                   tmr_retention=0.005)
AGES = (0, 1, 3e2, 1e5, 1e6, 3e7)
NORMAL_ULPS = 3
EVOLVE_RTOL, EVOLVE_ATOL = 1e-6, 1e-7
PROBS_ATOL = RATES_ATOL = 1e-6
SURFACE_ATOL = 1e-5
LOGITS_ATOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _drift(**kw):
    return jlt.DriftConfig(**kw), tlt.DriftConfig(**kw)


def _vary(**kw):
    return j_chip.VariationConfig(**kw), t_chip.VariationConfig(**kw)


def _fed(tree_j, cls):
    """The reference's maps (a NamedTuple of jax arrays) as the port's."""
    return cls(*tp.from_numpy(tree_j))


def _assert_ulps(got, want, n_ulps, msg=""):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= n_ulps * ulp), msg


def _lsb(iters, span=2.0):
    return span / 2 ** iters


# --- drift -----------------------------------------------------------------

@pytest.mark.parametrize("chip_id", [0, 5])
def test_sample_drift_maps_match_reference(chip_id):
    dj, dt = _drift(**DPROFILE)
    want = jlt.sample_drift_maps(dj, 32, 8, chip_id)
    got = tlt.sample_drift_maps(dt, 32, 8, chip_id, device="cpu")
    assert type(got) is tlt.DriftMaps
    for name in tlt.DriftMaps._fields:
        w_ = np.asarray(getattr(want, name))
        assert tuple(getattr(got, name).shape) == w_.shape
        assert getattr(got, name).dtype == torch.float32
        _assert_ulps(getattr(got, name), w_, NORMAL_ULPS, name)


def test_sample_drift_maps_stack_rows_are_the_chips():
    """A sequence of ids draws every chip at once, row g bit for bit chip
    g's; the seed moves the maps."""
    _, dt = _drift(**DPROFILE)
    ids = [0, 5, 2]
    stack = tlt.sample_drift_maps(dt, 16, 8, ids, device="cpu")
    for g, cid in enumerate(ids):
        one = tlt.sample_drift_maps(dt, 16, 8, cid, device="cpu")
        assert all(torch.equal(a[g], b) for a, b in zip(stack, one))
    other = tlt.sample_drift_maps(dataclasses.replace(dt, drift_seed=2), 16,
                                  8, 0, device="cpu")
    assert not torch.equal(other.d_pixel_offset, stack.d_pixel_offset[0])


@pytest.mark.parametrize("profile", [DPROFILE, BENCH_DRIFT],
                         ids=["test", "bench"])
def test_aging_and_temperature_match_reference(profile):
    dj, dt = _drift(**profile)
    for t in AGES:
        a_t = tlt.aging(t, dt.tau_frames)
        assert a_t.dtype == torch.float32
        _assert_ulps(a_t, np.float32(jlt.aging(t, dj.tau_frames)), 1,
                     f"aging at {t}")
        _assert_ulps(tlt.temp_excursion_c(t, dt),
                     np.float32(jlt.temp_excursion_c(t, dj)), 2,
                     f"temperature at {t}")
    assert float(tlt.aging(0, 100.0)) == 0.0
    # an age past 2^24 frames rounds to float32 first, as in the reference
    assert float(tlt.aging(2 ** 24 + 1, 1.0)) == float(tlt.aging(2 ** 24,
                                                                  1.0))


def _aged_pair(t, dj, dt, chip_id=5):
    vj, _ = _vary(**VPROFILE)
    chip_j = j_chip.sample_chip(vj, 32, 8, chip_id)
    maps_j = jlt.sample_drift_maps(dj, 32, 8, chip_id)
    want = jlt.evolve_chip(chip_j, maps_j, jnp.float32(t), dcfg=dj)
    chip_t = _fed(chip_j, t_chip.ChipMaps)
    got = tlt.evolve_chip(chip_t, _fed(maps_j, tlt.DriftMaps), t, dcfg=dt)
    return chip_t, got, want


@pytest.mark.parametrize("t", [3e2, 1e5])
def test_evolve_chip_matches_reference(t):
    dj, dt = _drift(**DPROFILE)
    _, got, want = _aged_pair(t, dj, dt)
    assert type(got) is t_chip.ChipMaps
    for name, g, w_ in zip(t_chip.ChipMaps._fields, got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w_), rtol=EVOLVE_RTOL,
                                   atol=EVOLVE_ATOL, err_msg=name)


def test_evolve_chip_identities_and_floors():
    """t = 0 returns the chip's values bit for bit; a zero-rate profile
    returns the chip object itself; at an extreme age the floors hold and
    equal the reference's bit for bit."""
    dj, dt = _drift(**DPROFILE)
    chip_t, got, want = _aged_pair(0.0, dj, dt)
    for a, b in zip(got, chip_t):
        assert torch.equal(a, b)
    assert tlt.evolve_chip(chip_t, None, 1e6, dcfg=tlt.DriftConfig()) \
        is chip_t
    dj10, dt10 = dj.scaled(10.0), dt.scaled(10.0)
    _, got, want = _aged_pair(1e12, dj10, dt10, chip_id=3)
    for name in ("mtj_logit_gain", "r_p_scale", "tmr_scale", "pixel_gain"):
        g, w_ = _np(getattr(got, name)), np.asarray(getattr(want, name))
        floored = w_ == np.float32(0.05)
        assert floored.any() and g.min() >= np.float32(0.05), name
        np.testing.assert_array_equal(g[floored], w_[floored])


def test_evolve_chip_on_a_stack_equals_each_chip():
    """A stack of chips and their maps ages row by row as each chip alone,
    bit for bit (what the fleet analysis runs)."""
    _, dt = _drift(**DPROFILE)
    _, vt = _vary(**VPROFILE)
    ids = [1, 4]
    chips = t_chip.sample_chips(vt, 16, 8, ids, device="cpu")
    maps = tlt.sample_drift_maps(dt, 16, 8, ids, device="cpu")
    aged = tlt.evolve_chip(chips, maps, 1e4, dcfg=dt)
    for g, cid in enumerate(ids):
        one = tlt.evolve_chip(
            t_chip.sample_chip(vt, 16, 8, cid, device="cpu"),
            tlt.sample_drift_maps(dt, 16, 8, cid, device="cpu"), 1e4, dcfg=dt)
        assert all(torch.equal(a[g], b) for a, b in zip(aged, one))


# --- energy ----------------------------------------------------------------

@pytest.mark.parametrize("spec_kw", [{}, dict(h_in=32, w_in=32, h_out=8,
                                              w_out=8)])
def test_maintenance_energy_equals_reference(spec_kw):
    f_t, f_j = t_energy.FrameSpec(**spec_kw), j_energy.FrameSpec(**spec_kw)
    for period in (0.5, 1.0, 64, 1e4, 3.3e5):
        for frames, iters in ((32, 12), (16, 6)):
            kw = dict(recal_period_frames=period, n_cal_frames=frames,
                      bisection_iters=iters)
            assert (t_energy.maintenance_energy_per_frame_pj(f_t, **kw)
                    == j_energy.maintenance_energy_per_frame_pj(f_j, **kw))


# --- the scheduler ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    vj, vt = _vary(**VPROFILE)
    cfg_j = jv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            variation=vj)
    cfg_t = tv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            variation=vt)
    pj = jv.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tp.from_numpy(jax.tree.map(np.asarray, pj))
    frames = np.random.default_rng(3).uniform(
        size=(4, 32, 32, 3)).astype(np.float32)
    return cfg_j, cfg_t, pj, pt, frames


def _schedulers(tiny, **policy):
    cfg_j, cfg_t, pj, pt, frames = tiny
    sj = jlt.RecalibrationScheduler(jlt.SchedulePolicy(**policy), cfg_j.p2m,
                                    jnp.asarray(frames), pj["p2m"])
    st = tlt.RecalibrationScheduler(tlt.SchedulePolicy(**policy), cfg_t.p2m,
                                    frames, pt["p2m"], device="cpu")
    return sj, st


def test_scheduler_monitor_matches_reference_exactly(tiny):
    """``observe`` / ``should_fire`` fed one rate sequence (the EMA in
    float64 numpy on both sides): every metric and decision equal, through
    a refresh that re-arms the baseline; each refresh's trim within 8
    LSBs; the refresh energy equal."""
    sj, st = _schedulers(tiny, rate_err_threshold=0.02,
                         min_interval_frames=4, ema=0.6, cal_iters=8)
    assert st.recal_energy_pj == sj.recal_energy_pj
    rng = np.random.default_rng(5)
    chip_j = j_chip.identity_chip(32, 8)
    last = fired = 0
    for step in range(12):
        rates = (0.3 + 0.05 * step * rng.uniform(size=32)).astype(np.float32)
        assert st.observe(torch.from_numpy(rates)) == sj.observe(
            jnp.asarray(rates))
        age = 2 * (step + 1)
        decision = sj.should_fire(age, last)
        assert st.should_fire(age, last) == decision
        if decision:
            trim_j = sj.recalibrate(chip_j)
            trim_t = st.recalibrate(_fed(chip_j, t_chip.ChipMaps))
            np.testing.assert_allclose(_np(trim_t), np.asarray(trim_j),
                                       rtol=0, atol=8 * _lsb(8))
            last, fired = age, fired + 1
    assert fired >= 2
    assert st.observe(None) == sj.observe(None)


def test_recalibrate_and_fleet_match_reference(tiny):
    """The refresh against an aged chip, and ``recalibrate_fleet`` on a
    stack of aged chips, within 8 LSBs of the reference's jitted solves;
    the fleet rows bit for bit the port's single-chip refreshes (the CPU
    reduces each chip's rows in the same order), and the monitor untouched
    by a fleet refresh; ``rate_error`` within 1e-6."""
    sj, st = _schedulers(tiny, period_frames=8, cal_iters=12)
    dj, dt = _drift(**DPROFILE)
    vj, _ = _vary(**VPROFILE)
    ids = [0, 3, 6]
    aged_j = [jlt.evolve_chip(j_chip.sample_chip(vj, 32, 8, c),
                              jlt.sample_drift_maps(dj, 32, 8, c),
                              jnp.float32(1e4), dcfg=dj) for c in ids]
    aged_t = [_fed(a, t_chip.ChipMaps) for a in aged_j]
    st.observe(torch.full((32,), 0.3))
    st.observe(torch.full((32,), 0.5))
    before = st._last_err
    stack_j = jax.tree.map(lambda *x: jnp.stack(x), *aged_j)
    stack_t = t_chip.ChipMaps(*(torch.stack(x) for x in zip(*aged_t)))
    fleet_t = st.recalibrate_fleet(stack_t)
    assert st._last_err == before > 0
    fleet_j = np.asarray(sj.recalibrate_fleet(stack_j))
    assert tuple(fleet_t.shape) == (3, 32)
    np.testing.assert_allclose(_np(fleet_t), fleet_j, rtol=0,
                               atol=8 * _lsb(12))
    for g, (a_j, a_t) in enumerate(zip(aged_j, aged_t)):
        one = st.recalibrate(a_t)
        assert torch.equal(one, fleet_t[g])
        np.testing.assert_allclose(_np(one), np.asarray(sj.recalibrate(a_j)),
                                   rtol=0, atol=8 * _lsb(12))
        for trim in (None, one):
            np.testing.assert_allclose(
                st.rate_error(a_t, trim),
                sj.rate_error(a_j, None if trim is None
                              else jnp.asarray(_np(trim))),
                rtol=0, atol=1e-6)
    assert st._last_err == 0.0


def test_scheduler_refuses_what_the_reference_refuses(tiny):
    cfg_j, cfg_t, pj, pt, frames = tiny
    assert not tlt.SchedulePolicy().enabled
    with pytest.raises(ValueError, match="period_frames"):
        tlt.RecalibrationScheduler(tlt.SchedulePolicy(), cfg_t.p2m, frames,
                                   pt["p2m"], device="cpu")
    with pytest.raises(ValueError, match="calibration frames"):
        tlt.RecalibrationScheduler(tlt.SchedulePolicy(period_frames=4),
                                   cfg_t.p2m, None, pt["p2m"], device="cpu")
    _, dt = _drift(**DPROFILE)
    with pytest.raises(ValueError):
        VisionEngine(cfg_t, pt, device="cpu", drift=dt,
                     schedule=tlt.SchedulePolicy(period_frames=4))
    with pytest.raises(ValueError):
        VisionEngine(cfg_t, pt, device="cpu", drift=dt,
                     schedule=tlt.SchedulePolicy(), calibration_frames=frames)


# --- the numpy bridge --------------------------------------------------------

def test_lifetime_state_carries_across_the_bridge(tiny):
    """``from_numpy`` / ``to_numpy`` carry a NamedTuple field by field and
    keep its type: a reference engine's ``LifetimeState`` chip0, maps and
    trim come across and back unchanged."""
    cfg_j, _, pj, _, frames = tiny
    dj, _ = _drift(**DPROFILE)
    eng = JaxEngine(cfg_j, pj, backend="device", drift=dj)
    st = eng.lifetime
    for tree in (st.chip0, st.maps, st.trim,
                 {"chip": st.chip0, "trim": st.trim}):
        moved = tp.from_numpy(tree)
        back = tp.to_numpy(moved)
        if not hasattr(tree, "shape"):      # the trim is one array
            assert type(moved) is type(back) is type(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert isinstance(a, np.ndarray)
            np.testing.assert_array_equal(a, np.asarray(b))
    chip = t_chip.ChipMaps(*tp.from_numpy(st.chip0))
    assert all(isinstance(m, torch.Tensor) for m in chip)
    assert type(tp.from_numpy((np.zeros(2), np.ones(3)))) is tuple


# --- the aging engine --------------------------------------------------------

def _engines(tiny, backend_j, backend_t, microbatch=2, **kw):
    cfg_j, cfg_t, pj, pt, frames = tiny
    kw_j = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    kw_t = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    if "calibration_frames" in kw:
        kw_j["calibration_frames"] = jnp.asarray(frames)
        kw_t["calibration_frames"] = frames
    ej = JaxEngine(cfg_j, pj, backend=backend_j, microbatch=microbatch,
                   **kw_j)
    et = VisionEngine(cfg_t, pt, backend=backend_t, microbatch=microbatch,
                      device="cpu", **kw_t)
    return ej, et, frames


def _check_step(oj, ot):
    np.testing.assert_array_equal(_np(ot["labels"]), np.asarray(oj["labels"]))
    np.testing.assert_allclose(_np(ot["probs"]), np.asarray(oj["probs"]),
                               rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(_np(ot["channel_rates"]),
                               np.asarray(oj["channel_rates"]), rtol=0,
                               atol=RATES_ATOL)
    keys = sorted(k for k in oj if k.startswith("lifetime_"))
    assert keys == sorted(k for k in ot if k.startswith("lifetime_"))
    for k in keys:
        assert float(ot[k]) == float(oj[k]), k


@pytest.mark.parametrize("backends", [("pallas", "cuda"),
                                      ("device", "device")])
def test_aging_engine_matches_reference(tiny, backends):
    """No schedule: the chip ages per microbatch (4 of 2 frames over two
    batches); each batch's merged output against the reference's."""
    ej, et, frames = _engines(tiny, *backends, drift=_drift(**DPROFILE))
    outs_j = list(ej.stream([jnp.asarray(frames)] * 2))
    outs_t = list(et.stream([frames] * 2))
    for oj, ot in zip(outs_j, outs_t):
        _check_step(oj, ot)
    assert et.lifetime.age_frames == ej.lifetime.age_frames == 8
    assert et.lifetime.recal_count == 0


@pytest.mark.parametrize("backends", [("pallas", "cuda"),
                                      ("device", "device")])
def test_scheduled_engine_matches_reference(tiny, backends):
    """``SchedulePolicy(period_frames=4, cal_iters=6)``: after each batch
    the age, refresh count, last refresh frame and energy equal the
    reference's, the trims within 8 LSBs; the monitored rate error too."""
    pol = (jlt.SchedulePolicy(period_frames=4, cal_iters=6),
           tlt.SchedulePolicy(period_frames=4, cal_iters=6))
    ej, et, frames = _engines(tiny, *backends, drift=_drift(**DPROFILE),
                              schedule=pol, calibration_frames=True)
    for oj, ot in zip(ej.stream([jnp.asarray(frames)] * 2),
                      et.stream([frames] * 2)):
        _check_step(oj, ot)
        sj, st = ej.lifetime, et.lifetime
        assert (st.age_frames, st.recal_count, st.last_recal_frame,
                st.recal_energy_pj) == (sj.age_frames, sj.recal_count,
                                        sj.last_recal_frame,
                                        sj.recal_energy_pj)
        assert list(st.rate_err_history) == list(sj.rate_err_history)
        np.testing.assert_allclose(_np(st.trim), np.asarray(sj.trim),
                                   rtol=0, atol=8 * _lsb(6))
        assert float(ot["lifetime_recal_fired"]) == 1.0
    assert et.lifetime.recal_count == 2 and et.lifetime.last_recal_frame == 8
    assert et.lifetime.rate_err_history.maxlen == 1024


def test_aging_step_serves_the_aged_chip_and_trim(tiny):
    """A step of the aging engine equals a plain engine's step with the
    chip aged to the step's age and the trim then in force in
    ``params["p2m"]``, bit for bit (``cuda`` on the CPU)."""
    cfg_j, cfg_t, pj, pt, frames = tiny
    _, dt = _drift(**DPROFILE)
    eng = VisionEngine(cfg_t, pt, device="cpu", drift=dt, microbatch=2,
                       schedule=tlt.SchedulePolicy(period_frames=2,
                                                   cal_iters=4),
                       calibration_frames=frames)
    list(eng.stream([frames]))
    st = eng.lifetime
    assert st.age_frames == 4 and st.recal_count == 2
    aged = tlt.evolve_chip(st.chip0, st.maps, st.age_frames, dcfg=dt)
    plain = VisionEngine(cfg_t, {**pt, "p2m": {**pt["p2m"], "chip": aged,
                                               "cal_trim": st.trim}},
                         device="cpu")
    key = prng.PRNGKey(4)
    o = eng.classify(frames, key=key)
    o_plain = plain.classify(frames, key=key)
    assert torch.equal(o["labels"], o_plain["labels"])
    assert torch.equal(o["probs"], o_plain["probs"])
    assert torch.equal(o["channel_rates"], o_plain["channel_rates"])


def test_replay_and_key_free_rules(tiny):
    """An explicit key replays a draw without aging the chip (and emits no
    lifetime keys); refreshes consume no key (frame counter and key equal
    a scheduler-less twin's) and re-solving the last refresh's aged chip
    gives the programmed trim bit for bit."""
    _, cfg_t, _, pt, frames = tiny
    _, dt = _drift(**DPROFILE)
    armed = VisionEngine(cfg_t, pt, backend="device", device="cpu",
                         microbatch=2, drift=dt,
                         schedule=tlt.SchedulePolicy(period_frames=4,
                                                     cal_iters=6),
                         calibration_frames=frames)
    twin = VisionEngine(cfg_t, pt, backend="device", device="cpu",
                        microbatch=2, drift=dt)
    out = armed.classify(frames)
    assert armed.lifetime.age_frames == 4
    assert float(out["lifetime_recal_fired"]) == 1.0
    replay = armed.classify(frames, key=prng.PRNGKey(99))
    assert armed.lifetime.age_frames == 4
    assert not any(k.startswith("lifetime_") for k in replay)
    twin.classify(frames)
    list(armed.stream([frames, frames]))
    list(twin.stream([frames, frames]))
    assert armed.lifetime.recal_count == 3
    assert armed._frame_count == twin._frame_count
    np.testing.assert_array_equal(armed._key, twin._key)
    st = armed.lifetime
    aged = armed._evolve(st.chip0, st.maps, st.last_recal_frame)
    assert torch.equal(armed._scheduler._solve(aged), st.trim)


@pytest.mark.parametrize("backend", ["ideal", "analog", "device", "cuda"])
def test_inert_lifetime_is_bit_identical(tiny, backend):
    """``drift=None`` and an all-zero profile, a scheduler armed, leave a
    stream bit for bit the plain engine's on every backend."""
    _, cfg_t, _, pt, frames = tiny
    pol = tlt.SchedulePolicy(period_frames=2)
    for drift in (None, tlt.DriftConfig()):
        plain = VisionEngine(cfg_t, pt, backend=backend, device="cpu",
                             microbatch=2)
        aging = VisionEngine(cfg_t, pt, backend=backend, device="cpu",
                             microbatch=2, drift=drift, schedule=pol,
                             calibration_frames=frames)
        assert aging.lifetime is None
        for o_p, o_a in zip(plain.stream([frames, frames]),
                            aging.stream([frames, frames])):
            assert set(o_p) == set(o_a)
            for k in ("labels", "probs", "channel_rates"):
                assert torch.equal(o_p[k], o_a[k]), k


def test_merge_rules_for_the_lifetime_keys():
    """Counters merge by their last value and refresh events by
    any-fired, never by a frame-weighted mean."""
    outs = [{"wall_ms": 1.0, "lifetime_age_frames": 2.0,
             "lifetime_recal_count": 0.0, "lifetime_recal_fired": 0.0,
             "lifetime_rate_err": 0.25, "lifetime_recal_energy_pj": 0.0},
            {"wall_ms": 1.0, "lifetime_age_frames": 5.0,
             "lifetime_recal_count": 1.0, "lifetime_recal_fired": 1.0,
             "lifetime_rate_err": 0.0, "lifetime_recal_energy_pj": 7.5},
            {"wall_ms": 1.0, "lifetime_age_frames": 6.0,
             "lifetime_recal_count": 1.0, "lifetime_recal_fired": 0.0,
             "lifetime_rate_err": 0.125, "lifetime_recal_energy_pj": 7.5}]
    m = _merge_outputs(outs, [2, 3, 1])
    assert m["lifetime_age_frames"] == 6.0
    assert m["lifetime_recal_count"] == 1.0
    assert m["lifetime_recal_fired"] == 1.0
    assert m["lifetime_rate_err"] == 0.125
    assert m["lifetime_recal_energy_pj"] == 7.5
    assert m["wall_ms"] == 3.0


# --- the fleet ---------------------------------------------------------------

def test_rate_error_vs_age_matches_reference():
    """3 chips at ages (0, 1e3, 1e5), ``iters=10``: the four surfaces
    within 1e-5 of the reference's; the birth trims within 8 LSBs of the
    reference's jitted fleet solve."""
    pcfg = j_p2m.P2MConfig()
    params = j_p2m.init_params(jax.random.PRNGKey(14), pcfg)
    frames = jax.random.uniform(jax.random.PRNGKey(15), (4, 32, 32, 3))
    vj, vt = _vary(**VPROFILE)
    dj, dt = _drift(**DPROFILE)
    ages = (0.0, 1e3, 1e5)
    want = jlt.rate_error_vs_age(params, pcfg, vj, dj, frames, ages,
                                 n_chips=3, iters=10)
    params_t = tp.from_numpy(jax.tree.map(np.asarray, params))
    frames_t = np.array(frames)
    got = tlt.rate_error_vs_age(params_t, t_p2m.P2MConfig(), vt, dt,
                                frames_t, ages, 3, iters=10, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == (3, 3)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=SURFACE_ATOL, err_msg=k)
    stale = got["err_stale_mean"].mean(axis=0)
    assert stale[2] > stale[1] > stale[0]
    surf = t_fleet.fleet_surfaces(params_t, t_p2m.P2MConfig(), vt, dt,
                                  frames_t, ages, 3, iters=10, device="cpu")
    assert tuple(surf["trim_t"].shape) == (3, 3, 32)
    sj = jlt.RecalibrationScheduler(jlt.SchedulePolicy(period_frames=1,
                                                       cal_iters=10),
                                    pcfg, frames, params)
    chips_j = jax.vmap(lambda c: j_chip.sample_chip(vj, 32, 8, c))(
        jnp.arange(3))
    np.testing.assert_allclose(_np(surf["trim0"]),
                               np.asarray(sj.recalibrate_fleet(chips_j)),
                               rtol=0, atol=8 * _lsb(10))


def test_time_to_failure_equals_reference():
    ages = (0.0, 10.0, 100.0, 1000.0)
    err = np.array([[0.0, 0.01, 0.2, 0.3],
                    [0.0, 0.0, 0.0, 0.0],
                    [0.0, 0.2, 0.3, 0.4]])
    for budget in (0.05, 0.25, 1.0):
        assert (tlt.time_to_failure(err, ages, budget)
                == jlt.time_to_failure(err, ages, budget))
    ttf = tlt.time_to_failure(err, ages, budget=0.05)
    assert ttf["survivor_fraction"] == pytest.approx(1 / 3)
    assert ttf["ttf_frames_p50"] == 100.0


def test_accuracy_vs_age_matches_reference(tiny, monkeypatch):
    """1 chip, ages (0, 1e5), ``cal_iters=6``, through ``device``: the
    rows equal the reference's, and every eval's key is the reference's
    and its logits within 1e-5 (the words are jax's)."""
    cfg_j, cfg_t, pj, pt, frames = tiny
    cfg_j = dataclasses.replace(cfg_j, variation=None)
    cfg_t = dataclasses.replace(cfg_t, variation=None)
    labels = np.arange(4) % 10
    vj, vt = _vary(**VPROFILE)
    dj, dt = _drift(**DPROFILE)
    kj = jax.random.PRNGKey(7)
    seen = {"j": [], "t": []}

    def recording(fwd, tag):
        def call(params, images, cfg, **kw):
            out = fwd(params, images, cfg, **kw)
            seen[tag].append((_np(kw["key"]), _np(out[0])))
            return out
        return call

    monkeypatch.setattr(jv, "forward", recording(jv.forward, "j"))
    monkeypatch.setattr(tv, "forward", recording(tv.forward, "t"))
    kw = dict(ages=(0.0, 1e5), n_chips=1, cal_iters=6)
    rows_j = jlt.accuracy_vs_age(
        pj, cfg_j, [{"image": jnp.asarray(frames),
                     "label": jnp.asarray(labels)}],
        vcfg=vj, dcfg=dj, calibration_frames=jnp.asarray(frames), key=kj,
        **kw)
    rows_t = tlt.accuracy_vs_age(
        pt, cfg_t, [{"image": frames, "label": labels}], vcfg=vt, dcfg=dt,
        calibration_frames=frames, key=np.asarray(jax.random.key_data(kj)),
        device="cpu", **kw)
    assert rows_t == rows_j
    assert len(seen["t"]) == len(seen["j"]) == 4
    for (k_t, l_t), (k_j, l_j) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(k_t, np.asarray(
            jax.random.key_data(k_j)))
        np.testing.assert_allclose(l_t, l_j, rtol=0, atol=LOGITS_ATOL)


def test_lifetime_entry_points_default_to_the_gpu(tiny):
    """``sample_drift_maps``, the scheduler, ``rate_error_vs_age`` and
    ``accuracy_vs_age`` run on the GPU unless asked otherwise: without one
    each raises and names ``device="cpu"``; with one their results lie on
    it."""
    _, cfg_t, _, pt, frames = tiny
    _, dt = _drift(**DPROFILE)
    _, vt = _vary(**VPROFILE)
    calls = {
        "sample_drift_maps": lambda: tlt.sample_drift_maps(
            dt, 8, 8, 0).d_tmr,
        "scheduler": lambda: tlt.RecalibrationScheduler(
            tlt.SchedulePolicy(period_frames=4, cal_iters=2), cfg_t.p2m,
            frames[:1], pt["p2m"])._ref,
        "rate_error_vs_age": lambda: t_fleet.fleet_surfaces(
            pt["p2m"], cfg_t.p2m, vt, dt, frames[:1], (0.0,), 1,
            iters=2)["trim0"],
        "accuracy_vs_age": lambda: tlt.accuracy_vs_age(
            pt, cfg_t, [], vcfg=vt, dcfg=dt, ages=(), n_chips=0,
            calibration_frames=frames[:1], key=prng.PRNGKey(0))}
    for name, call in calls.items():
        if torch.cuda.is_available():
            out = call()
            if isinstance(out, torch.Tensor):
                assert out.device.type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
