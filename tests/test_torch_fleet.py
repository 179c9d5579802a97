"""The port's fleet serving against the JAX package's: ``FleetEngine``
(``cuda`` on the CPU, that is the kernels' plain versions, against the
reference's ``pallas`` in interpret mode), the fleet frontend wrappers, and
warm restarts across the two packages.

The cases mirror ``tests/test_fleet_engine.py`` (vgg_tiny, 32x32 frames,
its variation and drift profiles): single-chip parity with the port's
``VisionEngine`` on every backend, a microbatched fused stream, the
variation-and-drift stream with birth calibration, nothing planted,
classify leaving the carry alone, ragged tails, a chip joining and leaving
mid-stream, the sweep (staleness priority, audit trail, energy budget,
rng-freedom), save / restore / resume, the seed check and a pinned replay
ageing nothing. The reference's jit-cache and sharded cases have no
counterpart (no jit, no mesh here).

Tolerances and why:

* port against reference: labels equal; probs within 1e-6 and
  ``channel_rates`` within 1e-6 (the same draws, float32 sums in another
  order); every ``lifetime_*`` value, age, counter and refreshed-id list
  equal; trims within 8 * span / 2^iters of the reference's (the rates of
  the bisection sum in another order, so a step near the target may go the
  other way), farther only where the port's trim puts the channel's rate
  at least as close to its target (``_check_registry``); where a fleet sweeps, the serving path is then compared on
  the reference's trims (a trim one step off moves draws legitimately);
* port against port (a one-chip fleet against ``VisionEngine``, a
  restarted fleet against the one that saved): bit for bit;
* the fleet wrappers against the reference's on the same operands: draws
  by ``tests/draw_asserts.py``'s word-boundary rule, theta and the V stats
  at rtol 1e-5, ``channel_rates`` within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from draw_asserts import assert_draws_match_modulo_word_boundary
from repro import lifetime as jlt
from repro.kernels import ops as j_ops
from repro.kernels import p2m_conv as jk
from repro.kernels import ref as j_ref
from repro.models import vision as jv
from repro.serving import FleetEngine as JaxFleet
from repro.serving import FleetSweepPolicy as JaxSweep
from repro.variation import chip as j_chip
from repro_torch import lifetime as tlt
from repro_torch import prng
from repro_torch.kernels import autotune as t_autotune
from repro_torch.kernels import ops as t_ops
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.serving import FleetEngine, FleetSweepPolicy, VisionEngine
from repro_torch.variation import chip as t_chip
from repro_torch.core import hoyer as t_hoyer
from repro_torch.core import p2m as t_p2m
from repro_torch.variation.calibrate import (calibrate, channel_rates,
                                             target_rates)

VPROFILE = dict(sigma_logit_offset=0.4, sigma_pixel_offset=0.25,
                sigma_pixel_gain=0.05)
DPROFILE = dict(sigma_pixel_offset=0.2, sigma_logit_offset=0.1,
                tau_frames=50.0)
PROBS_ATOL = RATES_ATOL = 1e-6
# birth calibration's bisection steps, a refresh's (SchedulePolicy's
# default cal_iters) and both windows
BIRTH_ITERS, REFRESH_ITERS, SPAN = 16, 12, 2.0


def _lsb(iters, span=SPAN):
    return span / 2 ** iters


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same(a, b) -> bool:
    return np.array_equal(_np(a), _np(b))


def _frames(seed: int, b: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        size=(b, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """(cfg_j, cfg_t, params_j, params_t) of vgg_tiny, nominal chips."""
    cfg_j = jv.VisionConfig(arch="vgg_tiny")
    cfg_t = tv.VisionConfig(arch="vgg_tiny")
    pj = jv.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tp.from_numpy(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def varied(tiny):
    """The same with the variation profile armed."""
    _, _, pj, pt = tiny
    return (jv.VisionConfig(arch="vgg_tiny",
                            variation=j_chip.VariationConfig(**VPROFILE)),
            tv.VisionConfig(arch="vgg_tiny",
                            variation=t_chip.VariationConfig(**VPROFILE)),
            pj, pt)


@pytest.fixture(scope="module")
def cal_frames():
    return _frames(42, 8)


@pytest.fixture(autouse=True)
def _untuned(monkeypatch):
    """Every shape at the default choice (f32, fused) on both sides."""
    from repro.kernels import autotune as j_autotune
    monkeypatch.setattr(t_autotune, "_TABLE", {})
    monkeypatch.setattr(j_autotune, "_TABLE", {})


def _pair(setup, **kw):
    """The reference's and the port's engine on one setup: ``kw`` values
    given as (reference, port) pairs go to each side."""
    cfg_j, cfg_t, pj, pt = setup
    kj = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    kt = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    if "calibration_frames" in kw:
        kj["calibration_frames"] = jnp.asarray(kw["calibration_frames"])
    return (JaxFleet(cfg_j, pj, backend="pallas", seed=0, **kj),
            FleetEngine(cfg_t, pt, backend="cuda", seed=0, device="cpu",
                        **kt))


def _drift():
    return jlt.DriftConfig(**DPROFILE), tlt.DriftConfig(**DPROFILE)


def _sweep(**kw):
    pol = kw.pop("period_frames")
    return (JaxSweep(policy=jlt.SchedulePolicy(period_frames=pol), **kw),
            FleetSweepPolicy(policy=tlt.SchedulePolicy(period_frames=pol),
                             **kw))


def _serve(ej, et, requests):
    """One request batch through both engines."""
    outs_j = ej.serve([(c, jnp.asarray(f)) for c, f in requests])
    outs_t = et.serve(requests)
    return outs_j, outs_t


def _check(oj, ot):
    np.testing.assert_array_equal(_np(ot["labels"]), np.asarray(oj["labels"]))
    np.testing.assert_allclose(_np(ot["probs"]), np.asarray(oj["probs"]),
                               rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(_np(ot["channel_rates"]),
                               np.asarray(oj["channel_rates"]), rtol=0,
                               atol=RATES_ATOL)
    assert set(ot) == set(oj), set(ot) ^ set(oj)
    for k in (k for k in oj if k.startswith("lifetime_")):
        assert float(ot[k]) == float(oj[k]), k


def _trim_rate_gaps(et, cal, slot, trims):
    """|rate - target| of chip ``slot`` (aged to its last solve) at each
    of ``trims`` (C,), by the port's chain on the calibration frames."""
    pp = et.params["p2m"]
    u = t_p2m.hardware_conv(torch.from_numpy(cal), pp["w"], et.cfg.p2m)
    theta = t_hoyer.effective_threshold(u, pp["v_th"]) * pp["v_th"]
    target = target_rates(u, theta, et.cfg.p2m)
    chip, _ = et._gather_operands(
        [slot], np.array([et.state.last_recal_frame[slot]], np.float64))
    return [np.abs(_np(channel_rates(u, theta, chip, torch.from_numpy(
        np.array(t))[None], et.cfg.p2m)[0] - target)) for t in trims]


def _check_registry(ej, et, cal=None):
    """Registries equal; each trim within 8 LSBs of its last solve (birth
    calibration's 16 steps, or a refresh's ``SchedulePolicy.cal_iters``)
    of the reference's. Farther only on a channel whose rate is flat there
    (near saturation the reference's float32 sequential mean over the
    calibration frames, up to ~1e-5 off, moves its bisection by more), and
    then the port's trim must put the rate at least as close to the
    target as the reference's trim does."""
    sj, st = ej.state, et.state
    assert st.chip_ids == sj.chip_ids
    for name in ("age_frames", "frame_count", "last_recal_frame",
                 "recal_count", "ema_valid", "baseline_valid"):
        np.testing.assert_array_equal(getattr(st, name), getattr(sj, name),
                                      err_msg=name)
    np.testing.assert_array_equal(st.recal_energy_pj, sj.recal_energy_pj)
    iters = np.where(st.recal_count > 0, REFRESH_ITERS, BIRTH_ITERS)
    err = np.abs(_np(st.trim) - np.asarray(sj.trim))
    far = err > 8 * _lsb(iters)[:, None]
    for slot in np.nonzero(far.any(axis=1))[0]:
        assert cal is not None, err.max()
        gap_t, gap_j = _trim_rate_gaps(et, cal, slot, (
            _np(st.trim)[slot], np.asarray(sj.trim)[slot]))
        assert np.all((gap_t <= gap_j + 1e-7)[far[slot]]), (gap_t, gap_j)
    assert et.frames_served == ej.frames_served
    assert et.sweep_count == ej.sweep_count


# --- single-chip parity: a one-chip fleet is a VisionEngine ------------------

@pytest.mark.parametrize("backend", ["ideal", "analog", "device", "cuda"])
def test_classify_matches_vision_engine(tiny, backend):
    _, cfg, _, p = tiny
    ve = VisionEngine(cfg, p, backend=backend, device="cpu")
    fe = FleetEngine(cfg, p, backend=backend, device="cpu")
    f = _frames(1)
    a, b = ve.classify(f), fe.classify(7, f)
    for k in a:
        assert _same(a[k], b[k]) or k in ("wall_ms", "throughput_fps"), k
    assert set(a) == set(b)


@pytest.fixture(scope="module")
def fused_streams(tiny):
    """Three batches of 5 on chip 3 at microbatch 2 through both fleets."""
    batches = [_frames(i + 10, 5) for i in range(3)]
    ej, et = _pair(tiny, microbatch=2)
    outs_j = [o for (o,) in ej.stream([[(3, jnp.asarray(b))]
                                       for b in batches])]
    outs_t = [o for (o,) in et.stream([[(3, b)] for b in batches])]
    return batches, ej, et, outs_j, outs_t


def test_microbatched_fused_stream_matches_vision_engine(tiny,
                                                         fused_streams):
    _, cfg, _, p = tiny
    batches, _, et, _, outs_t = fused_streams
    ve = VisionEngine(cfg, p, device="cpu", microbatch=2)
    for ov, of in zip(ve.stream(batches), outs_t):
        for k in ("labels", "probs", "theta_used", "stream_fused"):
            assert _same(ov[k], of[k]), k
        assert set(ov) == set(of)
    assert ve._theta_carry == et._theta_carry[3]
    assert et.fused_step_count == ve.fused_step_count >= 1


def test_microbatched_fused_stream_matches_reference(fused_streams):
    _, ej, et, outs_j, outs_t = fused_streams
    for oj, ot in zip(outs_j, outs_t):
        _check(oj, ot)
        assert float(ot["stream_fused"]) == float(oj["stream_fused"])
        np.testing.assert_allclose(float(ot["theta_used"]),
                                   float(oj["theta_used"]), rtol=1e-5)
    assert et.fused_step_count == ej.fused_step_count
    assert et.fused_fallback_count == ej.fused_fallback_count
    _check_registry(ej, et)


def test_variation_drift_stream_matches(varied, cal_frames):
    """A sampled chip, birth calibration and per-microbatch aging: the
    birth trim is ``calibrate``'s bit for bit and within 8 LSBs of the
    reference's; the stream equals a calibrated aging ``VisionEngine`` bit
    for bit and the reference's fleet by the rules above."""
    cfg_j, _, pj, pt = varied
    cfg_t = tv.VisionConfig(arch="vgg_tiny", chip_id=5,
                            variation=t_chip.VariationConfig(**VPROFILE))
    ej, et = _pair(varied, microbatch=2, drift=_drift(),
                   calibration_frames=cal_frames)
    ej.add_chip(5)
    et.add_chip(5)
    art = calibrate(pt["p2m"], cfg_t.p2m, cfg_t.variation, cal_frames,
                    chip_id=5, device="cpu")
    assert _same(art.trim, et.state.trim[0])
    ve = VisionEngine(cfg_t, pt, device="cpu", microbatch=2,
                      calibration=art, drift=_drift()[1])
    batches = [_frames(i + 10, 5) for i in range(3)]
    outs_v = list(ve.stream(batches))
    outs_j = [o for (o,) in ej.stream([[(5, jnp.asarray(b))]
                                       for b in batches])]
    outs_t = [o for (o,) in et.stream([[(5, b)] for b in batches])]
    for ov, oj, ot in zip(outs_v, outs_j, outs_t):
        _check(oj, ot)
        for k in ("labels", "probs", "lifetime_age_frames", "theta_used"):
            assert _same(ov[k], ot[k]), k
        assert set(ov) == set(ot)
    _check_registry(ej, et)


def test_no_variation_no_drift_plants_nothing(tiny):
    """Neither axis armed: no chip operand is planted, so even ``analog``
    (whose identity chip is no bit-exact no-op) streams as a plain
    engine."""
    _, cfg, _, p = tiny
    fe = FleetEngine(cfg, p, backend="analog", device="cpu", microbatch=3)
    assert not fe._plant
    ve = VisionEngine(cfg, p, backend="analog", device="cpu", microbatch=3)
    batches = [_frames(i + 30, 5) for i in range(2)]
    for ov, (of,) in zip(ve.stream(batches),
                         fe.stream([[(2, b)] for b in batches])):
        assert _same(ov["probs"], of["probs"])


def test_classify_does_not_touch_stream_carry(tiny):
    _, cfg, _, p = tiny
    fe = FleetEngine(cfg, p, device="cpu")
    fe.classify(0, _frames(1))
    assert fe._theta_carry == {}


# --- ragged fleets --------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged(tiny):
    """Both fleets through unequal requests (10 and 7 frames at
    microbatch 4, two chips a step), then chip 9 joining, then chip 1
    leaving."""
    ej, et = _pair(tiny, microbatch=4, chips_per_step=2, fused_stream=False)
    rounds = [[(0, _frames(1, 10)), (1, _frames(2, 7))],
              [(0, _frames(3)), (9, _frames(4))]]
    outs = [_serve(ej, et, r) for r in rounds]
    ej.remove_chip(1)
    et.remove_chip(1)
    outs.append(_serve(ej, et, [(0, _frames(5))]))
    return ej, et, outs


def test_ragged_fleet_matches_reference(ragged):
    ej, et, outs = ragged
    for outs_j, outs_t in outs:
        for oj, ot in zip(outs_j, outs_t):
            _check(oj, ot)
    _check_registry(ej, et)
    assert et.state.chip_ids == [0, 9]


def test_mixed_chip_tail_microbatches(tiny, ragged):
    """Packing is invisible to the rng: each request equals its chip's
    solo stream."""
    _, cfg, _, p = tiny
    _, _, outs = ragged
    out_a, out_b = outs[0][1]
    assert out_a["labels"].shape == (10,) and out_b["labels"].shape == (7,)
    solo = FleetEngine(cfg, p, device="cpu", microbatch=4,
                       fused_stream=False)
    ref0 = solo.serve([(0, _frames(1, 10))])[0]
    assert _same(out_a["labels"], ref0["labels"])
    assert _same(out_a["probs"], ref0["probs"])


def test_chip_joins_and_leaves_mid_stream(tiny, ragged):
    """A joining chip registers with its deterministic identity and a
    leaving one is dropped; neither perturbs chip 0's stream."""
    _, cfg, _, p = tiny
    _, et, outs = ragged
    ref = FleetEngine(cfg, p, device="cpu", microbatch=4,
                      fused_stream=False)
    ref.serve([(0, _frames(1, 10))])
    for rnd in (1, 2):
        (r0,) = ref.serve([(0, _frames(3 if rnd == 1 else 5))])
        assert _same(outs[rnd][1][0]["probs"], r0["probs"])
    with pytest.raises(KeyError):
        et.slot_of(1)
    with pytest.raises(KeyError):
        et.remove_chip(3)


# --- the maintenance sweep ------------------------------------------------------

def _aging_pair(varied, cal_frames, sweep, **kw):
    return _pair(varied, chips_per_step=4, drift=_drift(), sweep=sweep,
                 calibration_frames=cal_frames, **kw)


def test_staleness_priority(varied, cal_frames):
    """More eligible chips than the budget: the stalest first, on both
    sides alike."""
    ej, et = _aging_pair(varied, cal_frames,
                         _sweep(period_frames=4, refresh_per_sweep=1,
                                auto=False))
    _serve(ej, et, [(0, _frames(1, 8))])                # chip 0 ages 8
    _serve(ej, et, [(1, _frames(2, 4))])                # chip 1 ages 4
    rj, rt = ej.run_sweep(), et.run_sweep()
    assert rt["eligible"] == rj["eligible"] == 2
    assert rt["refreshed"] == rj["refreshed"] == [0]
    assert et.state.recal_count[et.slot_of(0)] == 1
    assert et.state.recal_count[et.slot_of(1)] == 0
    assert et.run_sweep()["refreshed"] == ej.run_sweep()["refreshed"] == [1]
    _check_registry(ej, et)


def test_refresh_updates_trim_and_audit_trail(varied, cal_frames):
    _, et = _aging_pair(varied, cal_frames,
                        _sweep(period_frames=4, refresh_per_sweep=4,
                               auto=False))
    et.serve([(0, _frames(1, 8)), (1, _frames(2, 8))])
    trim_before = _np(et.state.trim).copy()
    assert sorted(et.run_sweep()["refreshed"]) == [0, 1]
    assert not np.array_equal(_np(et.state.trim), trim_before)
    assert (et.state.recal_count == 1).all()
    assert (et.state.last_recal_frame == et.state.age_frames).all()
    assert (et.state.recal_energy_pj > 0).all()


def test_energy_budget_gates_refreshes(varied, cal_frames):
    """Refreshes wait until served frames accrued one refresh's credit."""
    _, probe = _aging_pair(varied, cal_frames,
                           _sweep(period_frames=4, auto=False))
    cost = probe._scheduler.recal_energy_pj
    _, et = _aging_pair(varied, cal_frames,
                        _sweep(period_frames=4, refresh_per_sweep=4,
                               auto=False,
                               maintenance_energy_per_frame_pj=cost / 16))
    et.serve([(0, _frames(1, 8))])
    assert et._energy_credit_pj == pytest.approx(cost / 2)
    report = et.run_sweep()
    assert report["eligible"] == 1 and report["refreshed"] == []
    et.serve([(0, _frames(2, 8))])
    assert et.run_sweep()["refreshed"] == [0]
    assert et._energy_credit_pj >= 0.0


def test_sweep_is_rng_free(varied, cal_frames):
    """A forced refresh moves no rng stream: the frame counters and ages
    equal a fleet's that never swept."""
    sweep = _sweep(period_frames=10 ** 9, refresh_per_sweep=4, auto=False)
    _, et = _aging_pair(varied, cal_frames, sweep)
    _, ref = _aging_pair(varied, cal_frames, sweep)
    et.serve([(0, _frames(1))])
    ref.serve([(0, _frames(1))])
    et.run_sweep(force=True)
    assert et.state.frame_count[0] == ref.state.frame_count[0]
    assert et.state.age_frames[0] == ref.state.age_frames[0]


# --- warm restarts -------------------------------------------------------------

CONTINUATION = [[(0, 20), (2, 21), (1, 22)], [(1, 23), (0, 24)]]


def _held_trims(ej, et, cal):
    """Hold the port's solved trims to the reference's (``_check_registry``),
    then program the reference's into the port: a trim one bisection step
    off legitimately moves draws, so the serving path is compared on the
    reference's trims. Returns the port's own solve."""
    _check_registry(ej, et, cal)
    solved = _np(et.state.trim).copy()
    et.state.trim = torch.from_numpy(np.array(ej.state.trim))
    return solved


@pytest.fixture(scope="module")
def restart(varied, cal_frames, tmp_path_factory):
    """Both fleets (variation, drift, sweeps every 8 frames, three chips a
    step) register chips 0-2 (birth calibration), serve two rounds and
    save; then the continuation. After the registration and after every
    round (its sweep) the trims are held and the reference's programmed
    (``_held_trims``); ``trims`` keeps each round's reference and port
    solves."""
    def make():
        return _pair(varied, microbatch=4, chips_per_step=3, drift=_drift(),
                     sweep=_sweep(period_frames=8, refresh_per_sweep=2),
                     calibration_frames=cal_frames)

    ej, et = make()
    for cid in range(3):
        ej.add_chip(cid)
        et.add_chip(cid)
    _held_trims(ej, et, cal_frames)
    first = []
    for batch in ([(0, _frames(1)), (1, _frames(2)), (2, _frames(3))],
                  [(2, _frames(4)), (0, _frames(5))]):
        first.append(_serve(ej, et, batch))
        _held_trims(ej, et, cal_frames)
    dirs = {side: str(tmp_path_factory.mktemp(f"fleet_{side}"))
            for side in ("j", "t")}
    step_j, step_t = ej.save(dirs["j"]), et.save(dirs["t"])
    cont, trims = [], []
    for batch in CONTINUATION:
        cont.append(_serve(ej, et, [(c, _frames(s)) for c, s in batch]))
        trims.append((np.array(ej.state.trim),
                      _held_trims(ej, et, cal_frames)))
    return dict(make=make, first=first, cont=cont, trims=trims, dirs=dirs,
                ej=ej, et=et, steps=(step_j, step_t), cal=cal_frames)


def test_sweeping_fleet_matches_reference(restart):
    for outs_j, outs_t in restart["first"] + restart["cont"]:
        for oj, ot in zip(outs_j, outs_t):
            _check(oj, ot)
    assert restart["et"].state.recal_count.sum() > 0
    _check_registry(restart["ej"], restart["et"], restart["cal"])


def test_save_restore_resumes_bit_identically(restart):
    """A fresh port fleet loads the port's checkpoint and serves the
    continuation (with the same trims programmed after each round) bit for
    bit; its sweeps solve the saver's trims bit for bit."""
    _, et2 = restart["make"]()
    assert et2.load(restart["dirs"]["t"]) == restart["steps"][1]
    assert et2.state.chip_ids == [0, 1, 2]
    for (_, ref), batch, (trim_j, solved) in zip(
            restart["cont"], CONTINUATION, restart["trims"]):
        got = et2.serve([(c, _frames(s)) for c, s in batch])
        for r, g in zip(ref, got):
            for k in ("labels", "probs", "theta_used", "lifetime_age_frames",
                      "lifetime_recal_count"):
                assert _same(r[k], g[k]), k
        assert _same(et2.state.trim, solved)
        et2.state.trim = torch.from_numpy(trim_j.copy())


def test_reference_checkpoint_loads_into_the_port(restart):
    """The reference's ``save`` directory (its ``.npz`` + ``manifest.json``
    layout as it is) loads into the port's fleet, which then serves the
    reference's continuation by the port-against-reference rules."""
    _, et2 = restart["make"]()
    assert et2.load(restart["dirs"]["j"]) == restart["steps"][0]
    for (outs_j, _), batch, (trim_j, _) in zip(
            restart["cont"], CONTINUATION, restart["trims"]):
        got = et2.serve([(c, _frames(s)) for c, s in batch])
        for oj, ot in zip(outs_j, got):
            _check(oj, ot)
        et2.state.trim = torch.from_numpy(trim_j.copy())
    _check_registry(restart["ej"], et2, restart["cal"])


def test_restore_checks_seed(tiny, tmp_path):
    _, cfg, _, p = tiny
    fe = FleetEngine(cfg, p, device="cpu")
    fe.serve([(0, _frames(1))])
    fe.save(str(tmp_path))
    other = FleetEngine(cfg, p, device="cpu", seed=1)
    with pytest.raises(ValueError, match="seed"):
        other.load(str(tmp_path))


def test_pinned_key_replay_on_restored_fleet_ages_nothing(varied, cal_frames,
                                                          tmp_path):
    _, cfg, _, p = varied
    kw = dict(device="cpu", drift=_drift()[1], calibration_frames=cal_frames)
    fe = FleetEngine(cfg, p, **kw)
    fe.serve([(0, _frames(1)), (1, _frames(2))])
    fe.save(str(tmp_path))
    fe2 = FleetEngine(cfg, p, **kw)
    fe2.load(str(tmp_path))
    age0, fc0 = fe2.state.age_frames.copy(), fe2.state.frame_count.copy()
    key = prng.PRNGKey(99)
    a = fe2.classify(0, _frames(30), key=key)
    b = fe2.classify(0, _frames(30), key=key)
    assert _same(a["labels"], b["labels"]) and _same(a["probs"], b["probs"])
    assert np.array_equal(fe2.state.age_frames, age0)
    assert np.array_equal(fe2.state.frame_count, fc0)


def test_fleet_engine_defaults_to_the_gpu(tiny):
    _, cfg, _, p = tiny
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetEngine(cfg, p)


# --- the fleet frontend wrappers against the reference's ---------------------

@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_fleet_wrappers_match_reference(precision):
    """``p2m_frontend_fleet`` and ``p2m_frontend_fused_fleet`` on 3 chips'
    frames (2 x 16 x 16), each with its own key and random (4, C) rows,
    against the reference's vmapped wrappers."""
    rng = np.random.default_rng(11)
    g, c = 3, 16
    images = rng.uniform(size=(g, 2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, c)) * 0.3).astype(np.float32)
    chan = np.stack([np.stack([1.0 + 0.1 * rng.normal(size=c),
                               0.05 * rng.normal(size=c),
                               1.0 + 0.1 * rng.normal(size=c),
                               0.3 * rng.normal(size=c)])
                     for _ in range(g)]).astype(np.float32)
    keys_t = [prng.fold_in(prng.PRNGKey(5), i) for i in range(g)]
    keys_j = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(5), i)
                        for i in range(g)])
    theta = np.array([0.5, 0.7, 0.6], np.float32)
    t = torch.from_numpy
    oj, auxj = j_ops.p2m_frontend_fleet(
        jnp.asarray(images), jnp.asarray(w), jnp.asarray(1.0), keys_j,
        chan=jnp.asarray(chan), precision=precision)
    ot, auxt = t_ops.p2m_frontend_fleet(t(images), t(w), torch.ones(()),
                                        keys_t, chan=t(chan),
                                        precision=precision)
    fj, fauxj = j_ops.p2m_frontend_fused_fleet(
        jnp.asarray(images), jnp.asarray(w), jnp.asarray(1.0),
        jnp.asarray(theta), keys_j, chan=jnp.asarray(chan),
        precision=precision)
    ft, fauxt = t_ops.p2m_frontend_fused_fleet(
        t(images), t(w), torch.ones(()), t(theta), keys_t, chan=t(chan),
        precision=precision)
    assert ot.shape == tuple(oj.shape) and ft.shape == tuple(fj.shape)
    wm = jk.pack_phase_weights(jnp.asarray(w).reshape(27, c))
    for i in range(g):
        if precision == "int8":
            wq, dq = j_ops.quantize_frontend_weights(wm)
            u_ref = jk.p2m_phase_a_implicit_q8_pallas(
                jnp.asarray(images[i]), wq, dq, jnp.ones((1, 1)), kernel=3,
                stride=2)[0]
        else:
            u_ref = jk.p2m_phase_a_implicit_pallas(
                jnp.asarray(images[i]), wm, jnp.ones((1, 1)), kernel=3,
                stride=2)[0]
        bits = j_ops.draw_bits(keys_j[i], u_ref.shape[0], c)
        for acts, th in ((ot, auxj["theta"][i]), (ft, theta[i])):
            q_ref, _ = j_ref._device_chain_q(
                u_ref, jnp.asarray(th), jnp.asarray(chan[i]),
                jk.pixel_model.DEFAULT_PIXEL, jk.mtj_model.DEFAULT_MTJ)
            assert_draws_match_modulo_word_boundary(
                acts[i].numpy().reshape(-1, c), q_ref, bits)
    for aj, at in ((auxj, auxt), (fauxj, fauxt)):
        assert set(at) == set(aj)
        for k in aj:
            assert tuple(at[k].shape) == tuple(aj[k].shape), k
            np.testing.assert_allclose(
                _np(at[k]), np.asarray(aj[k]), rtol=1e-5,
                atol=RATES_ATOL if k == "channel_rates" else 0, err_msg=k)


def test_fleet_table_key_ignores_the_chip_axis(monkeypatch):
    """One per-chip row serves every fleet size; the table never grows
    with G; an explicit precision or fused flag wins."""
    monkeypatch.setattr(t_autotune, "_TABLE", {})
    t_autotune.put(256, 27, 32, t_autotune.TileChoice(fused=False,
                                                      precision="int8"))
    for g in (1, 4, 64):
        assert t_autotune.fleet_key(g, 256, 27, 32) == (256, 27, 32)
        assert t_autotune.resolve_fleet(g, 256, 27, 32) == "int8"
        assert t_autotune.resolve_fleet(g, 256, 27, 32, "f32") == "f32"
        assert t_autotune.resolve_fleet_fused(g, 256, 27, 32) is False
        assert t_autotune.resolve_fleet_fused(g, 256, 27, 32, True) is True
    assert t_autotune.get_fleet(8, 512, 27, 32) == t_autotune.TileChoice()
    assert len(t_autotune._TABLE) == 2


def test_stacked_channel_rows_are_each_chips(varied):
    """``channel_operands`` of a (G, ...) chip stack and (G, C) trims is
    (G, 4, C), row g chip g's (4, C) rows bit for bit."""
    _, cfg, _, _ = varied
    ids = [4, 0, 9]
    chips = t_chip.sample_chips(cfg.variation, 32, 8, ids, device="cpu")
    trims = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 32)).astype(np.float32))
    rows = t_chip.channel_operands(chips, trims)
    assert rows.shape == (3, 4, 32)
    for i, cid in enumerate(ids):
        one = t_chip.sample_chip(cfg.variation, 32, 8, cid, device="cpu")
        assert torch.equal(rows[i], t_chip.channel_operands(one, trims[i]))


def test_evolve_at_an_age_vector_is_each_chips(varied):
    """``evolve_chip`` of a stack at (G,) ages: row g bit for bit chip g
    evolved at its own age."""
    _, cfg, _, _ = varied
    dcfg = tlt.DriftConfig(**DPROFILE, temp_amplitude_c=10.0,
                           temp_logit_per_c=-0.03, sigma_logit_gain=0.05,
                           sigma_tmr=0.03, tmr_retention=0.01,
                           pixel_gain_aging=0.01)
    ids, ages = [3, 1, 7], np.array([0.0, 300.0, 123457.0])
    chips = t_chip.sample_chips(cfg.variation, 32, 8, ids, device="cpu")
    maps = tlt.sample_drift_maps(dcfg, 32, 8, ids, device="cpu")
    aged = tlt.evolve_chip(chips, maps, ages, dcfg=dcfg)
    for i, (cid, age) in enumerate(zip(ids, ages)):
        one = tlt.evolve_chip(
            t_chip.sample_chip(cfg.variation, 32, 8, cid, device="cpu"),
            tlt.sample_drift_maps(dcfg, 32, 8, cid, device="cpu"), int(age),
            dcfg=dcfg)
        for a, b in zip(one, aged):
            assert torch.equal(a, b[i])
