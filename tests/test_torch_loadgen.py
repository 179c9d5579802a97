"""The port's load generator (``repro_torch.serving.loadgen``) against the
JAX package's (``repro.serving.loadgen``).

Every comparison is exact: the generator is pure host arithmetic on Python
floats and ints, so the same configuration must give the same schedule,
admission plan, simulation and knee byte for byte (compared as
``json.dumps(..., sort_keys=True)`` text), and ``record_slo`` the same
instruments, snapshot for snapshot. The port's copy reads no clock and,
loaded alone in a fresh interpreter, imports neither torch nor jax nor
numpy.
"""
import json
import subprocess
import sys

import pytest

import repro.obs as j_obs
import repro.serving as j_serving
from repro.serving import loadgen as j_lg
import repro_torch.obs as t_obs
import repro_torch.serving as t_serving
from repro_torch.serving import loadgen as t_lg

CONFIGS = [dict(seed=3, offered_fps=1500.0, n_requests=64),
           dict(seed=0, offered_fps=250.0, n_requests=40,
                frames_per_request=4, chips=3),
           dict(seed=7, offered_fps=4000.0, n_requests=96, arrival="uniform"),
           dict(seed=11, offered_fps=900.0, n_requests=33, chips=8,
                frames_per_request=2)]
PLANS = [(8, 0.004), (1, 0.001), (16, 0.02), (5, 1e-4)]


def _text(x) -> str:
    return json.dumps(x, sort_keys=True)


def _model(batch) -> float:
    return 1e-3 + 2.5e-4 * batch.n_frames


def _both(fn, *args, **kw):
    return getattr(j_lg, fn)(*args, **kw), getattr(t_lg, fn)(*args, **kw)


def _schedules(cfg):
    return (j_lg.make_schedule(j_lg.LoadgenConfig(**cfg)),
            t_lg.make_schedule(t_lg.LoadgenConfig(**cfg)))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 7])
def test_hash_u01_equals_reference(seed):
    assert [t_lg.hash_u01(seed, i) for i in range(4096)] == \
        [j_lg.hash_u01(seed, i) for i in range(4096)]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"seed{c['seed']}")
def test_schedule_equals_reference(cfg):
    sj, st = _schedules(cfg)
    assert _text([r.to_json() for r in st]) == \
        _text([r.to_json() for r in sj])
    assert [r.t_arrival for r in st] == [r.t_arrival for r in sj]


@pytest.mark.parametrize("max_frames,deadline", PLANS)
@pytest.mark.parametrize("cfg", CONFIGS[:2], ids=lambda c: f"seed{c['seed']}")
def test_plan_equals_reference(cfg, max_frames, deadline):
    sj, st = _schedules(cfg)
    pj = j_lg.plan_microbatches(sj, max_frames, deadline)
    pt = t_lg.plan_microbatches(st, max_frames, deadline)
    assert _text([b.to_json() for b in pt]) == \
        _text([b.to_json() for b in pj])


@pytest.mark.parametrize("slo_ms", [None, 3.0])
@pytest.mark.parametrize("service", ["model", "measured"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"seed{c['seed']}")
def test_simulate_equals_reference(cfg, service, slo_ms):
    sj, st = _schedules(cfg)
    pj = j_lg.plan_microbatches(sj, 8, 0.004)
    pt = t_lg.plan_microbatches(st, 8, 0.004)
    walls = (_model if service == "model"
             else [1e-3 * (1 + (i * 7) % 5) for i in range(len(pj))])
    simj = j_lg.simulate(pj, walls, slo_ms=slo_ms)
    simt = t_lg.simulate(pt, walls, slo_ms=slo_ms)
    assert _text(simt) == _text(simj)


def test_simulate_refuses_what_the_reference_refuses():
    sj, st = _schedules(CONFIGS[0])
    pj = j_lg.plan_microbatches(sj, 8, 0.004)
    pt = t_lg.plan_microbatches(st, 8, 0.004)
    for lg, plan in ((j_lg, pj), (t_lg, pt)):
        with pytest.raises(ValueError, match="service times"):
            lg.simulate(plan, [1e-3])
        with pytest.raises(ValueError, match="max_frames"):
            lg.plan_microbatches([], 0, 1e-3)
    for bad in (dict(offered_fps=0.0), dict(arrival="bursty")):
        with pytest.raises(ValueError):
            j_lg.LoadgenConfig(**bad)
        with pytest.raises(ValueError):
            t_lg.LoadgenConfig(**bad)


def _knee_rows():
    def row(fps, p99, slowdown=1.0):
        return {"offered_fps": fps, "latency_p99_ms": p99,
                "achieved_fps": fps, "slowdown": slowdown}
    flat = [row(100.0, 5.0), row(200.0, 5.5), row(400.0, 6.0)]
    return [[], flat, flat + [row(800.0, 20.0)],
            flat + [row(800.0, 6.5, slowdown=1.4)],
            flat + [row(800.0, 6.5, 1.05)], [row(1.0, 0.0)]]


@pytest.mark.parametrize("i", range(6))
def test_find_knee_equals_reference(i):
    rows = _knee_rows()[i]
    kj, kt = _both("find_knee", rows)
    assert _text(kt) == _text(kj)
    assert _text(t_lg.find_knee(rows, factor=1.05, max_slowdown=1.0)) == \
        _text(j_lg.find_knee(rows, factor=1.05, max_slowdown=1.0))


def _spans_without_timestamps(tracer):
    return [{k: v for k, v in r.items() if k != "ts"}
            for r in tracer.records]


@pytest.mark.parametrize("spans", [True, False])
def test_record_slo_instruments_equal_reference(spans):
    """The same simulation through ``record_slo`` on the reference's
    ``Obs`` and on the port's: the same summary, the same registry snapshot
    and exposition, and the same per-request spans (durations and args;
    the timestamps count from each tracer's own epoch)."""
    cfg = dict(seed=2, offered_fps=2500.0, n_requests=40)
    sj, st = _schedules(cfg)
    simj = j_lg.simulate(j_lg.plan_microbatches(sj, 8, 4e-3), _model,
                         slo_ms=3.0)
    simt = t_lg.simulate(t_lg.plan_microbatches(st, 8, 4e-3), _model,
                         slo_ms=3.0)
    oj, ot = j_obs.Obs(device_annotations=False), \
        t_obs.Obs(device_annotations=False)
    summ_j = j_lg.record_slo(oj, simj, 3.0, anchor=100.0, spans=spans)
    summ_t = t_lg.record_slo(ot, simt, 3.0, anchor=100.0, spans=spans)
    assert _text(summ_t) == _text(summ_j)
    assert _text(ot.registry.snapshot()) == _text(oj.registry.snapshot())
    assert ot.exposition() == oj.exposition()
    assert _spans_without_timestamps(ot.tracer) == \
        _spans_without_timestamps(oj.tracer)
    assert len(ot.tracer.spans("request")) == (40 if spans else 0)


def test_loadgen_reads_no_clock(monkeypatch):
    """The virtual-time pipeline runs with the port's clock banned."""
    from repro_torch.obs import clock

    def boom():          # pragma: no cover - must never fire
        raise AssertionError("loadgen read the wall clock")

    monkeypatch.setattr(clock, "now", boom)
    cfg = t_lg.LoadgenConfig(seed=2, offered_fps=2000.0, n_requests=32)
    plan = t_lg.plan_microbatches(t_lg.make_schedule(cfg), 8, 0.004)
    sim = t_lg.simulate(plan, _model, slo_ms=8.0)
    assert sim["requests"] and sim["slowdown"] >= 1.0


PROG = (
    "import importlib.util, json, sys\n"
    "spec = importlib.util.spec_from_file_location('lg', sys.argv[1])\n"
    "m = importlib.util.module_from_spec(spec)\n"
    "sys.modules['lg'] = m   # dataclasses resolves through sys.modules\n"
    "spec.loader.exec_module(m)\n"
    "bad = sorted(k for k in sys.modules\n"
    "             if k.split('.')[0] in ('jax', 'torch', 'numpy'))\n"
    "assert not bad, bad\n"
    "cfg = m.LoadgenConfig(seed=3, offered_fps=1500.0, n_requests=64)\n"
    "sched = m.make_schedule(cfg)\n"
    "plan = m.plan_microbatches(sched, 8, 0.004)\n"
    "sim = m.simulate(plan, lambda b: 1e-3 + 2.5e-4 * b.n_frames, "
    "slo_ms=8.0)\n"
    "print(json.dumps({'sched': [r.to_json() for r in sched], "
    "'plan': [b.to_json() for b in plan], 'sim': sim}, sort_keys=True))\n")


def test_schedules_byte_identical_in_fresh_interpreters():
    """Two fresh interpreters load the port's loadgen.py from its file
    (torch, jax and numpy never imported) and print the same bytes, which
    are the reference's module's bytes too."""
    runs = [subprocess.run([sys.executable, "-c", PROG, path],
                           capture_output=True, check=True, timeout=120)
            for path in (t_lg.__file__, t_lg.__file__, j_lg.__file__)]
    assert runs[0].stdout == runs[1].stdout == runs[2].stdout
    assert json.loads(runs[0].stdout)["sched"]


def test_serving_exports_the_reference_names():
    public = {n for n in dir(j_serving) if not n.startswith("_")
              and not isinstance(getattr(j_serving, n), type(sys))}
    assert public <= set(t_serving.__all__)
    assert all(hasattr(t_serving, n) for n in t_serving.__all__)
    assert set(t_lg.__all__) == set(j_lg.__all__)
    for name in set(t_lg.__all__) & public:
        assert getattr(t_serving, name) is getattr(t_lg, name)
