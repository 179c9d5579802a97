"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``), and the obs hooks of the port's serving stack.

What is compared, and how exactly:

* metrics, exposition, JSONL and the CLI (``summary`` / ``compare`` /
  ``chrome``): byte for byte. The code paths are pure Python on the same
  floats, so histogram snapshots of the same 10^4 values (three
  distributions, out-of-range values included), ``prometheus_text``,
  ``write_jsonl`` files and the CLI texts and files must be identical;
* tracer records: every field but the timestamps and durations (each
  tracer counts from its own epoch);
* engine runs (the port's ``cuda`` backend on the CPU, i.e. the kernels'
  plain versions, against the reference's ``pallas`` in interpret mode, on
  vgg_tiny): the span and event counts of ``Obs.summary()``, every counter
  value, every histogram's count, gauges that are counts exactly, and the
  events' and spans' args: ints, strings, bools and id lists exactly,
  floats (drift, thetas, rate errors, energy credit) within rtol 1e-5,
  because the thetas and rates they come from agree to float32 rounding
  (``tests/test_torch_vision.py``); no timing value enters a comparison;
* the port against itself: ``obs=None``, ``obs=Obs()`` and
  ``sync_timing=True`` give the same outputs bit for bit (walls aside) and
  the same ``cuda_lib.launch_counts()``; an async stream calls neither
  ``torch.cuda.synchronize`` nor the engine's ``_sync`` between
  microbatches.
"""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as j_obs
from repro import lifetime as jlt
from repro.models import vision as jv
from repro.obs import export as j_export
from repro.obs.__main__ import main as j_cli
from repro.obs.metrics import Histogram as JHistogram
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro.serving import FleetEngine as JaxFleet
from repro.serving import FleetSweepPolicy as JaxSweep
from repro.serving import VisionEngine as JaxEngine
from repro.variation import chip as j_chip
import repro_torch.obs as t_obs
from repro_torch import lifetime as tlt
from repro_torch.kernels import autotune as t_autotune
from repro_torch.kernels import cuda_lib
from repro_torch.models import params as tp
from repro_torch.models import vision as tv
from repro_torch.obs import clock
from repro_torch.obs import export as t_export
from repro_torch.obs.__main__ import main as t_cli
from repro_torch.obs.metrics import Histogram as THistogram
from repro_torch.obs.metrics import MetricsRegistry as TRegistry
from repro_torch.obs.trace import Tracer as TTracer
from repro_torch.serving import FleetEngine, FleetSweepPolicy, VisionEngine
from repro_torch.variation import chip as t_chip

ROOT = Path(__file__).resolve().parents[1]
FLOAT_RTOL = 1e-5
TIMING_KEYS = ("wall_ms", "throughput_fps")
VPROFILE = dict(sigma_logit_offset=0.4, sigma_pixel_offset=0.25,
                sigma_pixel_gain=0.05)
DPROFILE = dict(sigma_logit_offset=0.2, sigma_logit_gain=0.05,
                sigma_pixel_offset=0.15, tau_frames=100.0)


def _text(x) -> str:
    return json.dumps(x, sort_keys=True)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --- metrics -----------------------------------------------------------------

def _values(dist: str) -> np.ndarray:
    rng = np.random.default_rng({"lognormal": 1, "uniform": 2,
                                 "exponential": 3}[dist])
    if dist == "lognormal":
        v = rng.lognormal(mean=1.0, sigma=1.5, size=10_000)
    elif dist == "uniform":
        v = rng.uniform(0.0, 250.0, size=10_000)
    else:
        v = rng.exponential(scale=40.0, size=10_000)
    # out-of-range values on both sides, the edges and zero
    v[:7] = [0.0, 1e-5, 0.00999, 1e-2, 1e5, 3.5e5, 1e9]
    return v


def _fed(cls, values, **kw):
    h = cls("h_ms", **kw)
    for x in values:
        h.record(float(x))
    return h


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential"])
def test_histogram_snapshot_equals_reference(dist):
    v = _values(dist)
    hj, ht = _fed(JHistogram, v), _fed(THistogram, v)
    assert _text(ht.snapshot()) == _text(hj.snapshot())
    assert ht.counts == hj.counts
    assert ht.cumulative_buckets() == hj.cumulative_buckets()
    qs = [0.0, 0.001, 0.1, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0]
    assert [ht.quantile(q) for q in qs] == [hj.quantile(q) for q in qs]


@pytest.mark.parametrize("kw", [dict(lo=1e-3, hi=10.0, n_buckets=32),
                                dict(lo=0.5, hi=2e4, n_buckets=1000)])
def test_histogram_custom_buckets_equal_reference(kw):
    v = _values("lognormal")
    hj, ht = _fed(JHistogram, v, **kw), _fed(THistogram, v, **kw)
    assert _text(ht.snapshot()) == _text(hj.snapshot())
    assert ht.cumulative_buckets() == hj.cumulative_buckets()


def test_empty_histogram_and_refusals_equal_reference():
    assert _text(THistogram("e").snapshot()) == \
        _text(JHistogram("e").snapshot())
    assert np.isnan(THistogram("e").quantile(0.5))
    for cls in (JHistogram, THistogram):
        with pytest.raises(ValueError):
            cls("bad", lo=2.0, hi=1.0)
    for reg in (JRegistry(), TRegistry()):
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)
        reg.gauge("g")
        with pytest.raises(TypeError):
            reg.counter("g")


def _registry(cls):
    reg = cls()
    reg.counter("serving_frames_total").inc(48)
    reg.counter("fleet_drains_total").inc()
    reg.gauge("fleet_size").set(3)
    reg.gauge("never_set")
    for i, x in enumerate(_values("exponential")[:2000]):
        reg.histogram("serving_microbatch_wall_ms").record(float(x))
        if i % 3 == 0:
            reg.histogram("fleet_step_wall_ms", lo=1e-1, hi=1e3,
                          n_buckets=64).record(float(x))
    reg.histogram("empty_ms")
    return reg


def test_prometheus_text_equals_reference():
    jt = j_export.prometheus_text(_registry(JRegistry))
    tt = t_export.prometheus_text(_registry(TRegistry))
    assert tt == jt
    assert 'le="+Inf"' in tt and 'quantile="0.99"' in tt
    assert t_export.prometheus_text(TRegistry()) == \
        j_export.prometheus_text(JRegistry()) == ""


def _records():
    reg = _registry(TRegistry)
    recs = [{"ph": "M", "cat": "meta", "meta": {"bench": "t", "n": 1}},
            {"ph": "X", "name": "microbatch", "cat": "span", "ts": 12.5,
             "dur": 3.25, "pid": 0, "tid": "host", "depth": 1,
             "args": {"frames": 8, "path": "exact"}},
            {"ph": "i", "name": "fleet_join", "cat": "event", "s": "p",
             "ts": 99.0, "pid": 0, "tid": "host", "depth": 0,
             "args": {"chip_id": 3, "calibrated": True, "x": None}}]
    recs += [{"ph": "C", "cat": "metric", "name": n, **s}
             for n, s in reg.snapshot().items()]
    return recs


def test_write_jsonl_equals_reference(tmp_path):
    pj, pt = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    assert j_export.write_jsonl(str(pj), _records()) == \
        t_export.write_jsonl(str(pt), _records()) == len(_records())
    assert pt.read_bytes() == pj.read_bytes()
    assert t_export.read_jsonl(str(pt)) == j_export.read_jsonl(str(pj))


def test_bench_meta_keys():
    """The reference's keys with ``jax_version`` replaced by the torch and
    CUDA versions and the card; ``nvidia_smi`` is None without a card."""
    mt = t_obs.bench_meta("b", entries=4)
    mj = j_obs.bench_meta("b", entries=4)
    assert set(mt) == (set(mj) - {"jax_version"}) | {
        "torch_version", "cuda_version", "device", "nvidia_smi"}
    assert mt["schema_version"] == mj["schema_version"] == 1
    assert (mt["bench"], mt["entries"]) == ("b", 4)
    assert mt["torch_version"] == torch.__version__
    if not torch.cuda.is_available():
        assert (mt["backend"], mt["device"], mt["nvidia_smi"]) == \
            ("cpu", None, None)


# --- tracing -----------------------------------------------------------------

def _drive(tracer):
    with tracer.span("stream", frames=8):
        with tracer.span("microbatch", frames=4, path="exact"):
            tracer.event("drift_guard_fallback", chip_id=2, drift=0.5)
        with tracer.span("microbatch", frames=4, path="fused"):
            pass
    tracer.complete("microbatch_ready", tracer.epoch, tracer.epoch + 1e-3,
                    frames=4)
    tracer.complete("request", tracer.epoch, tracer.epoch + 2e-3,
                    tid="virtual", req=0)
    tracer.event("fleet_leave", chip_id=1, fleet_size=1)
    return tracer


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in ("ts", "dur")}
            for r in records]


def test_tracer_records_equal_reference():
    jt = _drive(JTracer(device_annotations=False))
    tt = _drive(TTracer(device_annotations=False))
    assert _untimed(tt.records) == _untimed(jt.records)
    assert [r["name"] for r in tt.spans()] == [r["name"] for r in jt.spans()]
    assert len(tt.events("fleet_leave")) == 1 and tt.depth == 0
    (ready,) = tt.spans("microbatch_ready")
    assert ready["ts"] == 0.0 and ready["dur"] == pytest.approx(1e3)


def test_span_names_reach_the_profiler():
    """A span enters ``torch.profiler.record_function``: its name is in a
    profile of the work inside it."""
    obs = t_obs.Obs()
    x = torch.ones(64, 64)
    with torch.profiler.profile() as prof:
        with obs.span("microbatch", frames=1):
            (x @ x).sum()
    assert "microbatch" in {e.key for e in prof.key_averages()}


def test_device_annotations_off_and_tracing_off(monkeypatch):
    def boom(name):          # pragma: no cover - must never be built
        raise AssertionError("record_function built")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    obs = t_obs.Obs(device_annotations=False)
    with obs.span("stream"):
        pass
    assert obs.summary()["spans"] == {"stream": 1}
    off = t_obs.Obs(tracing=False)
    with off.span("stream"):
        off.event("x")
        off.complete_span("y", 0.0, 1.0)
    assert off.tracer is None and "spans" not in off.summary()
    assert off.records(meta={})[0] == {"ph": "M", "cat": "meta", "meta": {}}


# --- the clock ---------------------------------------------------------------

class _FakeEvent:
    """Stands in for a torch.cuda.Event: done after ``polls`` queries."""

    def __init__(self, polls: int):
        self.polls, self.queries, self.syncs = polls, 0, 0

    def query(self) -> bool:
        self.queries += 1
        return self.queries > self.polls

    def synchronize(self) -> None:
        self.syncs += 1


def test_cpu_probe_latches_when_it_is_made():
    """On the CPU an eager step has already run: the probe's latency is
    latched at construction and later host work does not enter it."""
    t0 = clock.now()
    p = clock.WallProbe.record(torch.device("cpu"), t0=t0, frames=4)
    lat = p.latency
    assert lat is not None and lat >= 0.0 and p.token is None
    x = torch.ones(256, 256)
    for _ in range(20):
        x = x @ x / 256.0
    assert p.poll() and p.wait() == lat == p.latency
    assert p.tags == {"frames": 4}


def test_probe_polls_without_blocking_and_waits_on_its_event(monkeypatch):
    def no_device_sync(*a, **k):    # pragma: no cover - must never fire
        raise AssertionError("torch.cuda.synchronize called")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    ev = _FakeEvent(polls=2)
    p = clock.WallProbe(ev, t0=clock.now())
    assert p.latency is None
    assert not p.poll() and not p.poll() and ev.syncs == 0
    assert p.poll() and p.latency is not None and p.token is None
    ev2 = _FakeEvent(polls=10 ** 9)
    q = clock.WallProbe(ev2)
    assert q.wait() >= 0.0 and ev2.syncs == 1 and q.token is None
    assert q.wait() == q.latency and ev2.syncs == 1


def test_probe_set_and_span_bounds():
    ps = clock.ProbeSet()
    slow, fast = _FakeEvent(polls=10 ** 9), _FakeEvent(polls=0)
    a = ps.add(clock.WallProbe(slow, t0=1.0))
    b = ps.add(clock.WallProbe(fast, t0=2.0))
    assert ps.poll() == [b] and len(ps) == 1
    assert ps.drain() == [a] and len(ps) == 0 and slow.syncs == 1
    done = clock.WallProbe.completed(0.5, 0.25, frames=2)
    assert done.latency == 0.25 and done.poll()
    assert clock.span_bounds([done]) == (0.5, 0.75)
    t0, t1 = clock.span_bounds([a, b, done])
    assert t0 == 0.5 and t1 == max(1.0 + a.latency, 2.0 + b.latency)


def _clock_calls(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and node.attr in ("perf_counter", "time", "monotonic")
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"):
            yield node.lineno
        elif (isinstance(node, ast.ImportFrom) and node.module == "time"
              and any(a.name in ("perf_counter", "time", "monotonic")
                      for a in node.names)):
            yield node.lineno


def test_single_clock_rule():
    """``time.perf_counter`` / ``time.time`` appear in no file of
    ``src/repro_torch`` but ``obs/clock.py``."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    calls = {str(f.relative_to(ROOT)): list(_clock_calls(f)) for f in files}
    clock_file = "src/repro_torch/obs/clock.py"
    assert calls.pop(clock_file)
    assert not {f: c for f, c in calls.items() if c}


# --- the CLI -----------------------------------------------------------------

def _export(path, frames, walls, tracing=True):
    """A JSONL export through the port's Obs with a fixed meta block."""
    obs = t_obs.Obs(tracing=tracing, device_annotations=False)
    obs.counter("serving_frames_total").inc(frames)
    obs.gauge("fleet_size").set(2)
    for w in walls:
        obs.histogram("serving_microbatch_wall_ms").record(w)
    if tracing:
        with obs.span("stream", frames=frames):
            obs.event("fleet_join", chip_id=0)
    obs.export_jsonl(str(path), meta={"bench": "cli", "n": frames})
    return str(path)


def _run(cli, argv, capsys):
    rc = cli(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("cmd", ["summary", "compare", "compare_one_sided",
                                 "chrome"])
def test_cli_equals_reference(cmd, tmp_path, capsys):
    a = _export(tmp_path / "a.jsonl", 8, [1.0, 2.0, 40.0])
    b = _export(tmp_path / "b.jsonl", 16, [1.5, 3.0])
    if cmd == "summary":
        argv = ["summary", a]
    elif cmd == "compare":
        argv = ["compare", a, b]
    elif cmd == "compare_one_sided":
        c = tmp_path / "c.jsonl"
        t_export.write_jsonl(str(c), [r for r in t_export.read_jsonl(b)
                                      if r.get("name") != "fleet_size"])
        argv = ["compare", a, str(c)]
    else:
        argv = ["chrome", a]
    outs = []
    for cli, side in ((j_cli, "j"), (t_cli, "t")):
        out = str(tmp_path / f"{side}.json")
        rc, text, err = _run(cli, argv + ([out] if cmd == "chrome" else []),
                             capsys)
        outs.append((rc, text.replace(out, "OUT"), err))
    assert outs[1] == outs[0] and outs[0][0] == 0
    if cmd == "chrome":
        assert (tmp_path / "t.json").read_bytes() == \
            (tmp_path / "j.json").read_bytes()


def test_cli_failures_equal_reference(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    nometric = tmp_path / "nm.jsonl"
    t_export.write_jsonl(str(nometric), [{"ph": "M", "meta": {}}])
    for argv in (["summary", str(empty)],
                 ["compare", str(nometric), str(nometric)]):
        assert _run(t_cli, argv, capsys) == _run(j_cli, argv, capsys)
        assert _run(t_cli, argv, capsys)[0] == 1


def test_smoke_census_gate_sees_a_tensor_op_of_obs():
    """The smoke's zero-op gate: a stream step's op census with an
    ``Obs`` equals the one without (and the pinned stream.exact budget's
    structure); an ``Obs`` whose span runs a tensor op fails it by field."""
    from repro_torch.obs.__main__ import _census_gate

    assert _census_gate(t_obs.Obs()) == []

    class Noisy(t_obs.Obs):
        def span(self, name, **args):
            torch.zeros(1)
            return super().span(name, **args)

    fails = _census_gate(Noisy())
    assert len(fails) == 1, fails
    (with_obs, without), = re.findall(
        r"^op-overhead gate: stream step ops\.op_count = (\d+) with obs, "
        r"(\d+) without$", fails[0])
    assert int(with_obs) == int(without) + 2   # the stream, microbatch spans


def test_smoke_cli_exits_zero_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.obs", "smoke",
                          "--device", "cpu", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ok" in res.stdout.splitlines()[-1]
    recs = t_export.read_jsonl(str(tmp_path / "obs_smoke.jsonl"))
    assert recs[0]["meta"]["bench"] == "obs_smoke"
    names = {r.get("name") for r in recs}
    assert {"stream", "microbatch", "fleet_join", "fleet_leave",
            "serving_microbatch_wall_ms"} <= names


# --- engines against the reference -------------------------------------------

@pytest.fixture(autouse=True)
def _untuned(monkeypatch):
    """Every shape at the default choice (f32, fused) on both sides."""
    from repro.kernels import autotune as j_autotune
    monkeypatch.setattr(t_autotune, "_TABLE", {})
    monkeypatch.setattr(j_autotune, "_TABLE", {})


@pytest.fixture(scope="module")
def tiny():
    vj = j_chip.VariationConfig(**VPROFILE)
    vt = t_chip.VariationConfig(**VPROFILE)
    cfg_j = jv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10)
    cfg_t = tv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10)
    var_j = jv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            chip_id=5, variation=vj)
    var_t = tv.VisionConfig(name="t", arch="vgg_tiny", num_classes=10,
                            chip_id=5, variation=vt)
    pj = jv.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = tp.from_numpy(jax.tree.map(np.asarray, pj))
    return dict(cfg=(cfg_j, cfg_t), var=(var_j, var_t), params=(pj, pt))


def _frames(seed: int, b: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).uniform(
        size=(b, 32, 32, 3))).astype(np.float32)


def _scenes() -> np.ndarray:
    """Six frames, three scenes: the drift guard falls back at a cut."""
    return np.concatenate([_frames(1, 2, 0.1), _frames(2, 2),
                           _frames(3, 2, 0.1)])


def _is_float(v) -> bool:
    return isinstance(v, float) and not isinstance(v, bool)


def _assert_args_equal(got, want, what):
    assert sorted(got) == sorted(want), (what, got, want)
    for k in want:
        g, w = got[k], want[k]
        if _is_float(w) or _is_float(g):
            np.testing.assert_allclose(float(g), float(w), rtol=FLOAT_RTOL,
                                       atol=1e-12, err_msg=f"{what}.{k}")
        else:
            assert g == w, (what, k, g, w)


def _by_name(tracer, kind):
    out = {}
    for r in tracer.records:
        if (r["ph"] == "X") == (kind == "span"):
            out.setdefault(r["name"], []).append(r["args"])
    return out


def _assert_obs_equal(ot, oj, unordered=("microbatch_ready", "step_ready")):
    """Counts, counters, histogram counts and non-timing args of two Obs."""
    st, sj = ot.summary(), oj.summary()
    assert st["spans"] == sj["spans"]
    assert st["events"] == sj["events"]
    mt, mj = st["metrics"], sj["metrics"]
    assert sorted(mt) == sorted(mj)
    for name, snap in mj.items():
        got = mt[name]
        assert got["type"] == snap["type"], name
        if snap["type"] == "counter":
            assert got["value"] == snap["value"], name
        elif snap["type"] == "histogram":
            assert got["count"] == snap["count"], name
        elif name in ("fleet_size", "fleet_probe_high_water"):
            assert got["value"] == snap["value"], name
        elif name == "lifetime_rate_err":
            np.testing.assert_allclose(got["value"], snap["value"],
                                       rtol=FLOAT_RTOL, atol=1e-7)
    for kind in ("span", "event"):
        gt, gj = _by_name(ot.tracer, kind), _by_name(oj.tracer, kind)
        assert sorted(gt) == sorted(gj)
        for name in gj:
            a, b = gt[name], gj[name]
            if name in unordered:
                a, b = sorted(a, key=_text), sorted(b, key=_text)
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                _assert_args_equal(x, y, name)


@pytest.fixture(scope="module")
def stream_runs(tiny):
    """A microbatched stream of two six-frame batches through an
    obs-enabled engine of each package: fused with the drift guard armed
    (a fallback at the scene cuts), and pinned to the exact path."""
    (cfg_j, cfg_t), (pj, pt) = tiny["cfg"], tiny["params"]
    batches = [_scenes(), _scenes()[::-1].copy()]
    runs = {}
    for mode, kw in (("fused", dict(fused_stream=True, fused_theta_tol=0.05)),
                     ("exact", dict(fused_stream=False))):
        oj = j_obs.Obs(device_annotations=False)
        ot = t_obs.Obs()
        ej = JaxEngine(cfg_j, pj, backend="pallas", microbatch=2, obs=oj,
                       **kw)
        et = VisionEngine(cfg_t, pt, backend="cuda", device="cpu",
                          microbatch=2, obs=ot, **kw)
        outs_j = list(ej.stream([jnp.asarray(b) for b in batches]))
        outs_t = list(et.stream(batches))
        runs[mode] = (ej, et, oj, ot, outs_j, outs_t)
    return runs


@pytest.mark.parametrize("mode", ["fused", "exact"])
def test_vision_stream_obs_equals_reference(stream_runs, mode):
    ej, et, oj, ot, outs_j, outs_t = stream_runs[mode]
    _assert_obs_equal(ot, oj)
    assert (et.fused_step_count, et.fused_fallback_count) == \
        (ej.fused_step_count, ej.fused_fallback_count)
    assert ot.counter("serving_frames_total").value == 12
    spans = ot.summary()["spans"]
    assert spans["stream"] == 2 and spans["microbatch"] == 6
    if mode == "fused":
        assert et.fused_fallback_count >= 1
        evs = ot.tracer.events("drift_guard_fallback")
        assert len(evs) == et.fused_fallback_count
        assert all(e["args"]["chip_id"] == 0 for e in evs)
    else:
        assert spans["microbatch_ready"] == 6


def test_async_batch_wall_is_the_dispatch_to_ready_span(stream_runs):
    """The exact stream's merged wall spans its first dispatch to its last
    step's completion: no shorter than any microbatch's latency, no longer
    than the batch's ``stream`` span, and the throughput follows it."""
    _, _, _, ot, _, outs_t = stream_runs["exact"]
    ready = ot.tracer.spans("microbatch_ready")
    streams = ot.tracer.spans("stream")
    for i, o in enumerate(outs_t):
        mine = ready[3 * i:3 * i + 3]
        assert o["wall_ms"] * 1e3 >= max(r["dur"] for r in mine) - 1e-6
        assert o["wall_ms"] * 1e3 <= streams[i]["dur"] + 1e-6
        assert o["throughput_fps"] == pytest.approx(
            6 / (o["wall_ms"] / 1e3), rel=1e-12)
    hist = ot.registry.histogram("serving_microbatch_wall_ms")
    assert hist.count == 6 and hist.min > 0


@pytest.fixture(scope="module")
def aging_runs(tiny):
    """An aging engine of each package whose scheduler fires every four
    frames, streaming two four-frame batches at microbatch 2."""
    (var_j, var_t), (pj, pt) = tiny["var"], tiny["params"]
    cal = _frames(42, 4)
    runs = {}
    for fused in (None, False):
        oj, ot = j_obs.Obs(), t_obs.Obs()
        kw = dict(microbatch=2, fused_stream=fused)
        ej = JaxEngine(var_j, pj, backend="pallas", obs=oj,
                       drift=jlt.DriftConfig(**DPROFILE),
                       schedule=jlt.SchedulePolicy(period_frames=4,
                                                   cal_iters=6),
                       calibration_frames=jnp.asarray(cal), **kw)
        et = VisionEngine(var_t, pt, backend="cuda", device="cpu", obs=ot,
                          drift=tlt.DriftConfig(**DPROFILE),
                          schedule=tlt.SchedulePolicy(period_frames=4,
                                                      cal_iters=6),
                          calibration_frames=cal, **kw)
        frames = _frames(7, 4)
        list(ej.stream([jnp.asarray(frames)] * 2))
        list(et.stream([frames] * 2))
        runs[fused] = (ej, et, oj, ot)
    return runs


@pytest.mark.parametrize("fused", [None, False], ids=["auto", "exact"])
def test_aging_engine_obs_equals_reference(aging_runs, fused):
    ej, et, oj, ot = aging_runs[fused]
    _assert_obs_equal(ot, oj)
    assert et.lifetime.recal_count == ej.lifetime.recal_count == 2
    evs = ot.tracer.events("recalibration")
    assert [e["args"]["chip_id"] for e in evs] == [5, 5]
    assert [e["args"]["age_frames"] for e in evs] == [4, 8]
    assert len(ot.tracer.spans("recal_solve")) == 2
    assert ot.gauge("lifetime_rate_err").value is not None


@pytest.fixture(scope="module")
def fleet_runs(tiny, tmp_path_factory):
    """A fleet of each package: two chips join (birth calibration), two
    serves, a forced sweep, a chip leaves, then save and load."""
    (var_j, var_t), (pj, pt) = tiny["var"], tiny["params"]
    cal = _frames(42, 8)
    runs = {}
    for fused in (None, False):
        oj, ot = j_obs.Obs(), t_obs.Obs()
        kw = dict(chips_per_step=2, fused_stream=fused,
                  calibration_frames=cal)
        sides = []
        for side, obs in (("j", oj), ("t", ot)):
            if side == "j":
                mk = lambda: JaxFleet(
                    var_j, pj, backend="pallas", seed=0, obs=obs,
                    drift=jlt.DriftConfig(**DPROFILE),
                    sweep=JaxSweep(policy=jlt.SchedulePolicy(
                        period_frames=64), auto=False),
                    **{**kw, "calibration_frames": jnp.asarray(cal)})
                wrap = jnp.asarray
            else:
                mk = lambda: FleetEngine(
                    var_t, pt, backend="cuda", seed=0, device="cpu",
                    obs=obs, drift=tlt.DriftConfig(**DPROFILE),
                    sweep=FleetSweepPolicy(policy=tlt.SchedulePolicy(
                        period_frames=64), auto=False), **kw)
                wrap = np.asarray
            fe = mk()
            fe.add_chip(0)
            fe.add_chip(1)
            for r in range(2):
                fe.serve([(c, wrap(_frames(10 * r + c, 4))) for c in (0, 1)])
            report = fe.run_sweep(force=True)
            fe.remove_chip(1)
            d = tmp_path_factory.mktemp(f"fleet_{side}_{fused}")
            fe.save(str(d), step=2)
            mk().load(str(d))
            sides.append((fe, report))
        runs[fused] = (sides, oj, ot)
    return runs


@pytest.mark.parametrize("fused", [None, False], ids=["auto", "exact"])
def test_fleet_obs_equals_reference(fleet_runs, fused):
    ((fj, rep_j), (ft, rep_t)), oj, ot = fleet_runs[fused]
    _assert_obs_equal(ot, oj)
    assert rep_t["refreshed"] == rep_j["refreshed"] == [0, 1]
    ev = ot.summary()["events"]
    assert ev["fleet_join"] == 2 + 1          # load re-registers chip 0
    assert ev["fleet_leave"] == ev["fleet_sweep"] == 1
    assert ev["checkpoint_save"] == ev["checkpoint_load"] == 1
    reg = ot.registry
    assert reg.counter("fleet_drains_total").value == 2
    assert reg.counter("fleet_chips_refreshed_total").value == 2
    assert reg.counter("serving_frames_total").value == 16
    assert len(ot.tracer.spans("recal_solve_fleet")) == 1
    if fused is False:
        assert reg.counter("fleet_probes_drained_total").value == 2
        assert reg.gauge("fleet_probe_high_water").value == 1
        assert len(ot.tracer.spans("step_ready")) == 2


# --- the port against itself ---------------------------------------------------

def _same_outputs(a, b) -> bool:
    if set(a) != set(b):
        return False
    return all(k in TIMING_KEYS
               or np.array_equal(_np(a[k]), _np(b[k])) for k in a)


def _engine_kw(tiny, path):
    (_, cfg_t), (_, pt) = tiny["cfg"], tiny["params"]
    (_, var_t) = tiny["var"]
    if path == "aging":
        return var_t, pt, dict(drift=tlt.DriftConfig(**DPROFILE),
                               schedule=tlt.SchedulePolicy(period_frames=4,
                                                           cal_iters=6),
                               calibration_frames=_frames(42, 4))
    return cfg_t, pt, dict(fused_stream=path == "fused",
                           fused_theta_tol=0.05)


@pytest.mark.parametrize("path", ["fused", "exact", "aging"])
def test_obs_none_and_sync_timing_are_bit_identical(tiny, path):
    cfg, p, kw = _engine_kw(tiny, path)
    batches = [_scenes(), _frames(9, 5)]
    runs = []
    for extra in ({}, {"obs": t_obs.Obs()}, {"sync_timing": True},
                  {"obs": t_obs.Obs(), "sync_timing": True}):
        eng = VisionEngine(cfg, p, device="cpu", microbatch=2, **kw, **extra)
        cuda_lib.reset_launch_counts()
        outs = [eng.classify(_frames(8, 3))] + list(eng.stream(batches))
        runs.append((outs, cuda_lib.launch_counts()))
    base, base_counts = runs[0]
    for outs, counts in runs[1:]:
        assert counts == base_counts
        assert all(_same_outputs(a, b) for a, b in zip(base, outs))


def test_fleet_obs_none_is_bit_identical(tiny):
    (_, cfg_t), (_, pt) = tiny["cfg"], tiny["params"]
    runs = []
    for obs in (None, t_obs.Obs()):
        fe = FleetEngine(cfg_t, pt, device="cpu", microbatch=2,
                         chips_per_step=2, obs=obs)
        cuda_lib.reset_launch_counts()
        outs = fe.serve([(0, _frames(1, 3)), (1, _frames(2, 3))])
        outs += fe.serve([(0, _frames(3, 3)), (1, _frames(4, 3))])
        runs.append((outs, cuda_lib.launch_counts()))
    (a, ca), (b, cb) = runs
    assert ca == cb and all(_same_outputs(x, y) for x, y in zip(a, b))


def _count_syncs(monkeypatch, eng):
    calls = {"device": 0, "engine": 0}
    real = eng._sync

    def device_sync(*a, **k):
        calls["device"] += 1

    def engine_sync():
        calls["engine"] += 1
        real()

    monkeypatch.setattr(torch.cuda, "synchronize", device_sync)
    monkeypatch.setattr(eng, "_sync", engine_sync)
    return calls


@pytest.mark.parametrize("engine", ["vision", "fleet"])
def test_async_stream_never_syncs_between_microbatches(tiny, monkeypatch,
                                                       engine):
    """The deferred exact path dispatches every microbatch (every step)
    without ``torch.cuda.synchronize`` or the engine's ``_sync``; with
    ``sync_timing=True`` each step syncs."""
    (_, cfg_t), (_, pt) = tiny["cfg"], tiny["params"]
    counts = []
    for sync_timing in (False, True):
        if engine == "vision":
            eng = VisionEngine(cfg_t, pt, device="cpu", microbatch=2,
                               fused_stream=False, obs=t_obs.Obs(),
                               sync_timing=sync_timing)
            run = lambda: list(eng.stream([_frames(1, 6), _frames(2, 4)]))
        else:
            eng = FleetEngine(cfg_t, pt, device="cpu", microbatch=2,
                              chips_per_step=1, fused_stream=False,
                              obs=t_obs.Obs(), sync_timing=sync_timing)
            run = lambda: eng.serve([(0, _frames(1, 4)), (1, _frames(2, 4))])
        calls = _count_syncs(monkeypatch, eng)
        outs = run()
        assert all(o["wall_ms"] > 0 for o in outs)
        counts.append(dict(calls))
    assert counts[0] == {"device": 0, "engine": 0}
    assert counts[1]["engine"] >= 5


def test_scheduler_spans_and_obs_none_trims(tiny):
    (_, var_t), (_, pt) = tiny["var"], tiny["params"]
    cal = _frames(42, 4)
    pol = tlt.SchedulePolicy(period_frames=4, cal_iters=6)
    obs = t_obs.Obs()
    plain = tlt.RecalibrationScheduler(pol, var_t.p2m, cal, pt["p2m"],
                                       device="cpu")
    spanned = tlt.RecalibrationScheduler(pol, var_t.p2m, cal, pt["p2m"],
                                         device="cpu", obs=obs)
    chips = t_chip.sample_chips(var_t.variation, 32, 8, [1, 2],
                                device="cpu")
    one = t_chip.ChipMaps(*(m[0] for m in chips))
    assert torch.equal(spanned.recalibrate(one), plain.recalibrate(one))
    assert torch.equal(spanned.recalibrate_fleet(chips),
                       plain.recalibrate_fleet(chips))
    assert obs.summary()["spans"] == {"recal_solve": 1,
                                      "recal_solve_fleet": 1}
    assert [s["args"] for s in obs.tracer.spans()] == [{"iters": 6}] * 2
