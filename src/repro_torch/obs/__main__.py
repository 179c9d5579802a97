"""CLI for the observability layer: ``python -m repro_torch.obs``.

Port of ``python -m repro.obs``. Four subcommands:

    python -m repro_torch.obs summary FILE.jsonl      # span/event/metric digest
    python -m repro_torch.obs compare A.jsonl B.jsonl # metric diff of two runs
    python -m repro_torch.obs smoke [--out DIR] [--device cpu]  # smoke + gates
    python -m repro_torch.obs chrome IN.jsonl OUT.json  # chrome://tracing wrap

``summary``, ``compare`` and ``chrome`` print the reference's text and write
its file for the same JSONL. ``compare`` diffs the metric records of two
exported runs: counter and gauge deltas, per-histogram count and
p50/p95/p99 deltas.

``smoke`` drives an obs-enabled ``VisionEngine.stream`` (two same-shape
rounds, once with the fused steps the ``cuda`` backend chooses and once
pinned to the exact, deferred path) and a ``FleetEngine`` through a join,
a serve and a leave, on the GPU unless ``--device cpu``. Its gates:

* the exports are not empty: JSONL records, exposition lines and
  ``serving_microbatch_wall_ms`` quantiles;
* the ``stream`` / ``microbatch`` spans and the ``fleet_join`` /
  ``fleet_leave`` events are there;
* instrumentation adds no work: the same streams with ``obs=None`` give
  the same ``cuda_lib.launch_counts()`` and the same outputs bit for bit;
* the reference's zero-op gate, as the port's op census
  (``repro_torch.analysis.census``, on the CPU whatever ``--device``): a
  stream step with an ``Obs`` holds the same ops, kernel calls, products,
  host syncs and draws as the same step without one, and the step's
  convolutions, products, kernel calls and host syncs are the pinned
  ``stream.exact`` budget's.

The reference's retrace gate (one compile of the step across a two-round
stream) has no counterpart: the port runs eagerly and traces nothing.

Exit code 0 only if every gate holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


# -- summary ------------------------------------------------------------------

def _summarize(records: List[Dict[str, Any]]) -> str:
    spans: Dict[str, List[float]] = {}
    events: Dict[str, int] = {}
    metrics: List[Dict[str, Any]] = []
    meta: Optional[Dict[str, Any]] = None
    for r in records:
        ph = r.get("ph")
        if ph == "X":
            spans.setdefault(r["name"], []).append(r.get("dur", 0.0))
        elif ph == "i":
            events[r["name"]] = events.get(r["name"], 0) + 1
        elif ph == "C":
            metrics.append(r)
        elif ph == "M" and meta is None:
            meta = r.get("meta")
    lines: List[str] = []
    if meta is not None:
        lines.append(f"meta: {json.dumps(meta, sort_keys=True)}")
    lines.append(f"{len(records)} record(s): "
                 f"{sum(len(v) for v in spans.values())} span(s), "
                 f"{sum(events.values())} event(s), "
                 f"{len(metrics)} metric(s)")
    for name in sorted(spans):
        durs = spans[name]
        lines.append(f"  span  {name:<28} n={len(durs):<5} "
                     f"total={sum(durs) / 1e3:.3f}ms")
    for name in sorted(events):
        lines.append(f"  event {name:<28} n={events[name]}")
    for m in sorted(metrics, key=lambda r: r["name"]):
        if m.get("type") == "histogram":
            lines.append(f"  hist  {m['name']:<28} count={m['count']:<6} "
                         f"p50={m['p50']:.4g} p95={m['p95']:.4g} "
                         f"p99={m['p99']:.4g}")
        else:
            lines.append(f"  {m.get('type', 'metric'):<5} {m['name']:<28} "
                         f"value={m['value']:.6g}")
    return "\n".join(lines)


def cmd_summary(args: argparse.Namespace) -> int:
    from repro_torch.obs import export
    records = export.read_jsonl(args.file)
    if not records:
        print(f"FAIL: {args.file} holds no records", file=sys.stderr)
        return 1
    print(_summarize(records))
    return 0


# -- compare ------------------------------------------------------------------

def _metric_index(records: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    return {r["name"]: r for r in records if r.get("ph") == "C"}


def _delta(a: Optional[float], b: Optional[float]) -> str:
    if a is None or b is None:
        return "n/a"
    d = float(b) - float(a)
    rel = f" ({d / a:+.1%})" if a else ""
    return f"{d:+.6g}{rel}"


def compare_text(recs_a: List[Dict[str, Any]],
                 recs_b: List[Dict[str, Any]]) -> str:
    """Human-readable metric diff of two exported runs (A -> B)."""
    a, b = _metric_index(recs_a), _metric_index(recs_b)
    lines: List[str] = []
    for name in sorted(set(a) | set(b)):
        ra, rb = a.get(name), b.get(name)
        if ra is None or rb is None:
            which = "B" if ra is None else "A"
            lines.append(f"  {name:<32} only in {which}")
            continue
        if ra.get("type") == "histogram":
            parts = [f"count {_delta(ra['count'], rb['count'])}"]
            for q in ("p50", "p95", "p99"):
                parts.append(f"{q} {_delta(ra.get(q), rb.get(q))}")
            lines.append(f"  hist  {name:<26} " + "  ".join(parts))
        else:
            lines.append(f"  {ra.get('type', 'metric'):<5} {name:<26} "
                         f"{_fmtv(ra.get('value'))} -> "
                         f"{_fmtv(rb.get('value'))}  "
                         f"{_delta(ra.get('value'), rb.get('value'))}")
    if not lines:
        return "no metric records in either file"
    return "\n".join([f"{len(a)} metric(s) in A, {len(b)} in B:"] + lines)


def _fmtv(v: Optional[float]) -> str:
    return "none" if v is None else f"{float(v):.6g}"


def cmd_compare(args: argparse.Namespace) -> int:
    from repro_torch.obs import export
    recs_a = export.read_jsonl(args.file_a)
    recs_b = export.read_jsonl(args.file_b)
    if not _metric_index(recs_a) and not _metric_index(recs_b):
        print("FAIL: neither file holds metric records", file=sys.stderr)
        return 1
    print(compare_text(recs_a, recs_b))
    return 0


# -- chrome -------------------------------------------------------------------

def cmd_chrome(args: argparse.Namespace) -> int:
    """Wrap obs JSONL into the ``chrome://tracing`` object format."""
    from repro_torch.obs import export
    records = export.read_jsonl(args.infile)
    trace = [r for r in records if r.get("ph") in ("X", "i")]
    with open(args.outfile, "w") as fh:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, fh)
    print(f"wrote {len(trace)} trace event(s) to {args.outfile}")
    return 0


# -- smoke + overhead gates ---------------------------------------------------

def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)


def _same_outputs(a: List[Dict[str, Any]], b: List[Dict[str, Any]]) -> bool:
    """Every output of two runs equal bit for bit, the walls left out."""
    import torch
    timing = ("wall_ms", "throughput_fps")
    if len(a) != len(b):
        return False
    for oa, ob in zip(a, b):
        if sorted(oa) != sorted(ob):
            return False
        for k in oa:
            if k in timing:
                continue
            if not torch.equal(torch.as_tensor(oa[k]), torch.as_tensor(ob[k])):
                return False
    return True


def _census_gate(obs) -> List[str]:
    """The op census of one stream step (vgg_tiny, the census's stream
    batch, pinned exact) on the CPU with ``obs`` and without: failures, each
    naming its field."""
    from repro_torch import prng
    from repro_torch.analysis import census
    from repro_torch.models import vision
    from repro_torch.serving import VisionEngine

    cfg = vision.VisionConfig(name="census", arch="vgg_tiny", num_classes=10)
    params = vision.init_params(0, cfg, device="cpu")
    frames = prng.uniform(prng.PRNGKey(1), (census.STREAM_BATCH, 32, 32, 3))
    got = {}
    for name, o in (("without obs", None), ("with obs", obs)):
        eng = VisionEngine(cfg, params, seed=0, device="cpu",
                           fused_stream=False, obs=o)
        got[name] = census.op_census(lambda: list(eng.stream([frames])))
    fails = [f"op-overhead gate: stream step {block}.{k} = {v} with obs, "
             f"{got['without obs'][block][k]} without"
             for block in ("ops", "flops", "kernels")
             for k, v in got["with obs"][block].items()
             if got["without obs"][block].get(k) != v]
    budget = census.load_budgets()["census"]["stream.exact"]["ops"]
    fails += [f"op-overhead gate: stream step ops.{k} = "
              f"{got['with obs']['ops'][k]} with obs, the stream.exact "
              f"budget pins {budget[k]}"
              for k in ("conv", "dot", "kernel_calls", "host_sync")
              if got["with obs"]["ops"][k] != budget[k]]
    return fails


def cmd_smoke(args: argparse.Namespace) -> int:
    import torch

    import repro_torch.obs as obs_mod
    from repro_torch.devices import resolve_device
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import vision
    from repro_torch.serving import FleetEngine, VisionEngine

    failed = False
    device = resolve_device(args.device)
    out_dir = args.out or os.path.join(_repo_root(), "results")
    os.makedirs(out_dir, exist_ok=True)

    cfg = vision.VisionConfig(name="obs-smoke", arch="vgg_tiny",
                              num_classes=10)
    params = vision.init_params(0, cfg, device=device)
    frames = torch.rand((8, 32, 32, 3),
                        generator=torch.Generator().manual_seed(1)).to(device)

    # 1. obs-enabled streams, two same-shape rounds of two microbatches,
    #    each beside the same stream with obs=None: the same launches and
    #    the same outputs bit for bit
    obs = obs_mod.Obs()
    for fused in (None, False):
        runs = []
        for o in (None, obs):
            eng = VisionEngine(cfg, params, seed=0, device=device,
                               microbatch=4, fused_stream=fused, obs=o)
            cuda_lib.reset_launch_counts()
            outs = list(eng.stream([frames, frames]))
            runs.append((outs, cuda_lib.launch_counts()))
        (plain, n_plain), (instrumented, n_obs) = runs
        path = "exact" if fused is False else "auto"
        if not (instrumented and all("labels" in o for o in instrumented)):
            _fail(f"obs-enabled {path} stream produced no classifications")
            failed = True
        if n_obs != n_plain:
            _fail(f"launch gate ({path} stream): {n_obs} kernel launches "
                  f"with obs, {n_plain} without")
            failed = True
        if not _same_outputs(plain, instrumented):
            _fail(f"output gate ({path} stream): obs changed an output")
            failed = True

    # 2. fleet smoke: join/serve/leave must land as structured events
    fe = FleetEngine(cfg, params, seed=0, device=device, obs=obs)
    fe.add_chip(0)
    fe.add_chip(1)
    fe.serve([(0, frames), (1, frames)])
    fe.remove_chip(1)

    # 3. exports must be non-empty and carry latency quantiles
    jsonl_path = os.path.join(out_dir, "obs_smoke.jsonl")
    n_records = obs.export_jsonl(
        jsonl_path, meta=obs_mod.bench_meta("obs_smoke"))
    summary = obs.summary()
    expo = obs.exposition()
    if n_records < 4:
        _fail(f"JSONL export held only {n_records} record(s)")
        failed = True
    for name in ("stream", "microbatch"):
        if not summary.get("spans", {}).get(name):
            _fail(f"no {name!r} spans recorded")
            failed = True
    for name in ("fleet_join", "fleet_leave"):
        if not summary.get("events", {}).get(name):
            _fail(f"no {name!r} events recorded")
            failed = True
    hist = summary["metrics"].get("serving_microbatch_wall_ms", {})
    if not hist.get("count") or hist.get("p50") is None:
        _fail("serving_microbatch_wall_ms histogram empty")
        failed = True
    if "serving_frames_total" not in expo or "quantile=" not in expo:
        _fail("Prometheus exposition incomplete")
        failed = True

    # 4. zero-op gate: obs adds no tensor op to a stream step
    for f in _census_gate(obs_mod.Obs()):
        _fail(f)
        failed = True

    print(_summarize(obs_mod.export.read_jsonl(jsonl_path)))
    print(f"smoke: {n_records} JSONL record(s) -> {jsonl_path}, "
          f"{len(expo.splitlines())} exposition line(s), "
          f"{'FAIL' if failed else 'ok'}")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summary", help="digest an obs JSONL export")
    p.add_argument("file")
    p.set_defaults(fn=cmd_summary)
    p = sub.add_parser("compare",
                       help="diff the metrics of two obs JSONL exports")
    p.add_argument("file_a")
    p.add_argument("file_b")
    p.set_defaults(fn=cmd_compare)
    p = sub.add_parser("smoke", help="end-to-end obs smoke + overhead gates")
    p.add_argument("--out", default=None,
                   help="output dir for obs_smoke.jsonl (default: results/)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU)")
    p.set_defaults(fn=cmd_smoke)
    p = sub.add_parser("chrome",
                       help="wrap obs JSONL for chrome://tracing")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.set_defaults(fn=cmd_chrome)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:     # e.g. `... summary f.jsonl | head`
        return 0


if __name__ == "__main__":
    sys.exit(main())
