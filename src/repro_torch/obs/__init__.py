"""repro_torch.obs: serving telemetry off the dispatch path (port of
``repro.obs``).

One facade object threads through the serving stack::

    obs = Obs()
    eng = VisionEngine(cfg, params, obs=obs)
    for out in eng.stream(batches):
        ...
    obs.export_jsonl("serve.jsonl")
    print(obs.exposition())

Everything is opt-in and host-side: engines take ``obs=None`` by default and
guard each instrument call with one ``is None`` check, so the disabled path
costs nothing: the same outputs bit for bit and the same kernel launches
(both tested). Submodules:

* :mod:`repro_torch.obs.clock`: the one wall clock and the deferred
  :class:`~repro_torch.obs.clock.WallProbe` (a CUDA event behind the step)
  that moves latency syncs off the dispatch path;
* :mod:`repro_torch.obs.metrics`: counters, gauges and log-bucket streaming
  histograms (p50/p95/p99 without storing samples);
* :mod:`repro_torch.obs.trace`: spans and structured events in Chrome trace
  format, mirrored to ``torch.profiler.record_function`` and NVTX;
* :mod:`repro_torch.obs.export`: the JSONL sink, the Prometheus-style
  exposition and the shared ``meta`` block of result files.
"""
from __future__ import annotations

import contextlib
from typing import Any, ContextManager, Dict, List, Optional

from repro_torch.obs import clock, export, metrics, trace
from repro_torch.obs.clock import ProbeSet, WallProbe
from repro_torch.obs.export import bench_meta
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = ["Obs", "bench_meta", "clock", "export", "metrics", "trace",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "ProbeSet", "Tracer", "WallProbe"]


class Obs:
    """Facade bundling one metrics registry and one tracer.

    ``tracing=False`` keeps metrics but makes spans and events no-ops;
    ``device_annotations=False`` keeps host spans but skips
    ``record_function`` and NVTX.
    """

    def __init__(self, tracing: bool = True,
                 device_annotations: bool = True):
        self.registry = MetricsRegistry()
        self.tracer: Optional[Tracer] = (
            Tracer(device_annotations=device_annotations) if tracing
            else None)

    # -- metrics ------------------------------------------------------------
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str, **kwargs: Any) -> Histogram:
        return self.registry.histogram(name, **kwargs)

    # -- tracing ------------------------------------------------------------
    def span(self, name: str, **args: Any) -> ContextManager[None]:
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def event(self, name: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.event(name, **args)

    def complete_span(self, name: str, t0: float, t1: float,
                      **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.complete(name, t0, t1, **args)

    # -- export -------------------------------------------------------------
    def records(self, meta: Optional[Dict[str, Any]] = None
                ) -> List[Dict[str, Any]]:
        """Everything as JSONL-ready records: meta, then trace, then one
        ``metric`` record per instrument."""
        out: List[Dict[str, Any]] = [
            {"ph": "M", "cat": "meta",
             "meta": meta if meta is not None else bench_meta("obs")}]
        if self.tracer is not None:
            out.extend(self.tracer.records)
        for name, snap in self.registry.snapshot().items():
            out.append({"ph": "C", "cat": "metric", "name": name, **snap})
        return out

    def export_jsonl(self, path: str,
                     meta: Optional[Dict[str, Any]] = None) -> int:
        return export.write_jsonl(path, self.records(meta))

    def exposition(self) -> str:
        return export.prometheus_text(self.registry)

    def summary(self) -> Dict[str, Any]:
        """Metrics snapshot and span/event counts, for quick inspection."""
        out: Dict[str, Any] = {"metrics": self.registry.snapshot()}
        if self.tracer is not None:
            spans: Dict[str, int] = {}
            events: Dict[str, int] = {}
            for r in self.tracer.records:
                bucket = spans if r["ph"] == "X" else events
                bucket[r["name"]] = bucket.get(r["name"], 0) + 1
            out["spans"] = spans
            out["events"] = events
        return out
