"""Span tracing and structured events, Chrome-trace compatible.

Port of ``repro.obs.trace``. A :class:`Tracer` records two kinds of record:

* **Spans**: ``with tracer.span("microbatch", frames=8):`` blocks with a
  start timestamp and a duration. Nesting is tracked on the host (a span
  stack), and each span also enters ``torch.profiler.record_function`` and,
  where CUDA is available, an NVTX range of the same name, so a device
  profile of the step (``torch.profiler``) carries the same names as the
  host trace. Spans measured elsewhere (a :class:`~repro_torch.obs.clock.
  WallProbe`'s latency) are attached with :meth:`Tracer.complete`.
* **Events**: instantaneous structured facts (``recalibration``,
  ``drift_guard_fallback``, ``fleet_join`` ...) with the chip id in their
  args.

The records are Chrome Trace Event Format (phase ``"X"`` complete spans,
``"i"`` instants, timestamps in µs since the tracer's epoch), loadable in
``chrome://tracing`` / Perfetto once wrapped in ``{"traceEvents": [...]}``,
which ``python -m repro_torch.obs chrome`` does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

import torch

from repro_torch.obs import clock


@contextlib.contextmanager
def _device_annotation(name: str, nvtx: bool) -> Iterator[None]:
    with torch.profiler.record_function(name):
        if not nvtx:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class Tracer:
    """Host-side span/event recorder with a fixed epoch.

    ``device_annotations=False`` skips ``record_function`` and the NVTX
    range (a test that counts host work wants the tracer inert).
    """

    def __init__(self, device_annotations: bool = True):
        self.epoch = clock.now()
        self.records: List[Dict[str, Any]] = []
        self._stack: List[str] = []
        self._device_annotations = device_annotations
        self._nvtx = device_annotations and torch.cuda.is_available()

    # -- helpers ------------------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    @property
    def depth(self) -> int:
        return len(self._stack)

    # -- spans --------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        t0 = clock.now()
        self._stack.append(name)
        ann = (_device_annotation(name, self._nvtx)
               if self._device_annotations else contextlib.nullcontext())
        try:
            with ann:
                yield
        finally:
            self._stack.pop()
            t1 = clock.now()
            self.records.append({
                "ph": "X", "name": name, "cat": "span",
                "ts": self._us(t0), "dur": (t1 - t0) * 1e6,
                "pid": 0, "tid": "host", "depth": len(self._stack),
                "args": args,
            })

    def complete(self, name: str, t0: float, t1: float,
                 tid: str = "device", **args: Any) -> None:
        """Attach an externally timed span (e.g. a probe's latency)."""
        self.records.append({
            "ph": "X", "name": name, "cat": "span",
            "ts": self._us(t0), "dur": (t1 - t0) * 1e6,
            "pid": 0, "tid": tid, "depth": 0, "args": args,
        })

    # -- events -------------------------------------------------------------
    def event(self, name: str, **args: Any) -> None:
        """Record an instantaneous structured event."""
        self.records.append({
            "ph": "i", "name": name, "cat": "event", "s": "p",
            "ts": self._us(clock.now()),
            "pid": 0, "tid": "host", "depth": len(self._stack),
            "args": args,
        })

    # -- queries ------------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records
                if r["ph"] == "X" and (name is None or r["name"] == name)]

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records
                if r["ph"] == "i" and (name is None or r["name"] == name)]
