"""The one wall clock of the port, and deferred readiness probes.

Port of ``repro.obs.clock``. Every wall-clock timestamp in
``src/repro_torch`` comes from :func:`now`: ``time.perf_counter`` is called
in this file and nowhere else in the package (the single-clock rule, held
by ``tests/test_torch_obs.py``), so the timing semantics (monotonic, not
subject to NTP steps) and any later swap of the clock live in one place.

The probes move latency measurement off the dispatch path. The honest but
blocking pattern::

    t0 = now(); out = step(...); torch.cuda.synchronize(); wall = now() - t0

keeps the host waiting while it could queue the next microbatch.
:class:`WallProbe` splits the measurement into a dispatch-side timestamp and
a deferred readiness check: a ``torch.cuda.Event`` recorded on the current
stream of the device, the stream the kernel wrappers launch on
(``kernels.cuda_lib.stream_of``), right behind the step's work. The host
keeps dispatching, polls finished probes between dispatches
(``Event.query``, which never blocks) and waits once at a batch boundary
(``Event.synchronize``, never ``torch.cuda.synchronize``). Each latency is
then as honest as the blocking version's (dispatch start to the step's
last kernel done), while the device queue stayed full in between.

On the CPU an eager step has already run when its dispatch returns, so a
probe made without an event latches its latency when it is created.
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

import torch


def now() -> float:
    """Monotonic wall-clock seconds: the only ``time.perf_counter`` call in
    ``src/repro_torch`` (the single-clock rule)."""
    return time.perf_counter()


class WallProbe:
    """Dispatch timestamp and deferred readiness of one dispatched step.

    ``token`` is a ``torch.cuda.Event`` recorded behind the step (see
    :meth:`record`), or None for a step that has already finished: then the
    latency is latched at construction. The probe never blocks unless
    :meth:`wait` is called, and it drops its event once the latency is
    latched. It holds no output tensor.
    """

    __slots__ = ("t0", "token", "tags", "_latency")

    def __init__(self, token: Optional[torch.cuda.Event] = None,
                 t0: Optional[float] = None, **tags: Any):
        self.t0 = now() if t0 is None else t0
        self.token = token
        self.tags = tags
        self._latency: Optional[float] = None
        if token is None:       # the step already ran (an eager CPU step)
            self._latency = now() - self.t0

    @classmethod
    def record(cls, device: torch.device, t0: Optional[float] = None,
               **tags: Any) -> "WallProbe":
        """A probe of the work queued so far on ``device``: on a CUDA
        device an event recorded on its current stream, on the CPU none
        (latched now)."""
        if device.type != "cuda":
            return cls(None, t0=t0, **tags)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return cls(event, t0=t0, **tags)

    @classmethod
    def completed(cls, t0: float, latency: float, **tags: Any) -> "WallProbe":
        """An already-measured probe (a synchronous step that still takes
        part in its batch's ``span_bounds``)."""
        p = cls(None, t0=t0, **tags)
        p._latency = float(latency)
        return p

    # -- readiness ----------------------------------------------------------
    def poll(self) -> bool:
        """Non-blocking: True (and the latency latched) iff the step is
        done."""
        if self._latency is not None:
            return True
        if not self.token.query():
            return False
        self._latency = now() - self.t0
        self.token = None
        return True

    def wait(self) -> float:
        """Block until the step is done; returns its latency in seconds.
        Waits on the probe's own event, never on the whole device."""
        if self._latency is None:
            self.token.synchronize()
            self._latency = now() - self.t0
            self.token = None
        return self._latency

    @property
    def latency(self) -> Optional[float]:
        """Seconds from dispatch to readiness; None until measured."""
        return self._latency


class ProbeSet:
    """The in-flight probes of one streaming session.

    Typical engine loop::

        done = probes.poll()        # between dispatches: non-blocking
        ...
        probes.add(WallProbe.record(device, t0=t0, frames=b))
        ...
        done = probes.drain()       # batch boundary: the one blocking wait

    ``drain`` is the only call that blocks, once for the whole pending set.
    """

    def __init__(self) -> None:
        self._pending: List[WallProbe] = []

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, probe: WallProbe) -> WallProbe:
        self._pending.append(probe)
        return probe

    def poll(self) -> List[WallProbe]:
        """Harvest every probe whose step already finished (non-blocking)."""
        done = [p for p in self._pending if p.poll()]
        if done:
            self._pending = [p for p in self._pending if p.latency is None]
        return done

    def drain(self) -> List[WallProbe]:
        """Block until every pending probe is done; returns them all."""
        done, self._pending = self._pending, []
        for p in done:
            p.wait()
        return done


def span_bounds(probes: Sequence[WallProbe]) -> Tuple[float, float]:
    """(first dispatch t0, last measured ready time) over measured probes:
    their difference is the honest wall of the whole batch."""
    t0 = min(p.t0 for p in probes)
    t1 = max(p.t0 + (p.latency or 0.0) for p in probes)
    return t0, t1
