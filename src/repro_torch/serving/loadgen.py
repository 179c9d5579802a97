"""Deterministic closed-loop load generation for the serving harness.

Port of ``repro.serving.loadgen``; the code is the reference's, so the same
configuration gives the same schedule, plan and simulation byte for byte.

A steady-state step timer cannot see the queueing regime: latency against
offered load, and the knee where the engine saturates, only exist once
requests arrive on their own clock. This module supplies that clock without
reading one:

* **Virtual-time arrivals.** :func:`make_schedule` draws inter-arrival
  gaps from a seeded counter hash (the murmur3 finalizer over
  ``seed ^ index``): no host RNG, no ``np.random``, no torch generator and
  no wall clock. Arrival timestamps are pure functions of
  ``(seed, index, offered_fps)`` in virtual seconds, so two processes with
  one seed produce byte-identical schedules (tested).
* **Continuous-microbatching admission.** :func:`plan_microbatches`
  assembles arrivals into admission windows: a window closes when it is
  frame-full or when the batching deadline since its first arrival expires
  (tail microbatches allowed). Window composition depends only on the
  arrival schedule, never on measured service times, so the planned
  request trace is reproducible while the queueing below still responds to
  load.
* **Closed-loop queueing simulation.** :func:`simulate` couples the
  admission plan to one work-conserving server: batch ``k`` dispatches at
  ``max(close_k, server_free)`` and the server frees at
  ``dispatch + service_k``, where ``service_k`` is the measured wall of the
  real engine step (the probe-derived ``wall_ms`` of
  ``VisionEngine.stream`` / ``FleetEngine.serve``). Per-request latency
  decomposes exactly as queue wait (arrival to dispatch) plus service
  (dispatch to device ready); time to first activation is the interval
  from the shutter closing to activations on the device.
* **SLO accounting on repro_torch.obs.** :func:`record_slo` lands the
  decomposition in the obs instruments: log-bucket histograms
  (``serving_request_latency_ms`` / ``serving_queue_wait_ms`` /
  ``serving_ttfa_ms``), the ``slo_violations_total`` burn counter, the
  ``serving_queue_depth`` high-water gauge, and per-request
  ``request`` / ``queue_wait`` complete spans (virtual times re-anchored
  onto the caller's clock origin, so the module itself never reads a
  clock).

Nothing here imports torch or ``repro_torch.obs.clock``: the generator is
pure host arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["LoadgenConfig", "Request", "Microbatch", "hash_u01",
           "make_schedule", "plan_microbatches", "simulate", "record_slo",
           "find_knee"]

# murmur3 finalizer constants and the golden-ratio offset of a counter hash
_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _fmix32(h: int) -> int:
    """murmur3 32-bit finalizer: a bijective avalanche over uint32."""
    h &= _MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h


def hash_u01(seed: int, index: int) -> float:
    """Deterministic uniform in [0, 1) from a (seed, counter) pair."""
    h = _fmix32((_fmix32(seed) + index * _GOLDEN) & _MASK32)
    return h / 4294967296.0


@dataclasses.dataclass(frozen=True)
class LoadgenConfig:
    """One operating point of the load generator.

    ``offered_fps`` is the offered load in frames per second of virtual
    time; requests carry ``frames_per_request`` frames each, so the
    request rate is ``offered_fps / frames_per_request``. ``arrival``
    picks the gap law: ``"poisson"`` (exponential gaps via inverse CDF
    over the counter-hash uniforms) or ``"uniform"`` (a deterministic
    isochronous camera). ``chips`` > 1 round-robins requests over chip
    ids (the FleetEngine harness).
    """
    seed: int = 0
    offered_fps: float = 1000.0
    n_requests: int = 64
    frames_per_request: int = 1
    chips: int = 1
    arrival: str = "poisson"

    def __post_init__(self):
        if self.offered_fps <= 0:
            raise ValueError("offered_fps must be > 0")
        if self.arrival not in ("poisson", "uniform"):
            raise ValueError(f"unknown arrival law {self.arrival!r}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One arrival: ``t_arrival`` is virtual seconds from stream start."""
    req_id: int
    t_arrival: float
    n_frames: int = 1
    chip_id: int = 0

    def to_json(self) -> Dict:
        return {"req_id": self.req_id, "t_arrival_ms": self.t_arrival * 1e3,
                "n_frames": self.n_frames, "chip_id": self.chip_id}


@dataclasses.dataclass(frozen=True)
class Microbatch:
    """One admission window: closed (shutter down) at ``t_close``."""
    index: int
    t_close: float
    requests: Tuple[Request, ...]

    @property
    def n_frames(self) -> int:
        return sum(r.n_frames for r in self.requests)

    def to_json(self) -> Dict:
        return {"index": self.index, "t_close_ms": self.t_close * 1e3,
                "n_frames": self.n_frames,
                "req_ids": [r.req_id for r in self.requests]}


def make_schedule(cfg: LoadgenConfig) -> List[Request]:
    """The deterministic arrival schedule of one operating point.

    Gap ``i`` is ``-ln(1 - u_i) / rate`` (poisson) or ``1 / rate``
    (uniform) with ``u_i = hash_u01(seed, i)`` — a pure function of the
    config, independent of process, host, and wall clock.
    """
    rate = cfg.offered_fps / cfg.frames_per_request
    t = 0.0
    out: List[Request] = []
    for i in range(cfg.n_requests):
        if cfg.arrival == "poisson":
            u = hash_u01(cfg.seed, i)
            t += -math.log(1.0 - u) / rate
        else:
            t += 1.0 / rate
        out.append(Request(req_id=i, t_arrival=t,
                           n_frames=cfg.frames_per_request,
                           chip_id=i % max(cfg.chips, 1)))
    return out


def plan_microbatches(schedule: Sequence[Request], max_frames: int,
                      deadline_s: float) -> List[Microbatch]:
    """Assemble arrivals into admission windows (continuous batching).

    A window closes when (a) it is frame-full — at its last admit's
    arrival, (b) the next arrival would overflow it — at that arrival,
    or (c) the batching deadline since its first arrival expires before
    the next arrival — at ``open + deadline``. Tail windows (fewer than
    ``max_frames`` frames) are first-class. Composition is a pure
    function of the schedule: server state never feeds back into it.
    """
    if max_frames < 1:
        raise ValueError("max_frames must be >= 1")
    batches: List[Microbatch] = []
    cur: List[Request] = []
    frames = 0
    open_t = 0.0

    def close(t: float) -> None:
        nonlocal cur, frames
        batches.append(Microbatch(len(batches), t, tuple(cur)))
        cur, frames = [], 0

    for r in schedule:
        if cur and r.t_arrival >= open_t + deadline_s:
            close(open_t + deadline_s)
        if cur and frames + r.n_frames > max_frames:
            close(r.t_arrival)
        if not cur:
            open_t = r.t_arrival
        cur.append(r)
        frames += r.n_frames
        if frames >= max_frames:
            close(r.t_arrival)
    if cur:
        close(open_t + deadline_s)
    return batches


ServiceTimes = Union[Sequence[float], Callable[[Microbatch], float]]


def simulate(batches: Sequence[Microbatch], service_s: ServiceTimes,
             slo_ms: Optional[float] = None) -> Dict:
    """Run the admission plan through one work-conserving FIFO server.

    ``service_s`` supplies each batch's service wall in seconds — either
    a sequence (measured engine walls, in dispatch order) or a callable
    of the batch (a deterministic service model for the --quick trace).
    Returns per-request records (queue-wait / service / latency / TTFA,
    all ms), per-batch dispatch records, and the queue-depth high-water
    mark. Pure virtual-time arithmetic: no clock, no rng.
    """
    if callable(service_s):
        walls = [float(service_s(b)) for b in batches]
    else:
        walls = [float(s) for s in service_s]
        if len(walls) != len(batches):
            raise ValueError(f"{len(walls)} service times for "
                             f"{len(batches)} batches")
    free = 0.0
    req_rows: List[Dict] = []
    batch_rows: List[Dict] = []
    for b, s in zip(batches, walls):
        dispatch = max(b.t_close, free)
        ready = dispatch + s
        free = ready
        batch_rows.append({
            "index": b.index, "n_frames": b.n_frames,
            "n_requests": len(b.requests),
            "t_close_ms": b.t_close * 1e3,
            "t_dispatch_ms": dispatch * 1e3,
            "t_ready_ms": ready * 1e3,
            "service_ms": s * 1e3,
            # shutter-close -> first activations on device
            "ttfa_ms": (ready - b.t_close) * 1e3,
        })
        for r in b.requests:
            lat = ready - r.t_arrival
            row = {"req_id": r.req_id, "batch": b.index,
                   "chip_id": r.chip_id, "n_frames": r.n_frames,
                   "t_arrival_ms": r.t_arrival * 1e3,
                   "queue_wait_ms": (dispatch - r.t_arrival) * 1e3,
                   "service_ms": s * 1e3,
                   "latency_ms": lat * 1e3,
                   "ttfa_ms": (ready - b.t_close) * 1e3}
            if slo_ms is not None:
                row["slo_violation"] = lat * 1e3 > slo_ms
            req_rows.append(row)
    # queue-depth high-water: +1 at each arrival, -batch at each dispatch
    events: List[Tuple[float, int, int]] = []
    for b, row in zip(batches, batch_rows):
        for r in b.requests:
            events.append((r.t_arrival, 1, 1))
        # dispatches sort after arrivals at equal timestamps: the request
        # that closes a full window is queued before it dispatches
        events.append((row["t_dispatch_ms"] / 1e3, 2, -len(b.requests)))
    events.sort(key=lambda e: (e[0], e[1]))
    depth = high = 0
    for _, _, d in events:
        depth += d
        high = max(high, depth)
    done = batch_rows[-1]["t_ready_ms"] / 1e3 if batch_rows else 0.0
    frames = sum(r["n_frames"] for r in req_rows)
    # the uncoupled reference: every window served the instant it closes
    # (an infinitely deep server). The loaded/unloaded makespan ratio is
    # the saturation signal find_knee uses — unlike achieved/offered it
    # is immune to the cold-tail edge effect of a finite request count.
    done0 = max((b.t_close + s for b, s in zip(batches, walls)),
                default=0.0)
    return {"requests": req_rows, "batches": batch_rows,
            "queue_depth_high_water": high,
            "makespan_ms": done * 1e3,
            "unloaded_makespan_ms": done0 * 1e3,
            "slowdown": done / done0 if done0 > 0 else 1.0,
            "achieved_fps": frames / done if done > 0 else 0.0}


def record_slo(obs, sim: Dict, slo_ms: float,
               anchor: float = 0.0, spans: bool = True) -> Dict:
    """Land one simulation's SLO accounting in a ``repro_torch.obs.Obs``.

    Histograms carry the latency decomposition (quantiles are read back
    from the log buckets — no sample retention); ``slo_violations_total``
    burns one count per request over ``slo_ms``; the queue-depth gauge
    latches the high-water mark. ``anchor`` re-bases the virtual
    timestamps for the per-request complete spans (callers pass their
    clock origin; this module never reads a clock). Returns the
    quantile summary used by the bench curves.
    """
    lat = obs.histogram("serving_request_latency_ms")
    qw = obs.histogram("serving_queue_wait_ms")
    ttfa = obs.histogram("serving_ttfa_ms")
    violations = obs.counter("slo_violations_total")
    obs.counter("serving_requests_total").inc(len(sim["requests"]))
    for row in sim["requests"]:
        lat.record(row["latency_ms"])
        qw.record(row["queue_wait_ms"])
        if row["latency_ms"] > slo_ms:
            violations.inc()
        if spans:
            t_arr = anchor + row["t_arrival_ms"] / 1e3
            t_disp = t_arr + row["queue_wait_ms"] / 1e3
            t_ready = t_disp + row["service_ms"] / 1e3
            obs.complete_span("queue_wait", t_arr, t_disp,
                              req=row["req_id"], batch=row["batch"])
            obs.complete_span("request", t_arr, t_ready,
                              req=row["req_id"], batch=row["batch"],
                              chip=row["chip_id"])
    for row in sim["batches"]:
        ttfa.record(row["ttfa_ms"])
    obs.gauge("serving_queue_depth").set(sim["queue_depth_high_water"])
    return {
        "n_requests": len(sim["requests"]),
        "latency_p50_ms": lat.quantile(0.50),
        "latency_p95_ms": lat.quantile(0.95),
        "latency_p99_ms": lat.quantile(0.99),
        "queue_wait_p50_ms": qw.quantile(0.50),
        "queue_wait_p99_ms": qw.quantile(0.99),
        "ttfa_p50_ms": ttfa.quantile(0.50),
        "ttfa_p95_ms": ttfa.quantile(0.95),
        "slo_ms": slo_ms,
        "slo_violations": violations.value,
        "queue_depth_high_water": sim["queue_depth_high_water"],
    }


def find_knee(rows: Sequence[Dict], factor: float = 2.0,
              max_slowdown: float = 1.05) -> Optional[Dict]:
    """The saturation knee of a latency-vs-offered-load curve.

    ``rows`` must be ordered by ``offered_fps`` and carry
    ``latency_p99_ms`` plus (from :func:`simulate`) ``slowdown``. The
    knee is the first operating point where p99 exceeds ``factor`` times
    the lightest load's p99 **or** the loaded makespan exceeds the
    uncoupled reference by more than ``max_slowdown`` — i.e. where the
    server stops keeping up with the admission plan. None while every
    point is below both thresholds (the sweep never saturated).
    """
    if not rows:
        return None
    base = rows[0]["latency_p99_ms"]
    for row in rows:
        saturated_lat = (base > 0 and row["latency_p99_ms"] > factor * base)
        saturated_tput = row.get("slowdown", 1.0) > max_slowdown
        if saturated_lat or saturated_tput:
            return {"offered_fps": row["offered_fps"],
                    "latency_p99_ms": row["latency_p99_ms"],
                    "achieved_fps": row.get("achieved_fps"),
                    "slowdown": row.get("slowdown", 1.0),
                    "p99_over_baseline": (row["latency_p99_ms"] / base
                                          if base > 0 else math.inf)}
    return None
