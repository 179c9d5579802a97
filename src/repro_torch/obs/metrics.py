"""Process-local metrics: counters, gauges, streaming histograms.

Port of ``repro.obs.metrics``; the code is the reference's, so the same
values recorded give the same snapshot, float for float.

* **Zero cost when disabled.** Engines hold ``obs=None`` by default and
  guard every instrument call with one ``is None`` check: no registry, no
  dict churn, no device sync, no kernel launch.
* **Quantiles without samples.** :class:`Histogram` uses fixed log-spaced
  buckets: recording is an O(1) integer increment (one ``math.log``), and
  p50/p95/p99 are recovered by geometric interpolation inside the target
  bucket, so the relative error is bounded by the bucket ratio however
  many values were recorded. Exact ``count``/``sum``/``min``/``max`` ride
  along.
* **Host-side only.** Values recorded are Python floats the caller already
  has; instruments never touch a ``torch.Tensor``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union


class Counter:
    """Monotonically increasing count (frames served, fallbacks, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        self.value += amount

    def snapshot(self) -> Dict[str, float]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (fleet size, theta drift, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed log-spaced-bucket streaming histogram.

    Buckets cover ``[lo, hi)`` with ``n_buckets`` geometrically equal
    steps; values below ``lo`` land in an underflow bucket (quantile
    reads report the exact ``min``), values at/above ``hi`` in an
    overflow bucket (reads report the exact ``max``). Defaults cover
    0.01 ms .. 100 s — every latency this repo measures — at ~3.6%
    bucket ratio.
    """

    __slots__ = ("name", "lo", "hi", "n_buckets", "_log_lo", "_scale",
                 "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, lo: float = 1e-2, hi: float = 1e5,
                 n_buckets: int = 256):
        if not (0 < lo < hi):
            raise ValueError(f"histogram {name}: need 0 < lo < hi")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_buckets = int(n_buckets)
        self._log_lo = math.log(self.lo)
        self._scale = self.n_buckets / (math.log(self.hi) - self._log_lo)
        # counts[0] = underflow, counts[1..n] = buckets, counts[n+1] = overflow
        self.counts: List[int] = [0] * (self.n_buckets + 2)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- write --------------------------------------------------------------
    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self.lo:
            idx = 0
        elif v >= self.hi:
            idx = self.n_buckets + 1
        else:
            idx = 1 + int((math.log(v) - self._log_lo) * self._scale)
            idx = min(idx, self.n_buckets)   # guard fp edge at v -> hi
        self.counts[idx] += 1

    # -- read ---------------------------------------------------------------
    def _edge(self, i: int) -> float:
        """Lower edge of bucket i (1-based interior buckets)."""
        return math.exp(self._log_lo + (i - 1) / self._scale)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile by geometric interpolation in-bucket."""
        if self.count == 0:
            return math.nan
        if q <= 0:
            return self.min
        if q >= 1:
            return self.max
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                if i == 0:                       # underflow bucket
                    return self.min
                if i == self.n_buckets + 1:      # overflow bucket
                    return self.max
                frac = (target - seen) / c
                e0, e1 = self._edge(i), self._edge(i + 1)
                val = e0 * (e1 / e0) ** frac
                # never report outside the observed range
                return min(max(val, self.min), self.max)
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def cumulative_buckets(self) -> List[tuple]:
        """Sparse cumulative buckets: ``(upper_edge, count_le_edge)``.

        One pair per *occupied* interior bucket (its upper edge, the
        count of values at or below it — underflow included) plus the
        terminal ``(inf, count)`` pair that absorbs the overflow bucket.
        This is exactly the Prometheus ``_bucket{le=...}`` series; the
        pairwise count differences sum back to ``count`` (tested), so
        sparse emission loses nothing.
        """
        out: List[tuple] = []
        cum = self.counts[0]
        for i in range(1, self.n_buckets + 1):
            c = self.counts[i]
            if c:
                cum += c
                out.append((self._edge(i + 1), cum))
        out.append((math.inf, self.count))
        return out

    def snapshot(self) -> Dict[str, object]:
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean if self.count else None,
                "p50": self.quantile(0.50) if self.count else None,
                "p95": self.quantile(0.95) if self.count else None,
                "p99": self.quantile(0.99) if self.count else None}


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create instrument store; the ``obs`` facade owns one.

    Names use Prometheus conventions (``serving_microbatch_wall_ms``):
    lowercase, underscores, unit suffix — the exposition writer relies
    on this.
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, name: str, cls, **kwargs) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, **kwargs)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-2, hi: float = 1e5,
                  n_buckets: int = 256) -> Histogram:
        return self._get(name, Histogram, lo=lo, hi=hi, n_buckets=n_buckets)

    def __iter__(self):
        return iter(sorted(self._instruments.values(),
                           key=lambda m: m.name))

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{name: typed snapshot} for every instrument, name-sorted."""
        return {m.name: m.snapshot() for m in self}
