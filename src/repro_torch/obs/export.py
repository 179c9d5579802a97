"""Exporters: JSONL sink, Prometheus-style exposition, bench metadata.

Port of ``repro.obs.export``; the JSONL and exposition writers are the
reference's, so the same records and registry give the same text byte for
byte.

* ``chrome://tracing`` and ad-hoc scripts: :func:`write_jsonl` (one JSON
  object per line: tracer records verbatim, one ``metric`` record per
  instrument snapshot and one ``meta`` header line).
* Scrape-style monitoring: :func:`prometheus_text`: counters and gauges as
  plain samples, histograms as cumulative ``_bucket{le=...}`` series plus
  ``quantile`` samples and ``_sum`` / ``_count``. Names must already follow
  Prometheus conventions (the registry's contract).
* ``BENCH_*.json`` and the autotuner's table: :func:`bench_meta`, the one
  ``meta`` block every result file carries (the reference's keys, with the
  torch and CUDA versions and the card in place of the JAX version).
"""
from __future__ import annotations

import json
import platform
import socket
import subprocess
import sys
from typing import Any, Dict, Iterable, List, Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry

#: Bump when the shape of bench JSON / obs JSONL records changes.
BENCH_SCHEMA_VERSION = 1


def _nvidia_smi() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` reports
    them (a card below its maximum power limit runs slower under load);
    None without a card or the tool."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def bench_meta(bench: str, **extra: Any) -> Dict[str, Any]:
    """The shared ``meta`` block stamped into every result file."""
    cuda = torch.cuda.is_available()
    meta: Dict[str, Any] = {
        "bench": bench,
        "schema_version": BENCH_SCHEMA_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": _nvidia_smi() if cuda else None,
        "hostname": socket.gethostname(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
    }
    meta.update(extra)
    return meta


# -- JSONL -------------------------------------------------------------------

def write_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> int:
    """Write records one-JSON-object-per-line; returns the line count."""
    n = 0
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, sort_keys=True))
            fh.write("\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# -- Prometheus-style text exposition ----------------------------------------

def _fmt(v: Any) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Text exposition of every instrument in the registry."""
    lines: List[str] = []
    for inst in registry:
        snap = inst.snapshot()
        kind = snap["type"]
        if kind == "counter":
            lines.append(f"# TYPE {inst.name} counter")
            lines.append(f"{inst.name} {_fmt(snap['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {inst.name} gauge")
            lines.append(f"{inst.name} {_fmt(snap['value'])}")
        else:                # histogram -> buckets + quantile summary
            # cumulative _bucket{le=} samples off the occupied log-bucket
            # edges (sparse emission of a cumulative series is lossless),
            # ended by the mandatory le="+Inf" == _count
            lines.append(f"# TYPE {inst.name} histogram")
            for edge, cum in inst.cumulative_buckets():
                le = "+Inf" if edge == float("inf") else _fmt(edge)
                lines.append(f'{inst.name}_bucket{{le="{le}"}} {cum}')
            # the summary view rides along under the same name (this
            # exposition is read by its own tools, not a strict parser)
            for q in (0.5, 0.95, 0.99):
                lines.append(f'{inst.name}{{quantile="{q}"}} '
                             f"{_fmt(inst.quantile(q))}")
            lines.append(f"{inst.name}_sum {_fmt(snap['sum'])}")
            lines.append(f"{inst.name}_count {_fmt(snap['count'])}")
    return "\n".join(lines) + ("\n" if lines else "")
