"""Per-shape frontend choices for the CUDA kernels (port of
``repro.kernels.autotune``).

The frontend's execution shape is fixed per deployment — one sensor
geometry, one serving batch — so the choice is a per-shape table keyed by
``(N, K, C)`` = (patch rows, k*k*C_in, C_out):

  * ``TileChoice(fused, precision)`` — whether a stream's steady state runs
    the single fused kernel, and the matmul precision (``"f32"`` or
    ``"int8"``) of both frontend paths. The reference's block sizes are TPU
    layout; the CUDA kernels pick their own launch geometry, so a table
    written by the reference loads here with those keys ignored.
  * ``get`` records the untuned default (f32, fused) on first use, so one
    shape resolves to one choice for the life of the process.
  * ``autotune_frontend`` — the measured search, timed with CUDA events on
    the card; nothing on the serving path triggers it.
  * ``save_table`` / ``load_table`` — JSON persistence with a ``"_meta"``
    stamp of the torch version, the card and its power limit.
  * ``fleet_key`` / ``get_fleet`` / ``resolve_fleet`` /
    ``resolve_fleet_fused`` — a fleet step of G chips resolves at the
    per-chip (N, K, C) key: the chip axis never enters the table.

The table is process-global, as the reference's is (``VisionEngine``'s
``tile_table=`` merges a file into it).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Dict, Optional, Tuple

import torch

TuneKey = Tuple[int, int, int]
PRECISIONS = ("f32", "int8")


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """One configuration for one frontend shape."""
    fused: bool = True         # stream with the single fused kernel
    precision: str = "f32"     # matmul precision: f32 | int8

    def to_json(self) -> Dict:
        return {"fused": self.fused, "precision": self.precision}

    @staticmethod
    def from_json(d: Dict) -> "TileChoice":
        return TileChoice(fused=bool(d["fused"]),
                          precision=str(d.get("precision", "f32")))


_TABLE: Dict[TuneKey, TileChoice] = {}


def shape_key(n: int, k_eff: int, c_out: int) -> TuneKey:
    """Table key: (patch rows N, contraction K = k*k*C_in, C_out)."""
    return (int(n), int(k_eff), int(c_out))


def lookup(n: int, k_eff: int, c_out: int) -> Optional[TileChoice]:
    return _TABLE.get(shape_key(n, k_eff, c_out))


def put(n: int, k_eff: int, c_out: int, choice: TileChoice) -> None:
    if choice.precision not in PRECISIONS:
        raise ValueError(f"unknown frontend precision {choice.precision!r}")
    _TABLE[shape_key(n, k_eff, c_out)] = choice


def clear() -> None:
    """Drop every in-process entry (tests)."""
    _TABLE.clear()


def get(n: int, k_eff: int, c_out: int) -> TileChoice:
    """The choice for a shape: the tuned/loaded entry, or the default
    (f32, fused) recorded on first use."""
    return _TABLE.setdefault(shape_key(n, k_eff, c_out), TileChoice())


def resolve_precision(n: int, k_eff: int, c_out: int,
                      precision: Optional[str] = None) -> str:
    """The matmul precision of a call: an explicit value wins (and is
    validated), otherwise the table's choice for the shape."""
    if precision is not None:
        if precision not in PRECISIONS:
            raise ValueError(f"unknown frontend precision {precision!r} "
                             "(expected 'f32' or 'int8')")
        return precision
    return get(n, k_eff, c_out).precision


def fleet_key(chips_in_batch: int, n: int, k_eff: int, c_out: int
              ) -> TuneKey:
    """The table key of a fleet step: the per-chip (N, K, C). The chip axis
    is not part of it: each chip row runs the single-chip kernel's tiling
    (the chip axis is an outer grid dimension), so one per-chip row serves
    every fleet size and the table never grows with G."""
    del chips_in_batch
    return shape_key(n, k_eff, c_out)


def get_fleet(chips_in_batch: int, n: int, k_eff: int,
              c_out: int) -> TileChoice:
    """The choice a (G, N, K, C) fleet step runs with: the per-chip
    entry."""
    return get(*fleet_key(chips_in_batch, n, k_eff, c_out))


def resolve_fleet(chips_in_batch: int, n: int, k_eff: int, c_out: int,
                  precision: Optional[str] = None) -> str:
    """The matmul precision of a fleet step, resolved at the per-chip key
    (an explicit value wins)."""
    return resolve_precision(*fleet_key(chips_in_batch, n, k_eff, c_out),
                             precision)


def resolve_fleet_fused(chips_in_batch: int, n: int, k_eff: int, c_out: int,
                        fused: Optional[bool] = None) -> bool:
    """Whether a fleet stream step runs the fused kernel: an explicit value
    wins, otherwise the per-chip entry's choice."""
    if fused is not None:
        return bool(fused)
    return get_fleet(chips_in_batch, n, k_eff, c_out).fused


def save_table(path: str) -> None:
    """Persist the in-process table as JSON (``{"n,k,c": {...}}``) with a
    ``"_meta"`` stamp of where it was written (``obs.export.bench_meta``:
    the torch and CUDA versions, the card and its power limit)."""
    from repro_torch.obs.export import bench_meta
    table = {",".join(map(str, k)): v.to_json()
             for k, v in sorted(_TABLE.items())}
    table["_meta"] = bench_meta("autotune", entries=len(_TABLE))
    with open(path, "w") as f:
        json.dump(table, f, indent=2)


def load_table(path: str) -> int:
    """Merge a persisted table into the process; returns entries loaded.
    Keys starting with ``"_"`` (the ``"_meta"`` stamp) are skipped."""
    with open(path) as f:
        raw = json.load(f)
    loaded = 0
    for k, v in raw.items():
        if k.startswith("_"):
            continue
        put(*(int(x) for x in k.split(",")), TileChoice.from_json(v))
        loaded += 1
    return loaded


def _device_ms(fn, repeats: int) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events."""
    fn()                                     # build + warm
    torch.cuda.synchronize()
    pairs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def autotune_frontend(images, w, v_th, key, *, kernel: int = 3,
                      stride: int = 2, chan=None, pixel_params=None,
                      mtj_params=None, repeats: int = 10,
                      store: bool = True):
    """Time the exact and the fused frontend step at both precisions on the
    card for this call's shape; return ``(TileChoice, report)`` and, by
    default, record the choice. ``report`` maps ``"exact"`` / ``"fused"``
    to ``{precision: median ms}``. ``fused`` is set when the faster fused
    step beats the faster exact step; ``precision`` is the faster one on
    the path so chosen. Raises without CUDA tensors: a CPU time says
    nothing about the card."""
    from repro_torch.core import mtj as mtj_model
    from repro_torch.core import pixel as pixel_model
    from repro_torch.kernels import blocking, ops
    if images.device.type != "cuda":
        raise RuntimeError("autotune_frontend measures on the card: pass "
                           "CUDA tensors")
    kw = dict(kernel=kernel, stride=stride, chan=chan,
              pixel_params=pixel_params or pixel_model.DEFAULT_PIXEL,
              mtj_params=mtj_params or mtj_model.DEFAULT_MTJ)
    theta = torch.as_tensor(v_th, dtype=torch.float32,
                            device=images.device).reshape(())
    report: Dict[str, Dict[str, float]] = {"exact": {}, "fused": {}}
    for prec in PRECISIONS:
        report["exact"][prec] = _device_ms(
            lambda: ops.p2m_frontend(images, w, v_th, key, precision=prec,
                                     **kw), repeats)
        report["fused"][prec] = _device_ms(
            lambda: ops.p2m_frontend_fused(images, w, v_th, theta, key,
                                           precision=prec, **kw), repeats)
    fused = min(report["fused"].values()) < min(report["exact"].values())
    path = report["fused" if fused else "exact"]
    choice = TileChoice(fused=fused, precision=min(path, key=path.get))
    if store:
        b, h, wd, cin = images.shape
        n = (b * blocking.conv_out_hw(h, stride)
             * blocking.conv_out_hw(wd, stride))
        put(n, kernel * kernel * cin, w.shape[-1], choice)
    return choice, report
