"""VisionEngine: serve camera frames through the SensorFrontend + backbone.

Port of ``repro.serving.vision.VisionEngine`` for one device:

    engine = VisionEngine(cfg, params)                  # runs on the GPU
    out = engine.classify(frames)                       # one batch
    for out in engine.stream(frame_batches):            # a frame stream
        ...

``stream`` splits incoming batches into ``microbatch``-sized steps with a
key folded per microbatch. With the ``cuda`` backend the first microbatch
of every stream runs the exact two-kernel step and seeds a carried Hoyer
threshold; later microbatches run the single fused kernel at the carried
EMA and fall back to the exact step whenever the fresh threshold drifts by
more than ``fused_theta_tol`` (relative). On the ``ideal``, ``analog`` and
``device`` backends every step is exact and carries no stream telemetry.

``tile_table=`` merges a table written by
``repro_torch.kernels.autotune.save_table`` into the process: the frontend's
precision (f32 or int8) and, with ``fused_stream=None``, whether a stream
step runs fused, then come from the entry of the executed microbatch's
(N, K, C) shape.

``calibration=`` (a ``variation.CalibrationArtifact``) programs that chip's
tester-solved per-channel trim into the frontend params
(``params["p2m"]["cal_trim"]``, on the engine's device): the engine serves
the one physical chip its config names (``VisionConfig(variation=,
chip_id=)``).

``drift=`` (a ``lifetime.DriftConfig``) makes the chip age: a frame clock
counts the served frames, and before every step the chip (the config's
sampled chip, or the nominal one) is re-evolved to that age
(``lifetime.evolve_chip``) and served as ``params["p2m"]["chip"]`` with the
trim in force, so the ``cuda`` backend's kernels B and fused take its (4, C)
rows. With ``schedule=`` (a ``lifetime.SchedulePolicy``) and
``calibration_frames=`` a ``RecalibrationScheduler`` watches the streamed
``channel_rates`` and re-solves the trim against the aged chip when the
policy fires, charging each refresh's tester energy. Every output of an
aging engine carries ``lifetime_age_frames``, ``lifetime_recal_count``,
``lifetime_recal_fired``, ``lifetime_rate_err`` and
``lifetime_recal_energy_pj``. ``classify`` with an explicit key replays a
draw and does not age the chip; ``stream`` ages it per microbatch. The
refresh is key-free, so the draws' key sequence is the same with or without
a scheduler. ``drift=None`` or an all-zero profile leaves every path as it
is without one, a scheduler armed or not.

``device=None`` means the GPU; without CUDA the engine raises rather than
moving to the CPU on its own. ``device="cpu"`` runs the kernels' plain
PyTorch versions.

Timing. ``classify`` is synchronous: the device is synchronized around the
step, so its ``wall_ms`` is the honest end-to-end time of the step. A
stream's exact microbatch is dispatched without a host sync: a
``obs.clock.WallProbe`` (a CUDA event recorded behind the step) latches its
latency at the next non-blocking poll or at the batch's one drain, and the
merged ``wall_ms`` / ``throughput_fps`` of the batch are the span from the
first dispatch to the last step's completion. Fused steps (the drift guard
reads the fresh theta on the host) and aging steps (the frame clock's
scheduler reads the channel rates) stay synchronous and add their measured
interval to that span. ``sync_timing=True`` synchronizes every step, and
each batch's ``wall_ms`` is then the sum of its microbatch walls.

Telemetry. ``obs=`` (a ``repro_torch.obs.Obs``) records the
``serving_microbatch_wall_ms`` histogram, the ``serving_frames_total``,
``serving_fused_steps_total`` and ``serving_fused_fallback_total``
counters, the ``stream`` / ``microbatch`` spans (with ``frames`` and
``path``) and each deferred step's ``microbatch_ready`` complete span, the
``drift_guard_fallback`` and ``recalibration`` events (each with the
config's ``chip_id``) and the ``lifetime_rate_err`` gauge, and hands
itself to the engine's ``RecalibrationScheduler``. ``obs=None`` costs one
``is None`` check a hook and changes no output and no kernel launch.
"""
from __future__ import annotations

import contextlib
import functools
from typing import ContextManager, Dict, Iterable, Iterator, List, Optional

import torch

from repro_torch import prng
from repro_torch.core import energy
from repro_torch.devices import resolve_device
from repro_torch.frontend.api import get_backend
from repro_torch.kernels import autotune, blocking
from repro_torch.lifetime import (LifetimeState, RecalibrationScheduler,
                                  evolve_chip, sample_drift_maps)
from repro_torch.models import vision
from repro_torch.models.params import to_device
from repro_torch.obs.clock import ProbeSet, WallProbe, now, span_bounds
from repro_torch.variation.calibrate import apply_calibration
from repro_torch.variation.chip import identity_chip, sample_chip


class VisionEngine:
    """Batched frame-classification engine on one device."""

    def __init__(self, cfg: vision.VisionConfig, params,
                 backend: str = "cuda", seed: int = 0, device=None,
                 microbatch: Optional[int] = None,
                 fused_stream: Optional[bool] = None,
                 fused_theta_tol: float = 0.02,
                 fused_theta_ema: float = 0.9,
                 tile_table: Optional[str] = None,
                 calibration=None, drift=None, schedule=None,
                 calibration_frames=None, obs=None,
                 sync_timing: bool = False):
        self.device = resolve_device(device)
        get_backend(backend)   # fail fast on typos
        if fused_stream and backend != "cuda":
            raise ValueError("fused_stream=True requires the 'cuda' backend "
                             f"(got {backend!r})")
        if tile_table is not None:
            autotune.load_table(tile_table)
        self.cfg = cfg
        self.backend = backend
        self.microbatch = microbatch
        if calibration is not None:
            params = {**params,
                      "p2m": apply_calibration(params["p2m"], calibration)}
        self.params = to_device(params, self.device)
        self._key = prng.PRNGKey(seed)
        self._frame_count = 0
        # telemetry: every hook sits behind one `is None` check
        self._obs = obs
        self._sync_timing = bool(sync_timing)
        self._pending = ProbeSet()
        self._batch_probes: List[WallProbe] = []
        # None = the table's choice for the executed microbatch's shape
        self._fused_stream = fused_stream
        self._fused_theta_tol = fused_theta_tol
        self._fused_theta_ema = fused_theta_ema
        self._theta_carry: Optional[float] = None
        self.fused_step_count = 0
        self.fused_fallback_count = 0
        lat = energy.frame_latency_us(self._frame_spec())
        self._sensor_latency_us = float(lat["total_us"])
        self._sensor_fps = float(lat["fps"])
        self.lifetime: Optional[LifetimeState] = None
        self._scheduler: Optional[RecalibrationScheduler] = None
        if drift is not None and drift.enabled:
            self._init_lifetime(drift, schedule, calibration_frames)

    def _frame_spec(self) -> energy.FrameSpec:
        cfg, pcfg = self.cfg, self.cfg.p2m
        conv = -(-cfg.in_hw // pcfg.stride)
        return energy.FrameSpec(
            h_in=cfg.in_hw, w_in=cfg.in_hw, c_in=pcfg.in_channels,
            h_out=max(conv // 2, 1), w_out=max(conv // 2, 1),
            c_out=pcfg.out_channels, kernel=pcfg.kernel_size,
            stride=pcfg.stride, n_mtj=pcfg.mtj.n_redundant)

    # --- telemetry ----------------------------------------------------------

    def _span(self, name: str, **args) -> ContextManager[None]:
        return (self._obs.span(name, **args) if self._obs is not None
                else contextlib.nullcontext())

    def _event(self, name: str, **args) -> None:
        if self._obs is not None:
            self._obs.event(name, chip_id=self.cfg.chip_id, **args)

    def _record_latency(self, wall_s: float, n_frames: int) -> None:
        if self._obs is not None:
            self._obs.histogram("serving_microbatch_wall_ms").record(
                wall_s * 1e3)
            self._obs.counter("serving_frames_total").inc(n_frames)

    def _record_probe(self, p: WallProbe) -> None:
        self._record_latency(p.latency, p.tags.get("frames", 0))
        if self._obs is not None:
            self._obs.complete_span("microbatch_ready", p.t0,
                                    p.t0 + p.latency, **p.tags)

    def _finish_batch(self, outs: List[Dict], sizes: List[int]) -> Dict:
        """Merge one incoming batch's microbatch outputs. In async mode the
        in-flight probes are drained first (the one blocking wait of the
        batch; the merge reads values on the host) and the merged wall is
        the span from the first dispatch to the last step's completion.
        With ``sync_timing`` a one-microbatch batch's output is returned as
        it is."""
        probes, self._batch_probes = self._batch_probes, []
        for p in self._pending.drain():
            self._record_probe(p)
        merged = (_merge_outputs(outs, sizes) if len(outs) > 1
                  else outs[0])
        if probes:
            t0, t1 = span_bounds(probes)
            wall = max(t1 - t0, 1e-9)
            merged = dict(merged)
            merged["wall_ms"] = wall * 1e3
            merged["throughput_fps"] = sum(sizes) / wall
        return merged

    # --- the aging chip -----------------------------------------------------

    def _init_lifetime(self, drift, schedule, calibration_frames) -> None:
        pcfg = self.cfg.p2m
        c, n = pcfg.out_channels, pcfg.mtj.n_redundant
        vcfg = self.cfg.variation
        chip0 = (sample_chip(vcfg, c, n, self.cfg.chip_id, device=self.device)
                 if vcfg is not None and vcfg.enabled
                 else identity_chip(c, n, device=self.device))
        trim0 = self.params["p2m"].get("cal_trim")
        if trim0 is None:     # a zero trim changes no bit
            trim0 = torch.zeros((c,), dtype=torch.float32,
                                device=self.device)
        self.lifetime = LifetimeState(
            chip0=chip0, trim=trim0,
            maps=sample_drift_maps(drift, c, n, self.cfg.chip_id,
                                   device=self.device))
        self._evolve = functools.partial(evolve_chip, dcfg=drift)
        if schedule is not None:
            self._scheduler = RecalibrationScheduler(
                schedule, pcfg, calibration_frames, self.params["p2m"],
                frame_spec=self._frame_spec(), device=self.device,
                obs=self._obs)

    def _aged_params(self) -> Dict:
        """The params at the frame clock's age: the aged chip and the trim
        in force in ``params["p2m"]``."""
        st = self.lifetime
        chip = self._evolve(st.chip0, st.maps, st.age_frames)
        return {**self.params, "p2m": {**self.params["p2m"],
                                       "chip": chip, "cal_trim": st.trim}}

    def _advance_lifetime(self, out: Dict, n_frames: int) -> Dict:
        """Tick the frame clock, run the scheduler, return the telemetry."""
        st = self.lifetime
        st.age_frames += n_frames
        fired = 0.0
        if self._scheduler is not None:
            st.rate_err = self._scheduler.observe(out.get("channel_rates"))
            st.rate_err_history.append(st.rate_err)
            if self._scheduler.should_fire(st.age_frames,
                                           st.last_recal_frame):
                st.trim = self._scheduler.recalibrate(
                    self._evolve(st.chip0, st.maps, st.age_frames))
                st.recal_count += 1
                st.last_recal_frame = st.age_frames
                st.recal_energy_pj += self._scheduler.recal_energy_pj
                fired = 1.0
                self._event("recalibration", age_frames=st.age_frames,
                            recal_count=st.recal_count,
                            rate_err=float(st.rate_err),
                            energy_pj=float(st.recal_energy_pj))
        if self._obs is not None and self._scheduler is not None:
            self._obs.gauge("lifetime_rate_err").set(float(st.rate_err))
        return {"lifetime_age_frames": float(st.age_frames),
                "lifetime_recal_count": float(st.recal_count),
                "lifetime_recal_fired": fired,
                "lifetime_rate_err": float(st.rate_err),
                "lifetime_recal_energy_pj": float(st.recal_energy_pj)}

    def _stream_fused_enabled(self, n_frames: int, h: int, w: int) -> bool:
        """Whether a stream step of ``n_frames`` (h, w) frames runs the
        fused kernel: an explicit ``fused_stream=`` wins, otherwise the
        table's entry for the EXECUTED step's (N, K, C) shape."""
        if self._fused_stream is not None:
            return self._fused_stream
        pcfg = self.cfg.p2m
        n = (n_frames * blocking.conv_out_hw(h, pcfg.stride)
             * blocking.conv_out_hw(w, pcfg.stride))
        k_eff = pcfg.kernel_size ** 2 * pcfg.in_channels
        return autotune.get(n, k_eff, pcfg.out_channels).fused

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _forward(self, params, frames: torch.Tensor, key) -> Dict:
        logits, _, aux = vision.forward(params, frames, self.cfg, key=key,
                                        backend=self.backend)
        return {"labels": torch.argmax(logits, -1),
                "probs": torch.softmax(logits, dim=-1), **aux}

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)

    def classify(self, frames, key=None) -> Dict:
        """frames (B, H, W, C) in [0, 1]. Returns labels/probs/frontend aux
        plus serving telemetry (wall_ms, throughput_fps, sensor_latency_us,
        sensor_fps). Without ``key`` the engine folds its frame counter into
        the seed key and advances it; an explicit key replays a draw and, on
        an aging engine, does not advance the frame clock."""
        return self._classify(self._frames(frames), key, advance=key is None)

    def _classify(self, frames: torch.Tensor, key, advance: bool,
                  fused: Optional[bool] = None, defer: bool = False) -> Dict:
        """``fused`` is tri-state: None = not a cuda-stream step (no
        streaming telemetry keys); False = a stream step kept on the exact
        path; True = attempt the fused carried-theta step. ``advance``
        ticks an aging engine's frame clock after the step.

        ``defer=True`` (a stream step) without ``sync_timing`` dispatches an
        exact step of a non-aging engine without a host sync: its probe
        latches the latency later, and this output's ``wall_ms`` is the
        dispatch-side time only. Fused and aging steps are synchronized
        and join the batch's span as measured probes."""
        if key is None:
            key = prng.fold_in(self._key, self._frame_count)
            self._frame_count += 1
        params = self.params if self.lifetime is None else self._aged_params()
        n = frames.shape[0]
        # harvest the in-flight steps already done: each latency latches at
        # the first moment it is seen, not at the drain
        for p in self._pending.poll():
            self._record_probe(p)
        in_batch = defer and not self._sync_timing
        probe = None
        if in_batch and not fused and self.lifetime is None:
            t0 = now()
            with self._span("microbatch", frames=n, path="exact"):
                out = self._forward(params, frames, key)
            probe = self._pending.add(
                WallProbe.record(self.device, t0=t0, frames=n))
            self._batch_probes.append(probe)
            wall = now() - t0
            drift, ran_fused = 0.0, False
        else:
            self._sync()
            t0 = now()
            with self._span("microbatch", frames=n,
                            path="fused" if fused else "exact"):
                if fused:
                    out, drift, ran_fused = self._fused_classify(
                        params, frames, key)
                else:
                    drift, ran_fused = 0.0, False
                    out = self._forward(params, frames, key)
                self._sync()
            wall = now() - t0
            if in_batch:
                done = WallProbe.completed(t0, wall, frames=n)
                self._batch_probes.append(done)
                if not fused:
                    # an aging exact step: the reference probes it too
                    probe = done
                    self._record_probe(done)
        out = dict(out)
        if fused is not None:
            out["stream_fused"] = 1.0 if ran_fused else 0.0
            out["stream_theta_drift"] = drift
            if "theta_used" not in out:     # exact step: it used its own
                out["theta_used"] = out["theta"]
        out["wall_ms"] = wall * 1e3
        out["throughput_fps"] = n / wall
        out["sensor_latency_us"] = self._sensor_latency_us
        out["sensor_fps"] = self._sensor_fps
        if probe is None:
            # synchronized steps record now, probed ones when they latch
            self._record_latency(wall, n)
        if self.lifetime is not None and advance:
            out.update(self._advance_lifetime(out, n))
        return out

    def _fused_classify(self, params, frames: torch.Tensor, key):
        """One stream microbatch on the fused path with the theta-EMA drift
        guard. Returns ``(out, rel_drift, ran_fused)``: the first microbatch
        runs exact and seeds the carry; a fused step whose fresh theta moved
        more than ``fused_theta_tol`` from the carry is re-run exact with
        the same key and re-seeds it; otherwise the carry advances as
        ``ema * carry + (1 - ema) * fresh``."""
        if self._theta_carry is None:
            out = self._forward(params, frames, key)
            out["theta_used"] = out["theta"]
            self._theta_carry = float(out["theta"])
            return out, 0.0, False
        carry = self._theta_carry
        fused_params = {**params, "p2m": {
            **params["p2m"],
            "theta_carry": torch.tensor(carry, dtype=torch.float32,
                                        device=self.device)}}
        out = self._forward(fused_params, frames, key)
        self.fused_step_count += 1
        if self._obs is not None:
            self._obs.counter("serving_fused_steps_total").inc()
        fresh = float(out["theta"])
        drift = abs(fresh - carry) / max(abs(carry), 1e-9)
        if drift > self._fused_theta_tol:
            self._event("drift_guard_fallback", drift=drift,
                        theta_carry=carry, theta_fresh=fresh)
            if self._obs is not None:
                self._obs.counter("serving_fused_fallback_total").inc()
            out = self._forward(params, frames, key)
            out["theta_used"] = out["theta"]
            self._theta_carry = float(out["theta"])
            self.fused_fallback_count += 1
            return out, drift, False
        self._theta_carry = (self._fused_theta_ema * carry
                             + (1.0 - self._fused_theta_ema) * fresh)
        return out, drift, True

    def stream(self, frame_batches: Iterable) -> Iterator[Dict]:
        """Classify a stream of frame batches; yields one merged output per
        incoming batch regardless of microbatching. Each stream starts a new
        scene: the carried threshold is dropped. An aging engine's frame
        clock advances per microbatch, and the scheduler may refresh the
        trim between microbatches. Each batch's exact steps are dispatched
        without a host sync and drained once, when the batch is merged."""
        self._theta_carry = None
        for frames in frame_batches:
            frames = self._frames(frames)
            mb = self.microbatch
            b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]

            def fused_arg(n_frames: int) -> Optional[bool]:
                # tri-state: None off the cuda backend (no stream telemetry)
                if self.backend != "cuda":
                    return None
                return self._stream_fused_enabled(n_frames, h, w)

            with self._span("stream", frames=b):
                if not mb or b <= mb:
                    outs = [self._classify(frames, None, advance=True,
                                           fused=fused_arg(b), defer=True)]
                    sizes = [b]
                else:
                    base = prng.fold_in(self._key, self._frame_count)
                    self._frame_count += 1
                    starts = list(range(0, b, mb))
                    sizes = [min(mb, b - i) for i in starts]
                    outs = [self._classify(frames[i:i + sz],
                                           prng.fold_in(base, j),
                                           advance=True, fused=fused_arg(sz),
                                           defer=True)
                            for j, (i, sz) in enumerate(zip(starts, sizes))]
                merged = self._finish_batch(outs, sizes)
            yield merged


# aux keys that are per-CHANNEL vectors: merged by frame-weighted mean
_CHANNEL_KEYS = ("channel_rates",)
# running counters of an aging engine: the last microbatch's value (the
# engine's state after the batch, never an average)
_CUMULATIVE_KEYS = ("lifetime_age_frames", "lifetime_recal_count",
                    "lifetime_recal_energy_pj", "lifetime_rate_err")
# events: 1.0 when any microbatch of the batch fired
_EVENT_KEYS = ("lifetime_recal_fired",)
# additive costs: the batch's total
_SUM_KEYS = ("wall_ms",)
# engine constants: passed through verbatim from the first microbatch
_CONSTANT_KEYS = ("sensor_latency_us", "sensor_fps")


def _stack(vals) -> torch.Tensor:
    device = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                  None)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=device) for v in vals])


def _merge_outputs(outs: List[Dict], sizes: List[int]) -> Dict:
    """Merge per-microbatch outputs into one batch-level dict: per-example
    rows concatenated, per-channel vectors and scalar stats by frame-weighted
    mean (min/max keys by min/max), lifetime counters by their last value
    and refresh events by any-fired, wall time summed and throughput
    recomputed from it, engine constants passed through."""
    w = torch.tensor(sizes, dtype=torch.float32)
    w = w / torch.sum(w)
    merged: Dict = {}
    for k in outs[0]:
        vals = [o[k] for o in outs]
        if k in _SUM_KEYS:
            merged[k] = sum(float(v) for v in vals)
        elif k in _CONSTANT_KEYS:
            merged[k] = vals[0]
        elif k in _CUMULATIVE_KEYS:
            merged[k] = vals[-1]
        elif k in _EVENT_KEYS:
            merged[k] = max(float(v) for v in vals)
        elif k in _CHANNEL_KEYS:
            stacked = _stack(vals)
            merged[k] = torch.sum(stacked * w.to(stacked.device)[:, None],
                                  dim=0)
        elif getattr(vals[0], "ndim", 0) >= 1:
            merged[k] = torch.cat(vals, dim=0)
        elif k.endswith("_min"):
            merged[k] = torch.min(_stack(vals))
        elif k.endswith("_max"):
            merged[k] = torch.max(_stack(vals))
        else:
            stacked = _stack(vals)
            merged[k] = torch.sum(stacked * w.to(stacked.device))
    merged["throughput_fps"] = sum(sizes) / (merged["wall_ms"] / 1e3)
    return merged
