"""FleetEngine: serve a fleet of distinct aging sensors on one device.

Port of ``repro.serving.fleet``. ``VisionEngine`` serves one chip instance;
a deployment is a population of them, each fabricated with its own mismatch
(``variation``), aging on its own frame clock (``lifetime``), streaming
concurrently. This engine batches frames across chips in one step:

    engine = FleetEngine(cfg, params, chips_per_step=4)   # on the GPU
    outs = engine.serve([(chip_id, frames), ...])         # one per request
    for outs in engine.stream(request_batches):           # concurrent streams
        ...

Data layout. A ``FleetState`` registry holds every chip's identity stacked
along a leading chip axis on the engine's device: ``chips0`` (the t = 0
``ChipMaps``), ``maps`` (the frozen ``DriftMaps`` directions) and ``trim``
(F, C), the programmed calibration trims; and, on the host, each chip's
frame-clock age, rng frame counter and recalibration audit trail. A step
gathers up to ``chips_per_step`` requests' rows (one ``index_select`` a
leaf), evolves the gathered chips to their ages (one ``evolve_chip`` at a
(G,) age vector) and runs the fleet forward (``vision.forward_fleet``): the
frontend per chip, which on the ``cuda`` backend is one launch of kernel A
and one of kernel B (or one fused launch) for all G chips with the chip
axis as a grid dimension, then the backbone once over the G * B frames.

Per-chip rng mirrors ``VisionEngine``: chip ``i``'s stream folds its own
frame counter into the engine seed key (microbatch ``j`` of a split request
folds ``j`` into that), assigned at plan time, so step packing never moves
a draw and a 1-chip fleet equals a ``VisionEngine`` with the same seed bit
for bit. With neither variation nor drift armed the step plants no chip
operands, keeping even ``analog`` byte-exact with a plain engine.

Fused streaming runs per chip (``cuda`` backend): each chip carries its own
Hoyer-theta EMA; a step runs fused only when every chip in it has a carry,
and the drift guard re-runs the whole step exact with the same keys when
any chip's fresh theta moved beyond ``fused_theta_tol``. A step never packs
two microbatches of one chip, so each carry advances in stream order.

Maintenance: ``sweep=`` arms a staleness-prioritised recalibration sweep
(the ``RecalibrationScheduler``'s ``recalibrate_fleet``: one bisection for
up to ``refresh_per_sweep`` of the stalest eligible chips, padded to that
width), budgeted by an energy credit accruing per served frame
(``maintenance_energy_per_frame_pj``). Sweeps are key-free: no rng stream
moves. Birth calibration solves each joining chip's trim eagerly, as
``variation.calibrate`` does.

Dispatch. An exact step is queued without a host sync (its host operands,
the gather rows, the ages' factors and the draw keys, go up through pinned
staging copies that do not wait for the device) and an
``obs.clock.WallProbe`` (a ``torch.cuda.Event``) recorded behind it; a
batch drains once, at its end, reading each step's readiness from its
event. Fused steps read their fresh thetas on the host and so are
synchronous; ``sync_timing=True`` synchronizes every step.

Telemetry: ``obs=`` (a ``repro_torch.obs.Obs``) records the
``fleet_step_wall_ms`` histogram; the ``fleet_drain_wall_ms``,
``fleet_probe_high_water`` and ``fleet_size`` gauges; the
``serving_frames_total``, ``fleet_steps_total``,
``serving_fused_steps_total`` / ``serving_fused_fallback_total``,
``fleet_probes_drained_total``, ``fleet_drains_total``,
``fleet_sweeps_total`` and ``fleet_chips_refreshed_total`` counters; the
``serve``, ``step`` and ``sweep`` spans and each deferred step's
``step_ready`` complete span; and the ``fleet_join``, ``fleet_leave``,
``fleet_sweep``, ``drift_guard_fallback``, ``checkpoint_save`` and
``checkpoint_load`` events. It also reaches the sweep's scheduler.
``obs=None`` costs one ``is None`` check a hook.

Warm restarts: ``save()`` persists the full fleet (stacked chips, trims,
ages, telemetry, rng frame clocks and theta carries) through
``checkpoint/manager.py``, in the reference's format; ``load()`` on a fresh
engine (same cfg, params and seed) resumes every stream bit for bit, and
reads a checkpoint the reference's engine wrote.

``device=None`` means the GPU (the engine raises without one);
``device="cpu"`` runs the kernels' plain versions. Not ported yet: the
reference's ``mesh=`` / ``rules=`` (sharded fleets).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (ContextManager, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import energy, hoyer, p2m
from repro_torch.devices import resolve_device, to_device_async
from repro_torch.frontend.api import get_backend
from repro_torch.kernels import autotune, blocking
from repro_torch.lifetime import (DriftMaps, RecalibrationScheduler,
                                  evolve_chip, sample_drift_maps)
from repro_torch.models import vision
from repro_torch.models.params import to_device
from repro_torch.obs.clock import WallProbe, now
from repro_torch.serving.vision import _merge_outputs
from repro_torch.variation.calibrate import solve_trim, target_rates
from repro_torch.variation.chip import ChipMaps, identity_chip, sample_chip


@dataclasses.dataclass(frozen=True)
class FleetSweepPolicy:
    """The amortized background maintenance loop of a fleet.

    ``policy`` is the per-chip eligibility condition (a
    ``lifetime.SchedulePolicy``: periodic staleness and/or a monitored-rate
    trigger); each sweep refreshes at most ``refresh_per_sweep`` eligible
    chips, most stale first. ``maintenance_energy_per_frame_pj`` caps the
    sweep rate by energy: every served frame accrues that much tester credit
    and each refresh spends ``RecalibrationScheduler.recal_energy_pj`` of it
    (None = no cap). ``auto`` runs a sweep after every ``serve()``.
    """
    policy: "object"
    refresh_per_sweep: int = 4
    maintenance_energy_per_frame_pj: Optional[float] = None
    auto: bool = True


@dataclasses.dataclass
class FleetState:
    """Every chip the engine serves, stacked along a leading (F,) axis."""
    chips0: ChipMaps             # t = 0 instances, leaves (F, ...)
    maps: DriftMaps              # drift directions, leaves (F, ...)
    trim: torch.Tensor           # (F, C) programmed trims
    chip_ids: List[int]          # registry order (row i serves chip_ids[i])
    age_frames: np.ndarray       # (F,) int64 frame-clock ages
    frame_count: np.ndarray      # (F,) int64 per-chip rng frame counters
    last_recal_frame: np.ndarray  # (F,) int64
    recal_count: np.ndarray      # (F,) int64
    recal_energy_pj: np.ndarray  # (F,) float64 cumulative tester energy
    rate_ema: np.ndarray         # (F, C) float64 monitored channel-rate EMA
    rate_baseline: np.ndarray    # (F, C) float64 post-refresh EMA snapshot
    ema_valid: np.ndarray        # (F,) bool: rate_ema holds observations
    baseline_valid: np.ndarray   # (F,) bool
    rate_err: np.ndarray         # (F,) float64 monitored drift metric

    @property
    def size(self) -> int:
        return len(self.chip_ids)


# the host-side per-chip leaves of a FleetState, each (F,) or (F, C)
_HOST_LEAVES = ("age_frames", "frame_count", "last_recal_frame",
                "recal_count", "recal_energy_pj", "rate_ema",
                "rate_baseline", "ema_valid", "baseline_valid", "rate_err")


@dataclasses.dataclass
class _WorkItem:
    """One executed microbatch of one request (planned before stepping)."""
    req: int                     # index into the serve() request list
    slot: int                    # fleet registry row
    chip_id: int
    frames: torch.Tensor         # (b, H, W, C) on the engine's device
    key: np.ndarray              # this microbatch's rng key (pre-folded)
    age: int                     # the chip's frame-clock age this item sees
    advance: bool = True         # False: pinned-key replay (ages nothing)


class FleetEngine:
    """Multi-chip frame-classification engine on one device."""

    def __init__(self, cfg: vision.VisionConfig, params,
                 backend: Optional[str] = None, seed: int = 0, device=None,
                 microbatch: Optional[int] = None,
                 chips_per_step: int = 4,
                 drift=None,
                 sweep: Optional[FleetSweepPolicy] = None,
                 calibration_frames=None,
                 birth_calibration: Optional[bool] = None,
                 birth_cal_iters: int = 16, birth_cal_span: float = 2.0,
                 fused_stream: Optional[bool] = None,
                 fused_theta_tol: float = 0.02,
                 fused_theta_ema: float = 0.9,
                 tile_table: Optional[str] = None,
                 obs=None, sync_timing: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.backend = backend or cfg.frontend_backend
        get_backend(self.backend)   # fail fast on typos
        self.microbatch = microbatch
        self._obs = obs
        self._sync_timing = bool(sync_timing)
        self.chips_per_step = int(chips_per_step)
        if self.chips_per_step < 1:
            raise ValueError("chips_per_step must be >= 1")
        self.seed = seed
        self._key = prng.PRNGKey(seed)
        if fused_stream and self.backend != "cuda":
            raise ValueError("fused_stream=True requires the 'cuda' backend "
                             f"(got {self.backend!r})")
        if tile_table is not None:
            autotune.load_table(tile_table)
        self._fused_stream = fused_stream
        self._fused_theta_tol = fused_theta_tol
        self._fused_theta_ema = fused_theta_ema
        # per-chip carried Hoyer-theta EMA, keyed by chip id (a chip that
        # leaves and rejoins starts a fresh stream)
        self._theta_carry: Dict[int, float] = {}
        self.fused_step_count = 0
        self.fused_fallback_count = 0
        self.frames_served = 0
        self.sweep_count = 0

        self.drift = drift if (drift is not None and drift.enabled) else None
        vcfg = cfg.variation
        self._vcfg = vcfg if (vcfg is not None and vcfg.enabled) else None
        # plant chip / trim operands only when some chip can differ from the
        # nominal device: with neither variation nor drift every backend
        # stays byte-exact with a plain engine (an identity chip would, e.g.,
        # arm the analog backend's nominal Fig. 5 flip draws)
        self._plant = self._vcfg is not None or self.drift is not None

        self.params = to_device(params, self.device)
        pcfg = cfg.p2m
        self._c = pcfg.out_channels
        self._n_red = pcfg.mtj.n_redundant

        lat = energy.frame_latency_us(self._frame_spec())
        self._sensor_latency_us = float(lat["total_us"])
        self._sensor_fps = float(lat["fps"])

        # the virtual tester: birth calibration and (with sweep=) the
        # scheduler whose fleet solve the background sweep runs
        self._birth_solve = None
        self._scheduler: Optional[RecalibrationScheduler] = None
        self.sweep_policy = sweep
        self._energy_credit_pj = 0.0
        if calibration_frames is not None:
            pp = self.params["p2m"]
            frames = torch.as_tensor(calibration_frames, dtype=torch.float32,
                                     device=self.device)
            u = p2m.hardware_conv(frames, pp["w"], pcfg)
            theta = hoyer.effective_threshold(u, pp["v_th"]) * pp["v_th"]
            ref = target_rates(u, theta, pcfg)
            # eager, as variation.calibrate solves: birth trims are the
            # tester artifact a single-chip engine would program
            self._birth_solve = lambda chip: solve_trim(
                u, theta, chip, ref, pcfg, iters=birth_cal_iters,
                span=birth_cal_span)
        if birth_calibration is None:
            birth_calibration = (calibration_frames is not None
                                 and self._vcfg is not None)
        if birth_calibration and self._birth_solve is None:
            raise ValueError("birth_calibration needs calibration_frames")
        self._birth_calibration = birth_calibration
        if sweep is not None:
            if calibration_frames is None:
                raise ValueError("a sweep policy needs calibration_frames "
                                 "(the tester re-exposes them per refresh)")
            self._scheduler = RecalibrationScheduler(
                sweep.policy, pcfg, calibration_frames, self.params["p2m"],
                frame_spec=self._frame_spec(), device=self.device,
                obs=self._obs)

        self.state = self._empty_state()

    # --- registry ----------------------------------------------------------

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _stacked_zeros(self, cls, f: int):
        """A ChipMaps / DriftMaps of zeros with f rows."""
        c, n = self._c, self._n_red
        return cls(*(self._zeros(f, c, n) for _ in range(4)),
                   self._zeros(f, c), self._zeros(f, c))

    def _empty_state(self) -> FleetState:
        c = self._c
        i64 = lambda: np.zeros((0,), np.int64)
        return FleetState(
            chips0=self._stacked_zeros(ChipMaps, 0),
            maps=self._stacked_zeros(DriftMaps, 0),
            trim=self._zeros(0, c), chip_ids=[],
            age_frames=i64(), frame_count=i64(), last_recal_frame=i64(),
            recal_count=i64(), recal_energy_pj=np.zeros((0,), np.float64),
            rate_ema=np.zeros((0, c), np.float64),
            rate_baseline=np.zeros((0, c), np.float64),
            ema_valid=np.zeros((0,), bool),
            baseline_valid=np.zeros((0,), bool),
            rate_err=np.zeros((0,), np.float64))

    def slot_of(self, chip_id: int) -> int:
        try:
            return self.state.chip_ids.index(int(chip_id))
        except ValueError:
            raise KeyError(f"chip {chip_id} is not in the fleet") from None

    def add_chip(self, chip_id: int,
                 calibrate: Optional[bool] = None) -> int:
        """Register one chip; returns its registry row.

        The chip's identity is deterministic in ``(cfg.variation,
        chip_id)`` and its drift directions in ``(drift.drift_seed,
        chip_id)``: re-adding an id on a restarted process gives the same
        physical chip. ``calibrate`` overrides the engine's
        ``birth_calibration`` for this chip.
        """
        chip_id = int(chip_id)
        if chip_id in self.state.chip_ids:
            raise ValueError(f"chip {chip_id} is already in the fleet")
        c, n = self._c, self._n_red
        chip = (sample_chip(self._vcfg, c, n, chip_id, device=self.device)
                if self._vcfg is not None
                else identity_chip(c, n, device=self.device))
        if self.drift is not None:
            maps = sample_drift_maps(self.drift, c, n, chip_id,
                                     device=self.device)
        else:
            maps = DriftMaps(*(m[0] for m in self._stacked_zeros(DriftMaps,
                                                                 1)))
        do_cal = self._birth_calibration if calibrate is None else calibrate
        if do_cal:
            if self._birth_solve is None:
                raise ValueError("calibrate=True needs calibration_frames")
            trim = self._birth_solve(chip)
        else:
            trim = self._zeros(c)
        st = self.state
        grow = lambda s, v: torch.cat([s, v[None].to(torch.float32)])
        st.chips0 = ChipMaps(*map(grow, st.chips0, chip))
        st.maps = DriftMaps(*map(grow, st.maps, maps))
        st.trim = grow(st.trim, trim)
        st.chip_ids.append(chip_id)
        for name in _HOST_LEAVES:
            a = getattr(st, name)
            setattr(st, name, np.concatenate(
                [a, np.zeros((1,) + a.shape[1:], a.dtype)]))
        self._event("fleet_join", chip_id=chip_id, fleet_size=st.size,
                    calibrated=bool(do_cal))
        if self._obs is not None:
            self._obs.gauge("fleet_size").set(st.size)
        return st.size - 1

    def remove_chip(self, chip_id: int) -> None:
        """Drop a chip from the registry (a chip leaving mid-stream). The
        remaining chips' rng streams, ages and trims are untouched."""
        i = self.slot_of(chip_id)
        st = self.state
        cut = lambda a: torch.cat([a[:i], a[i + 1:]])
        st.chips0 = ChipMaps(*map(cut, st.chips0))
        st.maps = DriftMaps(*map(cut, st.maps))
        st.trim = cut(st.trim)
        st.chip_ids.pop(i)
        for name in _HOST_LEAVES:
            setattr(st, name, np.delete(getattr(st, name), i, axis=0))
        self._theta_carry.pop(int(chip_id), None)
        self._event("fleet_leave", chip_id=int(chip_id), fleet_size=st.size)
        if self._obs is not None:
            self._obs.gauge("fleet_size").set(st.size)

    def _ensure_chip(self, chip_id: int) -> int:
        """Row of ``chip_id``, registering an unknown id (a chip joining
        mid-stream gets its deterministic identity and birth trim)."""
        chip_id = int(chip_id)
        if chip_id in self.state.chip_ids:
            return self.state.chip_ids.index(chip_id)
        return self.add_chip(chip_id)

    # --- geometry ------------------------------------------------------------

    def _frame_spec(self) -> energy.FrameSpec:
        cfg, pcfg = self.cfg, self.cfg.p2m
        conv = -(-cfg.in_hw // pcfg.stride)
        return energy.FrameSpec(
            h_in=cfg.in_hw, w_in=cfg.in_hw, c_in=pcfg.in_channels,
            h_out=max(conv // 2, 1), w_out=max(conv // 2, 1),
            c_out=pcfg.out_channels, kernel=pcfg.kernel_size,
            stride=pcfg.stride, n_mtj=pcfg.mtj.n_redundant)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- telemetry -----------------------------------------------------------

    def _span(self, name: str, **args) -> ContextManager[None]:
        return (self._obs.span(name, **args) if self._obs is not None
                else contextlib.nullcontext())

    def _event(self, name: str, **args) -> None:
        if self._obs is not None:
            self._obs.event(name, **args)

    def _record_step(self, wall_s: float, n_frames: int) -> None:
        if self._obs is not None:
            self._obs.histogram("fleet_step_wall_ms").record(wall_s * 1e3)
            self._obs.counter("serving_frames_total").inc(n_frames)
            self._obs.counter("fleet_steps_total").inc()
            self._obs.gauge("fleet_size").set(self.state.size)

    # --- the fleet step ------------------------------------------------------

    def _gather_operands(self, slots: Sequence[int], ages: np.ndarray
                         ) -> Tuple[ChipMaps, torch.Tensor]:
        """The chips and trims of one step's rows (one ``index_select`` a
        leaf), the chips evolved to each row's frame-clock age."""
        idx = to_device_async(np.asarray(slots, np.int64), self.device)
        chips = ChipMaps(*(m.index_select(0, idx)
                           for m in self.state.chips0))
        trims = self.state.trim.index_select(0, idx)
        if self.drift is not None:
            maps = DriftMaps(*(m.index_select(0, idx)
                               for m in self.state.maps))
            chips = evolve_chip(chips, maps, ages, dcfg=self.drift)
        return chips, trims

    def _forward(self, chips, trims, frames: torch.Tensor, keys,
                 theta_carry: Optional[torch.Tensor] = None) -> Dict:
        """One fleet forward: (G, B, ...) frames, one key a row. Without
        planted operands the params stay as they are."""
        pp = dict(self.params["p2m"])
        if self._plant:
            pp.update(chip=chips, cal_trim=trims)
        if theta_carry is not None:
            pp["theta_carry"] = theta_carry
        logits, aux = vision.forward_fleet({**self.params, "p2m": pp},
                                           frames, self.cfg, keys=keys,
                                           backend=self.backend)
        return {"labels": torch.argmax(logits, -1),
                "probs": torch.softmax(logits, dim=-1), **aux}

    def _fused_wanted(self, g: int, n_frames: int, h: int, w: int
                      ) -> Optional[bool]:
        """Tri-state fused decision for a (g, n_frames) step: None off the
        ``cuda`` backend (its outputs carry no stream telemetry)."""
        if self.backend != "cuda":
            return None
        pcfg = self.cfg.p2m
        n = (n_frames * blocking.conv_out_hw(h, pcfg.stride)
             * blocking.conv_out_hw(w, pcfg.stride))
        k_eff = pcfg.kernel_size ** 2 * pcfg.in_channels
        return autotune.resolve_fleet_fused(g, n, k_eff, pcfg.out_channels,
                                            self._fused_stream)

    # --- planning ------------------------------------------------------------

    def _plan(self, requests) -> List[_WorkItem]:
        """Split requests into per-chip microbatch work items, assigning
        each its rng key and frame-clock age as a per-chip
        ``VisionEngine.stream`` would (the key order is fixed at plan time,
        so step packing never perturbs the draws)."""
        items: List[_WorkItem] = []
        st = self.state
        age_run: Dict[int, int] = {}
        for r, (cid, frames) in enumerate(requests):
            slot = self._ensure_chip(cid)
            cid = int(cid)
            frames = torch.as_tensor(frames, dtype=torch.float32,
                                     device=self.device)
            b = frames.shape[0]
            mb = self.microbatch
            age = age_run.get(slot, int(st.age_frames[slot]))
            if not mb or b <= mb:
                key = prng.fold_in(self._key, int(st.frame_count[slot]))
                st.frame_count[slot] += 1
                items.append(_WorkItem(r, slot, cid, frames, key, age))
                age_run[slot] = age + b
                continue
            base = prng.fold_in(self._key, int(st.frame_count[slot]))
            st.frame_count[slot] += 1
            for j, i in enumerate(range(0, b, mb)):
                sz = min(mb, b - i)
                items.append(_WorkItem(r, slot, cid, frames[i:i + sz],
                                       prng.fold_in(base, j), age))
                age += sz
            age_run[slot] = age
        return items

    def _group(self, items: List[_WorkItem]) -> List[List[_WorkItem]]:
        """Pack items into steps of up to ``chips_per_step`` rows. A step's
        rows share a frame shape (one stacked operand) and hold distinct
        chips: two microbatches of one chip run in stream order across
        consecutive steps, so its carry and age advance as a single-chip
        stream's would."""
        groups: List[List[_WorkItem]] = []
        cur: List[_WorkItem] = []
        for it in items:
            fits = (len(cur) < self.chips_per_step
                    and (not cur or (cur[0].frames.shape == it.frames.shape
                                     and all(c.slot != it.slot
                                             for c in cur))))
            if not fits and cur:
                groups.append(cur)
                cur = []
            cur.append(it)
        if cur:
            groups.append(cur)
        return groups

    # --- stepping ------------------------------------------------------------

    def _run_step(self, group: List[_WorkItem], stream: bool = True,
                  defer: bool = False
                  ) -> Tuple[List[Dict], Optional[WallProbe]]:
        """Run one packed step; returns one output dict per item and the
        step's probe (None where the step was synchronized).

        ``stream=False`` (a bare ``classify``) runs the exact path, emits
        no stream telemetry and leaves the carries alone. ``defer=True`` on
        the plain exact path dispatches without a host sync: the caller
        drains the probe at the batch's end and patches the walls. Fused
        steps read their fresh thetas on the host, so they are synchronous
        and return no probe."""
        g = len(group)
        frames = torch.stack([it.frames for it in group])
        keys = [it.key for it in group]
        chips, trims = self._gather_operands(
            [it.slot for it in group],
            np.array([it.age for it in group], np.float64))
        b, h, w = group[0].frames.shape[:3]
        fused = self._fused_wanted(g, b, h, w) if stream else None
        carries = [self._theta_carry.get(it.chip_id) for it in group]
        run_fused = bool(fused) and all(c is not None for c in carries)
        total_frames = g * b

        probe = None
        if self._sync_timing or not defer or fused:
            self._sync()
        t0 = now()
        if run_fused:
            theta = to_device_async(np.asarray(carries, np.float32),
                                    self.device)
            with self._span("step", chips=g, frames=total_frames,
                            path="fused"):
                out = self._forward(chips, trims, frames, keys, theta)
                fresh = out["theta"].detach().cpu().numpy().astype(
                    np.float64)
            self.fused_step_count += 1
            if self._obs is not None:
                self._obs.counter("serving_fused_steps_total").inc()
            drifts = np.abs(fresh - np.asarray(carries)) / np.maximum(
                np.abs(np.asarray(carries)), 1e-9)
            if float(np.max(drifts)) > self._fused_theta_tol:
                # some chip's carried threshold went stale: re-serve the
                # whole step exact (same keys: the draws' sequence is the
                # same either way) and re-seed every carry
                self._event("drift_guard_fallback",
                            chip_ids=[it.chip_id for it in group],
                            drift=float(np.max(drifts)))
                if self._obs is not None:
                    self._obs.counter("serving_fused_fallback_total").inc()
                out = self._forward(chips, trims, frames, keys)
                self.fused_fallback_count += 1
                seeds = out["theta"].detach().cpu().tolist()
                for i, it in enumerate(group):
                    self._theta_carry[it.chip_id] = float(seeds[i])
                ran_fused = False
            else:
                e = self._fused_theta_ema
                for i, it in enumerate(group):
                    self._theta_carry[it.chip_id] = (
                        e * carries[i] + (1.0 - e) * float(fresh[i]))
                ran_fused = True
            drift_vals = [float(d) for d in drifts]
            self._sync()
            wall = now() - t0
            self._record_step(wall, total_frames)
        else:
            sync = self._sync_timing or not defer or bool(fused)
            with self._span("step", chips=g, frames=total_frames,
                            path="exact"):
                out = self._forward(chips, trims, frames, keys)
            if fused:
                # the step wanted fused but some chip had no carry yet (its
                # stream's first microbatch): the exact run seeds them all,
                # as VisionEngine's first microbatch does
                seeds = out["theta"].detach().cpu().tolist()
                for i, it in enumerate(group):
                    self._theta_carry[it.chip_id] = float(seeds[i])
            ran_fused = False
            drift_vals = [0.0] * g
            if sync:
                self._sync()
                wall = now() - t0
                self._record_step(wall, total_frames)
            else:
                # the drain replaces this dispatch-side wall
                probe = WallProbe.record(self.device, t0=t0,
                                         frames=total_frames, chips=g)
                wall = now() - t0

        outs: List[Dict] = []
        for i, it in enumerate(group):
            o = {k: v[i] for k, v in out.items()}
            if fused is not None:
                o["stream_fused"] = 1.0 if ran_fused else 0.0
                o["stream_theta_drift"] = drift_vals[i]
                if "theta_used" not in o:
                    o["theta_used"] = o["theta"]
            # the step's wall is shared by its rows: each item its frame
            # share, so merged request telemetry stays additive
            o["wall_ms"] = wall * 1e3 * (b / total_frames)
            o["throughput_fps"] = total_frames / wall
            o["sensor_latency_us"] = self._sensor_latency_us
            o["sensor_fps"] = self._sensor_fps
            outs.append(o)
        return outs, probe

    def _commit(self, it: _WorkItem, out: Dict) -> Dict:
        """Advance the chip's host state past one served item and attach
        its lifetime telemetry (``VisionEngine``'s, minus inline
        recalibration: refreshes happen in sweeps)."""
        st = self.state
        b = it.frames.shape[0]
        if it.advance:
            st.age_frames[it.slot] += b
            self.frames_served += b
            if self.sweep_policy is not None:
                budget = self.sweep_policy.maintenance_energy_per_frame_pj
                if budget is not None:
                    self._energy_credit_pj += b * budget
                self._observe(it.slot, out.get("channel_rates"))
        if self.drift is not None:
            out = dict(out)
            out.update({
                "lifetime_age_frames": float(st.age_frames[it.slot]),
                "lifetime_recal_count": float(st.recal_count[it.slot]),
                "lifetime_recal_fired": 0.0,
                "lifetime_rate_err": float(st.rate_err[it.slot]),
                "lifetime_recal_energy_pj":
                    float(st.recal_energy_pj[it.slot])})
        return out

    def _observe(self, slot: int, rates) -> None:
        """Fold one item's channel rates into the chip's monitoring EMA
        (``RecalibrationScheduler.observe`` per chip)."""
        if rates is None:
            return
        st = self.state
        r = rates.detach().cpu().numpy().astype(np.float64)
        e = self.sweep_policy.policy.ema
        if st.ema_valid[slot]:
            st.rate_ema[slot] = e * st.rate_ema[slot] + (1.0 - e) * r
        else:
            st.rate_ema[slot] = r
            st.ema_valid[slot] = True
        if not st.baseline_valid[slot]:
            st.rate_baseline[slot] = st.rate_ema[slot]
            st.baseline_valid[slot] = True
        st.rate_err[slot] = float(np.mean(
            np.abs(st.rate_ema[slot] - st.rate_baseline[slot])))

    # --- public serving API --------------------------------------------------

    def serve(self, requests: Sequence[Tuple[int, object]]) -> List[Dict]:
        """Serve a batch of ``(chip_id, frames (B, H, W, C))`` requests.

        Returns one merged output per request (microbatch splitting and
        cross-chip packing are invisible to the caller). Unknown chip ids
        register. With ``sweep=`` armed (``auto=True``) a maintenance sweep
        runs after the batch."""
        requests = list(requests)
        if not requests:
            return []
        items = self._plan(requests)
        defer = not self._sync_timing
        steps = []
        with self._span("serve", requests=len(requests)):
            # dispatch every packed step (exact ones without a host sync) ..
            for group in self._group(items):
                outs, probe = self._run_step(group, defer=defer)
                steps.append((group, outs, probe))
            # ... then drain once: each deferred step's wall as its event
            # saw it. Every probed step is still pending when the drain
            # starts (dispatch never harvests), so their count is the
            # batch's probe high-water mark.
            outstanding = (sum(1 for _, _, p in steps if p is not None)
                           if self._obs is not None else 0)
            drain_t0 = now() if self._obs is not None else 0.0
            for group, outs, probe in steps:
                if probe is None:
                    continue
                wall = probe.wait()
                total = probe.tags["frames"]
                self._record_step(wall, total)
                if self._obs is not None:
                    self._obs.complete_span("step_ready", probe.t0,
                                            probe.t0 + wall, **probe.tags)
                for it, o in zip(group, outs):
                    o["wall_ms"] = wall * 1e3 * it.frames.shape[0] / total
                    o["throughput_fps"] = total / wall
            if self._obs is not None:
                self._obs.gauge("fleet_drain_wall_ms").set(
                    (now() - drain_t0) * 1e3)
                self._obs.gauge("fleet_probe_high_water").set(outstanding)
                self._obs.counter("fleet_probes_drained_total").inc(
                    outstanding)
                self._obs.counter("fleet_drains_total").inc()
        per_req: Dict[int, List[Tuple[_WorkItem, Dict]]] = {}
        for group, outs, _ in steps:
            # commits run in plan order: the groups keep it
            for it, o in zip(group, outs):
                per_req.setdefault(it.req, []).append((it, self._commit(it,
                                                                        o)))
        results: List[Dict] = []
        for r in range(len(requests)):
            pairs = per_req[r]
            if len(pairs) == 1:
                o = dict(pairs[0][1])
                n = pairs[0][0].frames.shape[0]
                o["throughput_fps"] = n / (o["wall_ms"] / 1e3)
                results.append(o)
            else:
                results.append(_merge_outputs(
                    [o for _, o in pairs],
                    [it.frames.shape[0] for it, _ in pairs]))
        if self.sweep_policy is not None and self.sweep_policy.auto:
            self.run_sweep()
        return results

    def classify(self, chip_id: int, frames, key=None) -> Dict:
        """One chip, one batch: ``VisionEngine.classify``'s counterpart,
        always on the exact path. An explicit ``key`` is a pinned replay: it
        advances neither the chip's rng frame counter nor its age."""
        slot = self._ensure_chip(chip_id)
        st = self.state
        advance = key is None
        if advance:
            key = prng.fold_in(self._key, int(st.frame_count[slot]))
            st.frame_count[slot] += 1
        frames = torch.as_tensor(frames, dtype=torch.float32,
                                 device=self.device)
        it = _WorkItem(0, slot, int(chip_id), frames, key,
                       int(st.age_frames[slot]), advance=advance)
        (out,), _ = self._run_step([it], stream=False)
        return self._commit(it, out)

    def stream(self, request_batches: Iterable[Sequence[Tuple[int, object]]]
               ) -> Iterator[List[Dict]]:
        """Serve a stream of request batches (concurrent per-chip streams).
        A new stream is a new scene for every chip: all carried thetas drop,
        so each chip's first microbatch runs exact and re-seeds its carry."""
        self._theta_carry.clear()
        for batch in request_batches:
            yield self.serve(batch)

    # --- the amortized maintenance sweep -------------------------------------

    def run_sweep(self, force: bool = False) -> Dict:
        """One background recalibration sweep over the fleet.

        Eligibility follows the armed ``SchedulePolicy`` (``force=True``
        makes every chip eligible). The K most-stale eligible chips
        (staleness: frames since the last refresh) are refreshed in one
        ``recalibrate_fleet`` bisection, padded to ``refresh_per_sweep``
        rows, spending tester energy from the accrued credit when a budget
        is set. Key-free and deterministic: no rng stream moves."""
        report = {"eligible": 0, "refreshed": [],
                  "energy_credit_pj": float(self._energy_credit_pj)}
        st = self.state
        if self._scheduler is None or st.size == 0:
            return report
        pol = self.sweep_policy.policy
        since = st.age_frames - st.last_recal_frame
        elig = np.zeros((st.size,), bool)
        if force:
            elig[:] = True
        else:
            if pol.period_frames is not None:
                elig |= since >= pol.period_frames
            if pol.rate_err_threshold is not None:
                elig |= ((st.rate_err > pol.rate_err_threshold)
                         & (since >= pol.min_interval_frames))
        cand = np.nonzero(elig)[0]
        report["eligible"] = int(cand.size)
        if cand.size == 0:
            return report
        # most stale first; the energy budget caps how many are affordable
        cand = cand[np.argsort(-since[cand], kind="stable")]
        k = min(self.sweep_policy.refresh_per_sweep, cand.size)
        cost = self._scheduler.recal_energy_pj
        if self.sweep_policy.maintenance_energy_per_frame_pj is not None:
            k = min(k, int(self._energy_credit_pj // cost))
        if k <= 0:
            return report
        chosen = cand[:k]
        # the tester batch padded to the policy's width: every sweep solves
        # the same shape however many chips it refreshes
        width = self.sweep_policy.refresh_per_sweep
        padded = np.concatenate([chosen, np.full((width - k,), chosen[0])])
        chips, _ = self._gather_operands(
            padded, st.age_frames[padded].astype(np.float64))
        with self._span("sweep", refreshing=int(k)):
            trims = self._scheduler.recalibrate_fleet(chips)
            rows = to_device_async(chosen.astype(np.int64), self.device)
            st.trim = st.trim.index_copy(0, rows, trims[:k])
        for s in chosen:
            st.recal_count[s] += 1
            st.last_recal_frame[s] = st.age_frames[s]
            st.recal_energy_pj[s] += cost
            # the refreshed chip's post-trim rates are its new normal:
            # re-baseline its monitor
            st.ema_valid[s] = False
            st.baseline_valid[s] = False
            st.rate_err[s] = 0.0
        if self.sweep_policy.maintenance_energy_per_frame_pj is not None:
            self._energy_credit_pj -= k * cost
        self.sweep_count += 1
        report["refreshed"] = [int(st.chip_ids[s]) for s in chosen]
        report["energy_credit_pj"] = float(self._energy_credit_pj)
        self._event("fleet_sweep", eligible=report["eligible"],
                    refreshed=report["refreshed"],
                    energy_credit_pj=report["energy_credit_pj"])
        if self._obs is not None:
            self._obs.counter("fleet_sweeps_total").inc()
            self._obs.counter("fleet_chips_refreshed_total").inc(k)
        return report

    # --- warm restarts -------------------------------------------------------

    def _ckpt_tree(self) -> Dict:
        st = self.state
        return {"chips0": st.chips0, "maps": st.maps, "trim": st.trim,
                **{name: getattr(st, name) for name in _HOST_LEAVES}}

    def save(self, directory: str, step: Optional[int] = None,
             keep: int = 3) -> int:
        """Persist the full fleet through ``checkpoint/manager.py``: the
        stacked chips, maps and trims, ages, telemetry, per-chip rng frame
        clocks and theta carries. Returns the step written."""
        from repro_torch.checkpoint.manager import CheckpointManager
        m = CheckpointManager(directory, keep=keep, async_write=False)
        if step is None:
            latest = m.latest_step()
            step = 0 if latest is None else latest + 1
        extra = {
            "chip_ids": [int(c) for c in self.state.chip_ids],
            "seed": int(self.seed),
            "frames_served": int(self.frames_served),
            "sweep_count": int(self.sweep_count),
            "fused_step_count": int(self.fused_step_count),
            "fused_fallback_count": int(self.fused_fallback_count),
            "energy_credit_pj": float(self._energy_credit_pj),
            # json round-trips Python floats exactly (repr), so the
            # restored carries reproduce the fused stream bit for bit
            "theta_carry": {str(cid): v
                            for cid, v in self._theta_carry.items()},
        }
        m.save(step, {"fleet": self._ckpt_tree()}, extra=extra)
        self._event("checkpoint_save", step=int(step),
                    fleet_size=self.state.size)
        return step

    def load(self, directory: str, step: Optional[int] = None) -> int:
        """Restore a saved fleet into this freshly built engine (the same
        cfg, params and seed as the saver's; a checkpoint of the
        reference's ``FleetEngine`` too). Every chip's stream then resumes
        bit for bit. Returns the step restored."""
        from repro_torch.checkpoint.manager import CheckpointManager
        m = CheckpointManager(directory)
        if step is None:
            step = m.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {directory}")
        extra = m.manifest(step)["extra"]
        if int(extra["seed"]) != int(self.seed):
            raise ValueError(f"checkpoint seed {extra['seed']} != engine "
                             f"seed {self.seed}: streams would diverge")
        # rebuild the registry rows (deterministic identities), then
        # overwrite every leaf with the saved state
        self.state = self._empty_state()
        self._theta_carry.clear()
        for cid in extra["chip_ids"]:
            self.add_chip(int(cid), calibrate=False)
        restored, _ = m.restore(step, {"fleet": self._ckpt_tree()})
        t = restored["fleet"]
        st = self.state
        st.chips0, st.maps, st.trim = t["chips0"], t["maps"], t["trim"]
        for name in _HOST_LEAVES:
            setattr(st, name, np.asarray(t[name]))
        self.frames_served = int(extra["frames_served"])
        self.sweep_count = int(extra["sweep_count"])
        self.fused_step_count = int(extra.get("fused_step_count", 0))
        self.fused_fallback_count = int(extra.get("fused_fallback_count", 0))
        self._energy_credit_pj = float(extra["energy_credit_pj"])
        self._theta_carry = {int(k): float(v)
                             for k, v in extra["theta_carry"].items()}
        self._event("checkpoint_load", step=int(step),
                    fleet_size=self.state.size)
        return step
