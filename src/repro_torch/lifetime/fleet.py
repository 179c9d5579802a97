"""Fleet-lifetime analysis: what a population of aging sensors loses, and
what recalibration buys back (port of ``repro.lifetime.fleet``).

    rate_error_vs_age    per-chip mean and worst channel |rate - target| at
                         each age, with the stale t = 0 trim and with a trim
                         re-solved at that age
    time_to_failure      each chip's first age whose worst-channel error
                         exceeds a budget: the fleet's lifetime distribution
    accuracy_vs_age      end-task accuracy through the ``device`` backend on
                         aged chips, stale trim against a refreshed one

``rate_error_vs_age`` evaluates the whole fleet as one stack of chips (the
counterpart of the reference's ``vmap`` over chip ids): the chips and their
drift maps are drawn with a leading (K,) axis, every bisection solves all K
chips' trims at once, and the surfaces come to the host in one copy at the
end. ``accuracy_vs_age`` loops over chips, ages and batches, as the
reference's Monte-Carlo eval does.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import hoyer, p2m
from repro_torch.devices import resolve_device
from repro_torch.lifetime.drift import (DriftConfig, evolve_chip,
                                        sample_drift_maps)
from repro_torch.models.params import to_device
from repro_torch.variation.calibrate import (channel_rates, solve_trim,
                                             target_rates)
from repro_torch.variation.chip import (VariationConfig, sample_chip,
                                        sample_chips)

SURFACES = ("err_stale_mean", "err_stale_worst", "err_recal_mean",
            "err_recal_worst")


def _calibration_operands(w, v_th, frames, pcfg: p2m.P2MConfig):
    """u, theta and the target rates of the calibration frames."""
    u = p2m.hardware_conv(frames, w, pcfg)
    theta = hoyer.effective_threshold(u, v_th) * v_th
    return u, theta, target_rates(u, theta, pcfg)


def fleet_surfaces(params: Dict, pcfg: p2m.P2MConfig, vcfg: VariationConfig,
                   dcfg: DriftConfig, frames, ages: Sequence[float],
                   n_chips: int, *, iters: int = 12, span: float = 2.0,
                   device=None) -> Dict[str, torch.Tensor]:
    """``rate_error_vs_age``'s surfaces as (K, A) tensors on ``device``,
    with the trims they were measured at: ``trim0`` (K, C), the birth
    trims, and ``trim_t`` (A, K, C), the trims re-solved at each age."""
    device = resolve_device(device)
    weights = to_device({"w": params["w"], "v_th": params["v_th"]}, device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=device)
    u, theta, ref = _calibration_operands(weights["w"], weights["v_th"],
                                          frames, pcfg)
    c, n = pcfg.out_channels, pcfg.mtj.n_redundant
    ids = list(range(n_chips))
    chip0 = sample_chips(vcfg, c, n, ids, device=device)
    maps = sample_drift_maps(dcfg, c, n, ids, device=device)
    trim0 = solve_trim(u, theta, chip0, ref, pcfg, iters=iters, span=span)
    rows: Dict[str, List[torch.Tensor]] = {k: [] for k in SURFACES}
    trims = []
    for t in ages:                     # a small grid: one pass an age
        aged = evolve_chip(chip0, maps, float(t), dcfg=dcfg)
        trim_t = solve_trim(u, theta, aged, ref, pcfg, iters=iters,
                            span=span)
        trims.append(trim_t)
        for tag, trim in (("stale", trim0), ("recal", trim_t)):
            err = torch.abs(channel_rates(u, theta, aged, trim, pcfg) - ref)
            rows[f"err_{tag}_mean"].append(torch.mean(err, dim=-1))
            rows[f"err_{tag}_worst"].append(torch.amax(err, dim=-1))
    return {**{k: torch.stack(v, dim=1) for k, v in rows.items()},
            "trim0": trim0, "trim_t": torch.stack(trims)}


def rate_error_vs_age(params: Dict, pcfg: p2m.P2MConfig,
                      vcfg: VariationConfig, dcfg: DriftConfig, frames,
                      ages: Sequence[float], n_chips: int, *,
                      iters: int = 12, span: float = 2.0,
                      device=None) -> Dict[str, np.ndarray]:
    """The fleet's rate-error surfaces over the age grid, on ``device``
    (the GPU unless asked otherwise). ``params`` = ``{"w", "v_th"}``,
    ``frames`` the calibration batch. Chips 0 .. n_chips - 1 are born
    (``sample_chip``), trimmed at t = 0, then measured at each age with
    that stale trim and with a trim re-solved against the aged chip.
    Returns ``(n_chips, n_ages)`` float32 arrays ``err_stale_mean``,
    ``err_stale_worst``, ``err_recal_mean`` and ``err_recal_worst``."""
    surf = fleet_surfaces(params, pcfg, vcfg, dcfg, frames, ages, n_chips,
                          iters=iters, span=span, device=device)
    host = torch.stack([surf[k] for k in SURFACES]).cpu().numpy()
    return dict(zip(SURFACES, host))


def time_to_failure(err_worst: np.ndarray, ages: Sequence[float],
                    budget: float) -> Dict[str, float]:
    """Fleet lifetime distribution from an ``(n_chips, n_ages)`` surface: a
    chip fails at the first grid age whose worst-channel error exceeds
    ``budget``; chips that never fail report the horizon (right-censored,
    ``survivor_fraction`` says how many)."""
    ages_f = np.asarray([float(t) for t in ages])
    failed = np.asarray(err_worst) > budget           # (n_chips, n_ages)
    any_fail = failed.any(axis=1)
    first = np.where(any_fail, failed.argmax(axis=1), len(ages_f) - 1)
    ttf = ages_f[first]
    return {
        "budget": float(budget),
        "survivor_fraction": float(1.0 - any_fail.mean()),
        "ttf_frames_p10": float(np.percentile(ttf, 10)),
        "ttf_frames_p50": float(np.percentile(ttf, 50)),
        "ttf_frames_p90": float(np.percentile(ttf, 90)),
    }


def accuracy_vs_age(params, vis_cfg, batches: Iterable[Dict], *,
                    vcfg: VariationConfig, dcfg: DriftConfig,
                    ages: Sequence[float], n_chips: int,
                    calibration_frames, key, cal_iters: int = 12,
                    cal_span: float = 2.0,
                    device=None) -> List[Dict[str, float]]:
    """End-task accuracy along the age axis, stale trim against refreshed
    trim, on ``device`` (the GPU unless asked otherwise). Each chip is
    calibrated at birth; at every age the aged chip runs through the
    ``device`` backend with the birth trim and with a trim re-solved
    against it, the chip and trim in ``params["p2m"]`` (``"chip"``,
    ``"cal_trim"``). Batches (``{"image", "label"}``) and keys are paired
    across the variants: ``fold_in(key, (ci * 131 + ai) * 7 + j)``."""
    from repro_torch.models import vision   # models -> frontend -> lifetime

    device = resolve_device(device)
    params = to_device(params, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in batches]
    pcfg = vis_cfg.p2m
    c, n = pcfg.out_channels, pcfg.mtj.n_redundant
    frames = torch.as_tensor(calibration_frames, dtype=torch.float32,
                             device=device)
    u, theta, ref = _calibration_operands(params["p2m"]["w"],
                                          params["p2m"]["v_th"], frames, pcfg)

    def solve(chip):
        return solve_trim(u, theta, chip, ref, pcfg, iters=cal_iters,
                          span=cal_span)

    accs = {tag: np.zeros((len(ages), n_chips)) for tag in ("stale", "recal")}
    for ci in range(n_chips):
        chip0 = sample_chip(vcfg, c, n, ci, device=device)
        maps = sample_drift_maps(dcfg, c, n, ci, device=device)
        trim0 = solve(chip0)
        for ai, t in enumerate(ages):
            aged = evolve_chip(chip0, maps, float(t), dcfg=dcfg)
            for tag, trim in (("stale", trim0), ("recal", solve(aged))):
                pp = {**params, "p2m": {**params["p2m"], "chip": aged,
                                        "cal_trim": trim}}
                correct = total = 0
                for j, b in enumerate(batches):
                    k = prng.fold_in(key, (ci * 131 + ai) * 7 + j)
                    with torch.no_grad():
                        logits, _, _ = vision.forward(
                            pp, b["image"], vis_cfg, backend="device", key=k)
                    correct += int(torch.sum(torch.argmax(logits, -1)
                                             == b["label"]))
                    total += int(b["label"].shape[0])
                accs[tag][ai, ci] = correct / total
    return [{"age_frames": float(t),
             "acc_stale": float(accs["stale"][ai].mean()),
             "acc_recal": float(accs["recal"][ai].mean())}
            for ai, t in enumerate(ages)]
