"""Monte-Carlo yield analysis over sampled chips (port of
``repro.variation.yield_analysis``).

The 8-MTJ majority holds both activation-error modes under 0.1% for the
nominal device (Fig. 5). Over a population of sampled chips, what fraction
still meets that spec, and what does the end task lose?

    rows = yield_sweep(vcfg, sigmas=(0.5, 1.0, 2.0), n_chips=64, n_channels=32)

At each sigma point the G chips' maps are drawn as one stack with a leading
(G,) axis (``chip.sample_chips``; only the keys are derived a chip at a
time, on the host) and their statistics reduced in one batched pass, the
counterpart of the reference's ``vmap`` of ``chip_stats`` over chip ids:

    fail_rate / false_rate   mean and worst per-channel majority error
    read_margin_mv           worst burst-read sense margin (R_P / TMR spread)
    yield_fraction           chips whose worst channel meets ``error_budget``
                             and whose every device still reads correctly

``accuracy_sweep`` runs a model through the ``device`` backend on sampled
chips, calibrated and not, and reports task accuracy against sigma.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.core import mtj as mtj_model
from repro_torch.devices import resolve_device
from repro_torch.variation import chip as chip_mod
from repro_torch.variation.chip import VariationConfig


def read_margin(chip: chip_mod.ChipMaps,
                mtj_params: mtj_model.MTJParams = mtj_model.DEFAULT_MTJ,
                r_load: float = 6.0e3) -> torch.Tensor:
    """Per-device burst-read sense margin (volts), negative = misread: the
    smaller of (V_P - thr) and (thr - V_AP) against the one nominal
    comparator threshold, each device's levels at its R_P / TMR corner."""
    thr = mtj_model.comparator_threshold(mtj_params, r_load)
    device = chip.r_p_scale.device
    v_p = mtj_model.read_voltage_divider(
        torch.ones((), device=device), mtj_params, r_load,
        r_p_scale=chip.r_p_scale, tmr_scale=chip.tmr_scale)
    v_ap = mtj_model.read_voltage_divider(
        torch.zeros((), device=device), mtj_params, r_load,
        r_p_scale=chip.r_p_scale, tmr_scale=chip.tmr_scale)
    return torch.minimum(v_p - thr, thr - v_ap)              # (..., C, n)


def trimmed_chip(chip: chip_mod.ChipMaps) -> chip_mod.ChipMaps:
    """The chip as the tester leaves it: the trim cancels the channel-level
    offsets (the subtractor offset with its column noise, and the channel
    mean of the MTJ logit offsets); per-device residuals and the gain,
    slope and resistance spreads remain. The idealized endpoint of
    ``calibrate`` for the analytic statistics; works on a stack too."""
    return chip._replace(
        pixel_offset=torch.zeros_like(chip.pixel_offset),
        mtj_logit_offset=chip.mtj_logit_offset
        - torch.mean(chip.mtj_logit_offset, dim=-1, keepdim=True))


def _stats(chip: chip_mod.ChipMaps, mtj_params: mtj_model.MTJParams,
           r_load: float) -> Dict[str, torch.Tensor]:
    """``chip_stats``' numbers of a chip, or of each chip of a stack (the
    reductions run over the per-chip axes only)."""
    p_fail, p_false = chip_mod.noise_maps(chip, mtj_params)
    p_fail_c, p_false_c = chip_mod.noise_maps(trimmed_chip(chip), mtj_params)
    margin = read_margin(chip, mtj_params, r_load)
    return {"fail_worst": torch.amax(p_fail, dim=-1),
            "fail_mean": torch.mean(p_fail, dim=-1),
            "false_worst": torch.amax(p_false, dim=-1),
            "false_mean": torch.mean(p_false, dim=-1),
            "fail_worst_cal": torch.amax(p_fail_c, dim=-1),
            "false_worst_cal": torch.amax(p_false_c, dim=-1),
            "read_margin_min": torch.amin(margin, dim=(-2, -1))}


def chip_stats(vcfg: VariationConfig, chip_id: int, n_channels: int,
               mtj_params: mtj_model.MTJParams = mtj_model.DEFAULT_MTJ,
               r_load: float = 6.0e3, device=None) -> Dict[str, torch.Tensor]:
    """Analytic spec numbers of one sampled chip, raw and with the
    idealized trim (``*_cal``), as 0-d tensors on ``device`` (the GPU
    unless asked otherwise). Read margins do not depend on the trim."""
    chip = chip_mod.sample_chip(vcfg, n_channels, mtj_params.n_redundant,
                                chip_id, device=device)
    return _stats(chip, mtj_params, r_load)


def yield_sweep(vcfg: VariationConfig, sigmas: Sequence[float],
                n_chips: int, n_channels: int,
                mtj_params: mtj_model.MTJParams = mtj_model.DEFAULT_MTJ,
                *, error_budget: float = 1e-3, r_load: float = 6.0e3,
                device=None) -> List[Dict[str, float]]:
    """Monte-Carlo fleet statistics at each sigma scale, on ``device`` (the
    GPU unless asked otherwise). ``sigmas`` scale the whole profile
    (``VariationConfig.scaled``); at each point chips 0 .. n_chips - 1 are
    drawn as one stack and reduced at once. A chip yields when its worst
    channel keeps both error modes under ``error_budget`` and every
    device's read margin stays positive."""
    device = resolve_device(device)
    rows: List[Dict[str, float]] = []
    for s in sigmas:
        chips = chip_mod.sample_chips(vcfg.scaled(float(s)), n_channels,
                                      mtj_params.n_redundant,
                                      range(n_chips), device=device)
        st = _stats(chips, mtj_params, r_load)
        read_ok = st["read_margin_min"] > 0.0
        ok = ((st["fail_worst"] < error_budget)
              & (st["false_worst"] < error_budget) & read_ok)
        ok_cal = ((st["fail_worst_cal"] < error_budget)
                  & (st["false_worst_cal"] < error_budget) & read_ok)
        vals = torch.stack([
            torch.mean(ok.to(torch.float32)),
            torch.mean(ok_cal.to(torch.float32)),
            torch.max(st["fail_worst"]), torch.mean(st["fail_mean"]),
            torch.max(st["false_worst"]), torch.mean(st["false_mean"]),
            torch.max(st["fail_worst_cal"]), torch.max(st["false_worst_cal"]),
            torch.min(st["read_margin_min"])]).tolist()   # one host copy
        rows.append({
            "sigma_scale": float(s),
            "yield_fraction": vals[0],
            "yield_fraction_calibrated": vals[1],
            "fail_worst": vals[2], "fail_mean": vals[3],
            "false_worst": vals[4], "false_mean": vals[5],
            "fail_worst_cal": vals[6], "false_worst_cal": vals[7],
            "read_margin_min_mv": vals[8] * 1e3,
        })
    return rows


def accuracy_sweep(params, vis_cfg, batches: Iterable[Dict], *,
                   vcfg: VariationConfig, sigmas: Sequence[float],
                   n_chips: int, calibration_frames: Optional[torch.Tensor],
                   key, cal_iters: int = 12, device=None
                   ) -> List[Dict[str, float]]:
    """End-task accuracy against sigma, calibrated and uncalibrated, on
    ``device`` (the GPU unless asked otherwise). For each sigma and chip id
    the model runs through the ``device`` backend on that chip; with
    ``calibration_frames`` the same chip runs again with its solved trim.
    ``batches`` are ``{"image", "label"}`` eval batches, reused across
    chips so the comparison is paired; ``key`` a host key (``prng``)."""
    import dataclasses as _dc

    # deferred: models -> frontend -> variation would import in a cycle
    from repro_torch.models import vision
    from repro_torch.models.params import to_device
    from repro_torch.variation.calibrate import apply_calibration, calibrate

    device = resolve_device(device)
    params = to_device(params, device)
    batches = [{k: torch.as_tensor(v, device=device) for k, v in b.items()}
               for b in batches]
    rows: List[Dict[str, float]] = []
    for s in sigmas:
        v = vcfg.scaled(float(s))
        accs: Dict[str, List[float]] = {"uncal": [], "cal": []}
        for cid in range(n_chips):
            cfg_chip = _dc.replace(vis_cfg, variation=v, chip_id=cid)
            variants = {"uncal": params}
            if calibration_frames is not None:
                art = calibrate(params["p2m"], vis_cfg.p2m, v,
                                calibration_frames, chip_id=cid,
                                iters=cal_iters, device=device)
                variants["cal"] = {
                    **params, "p2m": apply_calibration(params["p2m"], art)}
            for tag, pp in variants.items():
                correct = total = 0
                for j, b in enumerate(batches):
                    k = prng.fold_in(key, (cid * 997 + j) * 2
                                     + (tag == "cal"))
                    with torch.no_grad():
                        logits, _, _ = vision.forward(
                            pp, b["image"], cfg_chip, backend="device", key=k)
                    correct += int(torch.sum(torch.argmax(logits, -1)
                                             == b["label"]))
                    total += int(b["label"].shape[0])
                accs[tag].append(correct / total)
        row = {"sigma_scale": float(s),
               "acc_uncalibrated": sum(accs["uncal"]) / len(accs["uncal"])}
        if accs["cal"]:
            row["acc_calibrated"] = sum(accs["cal"]) / len(accs["cal"])
        rows.append(row)
    return rows
