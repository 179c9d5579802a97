"""Global-shutter stage: burst read of stored MTJ states + reset accounting.

Port of ``repro.frontend.shutter``: the activations of stateful backends go
through the divider + comparator read model, and the read/reset energy of
each exposure is accounted per frame.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import energy, mtj


def global_shutter_readout(states: torch.Tensor,
                           mtj_params: mtj.MTJParams = mtj.DEFAULT_MTJ,
                           consts: energy.EnergyConstants =
                           energy.DEFAULT_ENERGY, *,
                           frames: int = 1,
                           chips: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Burst-read ``states`` ({0,1}, 1 = parallel = activated) holding
    ``frames`` exposures. Returns ``(read_bits, stats)``; the stats are per
    frame: ``activated_fraction``, ``reset_pulses`` (activated neurons x
    n_redundant, a neuron-level estimate), ``read_energy_pj`` and
    ``reset_energy_pj``. ``chips=True``: the first axis of ``states`` is a
    chip axis (``frames`` exposures each), and every stat is (G,), chip
    g's those of its own readout (the activated counts are exact sums)."""
    read_bits = mtj.burst_read(states, mtj_params)
    per_chip = states[0] if chips else states
    n_neurons = per_chip.numel() // frames        # per frame
    n_dev = n_neurons * mtj_params.n_redundant
    if chips:
        activated = torch.sum(states, dim=tuple(range(1, states.ndim)))
    else:
        activated = torch.sum(states)
    activated = activated / frames                # per frame
    reset_pulses = activated * mtj_params.n_redundant
    stats = {
        "activated_fraction": activated / n_neurons,
        "reset_pulses": reset_pulses,
        # a fill on the device: a copy from the host would wait for the
        # stream (a host sync in every deferred step)
        "read_energy_pj": torch.full(activated.shape,
                                     n_dev * consts.e_mtj_read_pj,
                                     dtype=torch.float32,
                                     device=states.device),
        "reset_energy_pj": reset_pulses * consts.e_mtj_write_pj,
    }
    return read_bits, stats
