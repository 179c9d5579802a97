"""SensorFrontend — the single API over the P2M in-pixel first layer.

Port of ``repro.frontend.api``: a registry of backends behind one call,

    frontend = SensorFrontend(FrontendConfig(p2m=..., backend="cuda"))
    params = frontend.init(torch.Generator().manual_seed(0))   # on the GPU
    activations, aux = frontend(params, images, key=key, mode="device")

returning ``(activations, aux)`` with the reference's aux keys, and
``frontend.fleet(params, frames (G, B, H, W, C), keys=...)`` serves G
chips at once, every aux value with a leading chip axis. Stateful
backends (their result is held in MTJ states) go through the global-shutter
burst read. The backends are ``ideal``, ``analog``, ``device`` and ``cuda``
(the hand-kernel counterpart of the reference's ``pallas``); ``ideal`` and
``analog`` are marked differentiable, as the reference marks them: training
runs through them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import p2m
from repro_torch.devices import resolve_device
from repro_torch.frontend import shutter
from repro_torch.variation.chip import VariationConfig

# backend signature: (cfg, params, images, key) -> (activations, aux)
BackendFn = Callable[["FrontendConfig", dict, torch.Tensor, Optional[object]],
                     Tuple[torch.Tensor, Dict]]

_BACKENDS: Dict[str, BackendFn] = {}
# backends with a call over a leading chip axis (one launch for G chips);
# the others serve a fleet a chip at a time
_FLEET_BACKENDS: Dict[str, Callable] = {}
# backends whose result is held in MTJ states (global-shutter burst read)
_STATEFUL: set = set()
# backends that carry straight-through gradients (training runs through them)
_DIFFERENTIABLE: set = set()


def register_backend(name: str, stateful: bool = False,
                     differentiable: bool = False):
    def deco(fn: BackendFn) -> BackendFn:
        _BACKENDS[name] = fn
        if stateful:
            _STATEFUL.add(name)
        if differentiable:
            _DIFFERENTIABLE.add(name)
        return fn
    return deco


def register_fleet_backend(name: str):
    """Register ``name``'s call over a leading chip axis:
    ``(cfg, params, images (G, ...), keys) -> (acts, aux)``, every aux
    value with a leading G."""
    def deco(fn: Callable) -> Callable:
        _FLEET_BACKENDS[name] = fn
        return fn
    return deco


def _chip_params(params: dict, i: int) -> dict:
    """Chip i's frontend params out of a fleet's: its rows of the stacked
    chip, trim and carried theta."""
    out = dict(params)
    if params.get("chip") is not None:
        out["chip"] = type(params["chip"])(*(m[i] for m in params["chip"]))
    for name in ("cal_trim", "theta_carry"):
        if params.get(name) is not None:
            out[name] = params[name][i]
    return out


def get_backend(name: str) -> BackendFn:
    if name not in _BACKENDS:
        raise KeyError(f"unknown frontend backend {name!r}; "
                       f"registered: {list_backends()}")
    return _BACKENDS[name]


def list_backends() -> list:
    return sorted(_BACKENDS)


def differentiable_backends() -> list:
    """Backends training runs through: their gradients reach
    ``params["w"]`` and ``params["v_th"]`` through the straight-through
    spike (``hoyer.spike``), the quantizer's straight-through estimator and
    the Fig. 8 flips' straight-through form (``repro_torch.train.vision``
    refuses any other backend)."""
    return sorted(_DIFFERENTIABLE)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Configuration of the sensor frontend. ``precision`` is the matmul
    precision of the kernel path: ``"f32"`` or ``"int8"`` pins it (int8
    quantizes both packed-matmul operands and runs the int8 kernel A / fused
    kernel; the device chain after the MAC is the same), ``None`` defers to
    the per-shape table of ``repro_torch.kernels.autotune`` (f32 when the
    shape is untuned). ``variation`` / ``chip_id`` select the sampled chip
    the ``analog``, ``device`` and ``cuda`` backends simulate (None: the
    nominal chip); a ``ChipMaps`` in ``params["chip"]`` overrides it at
    call time, and ``params["cal_trim"]`` carries a programmed trim."""
    p2m: p2m.P2MConfig = p2m.P2MConfig()
    backend: str = "cuda"
    global_shutter: bool = True   # run burst_read + reset accounting
    precision: Optional[str] = None
    variation: Optional[VariationConfig] = None
    chip_id: int = 0              # which chip of the population this is


class SensorFrontend:
    """The one surface every consumer of the P2M first layer talks to."""

    def __init__(self, cfg: FrontendConfig = FrontendConfig()):
        get_backend(cfg.backend)   # fail fast on typos
        self.cfg = cfg

    def init(self, generator: torch.Generator, device=None) -> dict:
        """Seeded parameters on ``device``: the GPU unless asked otherwise
        (``device="cpu"``); raises without one."""
        return p2m.init_params(generator, self.cfg.p2m,
                               device=resolve_device(device))

    def __call__(self, params: dict, images: torch.Tensor, *, key=None,
                 mode: Optional[str] = None) -> Tuple[torch.Tensor, Dict]:
        """images (B, H, W, C) in [0, 1] -> (binary activations, aux).
        ``mode`` overrides ``cfg.backend`` for this call."""
        name = mode or self.cfg.backend
        acts, aux = get_backend(name)(self.cfg, params, images, key)
        if self.cfg.global_shutter and name in _STATEFUL:
            # one exposure per batch element: shutter stats are per frame
            acts, shutter_aux = shutter.global_shutter_readout(
                acts, self.cfg.p2m.mtj, frames=acts.shape[0])
            aux = {**aux, **shutter_aux}
        if "channel_rates" not in aux:
            # per-channel rates of the map as read out (the fused kernel
            # emits them itself from its per-block draw counts)
            aux["channel_rates"] = torch.mean(
                acts, dim=tuple(range(acts.ndim - 1)))
        aux["sparsity"] = 1.0 - torch.mean(aux["channel_rates"])
        return acts, aux

    def fleet(self, params: dict, images: torch.Tensor, *, keys=None,
              mode: Optional[str] = None) -> Tuple[torch.Tensor, Dict]:
        """G chips' frames (G, B, H, W, C) -> ``(acts (G, B, H', W', C),
        aux)`` with a leading G on every aux value, chip g's those of the
        single-chip call on its frames with ``keys[g]`` and its rows of
        ``params["chip"]`` (a stacked ``ChipMaps``), ``params["cal_trim"]``
        (G, C) and ``params["theta_carry"]`` (G,), each where present. The
        ``cuda`` backend runs each kernel once for all G chips; the other
        backends run one single-chip call a chip (their draws are the
        chip's own key's, as the reference's vmap of threefry gives)."""
        name = mode or self.cfg.backend
        g = images.shape[0]
        fleet_fn = _FLEET_BACKENDS.get(name)
        if fleet_fn is None:
            get_backend(name)
            outs = [self(_chip_params(params, i), images[i],
                         key=None if keys is None else keys[i], mode=name)
                    for i in range(g)]
            return (torch.stack([o[0] for o in outs]),
                    {k: torch.stack([o[1][k] for o in outs])
                     for k in outs[0][1]})
        acts, aux = fleet_fn(self.cfg, params, images, keys)
        if self.cfg.global_shutter and name in _STATEFUL:
            acts, shutter_aux = shutter.global_shutter_readout(
                acts, self.cfg.p2m.mtj, frames=acts.shape[1], chips=True)
            aux = {**aux, **shutter_aux}
        if "channel_rates" not in aux:
            aux["channel_rates"] = torch.mean(
                acts, dim=tuple(range(1, acts.ndim - 1)))
        aux["sparsity"] = 1.0 - torch.mean(aux["channel_rates"], dim=-1)
        return acts, aux
