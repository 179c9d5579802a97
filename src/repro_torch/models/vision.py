"""The paper's model zoo: VGG16 / ResNet sparse-BNNs behind the P2M layer.

Port of ``repro.models.vision``. The first layer goes through the
SensorFrontend; every later conv is a 4-bit fake-quantized conv + BN + the
Hoyer binary spike. Eval (serving) uses the stored running stats and a
per-example threshold, so a frame's prediction does not depend on its
batchmates; training (``forward(train=True)``, ``loss_fn``) uses live batch
stats, returns their EMA, and spikes at the layer's global threshold with
the straight-through gradient. ``forward_fleet`` serves G chips' frames
with the frontend per chip and the backbone once over all of them.

The backbone convs are ``F.conv2d`` (the reference leaves them to XLA).
Frames and frontend activations are NHWC and weights HWIO at the public
functions; the backbone views the NHWC map as channels-last NCHW (no copy)
and permutes each HWIO weight to OIHW inside the forward. cuDNN runs with
TF32 off: TF32 would move logits by ~1e-3 against the float32 reference
(the flags here hold for the forward; ``repro_torch.train.vision`` takes
the gradient under the same flags).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import frontend
from repro_torch.core import hoyer, p2m
from repro_torch.kernels import blocking
from repro_torch.models.params import ParamSpec, init_tree
from repro_torch.variation.chip import VariationConfig


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str = "vgg16_cifar10"
    arch: str = "vgg16"       # vgg16 | vgg_tiny | resnet18 | resnet20
    num_classes: int = 10
    in_hw: int = 32
    p2m: p2m.P2MConfig = p2m.P2MConfig()
    frontend_backend: str = "cuda"       # default SensorFrontend backend
    weight_bits: int = 4
    remove_first_maxpool: bool = False   # paper's Model* variants
    hoyer_coeff: float = 1e-8
    bn_momentum: float = 0.9             # EMA decay of the BN running stats
    # the sampled chip this model's sensor frontend simulates; None = the
    # nominal chip
    variation: Optional[VariationConfig] = None
    chip_id: int = 0

    @property
    def frontend(self) -> frontend.FrontendConfig:
        return frontend.FrontendConfig(p2m=self.p2m,
                                       backend=self.frontend_backend,
                                       variation=self.variation,
                                       chip_id=self.chip_id)


_VGG_PLANS = {
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
    "vgg_tiny": [32, "M", 64, "M", 64, "M"],
}
_RESNET_PLAN = {"resnet18": (2, 2, 2, 2), "resnet20": (3, 3, 3)}


def _conv_spec(cin: int, cout: int, k: int = 3) -> Dict[str, Any]:
    return {
        "w": ParamSpec((k, k, cin, cout)),
        "bn_scale": ParamSpec((cout,), init="ones"),
        "bn_bias": ParamSpec((cout,), init="zeros"),
        "bn_mean": ParamSpec((cout,), init="zeros"),
        "bn_var": ParamSpec((cout,), init="ones"),
        "v_th": ParamSpec((), init="ones"),
    }


def model_spec(cfg: VisionConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "p2m": {
            "w": ParamSpec((cfg.p2m.kernel_size, cfg.p2m.kernel_size,
                            cfg.p2m.in_channels, cfg.p2m.out_channels)),
            "v_th": ParamSpec((), init="ones"),
        },
    }
    c_in = cfg.p2m.out_channels
    layers: Dict[str, Any] = {}
    if cfg.arch.startswith("vgg"):
        i = 0
        for item in _VGG_PLANS[cfg.arch]:
            if item == "M":
                continue
            layers[f"conv{i}"] = _conv_spec(c_in, item)
            c_in = item
            i += 1
    else:
        blocks_per = _RESNET_PLAN[cfg.arch]
        widths = [64 * (2 ** i) for i in range(len(blocks_per))] \
            if cfg.arch == "resnet18" else [16, 32, 64]
        for si, (n, w) in enumerate(zip(blocks_per, widths)):
            for bi in range(n):
                blk = {"c1": _conv_spec(c_in, w), "c2": _conv_spec(w, w)}
                if c_in != w:
                    blk["proj"] = _conv_spec(c_in, w, k=1)
                layers[f"s{si}b{bi}"] = blk
                c_in = w
    spec["layers"] = layers
    spec["head"] = {"w": ParamSpec((c_in, cfg.num_classes)),
                    "b": ParamSpec((cfg.num_classes,), init="zeros")}
    return spec


def init_params(seed: int, cfg: VisionConfig, device=None) -> Dict:
    """Seeded random weights (the repo ships no trained ones)."""
    gen = torch.Generator().manual_seed(seed)
    return init_tree(gen, model_spec(cfg), device=device)


def _channel(v: torch.Tensor) -> torch.Tensor:
    """A (C,) per-channel vector shaped to broadcast over NCHW."""
    return v.reshape(1, -1, 1, 1)


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor,
               stride: int) -> torch.Tensor:
    """SAME conv of an NCHW map with an HWIO weight (extra pad high)."""
    k = w_hwio.shape[0]
    (pt, pb), (pl, pr) = blocking.same_pads(x.shape[2], x.shape[3], k, stride)
    w = w_hwio.permute(3, 2, 0, 1)
    if (pt, pl) != (pb, pr):
        x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
    return F.conv2d(x, w, stride=stride, padding=(pt, pl))


def _conv_bn(params: Dict, x: torch.Tensor, stride: int, bits: int,
             train: bool = False, bn_momentum: float = 0.9
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One quantized conv + BN: ``(y, new_stats)``. Eval normalizes with the
    stored running stats (``new_stats`` None); ``train=True`` with the live
    batch statistics over (N, H, W), the population variance as
    ``jnp.var`` takes it, and returns the EMA running stats, detached."""
    w = p2m.quantize_weights(params["w"], bits)
    y = _conv_same(x, w, stride)
    new_stats = None
    if train:
        mu = torch.mean(y, dim=(0, 2, 3))
        var = torch.mean(torch.square(y - _channel(mu)), dim=(0, 2, 3))
        m = bn_momentum
        new_stats = {
            "bn_mean": (m * params["bn_mean"] + (1.0 - m) * mu).detach(),
            "bn_var": (m * params["bn_var"] + (1.0 - m) * var).detach()}
    else:
        mu, var = params["bn_mean"], params["bn_var"]
    y = (y - _channel(mu)) / torch.sqrt(_channel(var) + 1e-5)
    return y * _channel(params["bn_scale"]) + _channel(params["bn_bias"]), \
        new_stats


def _spike_terms(params: Dict, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(z, clip01(z), thr)``: the normalized map and its per-example
    Hoyer threshold, the eval spike's operands."""
    z = y / torch.clamp(params["v_th"], min=1e-6)
    zc = hoyer.clip01(z)
    return z, zc, hoyer.hoyer_extremum(zc, axis=(1, 2, 3), keepdims=True)


def _conv_apply(params: Dict, x: torch.Tensor, stride: int, bits: int,
                binary: bool = True, train: bool = False,
                bn_momentum: float = 0.9
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """One quantized conv + BN + Hoyer spike: ``(out, hoyer term,
    new_stats)``. Eval: stored stats and a per-example threshold (a frame's
    prediction does not depend on its batchmates). ``train=True``: batch
    stats, the EMA stats returned, and the global spike of
    ``hoyer.hoyer_spike`` with its straight-through gradient."""
    y, new_stats = _conv_bn(params, x, stride, bits, train, bn_momentum)
    if not binary:
        return F.relu(y), torch.zeros((), device=y.device), new_stats
    if train:
        o, hl = hoyer.hoyer_spike(y, params["v_th"])
        return o, hl, new_stats
    z, zc, thr = _spike_terms(params, y)
    return (z >= thr).to(y.dtype), hoyer.hoyer_regularizer(zc), new_stats


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """SAME 2x2/2 max-pool: ceil_mode reproduces the high-side -inf pad."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def pooled(x: torch.Tensor, pools: int) -> torch.Tensor:
    """``pools`` max-pools of an NCHW map, each skipped once the map is
    1 pixel high."""
    for _ in range(pools):
        if x.shape[2] > 1:
            x = _maxpool(x)
    return x


def vgg_stages(cfg: VisionConfig) -> List[Tuple[str, int]]:
    """The vgg plan as ``(layer, pools)``: each binary conv after the
    max-pools before it, then ``("head", pools)`` with those after the last
    conv. ``remove_first_maxpool`` drops the plan's first pool."""
    stages, pools, i, first_pool = [], 0, 0, True
    for item in _VGG_PLANS[cfg.arch]:
        if item == "M":
            if not (first_pool and cfg.remove_first_maxpool):
                pools += 1
            first_pool = False
            continue
        stages.append((f"conv{i}", pools))
        pools, i = 0, i + 1
    return stages + [("head", pools)]


def _backbone(params: Dict, x: torch.Tensor, cfg: VisionConfig,
              train: bool = False):
    """The binary conv stack on an NCHW map: ``(features, hoyer total,
    bn_state)``, ``bn_state`` the EMA stats of every layer (train only)."""
    hoyer_total = torch.zeros((), device=x.device)
    bn_state: Dict = {}

    def conv(layer_params, x, binary=True):
        return _conv_apply(layer_params, x, 1, cfg.weight_bits, binary,
                           train, cfg.bn_momentum)

    if cfg.arch.startswith("vgg"):
        for name, pools in vgg_stages(cfg):
            x = pooled(x, pools)
            if name == "head":
                break
            x, hl, st = conv(params["layers"][name], x)
            if train:
                bn_state[name] = st
            hoyer_total = hoyer_total + hl
    else:
        for name in sorted(params["layers"]):
            blk = params["layers"][name]
            h, hl1, st1 = conv(blk["c1"], x)
            h, hl2, st2 = conv(blk["c2"], h)
            sc = x
            blk_state = {"c1": st1, "c2": st2}
            if "proj" in blk:
                sc, _, blk_state["proj"] = conv(blk["proj"], x, binary=False)
            if train:
                bn_state[name] = blk_state
            x = h + sc
            hoyer_total = hoyer_total + hl1 + hl2
    return torch.mean(x, dim=(2, 3)), hoyer_total, bn_state


def forward(params: Dict, images: torch.Tensor, cfg: VisionConfig, *,
            key=None, backend: Optional[str] = None, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """images (B, H, W, C) in [0, 1]; ``key`` a host key
    (``repro_torch.prng``) for the stochastic frontend and the Fig. 8 flips.
    Returns ``(logits, hoyer_loss, aux)`` with the frontend aux (minus the
    loss term) and ``p2m_sparsity``. ``train=True`` switches BN to live
    batch statistics and returns the EMA running stats as
    ``aux["bn_state"]`` (apply them with ``apply_bn_state`` after the
    gradient step); eval, the default, uses the stored stats."""
    fe = frontend.SensorFrontend(cfg.frontend)
    x, fe_aux = fe(params["p2m"], images, key=key, mode=backend)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        feat, hoyer_total, bn_state = _backbone(
            params, x.permute(0, 3, 1, 2), cfg, train)
    logits = feat @ params["head"]["w"] + params["head"]["b"]
    aux = {"p2m_sparsity": fe_aux["sparsity"],
           **{k: v for k, v in fe_aux.items()
              if k not in ("hoyer_loss", "sparsity")}}
    if train:
        aux["bn_state"] = bn_state
    return logits, cfg.hoyer_coeff * (fe_aux["hoyer_loss"] + hoyer_total), aux


def forward_fleet(params: Dict, images: torch.Tensor, cfg: VisionConfig,
                  *, keys=None, backend: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """The eval forward of G chips' frames (G, B, H, W, C): the frontend
    per chip (``SensorFrontend.fleet``: ``params["p2m"]`` may hold the
    chips' stacked ``chip``, ``cal_trim`` and ``theta_carry``; ``keys``
    one host key a chip), then the backbone once over the G * B frames
    (its eval threshold is per example, so a frame's logits do not depend
    on its batch-mates). Returns ``(logits (G, B, classes), aux)``, aux as
    ``forward``'s with a leading G on every value."""
    fe = frontend.SensorFrontend(cfg.frontend)
    x, fe_aux = fe.fleet(params["p2m"], images, keys=keys, mode=backend)
    g, b = x.shape[:2]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        feat, _, _ = _backbone(
            params, x.reshape(g * b, *x.shape[2:]).permute(0, 3, 1, 2), cfg)
    logits = feat @ params["head"]["w"] + params["head"]["b"]
    aux = {"p2m_sparsity": fe_aux["sparsity"],
           **{k: v for k, v in fe_aux.items()
              if k not in ("hoyer_loss", "sparsity")}}
    return logits.reshape(g, b, -1), aux


def apply_bn_state(params: Dict, bn_state: Optional[Dict]) -> Dict:
    """Merge ``aux["bn_state"]`` (EMA running stats from a ``train=True``
    forward) into the parameter tree. Pure: returns a new tree."""
    if not bn_state:
        return params

    def merge(p, s):
        if not isinstance(s, dict):
            return s
        return {k: merge(p[k], s[k]) if k in s else p[k] for k in p}

    return {**params, "layers": merge(params["layers"], bn_state)}


def nll(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of ``label`` under
    ``log_softmax(logits)``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, label.long()[:, None]))


def loss_fn(params: Dict, batch: Dict, cfg: VisionConfig, key=None,
            train: bool = True):
    """The training loss: the NLL of ``log_softmax`` plus the scaled Hoyer
    term, and ``{"loss": nll, "acc": ..., **aux}``. ``key`` reaches the
    frontend (the Fig. 8 flips of ``analog``); ``train=True`` (the
    default) uses live BN stats and returns ``aux["bn_state"]``."""
    logits, hloss, aux = forward(params, batch["image"], cfg, key=key,
                                 train=train)
    label = batch["label"].long()
    loss = nll(logits, label)
    acc = torch.mean((torch.argmax(logits, -1) == label).to(torch.float32))
    return loss + hloss, {"loss": loss, "acc": acc, **aux}
