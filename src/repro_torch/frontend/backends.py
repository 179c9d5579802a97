"""The ``cuda`` SensorFrontend backend (port of ``repro.frontend.backends``'s
``pallas`` backend).

The patch matmul runs once, in kernel A, which also emits the Hoyer
partials; theta is combined on the device; kernel B draws the activations
and emits the V_CONV partials. With ``params["theta_carry"]`` set (only
``VisionEngine.stream`` plants it) the step is the single fused kernel at
the carried threshold, and aux still carries the FRESH theta for the
engine's drift guard. Chip variation and calibration trim operands come
with the variation slice and are refused here, not ignored.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import p2m
from repro_torch.frontend.api import FrontendConfig, register_backend
from repro_torch.kernels import ops


def _v_conv_stats(v: torch.Tensor) -> Dict:
    """Statistics of the subtractor voltage driving the VC-MTJ."""
    return {"v_conv_mean": torch.mean(v), "v_conv_min": torch.min(v),
            "v_conv_max": torch.max(v)}


@register_backend("cuda", stateful=True)
def cuda_backend(cfg: FrontendConfig, params: dict, images: torch.Tensor,
                 key: Optional[object]) -> Tuple[torch.Tensor, Dict]:
    """The hand-written CUDA kernel pipeline (plain PyTorch on CPU tensors)."""
    if key is None:
        raise ValueError("the 'cuda' backend is stochastic — pass key=")
    for name in ("chip", "cal_trim"):
        if params.get(name) is not None:
            raise NotImplementedError(
                f"params[{name!r}]: chip variation and calibration operands "
                "are not ported yet")
    pcfg = cfg.p2m
    wq = p2m.quantize_weights(params["w"], pcfg.weight_bits)
    kw = dict(kernel=pcfg.kernel_size, stride=pcfg.stride,
              pixel_params=pcfg.pixel, mtj_params=pcfg.mtj,
              precision=cfg.precision)
    carry = params.get("theta_carry")
    if carry is not None:
        o, kernel_aux = ops.p2m_frontend_fused(images, wq, params["v_th"],
                                               carry, key, **kw)
    else:
        o, kernel_aux = ops.p2m_frontend(images, wq, params["v_th"], key, **kw)
    return o, {"hoyer_loss": torch.zeros((), device=images.device),
               **kernel_aux}
