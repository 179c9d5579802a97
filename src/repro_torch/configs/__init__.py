"""Config registry: ``get_arch("<id>")`` (the port's copy of
``repro.configs``; the ten architecture files are data only)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (ALL_SHAPES, ArchConfig,  # noqa: F401
                                      OptimizerConfig, RunConfig, ShapeSpec)

from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.stablelm_3b import CONFIG as _stablelm
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.kimi_k2_1t import CONFIG as _kimi
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma

ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (
        _chameleon, _granite, _yi, _stablelm, _glm4,
        _deepseek, _kimi, _xlstm, _whisper, _rgemma,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
