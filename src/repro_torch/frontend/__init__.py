"""Unified SensorFrontend API for the P2M first layer (PyTorch port)."""
from repro_torch.frontend.api import (FrontendConfig, SensorFrontend,
                                      differentiable_backends, get_backend,
                                      list_backends, register_backend)
from repro_torch.frontend import backends as _backends  # registers ideal/analog/device/cuda
from repro_torch.frontend.shutter import global_shutter_readout

__all__ = ["FrontendConfig", "SensorFrontend", "differentiable_backends",
           "get_backend", "list_backends", "register_backend",
           "global_shutter_readout"]
