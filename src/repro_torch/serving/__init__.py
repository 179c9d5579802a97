from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fleet import FleetEngine, FleetSweepPolicy
from repro_torch.serving.vision import VisionEngine

__all__ = ["FleetEngine", "FleetSweepPolicy", "ServingEngine",
           "VisionEngine"]
