from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.vision import VisionEngine

__all__ = ["ServingEngine", "VisionEngine"]
