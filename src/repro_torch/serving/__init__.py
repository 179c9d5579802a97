from repro_torch.serving.vision import VisionEngine

__all__ = ["VisionEngine"]
