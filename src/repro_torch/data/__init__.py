"""Synthetic data pipelines (port of ``repro.data``): ``ImageStream`` for
the vision models. ``TokenStream`` comes with LM training."""
from repro_torch.data.synthetic import ImageStream, make_image_batch

__all__ = ["ImageStream", "make_image_batch"]
