"""Synthetic data pipelines (port of ``repro.data``): ``TokenStream`` for
the LMs, ``ImageStream`` for the vision models."""
from repro_torch.data.synthetic import (ImageStream, TokenStream,
                                        make_image_batch, make_lm_batch)

__all__ = ["ImageStream", "TokenStream", "make_image_batch", "make_lm_batch"]
