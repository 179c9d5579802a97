"""Optimizers and gradient compression (port of ``repro.optim``)."""
from repro_torch.optim.compression import (compress_int8,  # noqa: F401
                                           compressed_psum_bytes,
                                           decompress_int8)
from repro_torch.optim.optimizer import (OptState, apply_updates,  # noqa: F401
                                         init_opt_state, lr_schedule)
