"""Training (port of ``repro.train``): the LM ``Trainer`` and
``make_train_step`` in ``train.loop``, the vision SGD loops in
``train.vision``."""
from repro_torch.train.loop import Trainer, make_train_step  # noqa: F401
