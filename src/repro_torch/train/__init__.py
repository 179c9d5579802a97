"""Training (port of ``repro.train``): the vision SGD loops in
``train.vision``. The LM ``Trainer`` comes with LM training."""
