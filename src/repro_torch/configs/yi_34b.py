"""yi-34b [dense]: llama-arch GQA [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
56 heads do not divide the 16-way model axis; GSPMD pads (see EXPERIMENTS.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    source="arXiv:2403.04652; hf",
)
