"""glm4-9b [dense]: RoPE, GQA [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
kv=2 cannot shard over the 16-way model axis -> KV replicated (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    source="hf:THUDM/glm-4-9b; hf",
)
