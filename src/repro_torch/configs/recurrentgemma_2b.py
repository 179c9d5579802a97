"""recurrentgemma-2b [hybrid]: RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1 == MQA) d_ff=7680 vocab=256000; pattern
(rec, rec, local-attn) with a 2048-token window; O(1) recurrent state +
ring-buffer window cache -> runs long_500k.
10 heads don't divide 16 -> shard ffn/rnn, replicate heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    sub_quadratic=True,
    rule_overrides=(("heads", None), ("kv_heads", None)),
    source="arXiv:2402.19427; hf",
)
