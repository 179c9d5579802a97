"""xlstm-350m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H d_ff=0 (blocks carry their own projections)
vocab=50304. Block ratio ~7:1 mLSTM:sLSTM (xLSTM[7:1]); O(1) decode state
-> runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    sub_quadratic=True,
    # 350M params: replicate (DP-only) — TP would shard 4 heads over 16 ranks
    rule_overrides=(("heads", None), ("kv_heads", None), ("rnn", None)),
    source="arXiv:2405.04517; unverified",
)
