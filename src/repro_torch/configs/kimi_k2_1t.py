"""kimi-k2-1t-a32b [moe]: trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8, per the assigned table) d_ff=2048 (routed
expert) vocab=163840, 384 experts top-8, 1 shared expert, first layer dense.
Training this on 512 chips requires memory-reduced optimizer state
(factored second moment + bf16 momentum) — see EXPERIMENTS.md §Dry-run.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    num_experts=384,
    num_shared_experts=1,
    top_k=8,
    first_dense_layers=1,
    dense_d_ff=18432,
    # ZeRO-3 expert sharding (see deepseek note) — mandatory at 1T params
    rule_overrides=(("expert_ffn", ("pod", "data")),),
    source="arXiv:2501.kimi2 (paper-table); unverified",
)
