"""deepseek-v2-236b [moe]: MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

60L d_model=5120 128H d_ff=1536 (routed expert) vocab=102400. First layer is
dense (d_ff 12288); remaining 59 layers are MoE. MLA: kv_lora_rank=512,
q_lora_rank=1536, decoupled rope head 64.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    block_pattern=("mla",),
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    dense_d_ff=12288,
    # ZeRO-3: expert weights sharded over (pod, data) at rest, gathered per
    # layer — 236B params cannot live EP-only-sharded in 16 GB/chip
    rule_overrides=(("expert_ffn", ("pod", "data")),),
    source="arXiv:2405.04434; hf",
)
