"""chameleon-34b [vlm]: early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ image
tokenizer is a stub (tokens arrive pre-quantized in the shared vocab); the
paper's P2M binary-spike tokenizer is offered as an alternative front-end in
examples/p2m_frontend.py — this is the arch where the reproduced technique
plugs in (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    p2m_frontend=True,
    source="arXiv:2405.09818; unverified",
)
