"""Reduced (smoke-test) variants of every architecture.

Same family/block structure, tiny dims — instantiable on one CPU device.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config, preserving its structural family."""
    layers = max(2, len(cfg.block_pattern))
    if cfg.first_dense_layers > 0:
        layers = max(layers, cfg.first_dense_layers + 2)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    if heads % kv:
        kv = 1
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        dense_d_ff=128 if cfg.dense_d_ff else 0,
        vocab_size=256,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else 64,
        num_experts=8 if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.encoder_layers else 1500,
        window=16 if cfg.window else 0,
        q_chunk=16,
        kv_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
