"""whisper-base [audio]: enc-dec, conv frontend (STUB) [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865. The conv/mel
frontend is a stub per the brief: input_specs() provides precomputed frame
embeddings (B, 1500, 512). Full attention -> long_500k skipped. The paper's
P2M binary front-end is demonstrated for audio frames in examples/.
GELU (non-gated) MLPs; small dims -> shard ffn, replicate heads.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,
    mlp_gated=False,
    p2m_frontend=True,
    rule_overrides=(("heads", None), ("kv_heads", None)),
    source="arXiv:2212.04356; unverified",
)
