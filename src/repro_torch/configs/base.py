"""Architecture and shape configs: the port's copy of ``repro.configs.base``.

``ArchConfig`` describes a model architecture; ``ShapeSpec`` a serving or
training shape. Both are frozen dataclasses, overridable with
``dataclasses.replace``. The fields are the reference's, held equal to it by
``tests/test_torch_lm.py`` (``dataclasses.asdict`` against
``dataclasses.asdict``), so a fork of any number fails a test. ``dtype`` /
``pdtype`` return torch dtypes. ``OptimizerConfig`` and ``RunConfig`` are
the training run's, held equal to the reference's by
``tests/test_torch_train_lm.py``, but for ``RunConfig.checkpoint_dir``,
whose default lies under the process's temporary directory (``TMPDIR``)
rather than a fixed path.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // num_heads
    # mixer selection: per-layer pattern, cycled over the (post-prefix) depth
    block_pattern: Tuple[str, ...] = ("attn",)   # attn|mla|local_attn|rglru|mlstm|slstm
    window: int = 2048               # local-attention window
    # MLA (DeepSeek-style latent attention)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    first_dense_layers: int = 0      # leading dense layers before MoE starts
    dense_d_ff: int = 0              # d_ff of those dense layers (0 -> d_ff)
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0          # > 0 => enc-dec; num_layers = decoder depth
    encoder_seq: int = 1500          # stub frame count for the audio frontend
    # misc
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    mlp_gated: bool = True           # SwiGLU; False -> plain GELU (whisper)
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # P2M front-end (the paper's technique) applicability
    p2m_frontend: bool = False
    # shapes
    sub_quadratic: bool = False      # eligible for long_500k
    # per-arch sharding rule overrides (logical axis -> mesh axes)
    rule_overrides: Tuple[Tuple[str, object], ...] = ()
    # remat policy: "none" | "full" | "dots"
    remat: str = "full"
    # the reference's switch from a scan over layers to a Python loop (the
    # port always loops)
    force_unroll: bool = False
    # attention chunk sizes for the online-softmax implementation
    q_chunk: int = 512
    kv_chunk: int = 1024
    source: str = ""                 # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """(mixer, mlp) kind per decoder layer."""
        kinds = []
        for i in range(self.num_layers):
            mixer = self.block_pattern[i % len(self.block_pattern)]
            if self.num_experts > 0 and i >= self.first_dense_layers:
                mlp = "moe"
            elif mixer in ("mlstm", "slstm"):
                mlp = "none"     # xLSTM blocks carry their own projections
            else:
                mlp = "dense"
            kinds.append((mixer, mlp))
        return tuple(kinds)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"              # adamw | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # memory-reduced state
    factored_second_moment: bool = False   # Adafactor-style row/col factoring
    momentum_dtype: str = "float32"        # "bfloat16" to halve mu
    use_momentum: bool = True              # False: pure Adafactor (no mu)
    # int8 gradient compression with error feedback
    grad_compression: bool = False


@dataclasses.dataclass(frozen=True)
class RunConfig:
    arch: ArchConfig
    shape: ShapeSpec = TRAIN_4K
    optimizer: OptimizerConfig = OptimizerConfig()
    microbatches: int = 1            # gradient accumulation
    seed: int = 0
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
