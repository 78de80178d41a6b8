"""Config dataclasses for architectures and input shapes.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig`` instances in ``SHAPES``. Configs are
plain frozen dataclasses.  A copy of ``repro.configs.base``, field for field,
so that a configuration of either package compares equal as a dict.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu (non-gated)
    rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # a layer uses MoE iff n_experts>0 and (layer % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (jamba): 1 attention layer per `attn_period` layers ---
    attn_period: int = 0  # 0 => every layer is attention (or none for ssm family)
    attn_offset: int = 3  # which sublayer in the period is attention
    # --- mamba ---
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    # --- rwkv ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500  # whisper: 30 s of audio after the conv frontend (stub)
    # --- vlm (paligemma) ---
    n_vision_tokens: int = 0  # prefix patch embeddings (stub frontend)
    # --- training defaults ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor (big archs)
    remat: str = "full"  # none | full
    kv_quant: bool = False  # int8 KV cache (+bf16 per-token-head scales)
    # provenance
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period <= 1:
            return True
        return i % self.attn_period == self.attn_offset % self.attn_period

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts <= 0:
            return False
        return i % self.moe_every == self.moe_offset % self.moe_every

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable, plus the reason if not.

    ``long_500k`` requires sub-quadratic sequence mixing: only SSM/hybrid
    archs qualify. Full-attention archs are skipped
    per the assignment. All archs here have a decoder, so decode shapes apply
    everywhere.
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: pure full-attention arch (no sub-quadratic path)"
    return True, ""


def smoke_reduce(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family for CPU smoke tests."""
    n_layers = min(cfg.n_layers, cfg.attn_period if cfg.attn_period > 1 else 2)
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=96,
        vocab_size=512,
        enc_seq=24,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
        param_dtype="float32",
        compute_dtype="float32",
        rwkv_head_dim=16,
        rwkv_decay_lora=8,
        ssm_dt_rank=8,
    )
    if cfg.n_experts:
        kw.update(n_experts=8, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.is_encoder_decoder:
        kw.update(n_enc_layers=2)
    return cfg.replace(**kw)
