"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 (paper-table).

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840.
[arXiv:2501.kimi2; unverified].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    optimizer="adafactor",  # ~1.03T params: AdamW fp32 state would need ~14 TB
    param_dtype="bfloat16",  # fp32 params alone would fill a 256-chip pod (4.1 TB)
    source="arXiv:2501.kimi2; unverified",
)
