"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840.
[hf:moonshotai/Moonlight-16B-A3B; hf].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
