"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536. [arXiv:2404.05892; unverified].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rope=False,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    source="arXiv:2404.05892; unverified",
)
