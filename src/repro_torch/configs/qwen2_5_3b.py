"""qwen2.5-3b [dense] — GQA kv=2, QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936. [hf:Qwen/Qwen2.5-3B; hf].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
