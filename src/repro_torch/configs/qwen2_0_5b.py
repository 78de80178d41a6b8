"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936. [arXiv:2407.10671; hf].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671; hf",
)
