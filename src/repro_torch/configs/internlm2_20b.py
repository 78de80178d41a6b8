"""internlm2-20b [dense] — GQA kv=8.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544. [arXiv:2403.17297; hf].
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    source="arXiv:2403.17297; hf",
)
