"""paligemma-3b [vlm] — SigLIP frontend (stub) + gemma decoder, MQA kv=1.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216. [arXiv:2407.07726; hf].
The SigLIP vision tower is a stub: ``input_specs()`` provides 256 precomputed
patch embeddings that are prepended to the text sequence (prefix-LM mask).
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    n_vision_tokens=256,
    act="gelu_glu",  # gemma uses GeGLU (gated gelu)
    tie_embeddings=True,
    source="arXiv:2407.07726; hf",
)
