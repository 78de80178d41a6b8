"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
[arXiv:2403.19887; hf]. Block structure follows Jamba: period-8 blocks with one
attention sublayer; MoE on every second sublayer (e=2), dense FFN otherwise.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=3,
    ssm_d_state=16,
    ssm_conv=4,
    ssm_expand=2,
    optimizer="adafactor",  # 398B params: AdamW fp32 state would not fit one pod
    param_dtype="bfloat16",
    source="arXiv:2403.19887; hf",
)
