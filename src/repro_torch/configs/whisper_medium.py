"""whisper-medium [audio] — encoder-decoder, conv frontend (stub), MHA.

24L (x2: encoder+decoder) d_model=1024 16H d_ff=4096 vocab=51865.
[arXiv:2212.04356; unverified]. The conv audio frontend is a stub:
``input_specs()`` provides 1500 precomputed frame embeddings (30 s of audio).
The assigned seq_len applies to the decoder side.
"""
from repro_torch.configs.base import ModelConfig

ARCH = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    rope=False,  # whisper uses learned/sinusoidal absolute positions
    is_encoder_decoder=True,
    n_enc_layers=24,
    enc_seq=1500,
    source="arXiv:2212.04356; unverified",
)
