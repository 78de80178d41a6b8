"""Registry mapping ``--arch <id>`` to its ModelConfig: the reference's ten
architectures, in its order."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_reduce

_MODULES = {
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch_id]).ARCH
    assert cfg.arch_id == arch_id, (cfg.arch_id, arch_id)
    return cfg


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_reduce(get_config(arch_id))


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
