"""Registry mapping ``--arch <id>`` to its ModelConfig.

Only the architectures whose model family the port runs are listed, in the
reference's order; ``jamba-1.5-large-398b`` (hybrid), ``paligemma-3b`` (vlm)
and ``whisper-medium`` (audio) are still to port (ROADMAP queue 1 #2)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_reduce

_MODULES = {
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (ported: "
                       f"{sorted(_MODULES)}); the other families are ROADMAP "
                       f"queue 1 #2")
    cfg = importlib.import_module(_MODULES[arch_id]).ARCH
    assert cfg.arch_id == arch_id, (cfg.arch_id, arch_id)
    return cfg


def get_smoke_config(arch_id: str) -> ModelConfig:
    return smoke_reduce(get_config(arch_id))
