"""Registry mapping ``--arch <id>`` to its ModelConfig.

Only the architectures whose model family the port runs are listed; the
others are still to port (ROADMAP queue 1 #2)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, smoke_reduce

_MODULES = {
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
