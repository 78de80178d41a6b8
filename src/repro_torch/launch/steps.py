"""Step functions for serving: prefill and one greedy decode step (the
serving part of ``repro.launch.steps``; the train step waits for training)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as cache_mod


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return cache_mod.prefill(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        logits, new_cache = cache_mod.decode_step(cfg, params, cache, batch["tokens"])
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache
    return decode_step
