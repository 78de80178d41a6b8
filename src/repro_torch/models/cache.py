"""Prefill and single-token decode with caches (the ssm family).

The counterpart of ``repro.models.cache`` for rwkv6.  The cache is stacked
over layers, as in the reference:

  ssm (rwkv6): {"shift_t","shift_c": (L, B, 1, D) f32, "wkv": (L, B, H, dh, dh) f32,
                "pos": () int32}

``prefill`` runs the prompt through every layer (the ``wkv6`` kernel over the
whole prompt) and stores each layer's final states; ``decode_step`` runs one
token from them (the kernel at S = 1) and returns a new cache, leaving the
caller's untouched.  Both run on the parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import apply_norm
from repro_torch.models.model import (_check_family, _embed, _layer_slice,
                                      _logits, cast_params)

_STATE_KEYS = ("shift_t", "shift_c", "wkv")


def init_cache(cfg: ModelConfig, batch: int, device=None):
    """A zero cache on ``device`` (default: the CUDA device).  The reference
    also takes ``max_seq``; the ssm cache does not grow with it."""
    _check_family(cfg)
    dev = resolve_device(device)
    H = cfg.d_model // cfg.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=dev)
    return {"shift_t": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
            "shift_c": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
            "wkv": torch.zeros((cfg.n_layers, batch, H, cfg.rwkv_head_dim,
                                cfg.rwkv_head_dim), **f32),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _stack(states):
    return {k: torch.stack([s[k] for s in states]) for k in _STATE_KEYS}


def prefill(cfg: ModelConfig, params, batch):
    """Process the prompt ``batch["tokens"]`` (B, S); returns (last-token
    logits (B, 1, V), cache)."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    x = _embed(cfg, params, batch["tokens"])
    states = []
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        t, st = rwkv.rwkv_time_mix(cfg, lp, x)
        x = x + t
        c, sc = rwkv.rwkv_channel_mix(cfg, lp, x)
        x = x + c
        states.append({"shift_t": st["shift_t"], "shift_c": sc["shift_c"],
                       "wkv": st["wkv"]})
    cache = {**_stack(states),
             "pos": torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One token: tokens (B, 1) -> (logits (B, 1, V), new cache)."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    x = _embed(cfg, params, tokens)
    states = []
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        t, st = rwkv.rwkv_time_mix(cfg, lp, x, state={"shift_t": cache["shift_t"][i],
                                                      "wkv": cache["wkv"][i]})
        x = x + t
        c, sc = rwkv.rwkv_channel_mix(cfg, lp, x, state={"shift_c": cache["shift_c"][i]})
        x = x + c
        states.append({"shift_t": st["shift_t"], "wkv": st["wkv"],
                       "shift_c": sc["shift_c"]})
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), {**_stack(states), "pos": cache["pos"] + 1}
