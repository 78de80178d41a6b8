"""Shared model building blocks: dtypes, init, norms and the loss (the part
of ``repro.models.layers`` that the rwkv6 family uses; the MLP and rotary
helpers wait for the other families)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale: float = 1.0,
               *, lead: tuple = ()) -> torch.Tensor:
    """(*lead, d_in, d_out) normal weights of std ``scale / sqrt(d_in)``,
    drawn in float32 on ``gen``'s device, then cast to ``dtype``."""
    std = scale / (d_in ** 0.5)
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


# ---------------------------------------------------------------- norms

def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_params(cfg: ModelConfig, dtype, *, lead: tuple = (), device=None) -> dict:
    shape = (*lead, cfg.d_model)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE in fp32. logits (..., V), labels (...) integer."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
