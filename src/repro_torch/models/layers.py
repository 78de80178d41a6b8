"""Shared model building blocks: dtypes, init, norms, rotary and sinusoidal
position embeddings, the MLP and the loss (the counterpart of
``repro.models.layers``).

The reference's ``stacked`` (a ``vmap`` of a per-layer init) is the ``lead=``
argument here: every init draws its leaves with the leading axes ``lead``
(``(n_layers,)`` for a layer stack) in one call.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.counting import fake_mode_active


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale: float = 1.0,
               *, lead: tuple = ()) -> torch.Tensor:
    """(*lead, d_in, d_out) normal weights of std ``scale / sqrt(d_in)``,
    drawn in float32 on ``gen``'s device, then cast to ``dtype``.  Scaled in
    place: a large leaf (one Jamba block's experts, 3.2B elements) holds one
    float32 temporary beside its cast, not two."""
    std = scale / (d_in ** 0.5)
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)


def mm(a, b):
    """``a @ b`` with JAX's dtype promotion (bfloat16 @ float32 is float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


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


# ---------------------------------------------------------------- rotary

def rope_freqs(dh: int, theta: float, device=None):
    """(dh/2,) float32 inverse frequencies, the power taken in float32."""
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh); positions: (..., S) integers.  Rotates the two
    halves of each head (not interleaved pairs), angles in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    ang = positions.float()[..., None] * freqs  # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device=None):
    """Whisper-style absolute sinusoidal embeddings, (seq, d_model) float32.
    Built with torch on the CPU in the reference's operation order, then
    moved to ``device``: angles reach ``seq`` rad, where one ulp of the
    power moves ``sin`` / ``cos`` by ~1e-4, so the card and the CPU share
    the CPU's bits.  Cached per (seq, d_model, device), so a decode step
    neither rebuilds the table nor waits on its copy; callers must not
    write into the returned tensor.  Under fake tensors (the dry run) it is
    built anew: a fake table belongs to its own fake mode."""
    if fake_mode_active():
        return _sinusoidal_positions.__wrapped__(seq, d_model, device)
    return _sinusoidal_positions(seq, d_model, device)


@functools.lru_cache(maxsize=16)
def _sinusoidal_positions(seq: int, d_model: int, device=None):
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    i = torch.arange(d_model // 2, dtype=torch.float32)[None, :]
    ang = pos / (10000.0 ** (2 * i / d_model))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device)


# ---------------------------------------------------------------- MLP

def mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype, *, lead: tuple = ()):
    """The MLP sublayer's parameters (a gated pair for ``swiglu`` /
    ``gelu_glu``, one projection with biases for plain ``gelu``)."""
    dev = gen.device
    D, F_ = cfg.d_model, cfg.d_ff
    p = {"ln": norm_params(cfg, dtype, lead=lead, device=dev)}
    p["wi"] = dense_init(gen, D, F_, dtype, lead=lead)
    if cfg.act in ("swiglu", "gelu_glu"):
        p["wg"] = dense_init(gen, D, F_, dtype, lead=lead)
    else:  # plain gelu (whisper)
        p["bi"] = torch.zeros((*lead, F_), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((*lead, D), dtype=dtype, device=dev)
    p["wo"] = dense_init(gen, F_, D, dtype, 1.0 / max(cfg.n_layers, 1) ** 0.5, lead=lead)
    return p


def mlp_apply(cfg: ModelConfig, p, x):
    """Pre-norm MLP sublayer (no residual add).  ``jax.nn.gelu`` is the tanh
    approximation by default, and so is this one."""
    x = apply_norm(cfg, p["ln"], x)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif cfg.act == "gelu_glu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"] + p["bi"].to(x.dtype), approximate="tanh")
    out = h @ p["wo"]
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out


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
