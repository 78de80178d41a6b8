"""Model wiring: init / forward for the ported families.

Families:
  dense | moe : uniform decoder layers (attention + MLP-or-MoE)
  ssm (rwkv6) : time-mix + channel-mix layers

The counterpart of ``repro.models.model`` for these families: parameters
are nested dicts of tensors with the reference's keys and its layer-stacked
layout (a leading ``n_layers`` axis on every leaf under ``"layers"``), so a
reference parameter tree carries across one to one (``params_from_numpy``).
The layer stack is a plain Python loop over the stacked leaves, unbound once
(so that the backward stacks each leaf's gradient once).  With
``cfg.remat == "full"`` and autograd on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` in ``_scan_layers``: only a layer's input is
kept, and the backward recomputes the layer (its ``wkv6`` or its attention
and MoE routing included).  A uniform-MoE arch (every layer MoE) has
``"moe"`` in place of ``"mlp"`` in each layer, and ``forward`` returns the
sum of the layers' aux losses.  The reference's ``unroll`` and
sequence-sharding switches belong to its XLA cost analysis and to sharding,
which are not ported.  The vlm, hybrid and audio families raise
``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (apply_norm, cross_entropy, dtype_of, mlp_apply,
                                       mlp_params, norm_params)

# Param leaves kept in fp32 regardless of compute dtype (routing / SSM dynamics
# / norm statistics are precision-sensitive).
_FP32_KEEP = {"wr", "alog", "u", "w0", "gn_scale", "dskip", "scale", "bias"}
PORTED_FAMILIES = ("dense", "moe", "ssm")
ATTENTION_FAMILIES = ("dense", "moe")
BLOCK_KV = 2048   # keys a chunk of blockwise attention (sequences past 2048)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not ported (ported: "
                         f"{PORTED_FAMILIES}); see ROADMAP queue 1 #2")


def _map_named(fn, tree, name=None):
    """``fn(key, leaf)`` over a nested dict, with each leaf's own key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def cast_params(params, cfg: ModelConfig):
    """Float32/bfloat16 leaves to the compute dtype, except ``_FP32_KEEP``.
    Idempotent: a leaf already of its dtype is returned as it is (no copy)."""
    cdt = dtype_of(cfg.compute_dtype)

    def cast(name, leaf):
        if name in _FP32_KEEP or leaf.dtype not in (torch.float32, torch.bfloat16):
            return leaf
        return leaf.to(cdt)

    return _map_named(cast, params)


def param_device(params) -> torch.device:
    return params["embed"]["tok"].device


def params_to(params, device):
    """The same tree with every leaf copied to ``device``."""
    return _map_named(lambda _, leaf: leaf.to(device), params)


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (leaves through ``np.asarray``) as the
    port's, with the same keys, shapes and dtypes, on ``device`` (default:
    the CUDA device).  A bfloat16 leaf (ml_dtypes) goes through float32,
    which holds it exactly."""
    dev = resolve_device(device)

    def conv(_, leaf):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return _map_named(conv, tree)


# =============================================================== init

def init_params(seed: int, cfg: ModelConfig, device=None):
    """Random parameters from ``seed`` (a ``torch.Generator`` on ``device``,
    default the CUDA device): the reference's distributions and layout, not
    its bits (``jax.random`` and torch draw different numbers)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    V, D = cfg.vocab_size, cfg.d_model
    f32 = dict(generator=gen, dtype=torch.float32, device=dev)
    params = {
        "embed": {"tok": (torch.randn((V, D), **f32) * 0.02).to(pdt)},
        "final_norm": norm_params(cfg, pdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"wlm": (torch.randn((D, V), **f32) / D ** 0.5).to(pdt)}
    lead = (cfg.n_layers,)
    if cfg.family in ATTENTION_FAMILIES:
        params["layers"] = {"attn": attn.attn_params(gen, cfg, pdt, lead=lead)}
        if cfg.n_experts and cfg.is_moe_layer(0):
            # uniform-MoE archs (kimi, moonshot): every layer MoE
            params["layers"]["moe"] = moe_mod.moe_params(gen, cfg, pdt, lead=lead)
        else:
            params["layers"]["mlp"] = mlp_params(gen, cfg, pdt, lead=lead)
    else:
        params["layers"] = rwkv.rwkv_params(gen, cfg, pdt, lead=lead)
    return params


# =============================================================== helpers

def _embed(cfg, params, tokens):
    tok = params["embed"]["tok"]
    return tok[torch.as_tensor(tokens, device=tok.device).long()].to(
        dtype_of(cfg.compute_dtype))


def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].to(x.dtype).T
    return x @ params["lm_head"]["wlm"].to(x.dtype)


def _layer_slice(stacked, i: int):
    return _map_named(lambda _, a: a[i], stacked)


def _unbind_layers(stacked, n: int) -> list:
    """The layer-stacked tree as ``n`` per-layer trees of views."""
    flat = _map_named(lambda _, a: a.unbind(0), stacked)
    return [_map_named(lambda _, parts, i=i: parts[i], flat) for i in range(n)]


# =============================================================== forward

def ffn(cfg, lp, x):
    """The layer's MLP or MoE sublayer: (output, aux loss or None)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], x)
    return mlp_apply(cfg, lp["mlp"], x), None


def _layer(cfg, lp, x, positions):
    """One layer: (x, aux or None)."""
    if cfg.family == "ssm":
        t, _ = rwkv.rwkv_time_mix(cfg, lp, x)
        x = x + t
        c, _ = rwkv.rwkv_channel_mix(cfg, lp, x)
        return x + c, None
    x = x + attn.attention_block(cfg, lp["attn"], x, positions=positions,
                                 block_kv=BLOCK_KV)
    d, aux = ffn(cfg, lp, x)
    return x + d, aux


def forward(cfg: ModelConfig, params, batch):
    """Returns (logits (B, S, V), aux_loss: the layers' MoE aux losses
    summed, 0 without MoE).  ``batch["tokens"]``: (B, S) integer tokens
    (inputs only); runs on the parameters' device.  With ``cfg.remat ==
    "full"`` the backward recomputes each layer; without autograd that
    changes nothing."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    remat = cfg.remat == "full"
    x = _embed(cfg, params, batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unbind_layers(params["layers"], cfg.n_layers):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(_layer, cfg, lp, x, positions, use_reentrant=False)
        else:
            x, a = _layer(cfg, lp, x, positions)
        if a is not None:
            aux = aux + a
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), aux


# =============================================================== loss

def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01):
    """batch["tokens"]: (B, S+1); loss = CE(next token) + aux_weight * aux
    (the MoE aux loss; 0 without MoE).
    Returns (loss, {"ce", "aux"})."""
    tokens = torch.as_tensor(batch["tokens"], device=param_device(params))
    logits, aux = forward(cfg, params, {**batch, "tokens": tokens[:, :-1]})
    ce = cross_entropy(logits, tokens[:, 1:])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
