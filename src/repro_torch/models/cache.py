"""Prefill and single-token decode with caches.

The counterpart of ``repro.models.cache`` for the ported families.  Caches
are stacked over layers, as in the reference (leading L = layers):

  dense/moe  : {"k","v": (L, B, Smax, KVH, dh) compute dtype, "pos": () int32}
  ... int8   : {"k","v": (L, B, Smax, KVH, dh) int8,
                "k_scale","v_scale": (L, B, Smax, KVH, 1) bf16, "pos"}  (cfg.kv_quant)
  ssm (rwkv6): {"shift_t","shift_c": (L, B, 1, D) f32, "wkv": (L, B, H, dh, dh) f32,
                "pos": () int32}

``prefill`` runs the prompt through every layer and stacks each layer's keys
and values (zero-padded to ``max_seq``, ``_pad_seq``) or final states;
``decode_step`` runs one token from them and returns a new cache, leaving
the caller's untouched.  The new token's keys and values go in at ``pos``, a 0-d tensor
on the device, through ``index_copy_`` (no host read of ``pos``; the index
is clamped to the last slot, as ``dynamic_update_slice`` clamps it).  Both
run on the parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import apply_norm, dtype_of, mm
from repro_torch.models.model import (ATTENTION_FAMILIES, BLOCK_KV, _check_family,
                                      _embed, _layer_slice, _logits, cast_params, ffn)

FULL_THRESH = 2048   # prompts longer than this take blockwise attention


def kv_dtype(cfg):
    return dtype_of(cfg.compute_dtype)


def _q8(x):
    """Quantize (B,S,KVH,dh) -> (int8, bf16 scale (B,S,KVH,1)).  torch.round
    rounds half to even, as jnp.round."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dq(q, scale):
    return q.to(torch.bfloat16) * scale


def init_cache(cfg: ModelConfig, batch: int, max_seq: int | None = None, *, device=None):
    """A zero cache on ``device`` (default: the CUDA device).  The dense and
    MoE caches hold ``max_seq`` positions; the ssm cache does not grow with
    it and ignores it."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family in ATTENTION_FAMILIES:
        if max_seq is None:
            raise ValueError(f"a {cfg.family} cache needs max_seq")
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.dh)
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        if cfg.kv_quant:  # int8 KV + per-(token, head) bf16 scales (~1.97x less bytes)
            scale = (*shape[:-1], 1)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
                    "v_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
                    "pos": pos}
        dt = kv_dtype(cfg)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev), "pos": pos}
    H = cfg.d_model // cfg.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=dev)
    return {"shift_t": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
            "shift_c": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
            "wkv": torch.zeros((cfg.n_layers, batch, H, cfg.rwkv_head_dim,
                                cfg.rwkv_head_dim), **f32),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _stack(states):
    """Per-layer dicts of tensors as one dict of layer-stacked tensors."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _pad_seq(k, max_seq):
    S = k.shape[1]
    if S == max_seq:
        return k
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, max_seq - S))


def _layer_kv(cfg, k, v) -> dict:
    """A layer's cache entries for keys and values (B, S, KVH, dh)."""
    if cfg.kv_quant:
        kq, ks = _q8(k)
        vq, vs = _q8(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


# =============================================================== prefill

def prefill(cfg: ModelConfig, params, batch, *, max_seq: int | None = None):
    """Process the prompt ``batch["tokens"]`` (B, S); returns (last-token
    logits (B, 1, V), cache).  A dense/MoE cache holds ``max_seq`` positions
    (default S); a prompt longer than FULL_THRESH tokens takes blockwise
    attention."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    x = _embed(cfg, params, batch["tokens"])
    B, S_tot = x.shape[:2]
    max_seq = max_seq or S_tot
    states = []
    if cfg.family in ATTENTION_FAMILIES:
        positions = torch.arange(S_tot, dtype=torch.int32, device=x.device)
        for i in range(cfg.n_layers):
            lp = _layer_slice(params["layers"], i)
            h = apply_norm(cfg, lp["attn"]["ln"], x)
            q, k, v = attn.qkv(cfg, lp["attn"], h, positions)
            if S_tot <= FULL_THRESH:
                o = attn.full_attention(q, k, v, causal=True, q_pos=positions,
                                        kv_pos=positions)
            else:
                o = attn.blockwise_attention(q, k, v, causal=True, block_kv=BLOCK_KV)
            x = x + o.reshape(B, S_tot, -1) @ lp["attn"]["wo"]
            d, _ = ffn(cfg, lp, x)
            states.append({key: _pad_seq(val, max_seq)
                           for key, val in _layer_kv(cfg, k, v).items()})
            x = x + d
    else:
        for i in range(cfg.n_layers):
            lp = _layer_slice(params["layers"], i)
            t, st = rwkv.rwkv_time_mix(cfg, lp, x)
            x = x + t
            c, sc = rwkv.rwkv_channel_mix(cfg, lp, x)
            x = x + c
            states.append({"shift_t": st["shift_t"], "shift_c": sc["shift_c"],
                           "wkv": st["wkv"]})
    cache = {**_stack(states),
             "pos": torch.full((), S_tot, dtype=torch.int32, device=x.device)}
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return _logits(cfg, params, x), cache


# =============================================================== decode

def _decode_attention_layer(cfg, lp, x, new, i, pos, slot):
    """One layer's attention sublayer on the new token: writes its keys and
    values at ``slot`` of layer ``i`` of the ``new`` cache, returns x plus
    the sublayer's output."""
    B = x.shape[0]
    h = apply_norm(cfg, lp["attn"]["ln"], x)
    q, k, v = attn.qkv(cfg, lp["attn"], h, pos.reshape(1))  # the new token's rope position
    for key, val in _layer_kv(cfg, k, v).items():
        new[key][i].index_copy_(1, slot, val.to(new[key].dtype))
    if cfg.kv_quant:
        o = attn.decode_attention(q, _dq(new["k"][i], new["k_scale"][i]),
                                  _dq(new["v"][i], new["v_scale"][i]), pos)
    else:
        o = attn.decode_attention(q, new["k"][i], new["v"][i], pos)
    # int8 caches attend in bfloat16: JAX promotes o @ wo to wo's dtype
    return x + mm(o.reshape(B, 1, -1), lp["attn"]["wo"])


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One token: tokens (B, 1) -> (logits (B, 1, V), new cache)."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    if cfg.family in ATTENTION_FAMILIES:
        new = {k: v.clone() for k, v in cache.items() if k != "pos"}
        slot = torch.clamp(pos, max=new["k"].shape[2] - 1).long().reshape(1)
        for i in range(cfg.n_layers):
            lp = _layer_slice(params["layers"], i)
            x = _decode_attention_layer(cfg, lp, x, new, i, pos, slot)
            d, _ = ffn(cfg, lp, x)
            x = x + d
    else:
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
        new = _stack(states)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), {**new, "pos": pos + 1}
