"""Prefill and single-token decode with caches, for every family.

The counterpart of ``repro.models.cache``.  Caches are stacked over layers
(Jamba: blocks), as in the reference (leading L = layers, nb = blocks):

  dense/moe/vlm : {"k","v": (L, B, Smax, KVH, dh) compute dtype, "pos": () int32}
  ... int8      : {"k","v": (L, B, Smax, KVH, dh) int8,
                   "k_scale","v_scale": (L, B, Smax, KVH, 1) bf16, "pos"}  (cfg.kv_quant)
  hybrid (jamba): {"k","v": (nb, B, Smax, KVH, dh), "conv": (nb, P-1, B, KC-1, DI) f32,
                   "ssm": (nb, P-1, B, DI, N) f32, "pos"}
  ssm (rwkv6)   : {"shift_t","shift_c": (L, B, 1, D) f32, "wkv": (L, B, H, dh, dh) f32,
                   "pos": () int32}
  audio         : {"k","v": (L, B, Smax, KVH, dh), "xk","xv": (L, B, Se, KVH, dh), "pos"}

``prefill`` runs the prompt through every layer and stacks each layer's keys
and values (zero-padded to ``max_seq``, ``_pad_seq``) or final states; a vlm
prompt is its patches then its text, so its cache holds both (``max_seq``
counts the patches); the audio prefill runs the encoder once and caches
each decoder layer's cross-attention keys and values (``xk``/``xv``).
``decode_step`` runs one token from them and returns a new cache, leaving
the caller's untouched (the fixed cross cache is shared, never written).
The new token's keys and values go in at ``pos``, a 0-d tensor on the
device, through ``index_copy_`` (no host read of ``pos``; the index is
clamped to the last slot, as ``dynamic_update_slice`` clamps it).  Both run
on the parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (apply_norm, dtype_of, mlp_apply, mm,
                                       sinusoidal_positions)
from repro_torch.models.model import (ATTENTION_FAMILIES, BLOCK_KV, _check_family,
                                      _embed, _layer_slice, _logits, cast_params,
                                      cross_attention, cross_kv, ffn, jamba_ffn,
                                      jamba_sublayers, modality, unbind_blocks,
                                      whisper_encode)

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
    """A zero cache on ``device`` (default: the CUDA device).  The attention
    caches hold ``max_seq`` positions (the audio cross cache ``enc_seq``);
    the ssm cache does not grow with it and ignores it."""
    _check_family(cfg)
    dev = resolve_device(device)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        return {"shift_t": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
                "shift_c": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model), **f32),
                "wkv": torch.zeros((cfg.n_layers, batch, H, cfg.rwkv_head_dim,
                                    cfg.rwkv_head_dim), **f32),
                "pos": pos}
    if max_seq is None:
        raise ValueError(f"a {cfg.family} cache needs max_seq")
    L = cfg.n_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.n_layers
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    if cfg.kv_quant and cfg.family in ATTENTION_FAMILIES:
        # int8 KV + per-(token, head) bf16 scales (~1.97x less bytes)
        scale = (*shape[:-1], 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
                "v_scale": torch.zeros(scale, dtype=torch.bfloat16, device=dev),
                "pos": pos}
    dt = kv_dtype(cfg)
    cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.family == "hybrid":
        P = cfg.attn_period
        cache["conv"] = torch.zeros((L, P - 1, batch, cfg.ssm_conv - 1, cfg.d_inner), **f32)
        cache["ssm"] = torch.zeros((L, P - 1, batch, cfg.d_inner, cfg.ssm_d_state), **f32)
    elif cfg.family == "audio":
        cross = (L, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.dh)
        cache["xk"] = torch.zeros(cross, dtype=dt, device=dev)
        cache["xv"] = torch.zeros(cross, dtype=dt, device=dev)
    return {**cache, "pos": pos}


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

def _prefill_attention(cfg, ap, x, positions, prefix_len=0):
    """A prompt's attention sublayer: (x plus its output, k, v)."""
    B, S, _ = x.shape
    h = apply_norm(cfg, ap["ln"], x)
    q, k, v = attn.qkv(cfg, ap, h, positions)
    if S <= FULL_THRESH:
        o = attn.full_attention(q, k, v, causal=True, q_pos=positions, kv_pos=positions,
                                prefix_len=prefix_len)
    else:
        o = attn.blockwise_attention(q, k, v, causal=True, block_kv=BLOCK_KV,
                                     prefix_len=prefix_len)
    return x + o.reshape(B, S, -1) @ ap["wo"], k, v


def prefill(cfg: ModelConfig, params, batch, *, max_seq: int | None = None):
    """Process the prompt ``batch["tokens"]`` (B, S), after ``"patches"``
    (vlm) or beside ``"frames"`` (audio); returns (last-token logits (B, 1,
    V), cache).  An attention cache holds ``max_seq`` positions (default:
    the prompt's, the patches included); a prompt longer than FULL_THRESH
    positions takes blockwise attention (Whisper's 448-token decoder
    context never does; the reference's audio prefill is always full)."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    if cfg.family == "audio":
        return _whisper_prefill(cfg, params, batch, max_seq)
    x = _embed(cfg, params, batch["tokens"])
    prefix_len = 0
    if cfg.family == "vlm":
        patches = modality(cfg, params, batch, "patches")
        prefix_len = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    B, S_tot = x.shape[:2]
    max_seq = max_seq or S_tot
    positions = torch.arange(S_tot, dtype=torch.int32, device=x.device)
    states = []
    if cfg.family in ATTENTION_FAMILIES:
        for i in range(cfg.n_layers):
            lp = _layer_slice(params["layers"], i)
            x, k, v = _prefill_attention(cfg, lp["attn"], x, positions, prefix_len)
            d, _ = ffn(cfg, lp, x)
            states.append({key: _pad_seq(val, max_seq)
                           for key, val in _layer_kv(cfg, k, v).items()})
            x = x + d
    elif cfg.family == "hybrid":
        for bp in unbind_blocks(params["blocks"]):
            mamba_states = []
            for (mixer, i), (ffn_kind, j) in jamba_sublayers(cfg):
                if mixer == "attn":
                    x, k, v = _prefill_attention(cfg, bp["attn"], x, positions)
                    kv = {"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq)}
                else:   # from a zero carry, as the reference
                    m, st = mam.mamba_block(cfg, bp["mamba"][i], x,
                                            state=mam.mamba_init_state(cfg, B, device=x.device))
                    x = x + m
                    mamba_states.append(st)
                d, _ = jamba_ffn(cfg, bp, ffn_kind, j, x)
                x = x + d
            states.append({**kv, **_stack(mamba_states)})
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


def _whisper_prefill(cfg, params, batch, max_seq):
    """The encoder once, then the decoder over the prompt: each layer's self
    keys and values (padded to ``max_seq``, default S) and its cross keys
    and values of the encoder output."""
    enc = whisper_encode(cfg, params, batch)
    x = _embed(cfg, params, batch["tokens"])
    S = x.shape[1]
    max_seq = max_seq or S
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    pos_d = torch.arange(S, dtype=torch.int32, device=x.device)
    pos_e = torch.arange(enc.shape[1], dtype=torch.int32, device=x.device)
    states = []
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        x, k, v = _prefill_attention(cfg, lp["attn"], x, pos_d)
        xk, xv = cross_kv(cfg, lp["xattn"], enc)
        x = cross_attention(cfg, lp["xattn"], x, xk, xv, pos_d, pos_e)
        x = x + mlp_apply(cfg, lp["mlp"], x)
        states.append({"k": _pad_seq(k, max_seq), "v": _pad_seq(v, max_seq),
                       "xk": xk, "xv": xv})
    cache = {**_stack(states), "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
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
    B = x.shape[0]
    pos = cache["pos"]
    if cfg.family == "ssm":
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

    fixed = ("pos", "conv", "ssm", "xk", "xv")   # replaced, or shared unwritten
    new = {k: v.clone() for k, v in cache.items() if k not in fixed}
    slot = torch.clamp(pos, max=new["k"].shape[2] - 1).long().reshape(1)
    if cfg.family == "hybrid":
        states = []
        for b, bp in enumerate(unbind_blocks(params["blocks"])):
            mamba_states = []
            for (mixer, i), (ffn_kind, j) in jamba_sublayers(cfg):
                if mixer == "attn":
                    x = _decode_attention_layer(cfg, bp, x, new, b, pos, slot)
                else:
                    m, st = mam.mamba_block(cfg, bp["mamba"][i], x, state={
                        "conv": cache["conv"][b, i], "ssm": cache["ssm"][b, i]})
                    x = x + m
                    mamba_states.append(st)
                d, _ = jamba_ffn(cfg, bp, ffn_kind, j, x)
                x = x + d
            states.append(_stack(mamba_states))
        new.update(_stack(states))
    else:
        if cfg.family == "audio":   # the sinusoidal row at pos (clamped, as dynamic_slice)
            table = sinusoidal_positions(new["k"].shape[2], cfg.d_model, x.device)
            x = x + table.index_select(0, slot).to(x.dtype)[None]
            new["xk"], new["xv"] = cache["xk"], cache["xv"]
        for i in range(cfg.n_layers):
            lp = _layer_slice(params["layers"], i)
            x = _decode_attention_layer(cfg, lp, x, new, i, pos, slot)
            if cfg.family == "audio":   # every encoder position attended
                xp = lp["xattn"]
                qx = (apply_norm(cfg, xp["ln"], x) @ xp["wq"]).reshape(B, 1, cfg.n_heads,
                                                                        cfg.dh)
                o = attn.decode_attention(qx, new["xk"][i], new["xv"][i],
                                          new["xk"].shape[2] - 1)
                x = x + o.reshape(B, 1, -1) @ xp["wo"]
                x = x + mlp_apply(cfg, lp["mlp"], x)
            else:
                d, _ = ffn(cfg, lp, x)
                x = x + d
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), {**new, "pos": pos + 1}
