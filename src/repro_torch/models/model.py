"""Model wiring: init / forward for every family.

Families:
  dense | moe | vlm : uniform decoder layers (attention + MLP-or-MoE); vlm
                      puts its patch embeddings in front of the text under a
                      prefix-LM mask
  hybrid (jamba)    : period-8 blocks (7 Mamba + 1 attention; MoE every 2nd)
  ssm (rwkv6)       : time-mix + channel-mix layers
  audio (whisper)   : encoder-decoder with cross-attention

The counterpart of ``repro.models.model``: parameters are nested dicts of
tensors with the reference's keys and its stacked layout (a leading
``n_layers`` axis on every leaf under ``"layers"``; under Jamba's
``"blocks"`` a leading block axis, and a second one, the sublayer within
the block, under a block's ``"mamba"`` / ``"ffn_dense"`` / ``"ffn_moe"``),
so a reference parameter tree carries across one to one
(``params_from_numpy``).  A stack is a plain Python loop over its leaves,
unbound once a level (so that the backward stacks each leaf's gradient
once).  With ``cfg.remat == "full"`` and autograd on, each layer (each
Jamba block, each Whisper encoder and decoder layer) runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` in ``_scan_layers``: only a layer's input is
kept, and the backward recomputes the layer (its ``wkv6``, its attention,
MoE routing and Mamba scan included; the scan's own per-chunk checkpoints
nest inside).  A uniform-MoE arch (every layer MoE) has ``"moe"`` in place
of ``"mlp"`` in each layer, and ``forward`` returns the sum of the MoE aux
losses.  The reference's ``unroll`` switch belongs to its XLA cost
analysis (its dry run's ``--scan``; the port's dry run counts the eager
program, ``launch/dryrun.py``); its sequence-sharding hints are XLA
layout hints, left out (``repro_torch.sharding``): on a mesh the port runs
each rank's program on its batch shard (``launch/steps``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models.layers import (apply_norm, cross_entropy, dtype_of, mlp_apply,
                                       mlp_params, norm_params, sinusoidal_positions)
from repro_torch.tree import tree_leaves

# Param leaves kept in fp32 regardless of compute dtype (routing / SSM dynamics
# / norm statistics are precision-sensitive).
_FP32_KEEP = {"wr", "alog", "u", "w0", "gn_scale", "dskip", "scale", "bias"}
PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
ATTENTION_FAMILIES = ("dense", "moe", "vlm")
BLOCK_KV = 2048   # keys a chunk of blockwise attention (sequences past 2048)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (known: {PORTED_FAMILIES})")


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
    elif cfg.family == "hybrid":
        P = cfg.attn_period
        nb = cfg.n_layers // P
        n_moe = sum(cfg.is_moe_layer(i) for i in range(P))
        params["blocks"] = {
            "attn": attn.attn_params(gen, cfg, pdt, lead=(nb,)),
            "mamba": mam.mamba_params(gen, cfg, pdt, lead=(nb, P - 1)),
            "ffn_dense": mlp_params(gen, cfg, pdt, lead=(nb, P - n_moe)),
            "ffn_moe": moe_mod.moe_params(gen, cfg, pdt, lead=(nb, n_moe)),
        }
    elif cfg.family == "ssm":
        params["layers"] = rwkv.rwkv_params(gen, cfg, pdt, lead=lead)
    else:  # audio
        enc = (cfg.n_enc_layers,)
        params["enc_layers"] = {"attn": attn.attn_params(gen, cfg, pdt, lead=enc),
                                "mlp": mlp_params(gen, cfg, pdt, lead=enc)}
        params["enc_norm"] = norm_params(cfg, pdt, device=dev)
        params["layers"] = {"attn": attn.attn_params(gen, cfg, pdt, lead=lead),
                            "xattn": attn.attn_params(gen, cfg, pdt, lead=lead),
                            "mlp": mlp_params(gen, cfg, pdt, lead=lead)}
    return params


# =============================================================== helpers

def _embed(cfg, params, tokens):
    tok = params["embed"]["tok"]
    x = tok[torch.as_tensor(tokens, device=tok.device).long()].to(
        dtype_of(cfg.compute_dtype))
    if cfg.family == "vlm":  # gemma scales embeddings, the factor in x's dtype
        x = x * float(torch.tensor(cfg.d_model ** 0.5).to(x.dtype))
    return x


def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].to(x.dtype).T
    return x @ params["lm_head"]["wlm"].to(x.dtype)


def modality(cfg, params, batch, key):
    """``batch[key]`` (vlm ``"patches"``, audio ``"frames"``: (B, n, D) stub
    front-end outputs, numpy or tensors) on the parameters' device in the
    compute dtype."""
    return torch.as_tensor(batch[key], device=param_device(params)).to(
        dtype_of(cfg.compute_dtype))


def _layer_slice(stacked, i: int):
    return _map_named(lambda _, a: a[i], stacked)


def _unbind_layers(stacked) -> list:
    """The stacked tree as per-layer trees of views, one a leading index."""
    flat = _map_named(lambda _, a: a.unbind(0), stacked)
    n = len(tree_leaves(flat)[0])
    return [_map_named(lambda _, parts, i=i: parts[i], flat) for i in range(n)]


def unbind_blocks(blocks) -> list:
    """Jamba's ``"blocks"`` as one tree a block, whose ``"mamba"`` /
    ``"ffn_dense"`` / ``"ffn_moe"`` sub-stacks are lists of sublayer trees."""
    return [{k: v if k == "attn" else _unbind_layers(v) for k, v in bp.items()}
            for bp in _unbind_layers(blocks)]


def jamba_sublayers(cfg) -> list:
    """Each sublayer of a Jamba block in order: ((mixer, index), (ffn,
    index)), mixer ``"attn"`` at ``attn_offset`` else ``"mamba"``, ffn
    ``"ffn_moe"`` where ``is_moe_layer`` else ``"ffn_dense"``; the index
    counts that kind within the block."""
    seen = {"attn": 0, "mamba": 0, "ffn_dense": 0, "ffn_moe": 0}
    out = []
    for i in range(cfg.attn_period):
        kinds = ("attn" if i == cfg.attn_offset % cfg.attn_period else "mamba",
                 "ffn_moe" if cfg.is_moe_layer(i) else "ffn_dense")
        out.append(tuple((k, seen[k]) for k in kinds))
        for k in kinds:
            seen[k] += 1
    return out


def jamba_ffn(cfg, bp, ffn, j, x):
    """A Jamba sublayer's MLP or MoE: (output, aux loss or None)."""
    if ffn == "ffn_moe":
        return moe_mod.moe_ffn(cfg, bp[ffn][j], x)
    return mlp_apply(cfg, bp[ffn][j], x), None


def cross_kv(cfg, xp, enc):
    """Cross-attention keys and values of the encoder output ``enc`` (B, Se,
    D): (B, Se, KVH, dh) each, no rotary."""
    B, Se, _ = enc.shape
    return ((enc @ xp["wk"]).reshape(B, Se, cfg.n_kv_heads, cfg.dh),
            (enc @ xp["wv"]).reshape(B, Se, cfg.n_kv_heads, cfg.dh))


def cross_attention(cfg, xp, x, k, v, pos_d, pos_e):
    """x plus the cross-attention sublayer's output over the encoder's keys
    and values (every position attended)."""
    B, S, _ = x.shape
    h = apply_norm(cfg, xp["ln"], x)
    q = (h @ xp["wq"]).reshape(B, S, cfg.n_heads, cfg.dh)
    o = attn.full_attention(q, k, v, causal=False, q_pos=pos_d, kv_pos=pos_e)
    return x + o.reshape(B, S, -1) @ xp["wo"]


# =============================================================== forward

def ffn(cfg, lp, x):
    """The layer's MLP or MoE sublayer: (output, aux loss or None)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], x)
    return mlp_apply(cfg, lp["mlp"], x), None


def _layer(cfg, lp, x, positions, prefix_len=0):
    """One layer: (x, aux or None)."""
    if cfg.family == "ssm":
        t, _ = rwkv.rwkv_time_mix(cfg, lp, x)
        x = x + t
        c, _ = rwkv.rwkv_channel_mix(cfg, lp, x)
        return x + c, None
    x = x + attn.attention_block(cfg, lp["attn"], x, positions=positions,
                                 prefix_len=prefix_len, block_kv=BLOCK_KV)
    d, aux = ffn(cfg, lp, x)
    return x + d, aux


def _jamba_block(cfg, bp, x, positions):
    """One period-8 block: (x, the sum of its MoE aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (mixer, i), (ffn_kind, j) in jamba_sublayers(cfg):
        if mixer == "attn":
            x = x + attn.attention_block(cfg, bp["attn"], x, positions=positions,
                                         block_kv=BLOCK_KV)
        else:
            m, _ = mam.mamba_block(cfg, bp["mamba"][i], x)
            x = x + m
        d, a = jamba_ffn(cfg, bp, ffn_kind, j, x)
        if a is not None:
            aux = aux + a
        x = x + d
    return x, aux


def _run_stack(cfg, fn, layers, x, *args):
    """``fn(cfg, layer, x, *args) -> (x, aux or None)`` over ``layers``, each
    under ``checkpoint`` with ``cfg.remat == "full"`` and autograd on.
    Returns (x, the aux losses summed: 0 without any)."""
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layers:
        if remat:
            # no layer draws random numbers, so there is no generator state
            # to stash (a CUDA graph's capture could not read it)
            x, a = checkpoint(fn, cfg, lp, x, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = fn(cfg, lp, x, *args)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(cfg: ModelConfig, params, batch):
    """Returns (logits (B, S, V), aux_loss: the MoE aux losses summed, 0
    without MoE).  ``batch["tokens"]``: (B, S) integer tokens (inputs only),
    and ``"patches"`` (vlm: (B, P, D), put in front of the text; the logits
    cover both) or ``"frames"`` (audio: (B, Se, D)); runs on the parameters'
    device.  With ``cfg.remat == "full"`` the backward recomputes each
    layer; without autograd that changes nothing."""
    _check_family(cfg)
    params = cast_params(params, cfg)
    if cfg.family == "audio":
        return _whisper_forward(cfg, params, batch), torch.zeros(
            (), dtype=torch.float32, device=param_device(params))
    prefix_len = 0
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = modality(cfg, params, batch, "patches")
        prefix_len = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if cfg.family == "hybrid":
        x, aux = _run_stack(cfg, _jamba_block, unbind_blocks(params["blocks"]), x, positions)
    else:
        x, aux = _run_stack(cfg, _layer, _unbind_layers(params["layers"]), x, positions,
                        prefix_len)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), aux


def _enc_layer(cfg, lp, x, pos_e):
    B, Se, _ = x.shape
    h = apply_norm(cfg, lp["attn"]["ln"], x)
    q, k, v = attn.qkv(cfg, lp["attn"], h, None)
    o = attn.full_attention(q, k, v, causal=False, q_pos=pos_e, kv_pos=pos_e)
    x = x + o.reshape(B, Se, -1) @ lp["attn"]["wo"]
    return x + mlp_apply(cfg, lp["mlp"], x), None


def _dec_layer(cfg, lp, x, enc, pos_d, pos_e):
    x = x + attn.attention_block(cfg, lp["attn"], x, positions=pos_d, block_kv=BLOCK_KV)
    k, v = cross_kv(cfg, lp["xattn"], enc)
    x = cross_attention(cfg, lp["xattn"], x, k, v, pos_d, pos_e)
    return x + mlp_apply(cfg, lp["mlp"], x), None


def whisper_encode(cfg, params, batch):
    """The encoder over ``batch["frames"]`` plus their sinusoidal positions:
    (B, Se, D) after ``enc_norm``.  ``params`` cast already."""
    frames = modality(cfg, params, batch, "frames")
    Se = frames.shape[1]
    x = frames + sinusoidal_positions(Se, cfg.d_model, frames.device).to(frames.dtype)[None]
    pos_e = torch.arange(Se, dtype=torch.int32, device=x.device)
    x, _ = _run_stack(cfg, _enc_layer, _unbind_layers(params["enc_layers"]), x, pos_e)
    return apply_norm(cfg, params["enc_norm"], x)


def _whisper_forward(cfg, params, batch):
    enc = whisper_encode(cfg, params, batch)
    x = _embed(cfg, params, batch["tokens"])
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
    pos_d = torch.arange(S, dtype=torch.int32, device=x.device)
    pos_e = torch.arange(enc.shape[1], dtype=torch.int32, device=x.device)
    x, _ = _run_stack(cfg, _dec_layer, _unbind_layers(params["layers"]), x, enc, pos_d, pos_e)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x)


# =============================================================== loss

def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01):
    """batch["tokens"]: (B, S+1), with ``"patches"`` / ``"frames"`` for vlm /
    audio; loss = CE(next token) + aux_weight * aux (the MoE aux loss; 0
    without MoE), vlm's CE over the text positions only.  The batch goes to
    the parameters' device.  Returns (loss, {"ce", "aux"})."""
    dev = param_device(params)
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    tokens = inputs["tokens"]
    logits, aux = forward(cfg, params, {**inputs, "tokens": tokens[:, :-1]})
    if cfg.family == "vlm":  # loss only over text positions (after the prefix)
        logits = logits[:, cfg.n_vision_tokens:]
    ce = cross_entropy(logits, tokens[:, 1:])
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
