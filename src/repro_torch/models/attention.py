"""GQA attention: full, blockwise (flash-style online softmax), and decode.

The counterpart of ``repro.models.attention``, as plain torch ops that follow
the reference's ``jnp`` op for op, in its dtypes:

- ``full_attention`` takes the scores in float32, divides them by
  ``sqrt(dh)`` and casts the softmax weights to ``v``'s dtype before the
  second product;
- ``blockwise_attention`` scales ``q`` before the product, keeps the online
  softmax in float32 and casts only its result;
- ``decode_attention`` keeps the weights in float32 and reads the cache in
  float32.

Not ``F.scaled_dot_product_attention``: a fused attention sums in another
order and other dtypes.  The reference's sharding hints and its ``unroll``
switch (for XLA's cost analysis) have no counterpart here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_norm, apply_rope, dense_init, norm_params

NEG_INF = -1e30


def attn_params(gen: torch.Generator, cfg: ModelConfig, dtype, *, lead: tuple = ()):
    """One attention sublayer's parameters, each leaf with the leading axes
    ``lead``; zero QKV biases when ``cfg.qkv_bias``."""
    H, KVH, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_model
    dev = gen.device
    p = {
        "ln": norm_params(cfg, dtype, lead=lead, device=dev),
        "wq": dense_init(gen, D, H * dh, dtype, lead=lead),
        "wk": dense_init(gen, D, KVH * dh, dtype, lead=lead),
        "wv": dense_init(gen, D, KVH * dh, dtype, lead=lead),
        "wo": dense_init(gen, H * dh, D, dtype, 1.0 / max(cfg.n_layers, 1) ** 0.5,
                         lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", KVH * dh), ("bv", KVH * dh)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=dev)
    return p


def qkv(cfg: ModelConfig, p, x, positions=None):
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,KVH,dh)."""
    B, S, _ = x.shape
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KVH, dh)
    v = v.reshape(B, S, KVH, dh)
    if cfg.rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos, kv_pos, causal: bool, prefix_len: int = 0):
    """(Sq, Skv) boolean mask. prefix_len: bidirectional prefix (VLM)."""
    if not causal:
        return None
    m = q_pos[:, None] >= kv_pos[None, :]
    if prefix_len:
        m = m | (kv_pos[None, :] < prefix_len)
    return m


def full_attention(q, k, v, *, causal=True, q_pos=None, kv_pos=None, prefix_len=0):
    """q: (B,Sq,H,dh), k/v: (B,Skv,KVH,dh). Materialises scores — short seq only."""
    B, Sq, H, dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / (dh ** 0.5)
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], device=q.device)
    m = _mask(q_pos, kv_pos, causal, prefix_len)
    if m is not None:
        scores = torch.where(m[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, dh)


def blockwise_attention(q, k, v, *, causal=True, block_kv: int = 2048, prefix_len=0):
    """Flash-style attention: online softmax over KV chunks; O(Sq*block)
    memory.  The chunks run in a Python loop (the reference's ``lax.scan``).
    The first chunk gives every causal query a finite running max, so a
    chunk wholly masked for a query adds ``exp(-1e30 - m) = 0``; keys padded
    up to a multiple of ``block_kv`` are masked by ``kv_pos < Skv``."""
    B, Sq, H, dh = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    nblk = -(-Skv // block_kv)
    pad = nblk * block_kv - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(B, nblk, block_kv, KVH, dh)
    vb = v.reshape(B, nblk, block_kv, KVH, dh)
    qg = q.reshape(B, Sq, KVH, G, dh).float() / (dh ** 0.5)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, KVH, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KVH, G, dh), dtype=torch.float32, device=dev)
    for blk in range(nblk):
        kc, vc = kb[:, blk], vb[:, blk]
        kv_pos = blk * block_kv + torch.arange(block_kv, device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kc.float())
        msk = (q_pos[:, None] >= kv_pos[None, :]) if causal else (kv_pos[None, :] < Skv)
        if causal and prefix_len:
            msk = msk | (kv_pos[None, :] < prefix_len)
        if causal:
            msk = msk & (kv_pos[None, :] < Skv)
        s = torch.where(msk[None, :, None, None, :], s, NEG_INF)
        m_cur = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_cur[..., None])
        corr = torch.exp(m - m_cur)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vc.float())
        m = m_cur
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, dh).to(v.dtype)


def decode_attention(q, k_cache, v_cache, pos):
    """One-token attention against a cache.

    q: (B, 1, H, dh); k/v_cache: (B, Smax, KVH, dh); pos: () int32 current
    length, a tensor on the cache's device (no host read).  Slots ``<= pos``
    are attended: the token just written at ``pos`` included."""
    B, _, H, dh = q.shape
    Smax, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, dh).float() / (dh ** 0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float())
    valid = torch.arange(Smax, device=q.device)[None, None, None, :] <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.float())
    return out.reshape(B, 1, H, dh).to(v_cache.dtype)


def attention_block(cfg: ModelConfig, p, x, *, positions, causal=True, prefix_len=0,
                    block_kv=1024, full_thresh=2048):
    """Pre-norm attention sublayer (no residual add)."""
    h = apply_norm(cfg, p["ln"], x)
    q, k, v = qkv(cfg, p, h, positions)
    S = x.shape[1]
    if S <= full_thresh or q.shape[1] != k.shape[1]:
        # positions is a 1D (S,) vector everywhere (shared across batch)
        o = full_attention(q, k, v, causal=causal, q_pos=positions, kv_pos=positions,
                           prefix_len=prefix_len)
    else:
        o = blockwise_attention(q, k, v, causal=causal, block_kv=block_kv,
                                prefix_len=prefix_len)
    return o.reshape(x.shape[0], S, -1) @ p["wo"]
