"""Mixture-of-Experts FFN, the local path (one device).

The counterpart of ``repro.models.moe``'s local path: a float32 router,
top-k gates, sort-based positions within each expert, capacity-based
dropping with first-come-first-served priority, SwiGLU experts over an
(E, C, D) buffer, and a Switch-style aux loss.  The reference's expert
parallel paths (``_moe_ffn_ep``, ``_moe_ffn_a2a``) need a device mesh and
are still to port (ROADMAP queue 1 #3); like the reference without an
ambient mesh, ``moe_ffn`` here always takes the local path.

Routing and drops are decisions, and they follow the reference's exactly:
ties in the top-k go to the lower expert index (``jax.lax.top_k``'s order,
here a stable descending sort), positions come from a stable argsort of the
flattened expert ids and a left ``searchsorted``, and dropped assignments
add zeros into slot (0, 0), as ``buf.at[le, pos_c].add`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init, norm_params


def moe_params(gen: torch.Generator, cfg: ModelConfig, dtype, *, lead: tuple = ()):
    """One MoE sublayer's parameters, each leaf with the leading axes
    ``lead``; the router ``wr`` is drawn and kept in float32.  The experts
    are scaled in place (one float32 temporary a leaf)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device
    out_scale = 1.0 / max(cfg.n_layers, 1) ** 0.5
    f32 = dict(generator=gen, dtype=torch.float32, device=dev)
    return {
        "ln": norm_params(cfg, dtype, lead=lead, device=dev),
        "wr": dense_init(gen, D, E, torch.float32, lead=lead),  # router kept fp32
        "wei": torch.randn((*lead, E, D, F_), **f32).div_(D ** 0.5).to(dtype),
        "weg": torch.randn((*lead, E, D, F_), **f32).div_(D ** 0.5).to(dtype),
        "weo": torch.randn((*lead, E, F_, D), **f32).mul_(out_scale).div_(F_ ** 0.5)
        .to(dtype),
    }


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def _route(cfg: ModelConfig, xt, wr):
    """Router + sort-based position-within-expert. xt: (T, D).  Returns
    (flat_e, pos, gate, aux): the (T*K,) expert ids and positions (int64),
    the (T*K,) float32 gates and the 0-d float32 aux loss."""
    E, K = cfg.n_experts, cfg.experts_per_token
    T = xt.shape[0]
    logits = xt.float() @ wr  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the K largest, the lower index first among equals
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :K], ids[:, :K]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=xt.device).index_add_(
        0, ids.reshape(-1), torch.ones((T * K,), dtype=torch.float32,
                                       device=xt.device)) / (T * K)
    aux = E * torch.sum(me * ce)

    flat_e = ids.reshape(-1)  # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device), side="left")
    pos_sorted = torch.arange(T * K, device=xt.device) - start[sorted_e]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    return flat_e, pos, gate.reshape(-1), aux


def _expert_compute(buf, wei, weg, weo):
    """buf: (E, C, D) -> (E, C, D) SwiGLU experts."""
    hg = torch.einsum("ecd,edf->ecf", buf, weg)
    hi = torch.einsum("ecd,edf->ecf", buf, wei)
    h = F.silu(hg) * hi
    return torch.einsum("ecf,efd->ecd", h, weo)


def _dispatch_compute_combine(cfg, xt, p_wei, p_weg, p_weo, flat_e, pos, gatew,
                              C, e_start, E_loc):
    """Local experts are [e_start, e_start + E_loc); (T, D) partial sum over
    them."""
    K, D = cfg.experts_per_token, cfg.d_model
    T = xt.shape[0]
    local = (flat_e >= e_start) & (flat_e < e_start + E_loc) & (pos < C)
    le = torch.where(local, flat_e - e_start, 0)
    pos_c = torch.where(local, pos, 0)
    xe = torch.repeat_interleave(xt, K, dim=0)  # (T*K, D)
    buf = torch.zeros((E_loc, C, D), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((le, pos_c), torch.where(local[:, None], xe, 0), accumulate=True)
    y = _expert_compute(buf, p_wei, p_weg, p_weo)  # (E_loc, C, D)
    yt = y[le, pos_c] * torch.where(local, gatew, 0.0)[:, None].to(y.dtype)
    return yt.reshape(T, K, D).sum(dim=1)  # (T, D) partial (local experts only)


def moe_ffn(cfg: ModelConfig, p, x):
    """Pre-norm MoE sublayer (no residual add). x: (B,S,D) -> ((B,S,D), aux)."""
    B, S, D = x.shape
    E = cfg.n_experts
    x = apply_norm(cfg, p["ln"], x)
    xt = x.reshape(B * S, D)
    C = expert_capacity(cfg, B * S)
    flat_e, pos, gatew, aux = _route(cfg, xt, p["wr"])
    out = _dispatch_compute_combine(cfg, xt, p["wei"], p["weg"], p["weo"],
                                    flat_e, pos, gatew, C, 0, E)
    return out.reshape(B, S, D), aux
