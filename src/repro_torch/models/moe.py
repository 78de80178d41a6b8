"""Mixture-of-Experts FFN with expert parallelism over the "model" axis.

The counterpart of ``repro.models.moe``: a float32 router, top-k gates,
sort-based positions within each expert, capacity-based dropping with
first-come-first-served priority, SwiGLU experts over an (E, C, D) buffer,
and a Switch-style aux loss.  Three paths:

* **local** (no ambient mesh, or the rules do not split the experts over
  "model": E not divisible by it): one shard holds every expert.  Under a
  mesh whose batch is split (``use_mesh(batch_axes=)``) the tokens are
  gathered over the batch axes first and this rank keeps its rows: routing,
  capacity, drops and the aux loss are the whole batch's, as the
  reference's jitted local path computes them.
* **ep** (an ambient mesh, ``sharding.use_mesh``): the activations are this
  rank's batch shard, replicated over "model"; this rank owns experts
  ``[m*E_loc, (m+1)*E_loc)`` (its expert leaves hold only those), routes
  every token of its shard, computes its experts' contributions and sums
  them over "model".  The capacity is ``expert_capacity(cfg, T_loc)`` of the
  batch shard's tokens, so drops are decided per shard.
* **a2a** (``REPRO_MOE_A2A=1`` at the call, and S divisible by "model"):
  each model rank routes its S/M slice of the sequence, exchanges (dest,
  local expert) buckets with the experts' owners by all-to-all, computes,
  sends the results back, and the output is gathered over the sequence.

The aux loss returned is this batch shard's (a2a: the mean of its model
ranks'); the train step averages the gradients over the batch shards and
reports the aux as their mean (``launch/steps``).  The reference reads
``REPRO_MOE_A2A`` when its layer scan is traced and caches that trace; the
port reads it at every call.

Routing and drops are decisions, and they follow the reference's exactly:
ties in the top-k go to the lower expert index (``jax.lax.top_k``'s order,
here a stable descending sort), positions come from a stable argsort of the
flattened expert ids and a left ``searchsorted``, and dropped assignments
add zeros into slot (0, 0), as ``buf.at[le, pos_c].add`` does.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
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

    mesh = shd.ambient_mesh()
    if shd.experts_split(mesh, E):
        if os.environ.get("REPRO_MOE_A2A", "0") == "1":
            return _moe_ffn_a2a(cfg, p, x, mesh)
        return _moe_ffn_ep(cfg, p, x, mesh)

    # ---- local path (single shard) ----
    bax = shd.ambient_batch_axes() if mesh is not None else ()
    # every rank routes the whole batch; its loss reads its own rows, so the
    # gather's backward sums the cotangents over the batch axes
    xw = x if not bax else shd.gather_summed(x, mesh, bax, 0)
    Bw = xw.shape[0]
    xt = xw.reshape(Bw * S, D)
    C = expert_capacity(cfg, Bw * S)
    flat_e, pos, gatew, aux = _route(cfg, xt, p["wr"])
    out = _dispatch_compute_combine(cfg, xt, p["wei"], p["weg"], p["weo"],
                                    flat_e, pos, gatew, C, 0, E)
    out = out.reshape(Bw, S, D)
    return (out if not bax else shd.local_slice(out, mesh, bax, 0)), aux


def _local_experts(cfg: ModelConfig, p, mesh) -> int:
    """E_loc; the expert leaves must hold this rank's experts only."""
    E_loc = cfg.n_experts // mesh.shape["model"]
    if p["wei"].shape[0] != E_loc:
        raise ValueError(f"under a mesh with model={mesh.shape['model']} the expert "
                         f"leaves hold {E_loc} experts a rank, got {p['wei'].shape[0]}")
    return E_loc


def _moe_ffn_a2a(cfg: ModelConfig, p, x, mesh):
    """Sequence-split tokens + all-to-all dispatch (falls back to ep when S
    does not split over "model")."""
    B, S, D = x.shape
    K = cfg.experts_per_token
    M = mesh.shape["model"]
    if S % M != 0:
        return _moe_ffn_ep(cfg, p, x, mesh)  # seq not splittable: fall back
    E_loc = _local_experts(cfg, p, mesh)
    Sl = S // M
    xt = shd.split_along(x, mesh, "model", 1).reshape(B * Sl, D)
    C = expert_capacity(cfg, B * Sl)         # per-source-shard bucket size
    # each rank routes only its slice: the router's cotangents sum over "model"
    flat_e, pos, gatew, aux = _route(cfg, xt, shd.copy_to_axis(p["wr"], mesh, "model"))
    # destination shard + local expert of each assignment; the (dest, le)
    # bucket key is dest*E_loc + le == flat_e, so the stable sort that
    # positions an assignment in its bucket is _route's
    dest = torch.div(flat_e, E_loc, rounding_mode="floor")
    le = flat_e - dest * E_loc
    keep = pos < C
    bpos_c = torch.where(keep, pos, 0)
    xe = torch.repeat_interleave(xt, K, dim=0)
    send = torch.zeros((M, E_loc, C, D), dtype=xt.dtype, device=xt.device)
    send = send.index_put((dest, le, bpos_c), torch.where(keep[:, None], xe, 0),
                          accumulate=True)
    # exchange buckets: each shard receives its experts' tokens from all
    recv = shd.all_to_all(send, mesh, "model")                  # (M, E_loc, C, D)
    buf = recv.movedim(0, 1).reshape(E_loc, M * C, D)
    y = _expert_compute(buf, p["wei"], p["weg"], p["weo"])     # (E_loc, M*C, D)
    back = y.reshape(E_loc, M, C, D).movedim(1, 0)
    got = shd.all_to_all(back, mesh, "model")                   # (M, E_loc, C, D)
    yt = got[dest, le, bpos_c] * torch.where(keep, gatew, 0.0)[:, None].to(y.dtype)
    out = yt.reshape(B * Sl, K, D).sum(dim=1).reshape(B, Sl, D)
    aux = shd.reduce_from_axis(aux, mesh, "model") / M
    return shd.gather_along(out, mesh, "model", 1), aux


def _moe_ffn_ep(cfg: ModelConfig, p, x, mesh):
    """Expert parallel over "model": tokens replicated, experts split."""
    B, S, D = x.shape
    E_loc = _local_experts(cfg, p, mesh)
    xt = x.reshape(B * S, D)
    C = expert_capacity(cfg, B * S)  # per-batch-shard capacity
    flat_e, pos, gatew, aux = _route(cfg, xt, p["wr"])
    # xt and the gates enter per-rank work: their cotangents sum over "model"
    out = _dispatch_compute_combine(
        cfg, shd.copy_to_axis(xt, mesh, "model"), p["wei"], p["weg"], p["weo"],
        flat_e, pos, shd.copy_to_axis(gatew, mesh, "model"), C,
        mesh.index("model") * E_loc, E_loc)
    out = shd.reduce_from_axis(out, mesh, "model")
    return out.reshape(B, S, D), aux
