"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix.

The WKV6 recurrence per head (state S: (dk, dv)):
    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t
    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(wlog_t)) data-dependent per channel (LoRA on the shifted
input).  The counterpart of ``repro.models.rwkv6``: ``rwkv_time_mix`` runs the
recurrence through the ``wkv6`` kernel wrapper (the CUDA kernel on a CUDA
tensor; on a CPU tensor its plain version ``kernels.wkv6.wkv6_ref``, the
reference's ``wkv6_scan``), for a whole prompt and for one decode token
alike.

The dtypes flow as in the reference: the norms return the compute dtype,
``wr`` stays float32 (``model._FP32_KEEP``), so ``r`` is float32 as JAX's
promotion of a bfloat16 @ float32 product makes it (``layers.mm``); the recurrence
and the group norm run in float32, and the shift states are float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.layers import apply_norm, dense_init, mm, norm_params


def rwkv_params(gen: torch.Generator, cfg: ModelConfig, dtype, *, lead: tuple = ()):
    """One block's parameters, each leaf with the leading axes ``lead``
    (``(n_layers,)`` for the layer stack), drawn on ``gen``'s device."""
    D, HD = cfg.d_model, cfg.rwkv_head_dim
    R = cfg.rwkv_decay_lora
    dev = gen.device
    out_scale = 1.0 / max(cfg.n_layers, 1) ** 0.5
    f32 = dict(dtype=torch.float32, device=dev)

    def dense(d_in, d_out, scale=1.0):
        return dense_init(gen, d_in, d_out, dtype, scale, lead=lead)

    return {
        "ln_t": norm_params(cfg, dtype, lead=lead, device=dev),
        "ln_c": norm_params(cfg, dtype, lead=lead, device=dev),
        # token-shift interpolation coefficients (per channel) for r,k,v,w,g
        "mu": torch.rand((*lead, 5, D), generator=gen, **f32).to(dtype),
        "wr": dense(D, D),
        "wk": dense(D, D),
        "wv": dense(D, D),
        "wg": dense(D, D),
        "wo": dense(D, D, out_scale),
        # data-dependent decay LoRA: wlog = w0 + tanh(x @ wa) @ wb
        "w0": torch.full((*lead, D), -0.6, **f32),
        "wa": dense(D, R),
        "wb": dense(R, D, 0.1),
        "u": torch.randn((*lead, D), generator=gen, **f32) * 0.1,  # bonus, fp32
        "gn_scale": torch.ones((*lead, D), **f32),  # per-head groupnorm on y
        # channel mix
        "mu_ck": torch.rand((*lead, D), generator=gen, **f32).to(dtype),
        "wck": dense(D, cfg.d_ff),
        "wcv": dense(cfg.d_ff, D, out_scale),
    }


def _token_shift(x, x_prev):
    """x: (B,S,D); x_prev: (B,1,D) last token of previous segment (or zeros)."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_time_mix(cfg: ModelConfig, p, x, state=None):
    """state: None or {"shift_t": (B,1,D), "wkv": (B,H,dh,dh)}."""
    B, S, D = x.shape
    HD = cfg.rwkv_head_dim
    H = D // HD
    h = apply_norm(cfg, p["ln_t"], x)
    prev = state["shift_t"] if state is not None \
        else torch.zeros((B, 1, D), dtype=h.dtype, device=h.device)
    xp = _token_shift(h, prev)
    mu = p["mu"].to(h.dtype)
    xr, xk, xv, xw, xg = (h + mu[i] * (xp - h) for i in range(5))
    r = mm(xr, p["wr"]).reshape(B, S, H, HD)
    k = mm(xk, p["wk"]).reshape(B, S, H, HD)
    v = mm(xv, p["wv"]).reshape(B, S, H, HD)
    g = F.silu(mm(xg, p["wg"]))
    wlog = p["w0"].float() + mm(torch.tanh(mm(xw, p["wa"])), p["wb"]).float()
    wlog = wlog.reshape(B, S, H, HD)
    u = p["u"].reshape(H, HD)
    y, s = wkv6(r, k, v, wlog, u, state["wkv"] if state is not None else None)
    # per-head group norm (population variance, as jnp.var)
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = (y.reshape(B, S, D) * p["gn_scale"]).to(x.dtype)
    out = mm(y * g, p["wo"])
    new_state = {"shift_t": h[:, -1:].float(), "wkv": s}
    return out, new_state


def rwkv_channel_mix(cfg: ModelConfig, p, x, state=None):
    B, S, D = x.shape
    h = apply_norm(cfg, p["ln_c"], x)
    prev = state["shift_c"] if state is not None \
        else torch.zeros((B, 1, D), dtype=h.dtype, device=h.device)
    xp = _token_shift(h, prev)
    mu = p["mu_ck"].to(h.dtype)
    xk = h + mu * (xp - h)
    kk = torch.square(F.relu(mm(xk, p["wck"])))
    out = mm(kk, p["wcv"])
    return out, {"shift_c": h[:, -1:].float()}


def rwkv_init_state(cfg: ModelConfig, batch: int, device=None):
    """Zero states of one block on ``device`` (default: the CUDA device)."""
    H = cfg.d_model // cfg.rwkv_head_dim
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return {
        "shift_t": torch.zeros((batch, 1, cfg.d_model), **f32),
        "shift_c": torch.zeros((batch, 1, cfg.d_model), **f32),
        "wkv": torch.zeros((batch, H, cfg.rwkv_head_dim, cfg.rwkv_head_dim), **f32),
    }
