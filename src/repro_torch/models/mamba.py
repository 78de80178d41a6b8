"""Mamba (S6 selective SSM) block for the Jamba hybrid architecture.

The counterpart of ``repro.models.mamba``, as plain torch ops in the
reference's order and dtypes (the reference has no Pallas kernel here: its
scan is ``lax.scan`` through ``scan_utils.chunked_scan``):

- ``_conv_causal`` is the depthwise causal convolution as a sum of shifted
  products in ``x``'s dtype, taps in order, the bias added last; not
  ``F.conv1d``, which sums in another order and accumulates in float32;
- ``_ssm_scan`` runs in float32 whatever the compute dtype, a step at a
  time through ``chunked_scan`` (recompute per 128-step chunk under
  autograd);
- ``mamba_block`` without a state is the training / forward path; with a
  state (``{"conv": (B, KC-1, DI), "ssm": (B, DI, N)}``, float32) it
  continues from the carry, as prefill (from ``mamba_init_state``'s zeros)
  and decode do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import apply_norm, dense_init, norm_params
from repro_torch.models.scan_utils import chunked_scan


def mamba_params(gen: torch.Generator, cfg: ModelConfig, dtype, *, lead: tuple = ()):
    """One Mamba sublayer's parameters, each leaf with the leading axes
    ``lead``; ``alog`` (log 1..N a row) and ``dskip`` are float32."""
    D, DI, N, R, KC = cfg.d_model, cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank, cfg.ssm_conv
    dev = gen.device
    # log 1..N in numpy on the host: the reference's bits (torch's log of 7
    # is an ulp off), the same on every device
    alog = torch.from_numpy(np.log(np.arange(1, N + 1, dtype=np.float32))).to(dev)
    wconv = torch.randn((*lead, KC, DI), generator=gen, dtype=torch.float32, device=dev)
    return {
        "ln": norm_params(cfg, dtype, lead=lead, device=dev),
        "win": dense_init(gen, D, 2 * DI, dtype, lead=lead),
        "wconv": (wconv / KC ** 0.5).to(dtype),
        "bconv": torch.zeros((*lead, DI), dtype=dtype, device=dev),
        "wxdt": dense_init(gen, DI, R, dtype, lead=lead),
        "wxb": dense_init(gen, DI, N, dtype, lead=lead),
        "wxc": dense_init(gen, DI, N, dtype, lead=lead),
        "wdt": dense_init(gen, R, DI, dtype, lead=lead),
        "bdt": torch.full((*lead, DI), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "alog": alog.expand(*lead, DI, N).contiguous(),
        "dskip": torch.ones((*lead, DI), dtype=torch.float32, device=dev),
        "wout": dense_init(gen, DI, D, dtype, 1.0 / max(cfg.n_layers, 1) ** 0.5, lead=lead),
    }


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _conv_causal(x, w, b):
    """Depthwise causal conv via explicit shifts. x: (B, S, DI), w: (KC, DI)."""
    KC, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(KC):
        shift = KC - 1 - i
        xi = x if shift == 0 else F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _ssm_step(A):
    def step(h, inp):
        ut, dtt, bt, ct = inp  # (B,DI),(B,DI),(B,N),(B,N)
        dA = torch.exp(dtt[..., None] * A)  # (B,DI,N)
        dBu = (dtt * ut)[..., None] * bt[:, None, :]  # (B,DI,N)
        h = h * dA + dBu
        return h, torch.einsum("bdn,bn->bd", h, ct)
    return step


def _ssm_scan(u, dt, Bm, Cm, A, init_state=None):
    """Selective scan in float32. u, dt: (B, S, DI); Bm, Cm: (B, S, N); A:
    (DI, N) (negative).  Returns y (B, S, DI) and the final state (B, DI, N)."""
    Bsz, _, DI = u.shape
    N = Bm.shape[-1]
    h0 = torch.zeros((Bsz, DI, N), dtype=torch.float32, device=u.device) \
        if init_state is None else init_state
    xs = tuple(t.float().transpose(0, 1).contiguous() for t in (u, dt, Bm, Cm))
    h, ys = chunked_scan(_ssm_step(A), h0, xs)
    return ys.transpose(0, 1), h


def mamba_block(cfg: ModelConfig, p, x, state=None):
    """x: (B, S, D). state: None (train / forward) or a dict for the carry.

    Returns (out, new_state), new_state ``{"conv": (B, KC-1, DI), "ssm": (B,
    DI, N)}`` float32 (None without a state when KC = 1)."""
    KC = cfg.ssm_conv
    h = apply_norm(cfg, p["ln"], x)
    xz = h @ p["win"]
    xs, z = torch.chunk(xz, 2, dim=-1)  # (B,S,DI) each

    if state is not None:  # prepend the conv window from the carry
        xs_ext = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
        xc = _conv_causal(xs_ext, p["wconv"], p["bconv"])[:, KC - 1:]
        new_conv = xs_ext[:, -(KC - 1):].float() if KC > 1 else state["conv"]
    else:
        xc = _conv_causal(xs, p["wconv"], p["bconv"])
        new_conv = xs[:, -(KC - 1):].float() if KC > 1 else None
    xc = F.silu(xc)

    dt = _softplus((xc @ p["wxdt"]) @ p["wdt"] + p["bdt"].to(xc.dtype))
    Bm = xc @ p["wxb"]
    Cm = xc @ p["wxc"]
    A = -torch.exp(p["alog"])  # (DI, N)
    init = state["ssm"] if state is not None else None
    y, hN = _ssm_scan(xc, dt, Bm, Cm, A, init)
    y = (y + xc.float() * p["dskip"][None, None]).to(x.dtype)
    out = (y * F.silu(z)) @ p["wout"]
    new_state = {"conv": new_conv, "ssm": hN} \
        if new_conv is not None or state is not None else None
    return out, new_state


def mamba_init_state(cfg: ModelConfig, batch: int, *, device=None):
    """A zero carry on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), **f32),
            "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_d_state), **f32)}
