"""Optimizers on nested dicts of tensors (the counterpart of
``repro.optim.optimizers``).

``Optimizer`` is a pair of functions (init, update) like the reference's:
``update(grads, state, params, lr) -> (new_params, new_state)`` is
functional (it returns new trees and leaves its arguments as they are) and
runs under ``torch.no_grad()``; the learning rate comes from outside, so
schedules stay out of the state.  The states have the reference's leaves
(``{"m", "v", "count"}`` for AdamW, ``{"f", "count"}`` for Adafactor,
``{"m", "count"}`` for SGD with momentum) and its float32 order of
operations.  Weight decay follows the reference's rule ``p.ndim >= 2``: on
the layer-stacked ``(L, ...)`` leaves of a model it also decays norms and
the per-channel vectors, as the reference does.

Every ``update`` takes the global-norm clip's ``scale`` (``optim.clip``'s
``clip_scale`` of the norm; None: no clip) and scales each gradient by it
first, as ``clip_to_norm`` does, so that a step builds no clipped copy of its
gradients.  AdamW's update runs through ``kernels/adamw.adamw_update``: on
a card one fused pass over the leaves, on the CPU the plain version.

Every ``update`` also takes ``out``: a ``(params, state)`` pair of trees of
the new ones' leaves, written in place of new trees and returned (AdamW's
kernel writes its results there directly; the others copy them in).  A
train step replayed from a CUDA graph writes its next state so.

On a mesh, ``update(..., shardings=)`` takes each leaf as this rank's shard
(``sharding.NamedSharding`` per parameter): AdamW and SGD are elementwise,
and Adafactor's means over a split dim (the factored ``vr``/``vc``, their
row mean, the update's RMS) are summed over that dim's axes, so every rank
updates its shard as the whole leaf would be.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# the kernel module by name: it imports optim.clip, which runs this package's
# __init__, so either may be imported first
from repro_torch.kernels import adamw as adamw_kernels
from repro_torch.optim.clip import scaled
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten, tree_unzip


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params, lr) -> (new_params, new_state)
    name: str


def _zeros(p, dtype=torch.float32, shape=None):
    return torch.zeros(p.shape if shape is None else shape, dtype=dtype, device=p.device)


def _count(params):
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _into(out, new):
    """``new``'s leaves copied into ``out``'s (``(params, state)`` pairs of
    trees of one structure); returns ``out``."""
    for dst, src in zip(out, new):
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            d.copy_(s)
    return tuple(out)


def _mean(x, dim, sh, pdim: int, ndim: int, keepdim=False):
    """``x.mean(dim)`` where x's dim ``dim`` is dim ``pdim`` of an
    ``ndim``-dim parameter whose shard's sharding is ``sh``: the mean over
    every rank's block when ``sh`` splits that dim (equal blocks)."""
    m = x.mean(dim=dim, keepdim=keepdim)
    return _mean_over(m, sh, sh.axes(pdim, ndim)) if sh is not None else m


def _mean_over(m, sh, axes):
    if not axes:
        return m
    from repro_torch.sharding import all_reduce_
    n = 1
    for a in axes:
        n *= sh.mesh.shape[a]
    return all_reduce_(m.clone(), sh.mesh, axes) / n


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, shardings=None, scale=None, out=None):
        # elementwise
        c = state["count"] + 1
        bc1 = 1 - b1 ** c.float()
        bc2 = 1 - b2 ** c.float()
        dst = None if out is None else \
            tuple(tree_leaves(t) for t in (out[0], out[1]["m"], out[1]["v"]))
        new_p, new_m, new_v = adamw_kernels.adamw_update(
            *(tree_leaves(t) for t in (grads, state["m"], state["v"], params)),
            lr, bc1, bc2, scale, out=dst, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
        if out is not None:
            c = out[1]["count"].copy_(c)
        return tree_unflatten(params, new_p), {"m": tree_unflatten(params, new_m),
                                               "v": tree_unflatten(params, new_v),
                                               "count": c}

    return Optimizer(init, update, "adamw")


def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8, weight_decay=0.0,
              momentum: bool = False) -> Optimizer:
    """Factored second moment: for a (..., R, C) tensor keep row/col means.

    State per leaf: {"vr": shape[:-1], "vc": shape[:-2]+(C,)} for ndim>=2,
    else {"v": shape}. Optional bf16 first moment when momentum=True.
    """
    def init(params):
        def one(p):
            st = {}
            if p.ndim >= 2:
                st["vr"] = _zeros(p, shape=p.shape[:-1])
                st["vc"] = _zeros(p, shape=p.shape[:-2] + (p.shape[-1],))
            else:
                st["v"] = _zeros(p)
            if momentum:
                st["m"] = _zeros(p, torch.bfloat16)
            return st
        return {"f": tree_map(one, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, shardings=None, scale=None, out=None):
        c = state["count"] + 1
        rho = 1.0 - c.float() ** (-decay)

        def one(g, st, p, sh=None):
            g = scaled(g, scale).float()
            g2 = g * g + eps
            new_st = dict(st)
            n = p.ndim
            if n >= 2:
                vr = rho * st["vr"] + (1 - rho) * _mean(g2, -1, sh, -1, n)
                vc = rho * st["vc"] + (1 - rho) * _mean(g2, -2, sh, -2, n)
                new_st["vr"], new_st["vc"] = vr, vc
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    _mean(vr, -1, sh, -2, n, keepdim=True)[..., None], min=eps)
                u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                v = rho * st["v"] + (1 - rho) * g2
                new_st["v"] = v
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
            # update clipping (RMS)
            ms = torch.mean(u * u)
            rms = torch.sqrt(_mean_over(ms, sh, sh.all_axes()) if sh is not None else ms)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if momentum:
                m = 0.9 * st["m"].float() + u
                new_st["m"] = m.to(torch.bfloat16)
                u = m
            if weight_decay and p.ndim >= 2:
                u = u + weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype), new_st

        rest = (state["f"], params) + (() if shardings is None else (shardings,))
        new_params, new_f = tree_unzip(tree_map(one, grads, *rest), 2)
        new = (new_params, {"f": new_f, "count": c})
        return new if out is None else _into(out, new)

    return Optimizer(init, update, "adafactor")


def sgd_momentum(beta=0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros, params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, shardings=None, scale=None, out=None):
        # elementwise
        def upd(g, m, p):
            m = beta * m + scaled(g, scale).float()
            return (p.float() - lr * m).to(p.dtype), m
        new_params, new_m = tree_unzip(tree_map(upd, grads, state["m"], params), 2)
        new = (new_params, {"m": new_m, "count": state["count"] + 1})
        return new if out is None else _into(out, new)

    return Optimizer(init, update, "sgd_momentum")


def get_optimizer(name: str) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd_momentum": sgd_momentum}[name]()
