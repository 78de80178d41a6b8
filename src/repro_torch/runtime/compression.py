"""Gradient compression: int8 quantization with error feedback (the
counterpart of ``repro.runtime.compression``).

Gradients are quantized to int8 with a per-tensor scale before a
bandwidth-bound all-reduce; the quantization residual is carried into the
next step (error feedback), which keeps SGD/Adam convergence unbiased to
first order.  Trees are the port's nested dicts of tensors.  The rounding is
``torch.round`` (half to even, as ``jnp.round``), and the scale's division
by 127 is an IEEE division on every device (``latency.div_t``).
"""
from __future__ import annotations

import torch

from repro_torch.core.latency import div_t
from repro_torch.tree import tree_leaves, tree_map, tree_unzip


def init_compression_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)


def compress_grads(grads, err_state):
    """-> (int8 tree, scales tree, new err_state)."""
    def one(g, e):
        g = g.float() + e
        scale = div_t(torch.clamp_min(torch.max(torch.abs(g)), 1e-12), 127.0)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_e = g - q.float() * scale
        return q, scale, new_e

    return tree_unzip(tree_map(one, grads, err_state), 3)


def decompress_grads(q, scales):
    return tree_map(lambda qq, s: qq.float() * s, q, scales)


def compression_ratio(grads) -> float:
    """fp32 -> int8 + scale: ~4x less traffic on the compressed axis."""
    leaves = tree_leaves(grads)
    tot = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() * 1 + 4 for g in leaves)
    return tot / comp
