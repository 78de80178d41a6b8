"""The global-norm clip (the counterpart of the reference's
``clip_by_global_norm`` and ``global_norm`` in ``repro.optim.optimizers``).

A train step clips by scaling: ``clip_scale`` of the gradients' norm is the
factor each gradient is multiplied by, ``scaled`` applies it to one leaf.
The optimizers' updates take that scale and apply it as they read each
gradient, so a step builds no clipped copy; ``clip_to_norm`` and
``clip_by_global_norm`` build the copy, as the reference does.  This module
imports nothing of the port but ``tree``, so the kernels' plain versions
(``kernels/adamw``) build on it too.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of ``tree``'s leaves together (a tree, or a list of
    leaves in the order they are summed), in float32."""
    leaves = tree if isinstance(tree, list) else tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_scale(norm, max_norm: float):
    """The factor that brings a global norm ``norm`` to at most
    ``max_norm`` (0-d, float32)."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def scaled(g, scale):
    """``g`` times the clip's ``scale`` in float32, kept in g's dtype (g
    itself for ``scale`` None): the clip's operation on one leaf."""
    return g if scale is None else (g.float() * scale).to(g.dtype)


def clip_to_norm(tree, gn, max_norm: float):
    """``tree`` scaled so that a global norm ``gn`` becomes at most
    ``max_norm``; each leaf keeps its dtype."""
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: scaled(g, scale), tree)


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled so that its global norm is at most max_norm, the norm
    before)``; each leaf keeps its dtype."""
    gn = global_norm(tree)
    return clip_to_norm(tree, gn, max_norm), gn
