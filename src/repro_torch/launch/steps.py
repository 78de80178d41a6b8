"""Step functions: the train step (one device, or sharded over a mesh),
prefill and one greedy decode step, and the sharding glue (the counterpart
of ``repro.launch.steps``).  The reference's ``input_specs``,
``abstract_state`` and ``abstract_cache`` are ``eval_shape`` helpers for its
dry run and wait with ``launch/dryrun.py``.

The sharded step (``make_sharded_train_step``) computes what the
reference's ``jax.jit(train_step, in_shardings=..., out_shardings=...)``
computes on the same mesh.  Each rank holds its shards of the state
(``sharding.shard_tree`` by ``state_shardings``), as ``shard_map`` would see
them.  A step gathers the parameters whole for compute (the expert leaves
stay split over "model": the expert-parallel MoE paths run under
``use_mesh``), runs ``loss_fn`` on this rank's batch shard under autograd,
averages the gradients over the batch axes, takes the global norm counting
each element once, clips, and updates its own shards.  Dense layers are
computed whole on every rank of "model" (replicated, not tensor-parallel).
Where the rules leave the experts whole (E not divisible by "model"), the
local MoE path routes the whole batch, gathered over the batch axes.
"""
from __future__ import annotations

from math import prod

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as cache_mod
from repro_torch.models import model as model_mod
from repro_torch.optim import (clip_by_global_norm, clip_to_norm, get_optimizer,
                               linear_warmup_cosine)
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, tree_unflatten


def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0):
    """``train_step(state, batch) -> (new_state, metrics)`` for a state
    ``{"params", "opt", "step"}`` on one device and a batch with tokens (B,
    S+1).  As in the reference: the gradients of ``loss_fn`` are clipped to
    ``clip_norm`` by their global norm, then the rate is read from the
    schedule at ``state["step"]``, then the optimizer updates.  The state
    passed in is left as it is.  Metrics (0-d tensors): loss, ce, aux, gnorm
    (before clipping), lr."""
    opt = get_optimizer(cfg.optimizer)
    lr_fn = linear_warmup_cosine(base_lr, warmup, total_steps)

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss, parts = model_mod.loss_fn(cfg, params, batch)
            grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(grads, state["opt"], state["params"], lr)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "gnorm": gnorm, "lr": lr}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int | None = None):
    """``prefill_step(params, batch) -> (logits, cache)``; an attention cache
    holds ``max_seq`` positions (default: the prompt's, a vlm's patches
    included)."""
    def prefill_step(params, batch):
        return cache_mod.prefill(cfg, params, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        logits, new_cache = cache_mod.decode_step(cfg, params, cache, batch["tokens"])
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache
    return decode_step


# ------------------------------------------------------------- sharded step

def make_sharded_train_step(cfg: ModelConfig, mesh, state_sh, *, base_lr: float = 3e-4,
                            warmup: int = 100, total_steps: int = 10_000,
                            clip_norm: float = 1.0):
    """``train_step(state, batch) -> (new_state, metrics)`` on ``mesh``:
    ``state`` holds this rank's shards (``shard_tree(full, state_sh)``), the
    batch is the global one (numpy or CPU tensors, tokens (B, S+1)), split
    here by ``data_spec``.  Every rank of the mesh calls it.  Metrics (0-d
    tensors, identical on every rank): loss, ce and aux as their means over
    the batch shards (``loss_fn`` has no mask: every shard counts the same
    tokens), gnorm (before clipping) and lr."""
    opt = get_optimizer(cfg.optimizer)
    lr_fn = linear_warmup_cosine(base_lr, warmup, total_steps)
    psh = state_sh["params"]
    # expert leaves whose spec splits them over "model" stay split: the ep /
    # a2a paths compute on them
    keep = tree_map_with_path(shd.expert_axes, psh)

    def train_step(state, batch):
        B = len(batch["tokens"])
        bax = shd.entry_axes(shd._bax(mesh, B))
        n_b = prod(mesh.shape[a] for a in bax)
        local = {k: shd.local_slice(torch.as_tensor(v), mesh, bax, 0)
                 for k, v in batch.items()}
        with torch.no_grad():
            view = tree_map(lambda p, sh, kp: sh.gather(p, keep=kp),
                            state["params"], psh, keep)
        view = tree_map(lambda p: p.detach().requires_grad_(), view)
        with shd.use_mesh(mesh, batch_axes=bax), torch.enable_grad():
            # this rank's shard's loss (its ce and its aux): only the average
            # of the gradients below combines the batch shards
            loss, parts = model_mod.loss_fn(cfg, view, local)
            grads = torch.autograd.grad(loss, tree_leaves(view))
        del view
        with torch.no_grad():
            parts = torch.stack([loss.detach(), parts["ce"].detach(),
                                 parts["aux"].detach().float()])
            for g in grads:
                shd.all_reduce_(g, mesh, bax)
            shd.all_reduce_(parts, mesh, bax)
            if n_b > 1:
                grads = [g.div_(n_b) for g in grads]
                parts = parts / n_b
            grads = tree_unflatten(psh, grads)
            # global norm, each element once: a leaf split over "model" sums
            # its blocks' squares over the axis
            sq = tree_leaves(tree_map(lambda g: torch.sum(torch.square(g.float())), grads))
            split = [i for i, kp in enumerate(tree_leaves(keep)) if kp]
            if split and "model" in mesh.axis_names:
                part = shd.all_reduce_(torch.stack([sq[i] for i in split]), mesh, ("model",))
                for j, i in enumerate(split):
                    sq[i] = part[j]
            gnorm = torch.sqrt(sum(sq))
            grads = tree_map(lambda g, sh, kp: sh.shard(g, keep=kp).contiguous(),
                             grads, psh, keep)
            grads = clip_to_norm(grads, gnorm, clip_norm)
            lr = lr_fn(state["step"])
            new_params, new_opt = opt.update(grads, state["opt"], state["params"], lr,
                                             shardings=psh)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        metrics = {"loss": parts[0], "ce": parts[1], "aux": parts[2], "gnorm": gnorm,
                   "lr": lr}
        return new_state, metrics

    return train_step


# ------------------------------------------------------------- sharding glue

def state_shardings(state, mesh, fsdp_axes=("data",)):
    """The state's shardings from its whole leaves' shapes (tensors, or
    anything with ``.shape``)."""
    params_sh = shd.param_shardings(state["params"], mesh, fsdp_axes)
    opt_sh = shd.opt_state_shardings(state["opt"], state["params"], mesh, fsdp_axes)
    return {"params": params_sh, "opt": opt_sh, "step": shd.replicated(mesh)}


def metrics_shardings(mesh):
    return shd.replicated(mesh)
