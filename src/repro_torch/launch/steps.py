"""Step functions: the train step, prefill and one greedy decode step (the
counterpart of ``repro.launch.steps``).  The reference's ``input_specs``,
``abstract_state`` and ``abstract_cache`` are ``eval_shape`` helpers for its
dry run and wait with ``launch/dryrun.py``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache as cache_mod
from repro_torch.models import model as model_mod
from repro_torch.optim import clip_by_global_norm, get_optimizer, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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
