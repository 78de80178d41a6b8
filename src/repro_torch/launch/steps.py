"""Step functions: the train step (one device, or sharded over a mesh),
prefill and one greedy decode step (one device, or sharded), the inputs'
and the state's shapes without allocation, and the sharding glue (the
counterpart of ``repro.launch.steps``).  ``input_specs``, ``abstract_state``
and ``abstract_cache`` build fake tensors (``FakeTensorMode``: shapes and
dtypes, no storage) where the reference's ``eval_shape`` gives
``ShapeDtypeStruct``s; the dry run (``launch/dryrun.py``) runs the steps on
them.

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

The sharded prefill and decode steps (``make_sharded_prefill_step``,
``make_sharded_decode_step``) are the counterparts of the reference's
``jax.jit(prefill_step / decode_step, in_shardings=..., out_shardings=...)``
(its dry run's): the parameters gathered whole as above (with
``fsdp_axes=()``, the reference's ``infer-tp``, only the state at rest
changes), the batch split by ``data_spec``, the model run under
``use_mesh`` without autograd.  Each rank's logits and next tokens are its
batch shard's, and so is its cache, kept as computed: the batch shard over
the batch axes with whole heads and the whole sequence, the same on every
rank of "model" (``cache_rank_shardings``), where the reference's
``cache_spec`` also splits the heads (or the sequence) over "model".
"""
from __future__ import annotations

from math import prod

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.counting import fake_mode
from repro_torch.models import cache as cache_mod
from repro_torch.models import model as model_mod
from repro_torch.kernels.adamw import grad_sq_norm
from repro_torch.optim import clip_scale, get_optimizer, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, tree_unflatten


# ------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Fake stand-ins for every model input (no allocation), the
    reference's shapes and dtypes.

    train:   tokens (B, S+1) int32 [+ frames/patches stubs]
    prefill: tokens (B, S) int32 [+ stubs]
    decode:  tokens (B, 1) int32 (the cache is built separately)
    """
    B, S = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    with fake_mode():
        tok_len = S + 1 if shape.kind == "train" else S if shape.kind == "prefill" else 1
        if cfg.family == "vlm" and shape.kind != "decode":
            # patches count toward seq_len: text tokens = S - n_vision_tokens
            St = S - cfg.n_vision_tokens
            tok_len = St + 1 if shape.kind == "train" else St
        specs = {"tokens": torch.empty((B, tok_len), dtype=i32)}
        if cfg.family == "audio" and shape.kind != "decode":
            specs["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model), dtype=f32)
        if cfg.family == "vlm" and shape.kind != "decode":
            specs["patches"] = torch.empty((B, cfg.n_vision_tokens, cfg.d_model), dtype=f32)
    return specs


def abstract_state(cfg: ModelConfig, seed: int = 0, device="cpu"):
    """The train state ``{"params", "opt", "step"}`` as fake tensors on
    ``device`` (no allocation; ``launch.train.build_state``'s shapes)."""
    opt = get_optimizer(cfg.optimizer)
    with fake_mode():
        params = model_mod.init_params(seed, cfg, device=device)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig, device="cpu"):
    """The cache of ``shape`` (``global_batch`` sequences of ``seq_len``
    positions) as fake tensors on ``device``."""
    with fake_mode():
        return cache_mod.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)


# ------------------------------------------------------------- steps

def make_train_step(cfg: ModelConfig, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0):
    """``train_step(state, batch) -> (new_state, metrics)`` for a state
    ``{"params", "opt", "step"}`` on one device and a batch with tokens (B,
    S+1).  As in the reference: the gradients of ``loss_fn`` are clipped to
    ``clip_norm`` by their global norm, then the rate is read from the
    schedule at ``state["step"]``, then the optimizer updates.  The norm and
    the clip's scale come from ``kernels/adamw.grad_sq_norm`` (one read of
    the gradients on a card), and the optimizer scales each gradient as it
    updates (no clipped copy).  The state passed in is left as it is.
    Metrics (0-d tensors): loss, ce, aux, gnorm (before clipping), lr."""
    opt = get_optimizer(cfg.optimizer)
    lr_fn = linear_warmup_cosine(base_lr, warmup, total_steps)

    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss, parts = model_mod.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        gnorm, scale = grad_sq_norm(grads, clip_norm)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(tree_unflatten(params, grads), state["opt"],
                                         state["params"], lr, scale=scale)
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


# ------------------------------------------------------------- sharded steps

def _local_batch(batch, mesh):
    """This rank's batch shard (split over the batch axes by ``data_spec``)
    and those axes."""
    bax = shd.entry_axes(shd._bax(mesh, len(batch["tokens"])))
    return {k: shd.local_slice(torch.as_tensor(v), mesh, bax, 0)
            for k, v in batch.items()}, bax


def _gathered(params, psh, keep):
    """The parameters whole for compute; the leaves of ``keep`` (the
    experts, where split) stay split over "model"."""
    with torch.no_grad():
        return tree_map(lambda p, sh, kp: sh.gather(p, keep=kp), params, psh, keep)


def make_sharded_prefill_step(cfg: ModelConfig, mesh, params_sh, *,
                              max_seq: int | None = None):
    """``prefill_step(params, batch) -> (logits, cache)`` on ``mesh``:
    ``params`` holds this rank's shards (``shard_tree(full, params_sh)``),
    the batch is the global one, split here by ``data_spec``.  Returns this
    rank's batch shard's last-token logits (float32) and its cache (see the
    module's docstring).  Every rank of the mesh calls it."""
    keep = tree_map_with_path(shd.expert_axes, params_sh)

    def prefill_step(params, batch):
        local, bax = _local_batch(batch, mesh)
        view = _gathered(params, params_sh, keep)
        with shd.use_mesh(mesh, batch_axes=bax), torch.no_grad():
            return cache_mod.prefill(cfg, view, local, max_seq=max_seq)

    return prefill_step


def make_sharded_decode_step(cfg: ModelConfig, mesh, params_sh):
    """``decode_step(params, cache, batch) -> (next_tok, new_cache)`` on
    ``mesh``: ``cache`` is this rank's (its batch shard's, as the sharded
    prefill returns it), the batch the global tokens (B, 1); returns this
    rank's greedy next tokens (int32) and its new cache.  Every rank of the
    mesh calls it."""
    keep = tree_map_with_path(shd.expert_axes, params_sh)

    def decode_step(params, cache, batch):
        local, bax = _local_batch(batch, mesh)
        view = _gathered(params, params_sh, keep)
        with shd.use_mesh(mesh, batch_axes=bax), torch.no_grad():
            logits, new_cache = cache_mod.decode_step(cfg, view, cache, local["tokens"])
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), new_cache

    return decode_step


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
        local, bax = _local_batch(batch, mesh)
        n_b = prod(mesh.shape[a] for a in bax)
        view = tree_map(lambda p: p.detach().requires_grad_(),
                        _gathered(state["params"], psh, keep))
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
            lr = lr_fn(state["step"])
            new_params, new_opt = opt.update(grads, state["opt"], state["params"], lr,
                                             shardings=psh,
                                             scale=clip_scale(gnorm, clip_norm))
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


def cache_rank_shardings(cache, mesh):
    """How the sharded prefill and decode hold a cache: ``cache_spec``'s
    batch split, with "model" left out (whole heads and sequence)."""
    def spec(path, leaf):
        full = shd.cache_spec(path, tuple(leaf.shape), mesh)
        return shd.NamedSharding(mesh, shd.P(*(None if e == "model" else e for e in full)))
    return tree_map_with_path(spec, cache)
