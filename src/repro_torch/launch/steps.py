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
from repro_torch.counting import active_counter, fake_mode, is_fake
from repro_torch.kernels import ops
from repro_torch.models import cache as cache_mod
from repro_torch.models import model as model_mod
from repro_torch.kernels.adamw import grad_sq_norm
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.optim import clip_scale, get_optimizer, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path, tree_unflatten

# the single-device train steps by how they ran: replayed from a CUDA graph
# ("graph") or op by op ("eager")
_M_STEPS = _OBS_REGISTRY.counter(
    "repro_train_steps_total", "single-device train steps by path (graph or eager)",
    labelnames=("path",))
_M_GRAPH, _M_EAGER = (_M_STEPS.labels(path=p) for p in ("graph", "eager"))


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
    updates (no clipped copy).  Metrics (0-d tensors): loss, ce, aux, gnorm
    (before clipping), lr.

    On a card the step is replayed from CUDA graphs.  That engages where
    every leaf of the state is a CUDA tensor on one device (not fake, and no
    ``counting.WorkCounter`` active) and every batch value a tensor there, a
    CPU tensor or an array; other steps run op by op, as on the CPU.  At
    each batch shape and dtypes (a key) the first two calls run op by op, the
    second on a side stream (the warm-up capture asks for); the third
    captures and replays, and so does every later call at that key.  The
    state then lives in two buffers that the step owns: the state handed to
    the first capturing call (adopted where each leaf is contiguous with a
    storage of its own, else copied) and one more allocated beside it; a
    replay reads one and writes the other, the batch copied into the key's
    input first.  The graphs' work is the op-by-op step's, kernel for
    kernel, and each replay adds the launches it holds to the kernels'
    counters (``kernels/ops.launch_counts``).  Metrics are copies.  The
    graphs' working memory (gradients, recomputed activations) is one pool,
    held from the capture on; the first replay after a capture empties the
    allocator's cache once (``_Graphed._replay``).
    ``repro_train_steps_total{path="graph"|"eager"}`` counts the calls.

    Nothing that a call hands in or returns is changed by that call.  Once
    a key is captured, a state handed in may be written over by the next
    call, and a state returned holds its values through the next call and
    may be written over by the one after: the usual ``state = step(state,
    batch)`` loop sees neither."""
    opt = get_optimizer(cfg.optimizer)
    lr_fn = linear_warmup_cosine(base_lr, warmup, total_steps)

    def run(state, batch, out=None):
        """The step op by op; with ``out`` (a state of the same leaves, none
        of them an input) the new state is written into its tensors."""
        params = tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss, parts = model_mod.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, tree_leaves(params))
        gnorm, scale = grad_sq_norm(grads, clip_norm)
        lr = lr_fn(state["step"])
        new_params, new_opt = opt.update(
            tree_unflatten(params, grads), state["opt"], state["params"], lr, scale=scale,
            out=None if out is None else (out["params"], out["opt"]))
        step = state["step"] + 1
        new_state = {"params": new_params, "opt": new_opt,
                     "step": step if out is None else out["step"].copy_(step)}
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(), "gnorm": gnorm, "lr": lr}
        return new_state, metrics

    return _Graphed(run)


_CPU = torch.device("cpu")


def _graph_device(state, batch):
    """The CUDA device of ``state`` where a train step on it may replay a
    graph (``make_train_step``'s docstring), else None."""
    leaves = tree_leaves(state)
    dev = leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else None
    if dev is None or dev.type != "cuda" or active_counter() is not None:
        return None
    if not all(isinstance(t, torch.Tensor) and t.device == dev and not is_fake(t)
               for t in leaves):
        return None
    if any(isinstance(v, torch.Tensor) and (is_fake(v) or v.device not in (dev, _CPU))
           for v in batch.values()):
        return None
    return dev


def _signature(state) -> list:
    """Each leaf's key path, shape, dtype and device."""
    return tree_leaves(tree_map_with_path(
        lambda path, t: (path, tuple(t.shape), t.dtype, t.device), state))


class _Graphed:
    """``run(state, batch, out=None)`` replayed from CUDA graphs where
    ``make_train_step``'s docstring says.

    The state's two buffers are ``bufs[0]`` and ``bufs[1]`` (leaves in
    ``tree_leaves`` order).  A key holds its static batch and two graphs,
    ``graphs[i]`` reading buffer i and writing buffer 1 - i, each with its
    static metrics and its launches.  ``last`` is the buffer holding the
    state the last call returned (None: neither), which no call writes; a
    call whose state lies in no buffer runs op by op into the buffer it may
    write, so the next call replays.  All graphs share one memory pool
    (``_capture``) and one side stream (the warm-up's and the captures')."""

    def __init__(self, run):
        self.run = run
        self.calls: dict = {}     # key -> calls so far
        self.graphs: dict = {}    # key -> (static batch, [(graph, metrics, launches)] * 2)
        self.bufs = self.ptrs = self.like = self.sig = None
        self.last = None
        self.stream = self.pool = self.block = None
        self.fresh = False

    def __call__(self, state, batch):
        dev = _graph_device(state, batch)
        if dev is None:
            _M_EAGER.inc()
            return self.run(state, batch)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            if n >= 3 and self.bufs is None:
                self._adopt(state)
                src = 0     # the state's values, whether adopted or copied
            else:
                src = self._buffer_of(state)
            if n >= 3 and src is not None and self.last in (None, src):
                return self._replay(key, batch, src)
            # op by op, into a buffer that holds neither this state nor the
            # last one returned, where the state fits the buffers
            free = [] if self.bufs is None or _signature(state) != self.sig else \
                [i for i in (0, 1) if i not in (src, self.last)]
            out = free[0] if free else None
            self.last = out
            _M_EAGER.inc()
            if n != 2:
                return self.run(state, batch, self._state(out))
            here = torch.cuda.current_stream()
            self.stream.wait_stream(here)
            with torch.cuda.stream(self.stream):
                new = self.run(state, batch, self._state(out))
            here.wait_stream(self.stream)
            return new

    def _state(self, i):
        return None if i is None else tree_unflatten(self.like, self.bufs[i])

    def _adopt(self, state) -> None:
        """Buffer 0: ``state``'s leaves where each is contiguous and has a
        storage of its own, else a copy of every leaf; buffer 1 new."""
        own = tree_leaves(state)
        if not all(t.is_contiguous() for t in own) or \
                len({t.untyped_storage().data_ptr() for t in own}) < len(own):
            own = [t.clone(memory_format=torch.contiguous_format) for t in own]
        self.bufs = [own, [torch.empty_like(t) for t in own]]
        self.ptrs = [[t.data_ptr() for t in b] for b in self.bufs]
        self.like = tree_map(lambda _: None, state)
        self.sig = _signature(state)

    def _buffer_of(self, state):
        """The buffer whose tensors ``state``'s leaves are, or None."""
        if self.bufs is None:
            return None
        ptrs = [t.data_ptr() for t in tree_leaves(state)]
        for i in (0, 1):
            if ptrs == self.ptrs[i] and _signature(state) == self.sig:
                return i
        return None

    def _capture(self, key, batch) -> None:
        """The key's static batch and its two graphs; the kernels' launch
        counters are left as they were.

        All graphs share one pool, made at the first capture as one block
        sized from a probe: the graph reading buffer 0, captured in a pool
        of its own and then freed.  A pool grown as a capture asks holds
        segments each of a request's size, which no later request merges:
        rwkv6-1.6b's reserved 12.4 GB for a live peak of 8.35 GB (PERF.md
        §6).  One block is split and merged again in place."""
        static = {k: torch.empty_like(v, device=torch.cuda.current_device())
                  for k, v in batch.items()}
        if self.pool is None:
            torch.cuda.empty_cache()
            held, live = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
            probe = self._graph(torch.cuda.graph_pool_handle(), 0, static)
            # the probe's live peak, or more where the process peaked higher
            # before, with an eighth for the gaps splitting leaves
            peak = torch.cuda.max_memory_allocated() - live
            size = min(torch.cuda.memory_reserved() - held, peak + peak // 8)
            del probe
            torch.cuda.empty_cache()
            self.pool = torch.cuda.graph_pool_handle()
            # a graph that allocates the block and frees it into the pool;
            # kept, since a pool no live graph holds is emptied
            self.block = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.block, pool=self.pool, stream=self.stream):
                torch.empty(size, dtype=torch.uint8, device=torch.cuda.current_device())[:1] \
                    .zero_()
        self.graphs[key] = (static, [self._graph(self.pool, src, static) for src in (0, 1)])
        self.fresh = True

    def _graph(self, pool, src, static):
        """The graph reading buffer ``src`` and ``static`` into buffer 1 -
        src, captured in ``pool``: (graph, its metrics, the launches it
        holds)."""
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_snapshot()
        # the context synchronizes and empties the allocator's cache
        with torch.cuda.graph(graph, pool=pool, stream=self.stream):
            _, metrics = self.run(self._state(src), static, self._state(1 - src))
        after = ops.launch_snapshot()
        launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        ops.add_launches({k: -n for k, n in launches.items()})
        return graph, metrics, launches

    def _replay(self, key, batch, src):
        if key not in self.graphs:
            self._capture(key, batch)
        elif self.fresh:
            # the capture emptied the allocator's cache; what was cached
            # since is what the caller freed around the capturing call,
            # which op-by-op steps would have held in their own freed blocks
            torch.cuda.empty_cache()
            self.fresh = False
        static, graphs = self.graphs[key]
        for k, v in batch.items():
            static[k].copy_(v)
        graph, metrics, launches = graphs[src]
        graph.replay()
        ops.add_launches(launches)
        self.last = 1 - src
        _M_GRAPH.inc()
        return self._state(1 - src), {k: v.clone() for k, v in metrics.items()}


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
