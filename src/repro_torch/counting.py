"""What a program does on its tensors, counted op by op: the dry run's and the
roofline's measure (``launch/dryrun.py``, ``launch/roofline.py``).

``WorkCounter`` is a ``TorchDispatchMode``.  Inside it every aten op that
does work is tallied, on fake tensors (the dry run: nothing is computed or
allocated) as on real ones (the card's run that checks the dry run):

* ``ops``: device ops, every aten op but views and bare allocations
  (``empty`` and its kin), plus one a kernel call;
* ``flops``: by dtype name, from ``torch.utils.flop_counter``'s registry
  (matrix products, batched products, convolutions, attention; an
  elementwise op counts none), plus the hand-written kernels' own
  formulas, which their wrappers report through ``add_kernel``;
* ``bytes``: each op's tensor inputs read once and its outputs written
  once (an in-place op's written tensor once), plus the kernels' formulas.
  The port runs eagerly and fuses nothing, so this is its traffic to device
  memory, L2 hits aside;
* ``kernels``: calls, FLOPs and bytes of each kernel;
* memory (``track_memory``): the bytes of every live storage, each rounded
  up to the 512-byte blocks of the CUDA caching allocator (what
  ``torch.cuda.max_memory_allocated`` counts), and the peak with its parts
  (``peak_parts``): the storages held before the program ran (``adopt``,
  under a part name each), those allocated under ``part(...)`` (the
  gathered parameters, ``sharding.NamedSharding.gather``), and the rest,
  split into ``activations`` (allocated before the backward began, with
  ``split_activations``) and ``temporaries``.

A scan step stands for many (``models/scan_utils``): ``scaled(n)`` counts
the ops of a block n times, ``stand_for`` makes the autograd nodes created
in it count n times when the backward runs them (a pre-hook on each: the
engine runs one graph's nodes in the reverse order of their creation, so
the scale a node sets holds until the next hooked node) and weighs the
storages it leaves alive n times (the n steps' saved tensors and outputs).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

BLOCK = 512   # the CUDA caching allocator's rounding of an allocation
_ALLOC_ONLY = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided"}


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def active_counter() -> "WorkCounter | None":
    """The innermost ``WorkCounter`` on the dispatch mode stack, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, WorkCounter):
            return mode
    return None


@contextmanager
def part(name: str):
    """Storages allocated inside the block count under ``name`` in the
    active counter's memory parts (a no-op without a counter)."""
    c = active_counter()
    if c is None:
        yield
        return
    prev, c._part = c._part, name
    try:
        yield
    finally:
        c._part = prev


def kernel_call(name: str, work):
    """The active counter with a call of kernel ``name`` added, its work
    ``work()`` = (bytes, float32 operations) by the kernel's formula; None
    without a counter."""
    counter = active_counter()
    if counter is not None:
        n_bytes, flops = work()
        counter.add_kernel(name, flops, n_bytes, "float32")
    return counter


def plain_call(counter, fn, *args):
    """``fn(*args)``, a kernel's plain version, uncounted under ``counter``
    (the kernel's work is counted instead), its outputs tracked as the
    kernel's would be."""
    if counter is None:
        return fn(*args)
    with counter.paused():
        out = fn(*args)
    counter.adopt(out)
    return out


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


@dataclass
class _Block:
    """A storage's life in event indices: live from ``born`` up to ``dead``,
    weighing more from each ``(event, factor)`` of ``factors`` on."""
    nbytes: int
    part: str
    born: int
    dead: int | None = None
    weight: int = 1
    factors: list = field(default_factory=list)

    def weight_at(self, t: int) -> int:
        w = 1
        for event, factor in self.factors:
            if event <= t:
                w *= factor
        return w


def _view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _written(func) -> frozenset:
    return frozenset(a.name for a in func._schema.arguments
                     if a.alias_info is not None and a.alias_info.is_write)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class WorkCounter(TorchDispatchMode):
    """Counts device ops, FLOPs by dtype, bytes and kernels of everything run
    inside it, and (``track_memory``) the live storages' bytes and their
    peak.  See the module's docstring."""

    def __init__(self, *, track_memory: bool = True, split_activations: bool = False):
        super().__init__()
        self.ops = 0
        self.flops: dict = defaultdict(int)
        self.bytes = 0
        self.kernels: dict = {}
        self.scale = 1
        self.track_memory = track_memory
        self.split_activations = split_activations
        self._paused = 0
        self._part = None
        self._backward_seen = False
        self._blocks: list[_Block] = []
        self._seen = WeakIdKeyDictionary()
        self._finalizers: list = []
        self._event = 0
        self.live = 0
        self.peak = 0
        self._peak_at = 0
        self._kinds: dict = {}

    # ---------------------------------------------------------------- ops

    def _kind(self, func):
        """(counted, view, written args) of an op, cached."""
        k = self._kinds.get(func)
        if k is None:
            ns, name = func._schema.name.split("::")
            view = _view(func)
            counted = ns == "aten" and not view and name not in _ALLOC_ONLY
            k = self._kinds[func] = (counted, view, _written(func))
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        counted, view, written = self._kind(func)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if counted and (outs or written):
            s = self.scale
            self.ops += s
            packet = func._overloadpacket
            if packet in flop_registry:
                first = next(t for t in tree_leaves((args, kwargs))
                             if isinstance(t, torch.Tensor))
                n = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops[str(first.dtype).removeprefix("torch.")] += s * int(n)
            if written:   # the written tensor counts once, as an output
                names = [a.name for a in func._schema.arguments]
                inputs = [a for i, a in enumerate(args) if names[i] not in written]
                inputs += [a for key, a in kwargs.items() if key not in written]
            else:
                inputs = [args, kwargs]
            read = sum(_nbytes(t) for t in tree_leaves(inputs) if isinstance(t, torch.Tensor))
            self.bytes += s * (read + sum(_nbytes(t) for t in outs))
        if self.track_memory and not view and not written:
            if not self._backward_seen and torch._C._current_graph_task_id() >= 0:
                self._backward_seen = True
            for t in outs:
                self._adopt(t)
        return out

    def add_kernel(self, name: str, flops: int, n_bytes: int, dtype: str) -> None:
        s = self.scale
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += s
        k["flops"] += s * int(flops)
        k["bytes"] += s * int(n_bytes)
        self.ops += s
        self.flops[dtype] += s * int(flops)
        self.bytes += s * int(n_bytes)

    @contextmanager
    def paused(self):
        """Run ops uncounted and untracked (a plain version standing in for
        a kernel whose work its wrapper reports)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    @contextmanager
    def scaled(self, n: int):
        """Count the ops of the block ``n`` times."""
        prev, self.scale = self.scale, n
        try:
            yield
        finally:
            self.scale = prev

    # -------------------------------------------------------------- memory

    def _adopt(self, t, part: str | None = None) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        if part is None:
            part = self._part or ("activations" if self.split_activations
                                  and not self._backward_seen else "temporaries")
        i = len(self._blocks)
        self._event += 1
        b = _Block(_rounded(st.nbytes()), part, self._event)
        self._blocks.append(b)
        self._seen[st] = i
        self._finalizers.append(weakref.finalize(st, self._free, i))
        self._grow(b.nbytes)

    def adopt(self, tree, part: str | None = None) -> None:
        """Track the storages of ``tree``'s tensors: made while paused, or
        held before the program runs (its state, its cache: ``part``)."""
        if self.track_memory:
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._adopt(t, part)

    def hold_bytes(self, nbytes: int, part: str) -> None:
        """Bytes held throughout, with no storage here (a rank's batch
        shard, which lands on its card inside the step)."""
        self._event += 1
        self._blocks.append(_Block(_rounded(nbytes), part, self._event))
        self._grow(self._blocks[-1].nbytes)

    def _grow(self, n: int) -> None:
        self.live += n
        if self.live > self.peak:
            self.peak, self._peak_at = self.live, self._event

    def _free(self, i: int) -> None:
        b = self._blocks[i]
        self._event += 1
        b.dead = self._event
        self.live -= b.nbytes * b.weight

    def mark(self) -> int:
        """A point in the storage log (for ``stand_for``)."""
        return len(self._blocks)

    def weigh_since(self, mark: int, factor: int) -> None:
        """Storages allocated since ``mark`` and still alive weigh
        ``factor`` times more from now on."""
        self._event += 1
        for b in self._blocks[mark:]:
            if b.dead is None:
                b.factors.append((self._event, factor))
                self._grow(b.nbytes * b.weight * (factor - 1))
                b.weight *= factor

    def peak_parts(self) -> dict:
        """The live bytes at the peak by part."""
        parts: dict = defaultdict(int)
        t = self._peak_at
        for b in self._blocks:
            if b.born <= t and (b.dead is None or b.dead > t):
                parts[b.part] += b.nbytes * b.weight_at(t)
        return dict(parts)

    def storage_bytes(self, tree) -> int:
        """The rounded bytes of ``tree``'s distinct storages."""
        seen, n = set(), 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in seen:
                    seen.add(id(st))
                    n += _rounded(st.nbytes())
        return n

    def retag(self, tree, part: str) -> None:
        """Count ``tree``'s storages (the program's outputs) under ``part``."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                i = self._seen.get(t.untyped_storage())
                if i is not None:
                    self._blocks[i].part = part

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        self._finalizers = []
        return super().__exit__(*exc)

    def summary(self) -> dict:
        return {"ops": int(self.ops), "flops": dict(self.flops), "bytes": int(self.bytes),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


# ------------------------------------------------------------- scan steps

def scan_counter(x) -> WorkCounter | None:
    """The counter that a scan over ``x`` may count by standing steps: the
    active one when ``x`` is fake (nothing is computed), else None."""
    return active_counter() if is_fake(x) else None


def _autograd_mark() -> int:
    """The sequence number of a node made now: every node made later has a
    larger one."""
    with torch.enable_grad():
        return (torch.zeros((), requires_grad=True) * 1).grad_fn._sequence_nr()


def stand_for(counter: WorkCounter, fn, weight: int, factor: int):
    """``fn()`` standing for ``factor`` runs of itself inside a block that
    stands for ``weight / factor``: its ops count ``weight`` times now, its
    autograd nodes ``weight`` times when the backward runs them (nodes an
    inner ``stand_for`` hooked keep their own weight), and the storages it
    leaves alive weigh ``factor`` times more."""
    grad = torch.is_grad_enabled()
    if grad:
        with counter.paused():
            seq = _autograd_mark()
    m = counter.mark()
    with counter.scaled(weight):
        out = fn()
    if factor != 1:
        counter.weigh_since(m, factor)
    if grad:
        _hook_nodes(counter, out, seq, weight)
    return out


def _hook_nodes(counter: WorkCounter, out, seq: int, weight: int) -> None:
    """A pre-hook setting the scale to ``weight`` on every node made since
    ``seq`` that ``out`` reaches and no inner block hooked."""
    todo = [t.grad_fn for t in tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen = set()

    def pre(_grads):
        counter.scale = weight

    while todo:
        node = todo.pop()
        if node is None or id(node) in seen or type(node).__name__ == "AccumulateGrad" \
                or node._sequence_nr() <= seq:
            continue
        seen.add(id(node))
        if not node.metadata.get("counted"):
            node.metadata["counted"] = True
            node.register_prehook(pre)
        todo.extend(n for n, _ in node.next_functions)


def fake_mode_active() -> bool:
    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def fake_mode():
    """A context in which tensors are made fake: the active
    ``FakeTensorMode``'s (nothing to enter), or a new one."""
    return nullcontext() if fake_mode_active() else FakeTensorMode()
