"""The DIMM axis over several devices: the counterpart of the population part
of ``repro.sharding`` (``dimm_mesh``, ``chunk_spans``).

A ``DimmMesh`` is a 1-D list of torch devices.  An entry point given
``mesh=`` splits its batch arguments' DIMM axis into ``mesh.size`` contiguous
shards (``core/substrate._run_sharded``), runs its eager program on each
shard on that shard's device and gathers the outputs on ``devices[0]``.
Every draw is keyed by a DIMM's serial, which travels with its shard, so no
split changes an integer or a decision.  A device may repeat
(``DimmMesh(["cpu"] * 3)``, ``DimmMesh(["cuda:0"] * 2)``): the split, the
clone padding and the gather then run on one device, back to back on its
stream.  That measures the cost of the split and the gather, not a speed-up
across cards.

The training mesh: the counterpart of the rest of ``repro.sharding``.  A
``Mesh`` names its axes (``("data", "model")``, ``("pod", "data",
"model")``), holds this rank's coordinate and one process group per axis,
taken from ``torch.distributed``'s ``init_device_mesh``; a mesh whose axes
are all 1 needs no process group, and its collectives are the identity.  The
name-to-axis rules (``_RULES``) are the reference's, as data: ``param_spec``,
``opt_state_shardings``, ``data_spec``, ``cache_spec`` give the same specs
(``P``, a tuple of ``None`` / axis name / tuple of names) for the same key
paths and shapes.  A ``NamedSharding`` (mesh, spec) cuts a full tensor into
this rank's shard and gathers it back.  ``use_mesh`` makes a mesh ambient,
which ``models.moe.moe_ffn`` reads, the counterpart of ``with mesh:``.  The
collectives the expert-parallel MoE paths differentiate through are
``torch.autograd.Function``s over one axis's group, each with the backward
``shard_map`` would transpose it to: ``copy_to_axis``, ``reduce_from_axis``,
``split_along``, ``gather_along``, ``all_to_all``; and ``gather_summed``,
through which the local MoE path sees the whole batch, as GSPMD's does.
All of them go through three primitives (``all_reduce_``, ``all_gather``
and the all-to-all exchange), which keep a tally of the operand bytes and
calls of each collective kind over each axis (``COLLECTIVES``, the
reference's kind names; ``reset_collectives``).

The dry run's world (``counting_mesh``, asked for by name, never a
default): one rank's ``Mesh`` of a world of any size, e.g. the 256 or 512
ranks of the production meshes, with no process group: each axis above 1
holds a ``CountingGroup``, whose collectives take fake tensors only, move
no data and give outputs of the right shapes, so that a fake rank's program
runs and its collectives are counted.

Left out: the reference's JAX shims (``mesh_axis_types_kw``,
``abstract_mesh``, ``shard_map``; ``AbstractMesh`` here is a plain shape for
the rules), and ``hint`` / ``hint_heads_or_seq``, XLA layout hints with no
counterpart in the port's per-rank programs.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from math import prod

import torch
import torch.distributed as dist

from repro_torch.counting import is_fake
from repro_torch.counting import part as counting_part
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map, tree_map_with_path


@dataclass(frozen=True)
class DimmMesh:
    """A 1-D device mesh over the DIMM axis.  ``devices`` may repeat a
    device; a CUDA entry gets its index (``resolve_device``), and one raises
    when CUDA is not available: no shard quietly runs on the CPU."""
    devices: tuple

    def __post_init__(self):
        devs = tuple(resolve_device(torch.device(d)) for d in self.devices)
        if not devs:
            raise ValueError("a DimmMesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def dimm_mesh(n_devices: int | None = None, *, device=None) -> DimmMesh:
    """The first ``n_devices`` CUDA devices (default: every visible one) as a
    ``DimmMesh``; raises when more are asked for than are visible, or when
    there is no CUDA.  ``device="cpu"`` gives ``n_devices`` CPU entries
    (default 1), the CPU tests' mesh.  Never falls back to the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n <= 0:
            raise ValueError(f"dimm_mesh({n_devices}): need at least one device")
        return DimmMesh(("cpu",) * n)
    if kind != "cuda":
        raise ValueError(f"dimm_mesh: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("dimm_mesh: no CUDA device; pass device='cpu' for "
                           "a CPU mesh")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 0 < n <= count:
        raise ValueError(f"dimm_mesh({n_devices}): only {count} device(s) "
                         "visible")
    return DimmMesh(tuple(torch.device("cuda", i) for i in range(n)))


def mesh_device(mesh: DimmMesh | None, device=None) -> torch.device:
    """Where an entry point places its inputs and gathers its result: the
    mesh's first device (``device`` is then ignored), else ``device``
    (default: the current CUDA device)."""
    return resolve_device(device) if mesh is None else mesh.devices[0]


def chunk_spans(n_dimms: int, chunk_size: int,
                mesh: DimmMesh | None = None) -> list[tuple[int, int]]:
    """[lo, hi) population spans of a chunked scan: fixed-size chunks that
    tile [0, n_dimms) exactly, in serial order.  With a ``mesh`` the chunk
    size is rounded up to a multiple of its size, so every full chunk splits
    evenly and only the last, ragged one needs the shard split's clone
    padding."""
    if n_dimms < 0 or chunk_size <= 0:
        raise ValueError(f"need n_dimms >= 0 < chunk_size; got "
                         f"({n_dimms}, {chunk_size})")
    if mesh is not None:
        chunk_size += (-chunk_size) % mesh.size
    return [(lo, min(lo + chunk_size, n_dimms))
            for lo in range(0, n_dimms, chunk_size)]


# ------------------------------------------------------------ training mesh

class P(tuple):
    """A partition spec: one entry per leading dim, ``None`` (replicated),
    an axis name, or a tuple of axis names (the major one first); dims past
    the last entry are replicated.  ``P()`` replicates the whole leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names only: what the sharding rules read."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return prod(self.axis_sizes)


@dataclass(frozen=True)
class CountingGroup:
    """An axis of the dry run's world: ``size`` ranks, no process group."""
    axis: str
    size: int


@dataclass(frozen=True)
class Mesh(AbstractMesh):
    """A named mesh of ranks, each on ``device``: this rank's coordinate and
    one process group per axis (``groups == ()`` when every axis is 1 and no
    process group is used; its collectives are then the identity).  Build
    it with ``make_mesh``."""
    device: torch.device = None
    coords: tuple = ()
    groups: tuple = ()

    def index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def group(self, name: str):
        return self.groups[self.axis_names.index(name)] if self.groups else None


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def make_mesh(shape, names, *, device=None) -> Mesh | None:
    """A ``Mesh`` of ``shape`` over the first ``prod(shape)`` ranks of the
    initialized ``torch.distributed`` world, on ``device`` (default: the
    CUDA device).  Without an initialized process group only an all-1 mesh
    can be built (no group: identity collectives); any axis above 1 then
    raises.  The backend must follow the device: NCCL for CUDA, gloo for
    the CPU.  A rank past the mesh's ranks gets ``None``: it holds no
    shard."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    dev = resolve_device(device)
    n = prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise RuntimeError(f"a {shape} mesh needs {n} ranks: initialize "
                               f"torch.distributed ({_backend_for(dev)}) first")
        return Mesh(shape, names, dev, (0,) * len(shape), ())
    backend = str(dist.get_backend())
    if _backend_for(dev) not in backend:
        raise RuntimeError(f"a {dev.type} mesh needs the {_backend_for(dev)} "
                           f"backend; the process group runs {backend}")
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has {world}")
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=names)
    coords = dm.get_coordinate()
    if coords is None:
        return None
    return Mesh(shape, names, dev, tuple(int(c) for c in coords),
                tuple(dm.get_group(a) for a in names))


def counting_mesh(shape, names, *, rank: int = 0, device="cpu") -> Mesh:
    """Rank ``rank``'s ``Mesh`` of a world of ``prod(shape)`` ranks laid out
    row-major, for the dry run: no process group, a ``CountingGroup`` on
    each axis above 1 (its collectives count and move nothing; they take
    fake tensors only), no group on an axis of 1."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    if not 0 <= rank < prod(shape):
        raise ValueError(f"rank {rank} is not in a {shape} mesh")
    coords, r = [], rank
    for s in reversed(shape):
        coords.append(r % s)
        r //= s
    groups = tuple(CountingGroup(a, s) if s > 1 else None for a, s in zip(names, shape))
    return Mesh(shape, names, torch.device(device), tuple(reversed(coords)),
                groups if any(groups) else ())


# ambient mesh and batch axes: a module global (not thread-local), since a
# checkpointed layer's forward is rerun from autograd's worker thread on a
# card
_AMBIENT: list = [(None, ())]


@contextmanager
def use_mesh(mesh, *, batch_axes=()):
    """Make ``mesh`` ambient inside the block (``moe_ffn`` takes its
    expert-parallel paths), the counterpart of the reference's ``with
    mesh:``.  Under a mesh a model's activations are this rank's batch
    shard, split over ``batch_axes`` (``()``: the whole batch)."""
    prev, _AMBIENT[0] = _AMBIENT[0], (mesh, tuple(batch_axes))
    try:
        yield mesh
    finally:
        _AMBIENT[0] = prev


def ambient_mesh():
    return _AMBIENT[0][0]


def ambient_batch_axes() -> tuple[str, ...]:
    """The axes the ambient mesh's activations are split over."""
    return _AMBIENT[0][1]


# ---------------------------------------------------------------- collectives

# {(kind, axis): [calls, operand bytes]} since the last reset_collectives()
COLLECTIVES: dict = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _tally(kind: str, axis: str, t: torch.Tensor, g) -> bool:
    """Count one collective of ``kind`` over ``axis`` on operand ``t``;
    True when ``g`` is a ``CountingGroup`` (no data is to move)."""
    entry = COLLECTIVES.setdefault((kind, axis), [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()
    if not isinstance(g, CountingGroup):
        return False
    if not is_fake(t):
        raise TypeError("a counting mesh's collectives take fake tensors only")
    return True


def all_reduce_(t: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axes`` (one all-reduce per
    axis); the identity on a mesh without groups."""
    for a in axes:
        g = mesh.group(a)
        if g is not None and not _tally("all-reduce", a, t, g):
            dist.all_reduce(t, group=g)
    return t


def _flat_index(mesh: Mesh, axes) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes``, the first one major."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.index(a)
    return i, prod(mesh.shape[a] for a in axes)


def local_slice(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, split over ``axes``."""
    i, n = _flat_index(mesh, axes)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def all_gather(t: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of every rank of ``axes`` concatenated along ``dim`` (the
    inverse of ``local_slice``); a new contiguous tensor when any axis has a
    group (a gathered parameter keeps the layout, and so the sums, of the
    whole one)."""
    for a in reversed(axes):
        g = mesh.group(a)
        if g is None:
            continue
        n = mesh.shape[a]
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        if not _tally("all-gather", a, x, g):
            dist.all_gather_into_tensor(out, x, group=g)
        t = out.movedim(0, dim).contiguous()
    return t


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, (ctx.name,)), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        return all_reduce_(x.contiguous().clone(), mesh, (name,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axes)
        return local_slice(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, None, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        return local_slice(x, mesh, (name,), dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, (ctx.name,), ctx.dim), None, None, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        return all_gather(x, mesh, (name,), dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.mesh, (ctx.name,), ctx.dim).contiguous(), None, None, None


def _exchange(x: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """Block i of dim 0 to rank i of the axis; block j of the result from
    rank j (``all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    x = x.contiguous()
    g = mesh.group(name)
    if not _tally("all-to-all", name, x, g):
        dist.all_to_all_single(out, x, group=g)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return _exchange(x, mesh, name)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.mesh, ctx.name), None, None


def copy_to_axis(x, mesh: Mesh, name: str):
    """Identity forward; the cotangents summed over the axis backward (a
    value replicated over the axis entering per-rank work)."""
    return x if mesh.group(name) is None else _CopyToAxis.apply(x, mesh, name)


def reduce_from_axis(x, mesh: Mesh, name: str):
    """Sum over the axis forward (``psum``); identity backward."""
    return x if mesh.group(name) is None else _ReduceFromAxis.apply(x, mesh, name)


def split_along(x, mesh: Mesh, name: str, dim: int):
    """This rank's block along ``dim`` forward; all-gather backward."""
    return x if mesh.group(name) is None else _SplitAlong.apply(x, mesh, name, dim)


def gather_along(x, mesh: Mesh, name: str, dim: int):
    """All-gather along ``dim`` forward; this rank's block backward."""
    return x if mesh.group(name) is None else _GatherAlong.apply(x, mesh, name, dim)


def gather_summed(x, mesh: Mesh, axes, dim: int):
    """All-gather along ``dim`` over ``axes`` forward; backward the
    cotangents summed over the axes, then this rank's block (a value every
    rank of the axes computes from the whole, each rank's loss its own)."""
    if all(mesh.group(a) is None for a in axes):
        return x
    return _GatherSum.apply(x, mesh, tuple(axes), dim)


def all_to_all(x, mesh: Mesh, name: str):
    """Exchange dim 0's blocks (one a rank of the axis) forward; the reverse
    exchange backward."""
    return x if mesh.group(name) is None else _AllToAll.apply(x, mesh, name)


# ----------------------------------------------------------------- the rules

# name -> axis request per trailing dim. "m"=model, "f"=fsdp(data), None=replicate
_RULES: dict[str, tuple] = {
    # embeddings / head
    "tok": ("m", "f"),
    "wlm": ("f", "m"),
    # attention
    "wq": ("f", "m"), "wk": ("f", "m"), "wv": ("f", "m"), "wo": ("m", "f"),
    "bq": ("m",), "bk": ("m",), "bv": ("m",),
    # mlp
    "wi": ("f", "m"), "wg": ("f", "m"), "bi": ("m",), "bo": (None,),
    # moe
    "wr": (None, None),
    "wei": ("m", "f", None), "weg": ("m", "f", None), "weo": ("m", None, "f"),
    # mamba
    "win": ("f", "m"), "wconv": (None, "m"), "bconv": ("m",),
    "wxdt": ("m", None), "wxb": ("m", None), "wxc": ("m", None),
    "wdt": (None, "m"), "bdt": ("m",), "alog": ("m", None),
    "dskip": ("m",), "wout": ("m", "f"),
    # rwkv
    "mu": (None, None), "w0": (None,), "wa": ("f", None), "wb": (None, "f"),
    "u": (None,), "gn_scale": (None,), "mu_ck": (None,),
    "wck": ("f", "m"), "wcv": ("m", "f"),
    # norms / scalars
    "scale": (None,), "bias": (None,), "count": (),
}

# the expert leaves: split over "model" in the expert-parallel MoE paths
EXPERT_LEAVES = ("wei", "weg", "weo")


def _leaf_name(path) -> str:
    return str(path[-1])


def _resolve(shape, req, mesh, fsdp_axes: tuple[str, ...]) -> P:
    """Map axis requests onto the mesh with divisibility fallback."""
    entries = []
    used: set[str] = set()
    for dim, r in zip(shape, req):
        if r is None:
            entries.append(None)
            continue
        names = ("model",) if r == "m" else fsdp_axes
        names = tuple(n for n in names if n in mesh.axis_names and n not in used)
        size = prod(mesh.shape[n] for n in names) if names else 0
        if names and size and dim % size == 0:
            entries.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            entries.append(None)
    return P(*entries)


def param_spec(path, shape, mesh, fsdp_axes=("data",)) -> P:
    req = _RULES.get(_leaf_name(path))
    if req is None:
        return P()
    # allow up to two leading stacked dims (jamba blocks stack sub-stacks)
    extra = len(shape) - len(req)
    if extra < 0:
        return P()
    return _resolve(shape, (None,) * extra + tuple(req), mesh, fsdp_axes)


def experts_split(mesh, n_experts: int) -> bool:
    """Whether the rules split the expert leaves' expert dim over "model"
    on ``mesh`` (``_resolve`` of their "m" request): ``moe_ffn`` then takes
    an expert-parallel path, and the sharded step keeps those leaves split
    (``expert_axes``)."""
    if mesh is None:
        return False
    return "model" in entry_axes(param_spec(("wei",), (n_experts, 1, 1), mesh)[0])


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: how a full leaf is split into per-rank shards."""
    mesh: Mesh
    spec: P

    def _dims(self, skip):
        return [(d, tuple(a for a in entry_axes(e) if a not in skip))
                for d, e in enumerate(self.spec)]

    def shard(self, full: torch.Tensor, *, keep=()) -> torch.Tensor:
        """This rank's shard of ``full``; dims split over the axes in
        ``keep`` are taken as split already."""
        for d, axes in self._dims(keep):
            full = local_slice(full, self.mesh, axes, d)
        return full

    def gather(self, local: torch.Tensor, *, keep=()) -> torch.Tensor:
        """The full leaf from every rank's shard; the axes in ``keep`` stay
        split.  Counted as the gathered copy (``counting.part``)."""
        with counting_part("gathered"):
            for d, axes in self._dims(keep):
                local = all_gather(local, self.mesh, axes, d)
        return local

    def axes(self, dim: int, ndim: int) -> tuple[str, ...]:
        """The axes that split dim ``dim`` of an ``ndim``-dim leaf (a
        negative ``dim`` counts from the last)."""
        dim = dim % ndim
        return entry_axes(self.spec[dim]) if dim < len(self.spec) else ()

    def all_axes(self) -> tuple[str, ...]:
        return tuple(a for e in self.spec for a in entry_axes(e))


def expert_axes(path, sh: NamedSharding) -> tuple[str, ...]:
    """``("model",)`` for an expert leaf whose spec splits it over "model"
    (``experts_split``: the expert-parallel paths compute on its shard), else
    ``()``."""
    return ("model",) if _leaf_name(path) in EXPERT_LEAVES and "model" in sh.all_axes() \
        else ()


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


def param_shardings(tree, mesh, fsdp_axes=("data",)):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, _shape(leaf), mesh,
                                                          fsdp_axes)), tree)


def opt_state_spec(path, shape, mesh, fsdp_axes=("data",)) -> P:
    """An optimizer-state leaf inherits its parameter's spec where shapes
    match; Adafactor's factored leaves drop the reduced axis."""
    # path looks like ("m"|"v"|"f", <param path...>, maybe "vr"/"vc"/"m"/"v")
    keys = [str(k) for k in path]
    pname = next((k for k in keys[::-1] if k in _RULES), None)
    if pname is None:
        return P()
    req = _RULES[pname]
    tail = keys[-1]
    if tail == "vr":  # param shape[:-1]
        req = req[:-1]
    elif tail == "vc":  # param shape[:-2] + (C,)
        req = req[:-2] + req[-1:]
    extra = len(shape) - len(req)
    if extra < 0:
        return P()
    return _resolve(shape, (None,) * extra + tuple(req), mesh, fsdp_axes)


def opt_state_shardings(opt_state_shapes, params_shapes, mesh, fsdp_axes=("data",)):
    """``params_shapes`` is unused, as in the reference: a state leaf's key
    path names its parameter."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, opt_state_spec(path, _shape(leaf), mesh,
                                                              fsdp_axes)),
        opt_state_shapes)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _bax(mesh, dim: int):
    """Batch axis assignment with divisibility fallback (long_500k has B=1)."""
    b = batch_axes(mesh)
    size = prod(mesh.shape[a] for a in b)
    if b and size and dim % size == 0:
        return b if len(b) > 1 else b[0]
    if "data" in b and dim % mesh.shape["data"] == 0:
        return "data"
    return None


def data_spec(shape, mesh) -> P:
    """Batch-leading arrays: shard dim0 over ("pod","data")."""
    return P(_bax(mesh, shape[0]), *([None] * (len(shape) - 1)))


def batch_shardings(tree, mesh):
    return tree_map(lambda leaf: NamedSharding(mesh, data_spec(_shape(leaf), mesh)), tree)


def cache_spec(path, shape, mesh) -> P:
    """KV caches (L, B, S, KVH, dh): batch over data axes; kv-heads over
    "model" when divisible, else the *sequence* dim goes to "model" (GQA archs
    with kv_heads < model axis). SSM/RWKV states shard batch + the
    d_inner/head dim."""
    name = _leaf_name(path)
    if name == "pos":
        return P()
    M = mesh.shape["model"]
    if name in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
        bax = _bax(mesh, shape[1])
        kvh, seq = shape[3], shape[2]
        if kvh % M == 0:
            return P(None, bax, None, "model", None)
        if seq % M == 0:
            return P(None, bax, "model", None, None)
        return P(None, bax, None, None, None)
    if name in ("conv", "ssm"):  # (nb, P-1, B, *state)
        spec = [None] * len(shape)
        spec[2] = _bax(mesh, shape[2])
        di_dim = 3 if name == "ssm" else 4
        if shape[di_dim] % M == 0:
            spec[di_dim] = "model"
        return P(*spec)
    if name in ("shift_t", "shift_c"):  # (L, B, 1, D)
        return P(None, _bax(mesh, shape[1]), None, None)
    if name == "wkv":  # (L, B, H, dh, dh)
        m = "model" if shape[2] % M == 0 else None
        return P(None, _bax(mesh, shape[1]), m, None, None)
    return P()


def cache_shardings(tree, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec(path, _shape(leaf), mesh)), tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_tree(tree, shardings):
    """Each leaf's shard on this rank (the counterpart of ``jax.device_put``
    with shardings); a leaf not on the mesh's device is moved there."""
    def put(leaf, sh):
        leaf = torch.as_tensor(leaf, device=sh.mesh.device)
        part = sh.shard(leaf)
        return part.clone() if part.numel() != leaf.numel() else part  # free the rest
    return tree_map(put, tree, shardings)


def gather_tree(tree, shardings):
    """Every leaf whole on every rank (a collective: every rank calls it)."""
    return tree_map(lambda leaf, sh: sh.gather(leaf), tree, shardings)
