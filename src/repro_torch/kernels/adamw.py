"""The train step's global-norm clip and AdamW update: plain versions and
CUDA kernels (``csrc/adamw.cu``, whose header states the bound and the
design).

Neither replaces a Pallas kernel: the reference's ``clip_by_global_norm``
and ``adamw`` (``repro/optim/optimizers.py``) are jnp that XLA fuses inside
the jitted step.  Run eagerly, the same update makes ~16 passes a leaf and
the clip a scaled copy of every gradient; the kernels make two passes over a
step's leaves, 32 bytes a float32 element, which bounds them.

``grad_sq_norm(grads, max_norm)`` gives ``(norm, scale)``: the gradients'
global norm and the clip's scale ``min(max_norm / max(norm, 1e-9), 1)``, as
0-d float32 tensors on the gradients' device, never read back.
``adamw_update(grads, ms, vs, params, lr, bc1, bc2, scale)`` gives the new
parameters and AdamW's new first and second moments over lists of leaves,
each gradient first scaled by ``scale`` (None: unclipped) as
``optim.clip.clip_to_norm`` scales it; ``lr``, ``bc1`` and ``bc2`` are the rate
and the bias corrections that ``optim.adamw``'s update computes (0-d
tensors or floats).  Parameters keep their dtypes, weight decay follows the
reference's rule ``p.ndim >= 2``, and nothing passed in is changed but
``out``: lists ``(params, m, v)`` of tensors, none of them an input, that
receive the results in place of new ones (the kernel writes them directly;
a CUDA graph of the train step writes its next state there).

Dispatch is by the tensors' device alone: CPU tensors go to the plain
versions ``grad_sq_norm_ref`` / ``adamw_update_ref`` (the eager code the
optimizer ran before the kernels), CUDA tensors to the kernels, which take
float32 or bfloat16 parameters and gradients with float32 moments and raise
on any other dtype; fake tensors take the kernels' path up to the launch.
``grad_sq_norm.launches`` and ``adamw_update.launches`` count kernel
launches: ceil(leaves / 32) + 1 and ceil(leaves / 32) a call.  Under a
``counting.WorkCounter`` a call counts its bytes and no FLOPs (elementwise
work counts none there).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.counting import is_fake, kernel_call, plain_call
from repro_torch.optim.clip import clip_scale, global_norm, scaled

MAX_LEAVES = 32     # leaves a launch (csrc/adamw.cu's kMaxLeaves)
SQ_CHUNK = 16_384   # elements a block of the norm's first pass (kSqChunk)
# the dtypes the kernels take, with their codes in csrc/adamw.cu
_CODE = {torch.float32: 0, torch.bfloat16: 2}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def grad_sq_norm_work(grads) -> tuple[int, int]:
    """(bytes, FLOPs) of one grad_sq_norm call: each gradient read once, the
    norm and the scale written."""
    return sum(_nbytes(g) for g in grads) + 8, 0


def adamw_update_work(grads, params) -> tuple[int, int]:
    """(bytes, FLOPs) of one adamw_update call: g, p and the float32 m and
    v read once, p, m and v written once."""
    return sum(_nbytes(g) + 2 * _nbytes(p) + 16 * p.numel()
               for g, p in zip(grads, params)), 0


def grad_sq_norm_ref(grads, max_norm: float):
    """Plain PyTorch version, on any device: ``(global norm, clip scale)``
    as ``optim.clip`` computes them."""
    norm = global_norm(list(grads))
    return norm, clip_scale(norm, max_norm)


def adamw_update_ref(grads, ms, vs, params, lr, bc1, bc2, scale=None, *, out=None,
                     b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """Plain PyTorch version, on any device: the reference's AdamW update of
    each leaf in float32, its gradient scaled first; copied into ``out``
    where given."""
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, ms, vs, params):
        g = scaled(g, scale).float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if p.ndim >= 2:  # decay matrices only (norms/bias exempt)
            step = step + weight_decay * p.float()
        new_p.append((p.float() - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    if out is None:
        return new_p, new_m, new_v
    for dst, src in zip(out, (new_p, new_m, new_v)):
        for d, s in zip(dst, src):
            d.copy_(s)
    return tuple(list(dst) for dst in out)


def _device(tensors, what: str) -> torch.device:
    """The one device of ``tensors`` (cpu or cuda, or fake), else raises."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what} takes tensors, got {type(t).__name__}")
    if not tensors:
        raise ValueError(f"{what} takes at least one leaf")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every leaf must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {dev.type}")
    return dev


def _kernel_dtypes(what: str, takes, moments=()) -> None:
    """Raise unless ``takes`` are float32 or bfloat16 and ``moments``
    float32: the dtypes the kernels are built for."""
    for t in takes:
        if t.dtype not in _CODE:
            raise ValueError(f"the {what} kernel takes float32 or bfloat16 leaves, "
                             f"got {t.dtype}")
    for t in moments:
        if t.dtype != torch.float32:
            raise ValueError(f"the {what} kernel takes float32 moments, got {t.dtype}")


@functools.cache
def _entries():
    """``(grad_sq_norm_launch, adamw_launch)`` of the kernel library, built
    if needed, with their ctypes signatures set once."""
    from repro_torch.kernels.build import load
    lib = load("adamw")
    norm, upd = lib.grad_sq_norm_launch, lib.adamw_launch
    norm.restype = upd.restype = ctypes.c_int
    norm.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    upd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_float] * 6 \
        + [ctypes.c_void_p] * 5
    return norm, upd


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _call(fn, dev: torch.device, *args) -> None:
    """``fn(*args, current stream)`` on ``dev``; raises on a CUDA error."""
    from repro_torch.kernels.build import LaunchError
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev.index):
            err = fn(*args, stream)
    if err != 0:
        raise LaunchError(f"{fn.__name__} failed: CUDA error {err}")


def _scalar(x, dev):
    """``x`` (a float or a 0-d tensor) as a 0-d float32 tensor on ``dev``."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _norm_launch(grads, max_norm: float, fake: bool = False):
    """``(norm, scale)`` from the kernels (uncounted), or raises.  ``fake``:
    everything but the launch."""
    dev = grads[0].device
    live = [g.contiguous() for g in grads if g.numel()]
    out = torch.empty(2, dtype=torch.float32, device=dev)
    n_part = sum(-(-g.numel() // SQ_CHUNK) for g in live)
    partials = torch.empty(n_part, dtype=torch.float64, device=dev)
    if not fake:
        ptrs = _array(ctypes.c_void_p, [g.data_ptr() for g in live])
        numel = _array(ctypes.c_longlong, [g.numel() for g in live])
        codes = _array(ctypes.c_int, [_CODE[g.dtype] for g in live])
        _call(_entries()[0], dev, len(live), ctypes.addressof(ptrs),
              ctypes.addressof(numel), ctypes.addressof(codes), partials.data_ptr(),
              n_part, max_norm, out.data_ptr())
    return out[0], out[1]


def grad_sq_norm(grads, max_norm: float):
    """``(global norm, clip scale)`` of the gradient leaves ``grads`` (a
    list, all on one device), 0-d float32 tensors on that device: the plain
    version on the CPU, the kernels on a card (same bits every run)."""
    grads = list(grads)
    dev = _device(grads, "grad_sq_norm")
    counter = kernel_call("grad_sq_norm", lambda: grad_sq_norm_work(grads))
    if is_fake(grads[0]):
        _kernel_dtypes("grad_sq_norm", grads)
        return _norm_launch(grads, max_norm, fake=True)
    if dev.type == "cpu":
        return plain_call(counter, grad_sq_norm_ref, grads, max_norm)
    _kernel_dtypes("grad_sq_norm", grads)
    out = _norm_launch(grads, max_norm)
    grad_sq_norm.launches += -(-sum(1 for g in grads if g.numel()) // MAX_LEAVES) + 1
    return out


grad_sq_norm.launches = 0


def _launch(grads, ms, vs, params, lr, bc1, bc2, scale, hyper: dict, out=None,
            fake: bool = False):
    """Launch the update into ``out`` (checked by ``_outputs``) or new
    tensors; returns ``(new params, new m, new v)`` or raises.  ``fake``:
    everything but the launch."""
    dev = params[0].device
    g, m, v, p = ([t.contiguous() for t in ts] for ts in (grads, ms, vs, params))
    new = tuple([torch.empty_like(t) for t in ts] for ts in (p, m, v)) \
        if out is None else out
    live = [i for i, t in enumerate(p) if t.numel()]
    if fake or not live:
        return new
    rates = [_scalar(x, dev) for x in (lr, bc1, bc2)]
    clip = None if scale is None else _scalar(scale, dev)
    ptrs = [_array(ctypes.c_void_p, [ts[i].data_ptr() for i in live])
            for ts in (g, p, m, v, *new)]
    numel = _array(ctypes.c_longlong, [p[i].numel() for i in live])
    codes = [_array(ctypes.c_int, [f(i) for i in live])
             for f in (lambda i: _CODE[g[i].dtype], lambda i: _CODE[p[i].dtype],
                       lambda i: int(p[i].ndim >= 2))]
    b1, b2 = hyper["b1"], hyper["b2"]
    _call(_entries()[1], dev, len(live), *map(ctypes.addressof, ptrs),
          ctypes.addressof(numel), *map(ctypes.addressof, codes),
          b1, 1 - b1, b2, 1 - b2, hyper["eps"], hyper["weight_decay"],
          *(t.data_ptr() for t in rates), 0 if clip is None else clip.data_ptr())
    return new


def _outputs(out, ms, params):
    """``out`` as three lists, each leaf contiguous and of its input's
    shape, dtype and device; else raises."""
    out = tuple(list(x) for x in out)
    if len(out) != 3 or not all(len(x) == len(params) for x in out):
        raise ValueError("adamw_update: out takes (params, m, v), a list of "
                         f"{len(params)} leaves each")
    for dst, like in zip(out, (params, ms, ms)):
        for d, t in zip(dst, like):
            if (d.shape, d.dtype, d.device) != (t.shape, t.dtype, t.device) \
                    or not d.is_contiguous():
                raise ValueError(f"adamw_update: an output {d.dtype} {tuple(d.shape)} "
                                 f"for a leaf {t.dtype} {tuple(t.shape)} on {t.device}")
    return out


def adamw_update(grads, ms, vs, params, lr, bc1, bc2, scale=None, *, out=None, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """AdamW over the leaves ``params`` (lists, all on one device, each g, m
    and v of its p's shape): ``(new params, new m, new v)``, lists in the
    same order; with ``out`` (lists ``(params, m, v)``) written into its
    tensors and returned."""
    grads, ms, vs, params = (list(x) for x in (grads, ms, vs, params))
    if not len(grads) == len(ms) == len(vs) == len(params):
        raise ValueError(f"adamw_update: {len(grads)} gradients, {len(ms)} m, "
                         f"{len(vs)} v for {len(params)} parameters")
    dev = _device(grads + ms + vs + params, "adamw_update")
    for g, m, v, p in zip(grads, ms, vs, params):
        if not g.shape == m.shape == v.shape == p.shape:
            raise ValueError(f"adamw_update: a parameter {tuple(p.shape)} with a gradient "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v {tuple(v.shape)}")
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if out is not None:
        out = _outputs(out, ms, params)
    args = (grads, ms, vs, params, lr, bc1, bc2, scale)
    counter = kernel_call("adamw", lambda: adamw_update_work(grads, params))
    if is_fake(params[0]):
        _kernel_dtypes("adamw", grads + params, ms + vs)
        return _launch(*args, hyper, out, fake=True)
    if dev.type == "cpu":
        return plain_call(counter, functools.partial(adamw_update_ref, out=out, **hyper),
                          *args)
    _kernel_dtypes("adamw", grads + params, ms + vs)
    out = _launch(*args, hyper, out)
    adamw_update.launches += -(-sum(1 for p in params if p.numel()) // MAX_LEAVES)
    return out


adamw_update.launches = 0
