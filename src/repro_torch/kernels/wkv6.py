"""RWKV-6 WKV recurrence (the time-mix hot loop of rwkv6): plain version and
CUDA kernel.

``wkv6`` replaces the Pallas TPU kernel ``repro/kernels/wkv6.py::wkv6``
(``:66``).  For ``r, k, v, wlog`` of shape (B, S, H, dh) and ``u`` (H, dh) it
runs, per (b, h) and step t, with the state S (dh, dh) float32::

    y_t = r_t @ (S + diag(u) k_t^T v_t)
    S   = diag(exp(-exp(wlog_t))) S + k_t^T v_t

and returns ``(y (B, S, H, dh) float32, final state (B, H, dh, dh) float32)``
like the reference's sequence scan ``repro/models/rwkv6.py::wkv6_scan``, which
the model consumes: unlike the Pallas kernel (a zero start state, ``y`` only,
in the input dtype), it takes an optional ``init_state`` and gives back the
final one, so that prefill can store it and a decode step (S = 1) start from
it.  Inputs may be float32, float16 or bfloat16, each its own; both versions
compute in float32, and the kernel reads each input in its own dtype (the
serving path passes bfloat16 ``k``/``v`` and float32 ``r``/``wlog``).

``wkv6`` is differentiable: it runs through ``Wkv6Fn``, whose backward is
``wkv6_bwd``, the vector-Jacobian product of the recurrence (the port's
counterpart of XLA's autodiff of ``wkv6_scan``, which the reference trains
through: the Pallas kernel has no VJP).  It returns the gradients of ``r, k,
v, wlog, u`` in their inputs' dtypes and of ``init_state`` (float32) when one
was given.

Dispatch is by the tensors' device alone: CPU tensors go to the plain
versions ``wkv6_ref`` / ``wkv6_bwd_ref``, CUDA tensors to the kernels in
``csrc/wkv6.cu`` / ``csrc/wkv6_bwd.cu`` (their headers state the bounds and
the designs); anything else raises.
``wkv6.launches`` and ``wkv6_bwd.launches`` count kernel launches.

Fake tensors (the dry run, ``launch/dryrun.py``) take the kernels' path up
to the launch: the same conversions and allocations, outputs of the right
shapes and dtypes, nothing computed (never the plain version's loop over
time).  Under a ``counting.WorkCounter`` each call the kernel would launch
for counts its work by ``wkv6_work`` / ``wkv6_bwd_work``, the operations
and bytes the recurrence needs whatever the kernel does, on a card, on the
CPU (the plain version's own ops then go uncounted) and on fake tensors
alike.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.counting import is_fake, kernel_call, plain_call

DH = (8, 16, 32, 64)   # the kernel's instantiations of the head width
# the input dtypes, with their codes in csrc/wkv6.cu
_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# fp32 operations the recurrence needs per (b, h, t), whatever the kernel
# does: 5 per (i, j) (r.S: a product and a sum; w*S + k*v: two products and
# a sum) and 8 per i, because the u term is rank one, v_j * sum_i r_i u_i k_i
# (the decay's negation and two expf; r*u*k and its sum; v_j times it and
# the add to y_j)
WKV_FLOPS_PER_IJ, WKV_FLOPS_PER_I = 5, 8
# fp32 operations the backward needs per (b, h, t): 14 per (i, j) and 21 per
# i (csrc/wkv6_bwd.cu's header)
WKV_BWD_FLOPS_PER_IJ, WKV_BWD_FLOPS_PER_I = 14, 21


def _size(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def wkv6_work(r, k, v, wlog, u, init_state=None) -> tuple[int, int]:
    """(bytes, fp32 operations) of one wkv6 call: each input read once in
    its dtype, y and the final state (float32) written once."""
    B, S, H, dh = r.shape
    n_bytes = sum(_size(t) for t in (r, k, v, wlog, u, init_state)) \
        + 4 * (B * S * H * dh + B * H * dh * dh)
    return n_bytes, B * H * S * (WKV_FLOPS_PER_IJ * dh * dh + WKV_FLOPS_PER_I * dh)


def wkv6_bwd_work(r, k, v, wlog, u, init_state, dy, dstate=None) -> tuple[int, int]:
    """(bytes, fp32 operations) of one wkv6_bwd call: each input (and dy,
    and the state and its cotangent where given) read once, each gradient
    written once in its input's dtype."""
    B, S, H, dh = r.shape
    n_bytes = 2 * sum(_size(t) for t in (r, k, v, wlog, u, init_state)) \
        + _size(dy) + _size(dstate)
    return n_bytes, B * H * S * (WKV_BWD_FLOPS_PER_IJ * dh * dh + WKV_BWD_FLOPS_PER_I * dh)


def wkv6_ref(r, k, v, wlog, u, init_state=None):
    """Plain PyTorch version of the kernel, on any device: the reference's
    ``wkv6_scan`` step in a Python loop over the sequence."""
    B, S, H, dh = r.shape
    r, k, v, wlog = (t.float() for t in (r, k, v, wlog))
    u = u.float()
    s = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device) \
        if init_state is None else init_state.float()
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B,H,dh,dh)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = torch.exp(-torch.exp(wlog[:, t]))[..., None] * s + kv
    y = torch.stack(ys, dim=1) if ys else r.new_zeros((B, 0, H, dh))
    return y, s


def _check(r, k, v, wlog, u, init_state):
    for name, t in (("r", r), ("k", k), ("v", v), ("wlog", wlog), ("u", u)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dtype not in _CODE:
            raise ValueError(f"{name} must be float32, float16 or bfloat16, "
                             f"got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, dh), got {tuple(r.shape)}")
    shape = r.shape
    B, S, H, dh = shape
    for name, t in (("k", k), ("v", v), ("wlog", wlog)):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, r is {tuple(shape)}")
    if u.shape != (H, dh):
        raise ValueError(f"u must be (H, dh) = {(H, dh)}, got {tuple(u.shape)}")
    tensors = [k, v, wlog, u]
    if init_state is not None:
        if init_state.shape != (B, H, dh, dh) or init_state.dtype != torch.float32:
            raise ValueError(f"init_state must be (B, H, dh, dh) = "
                             f"{(B, H, dh, dh)} float32, got "
                             f"{tuple(init_state.shape)} {init_state.dtype}")
        tensors.append(init_state)
    dev = r.device
    if any(t.device != dev for t in tensors):
        raise ValueError("r, k, v, wlog, u and init_state must share one device")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels move a thread's
    state tile 16 bytes at a time), copied only if it is not."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if not is_fake(t) and t.data_ptr() % 16 else t


@functools.cache
def _entry():
    """``wkv6_launch`` of the kernel library, built if needed, with its ctypes
    signature set once."""
    from repro_torch.kernels.build import load
    fn = load("wkv6").wkv6_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _launch(r, k, v, wlog, u, init_state, fake: bool = False):
    """Launch the kernel on r, k, v, wlog in their own dtypes (no cast, and no
    copy of a contiguous tensor); returns ``(y, final state)`` or raises.
    ``fake``: everything but the launch (fake tensors)."""
    from repro_torch.kernels.build import LaunchError
    B, S, H, dh = r.shape
    if dh not in DH:
        raise ValueError(f"the wkv6 kernel is built for dh in {DH}, got {dh}")
    r, k, v, wlog = (t.contiguous() for t in (r, k, v, wlog))
    u = u.float().contiguous()
    s0 = _aligned(init_state)
    y = r.new_empty((B, S, H, dh), dtype=torch.float32)
    state = r.new_empty((B, H, dh, dh), dtype=torch.float32)
    if fake:
        return y, state
    index = r.device.index
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
            _CODE[r.dtype], _CODE[k.dtype], _CODE[v.dtype], _CODE[wlog.dtype],
            u.data_ptr(), 0 if s0 is None else s0.data_ptr(), y.data_ptr(),
            state.data_ptr(), B, S, H, dh,
            # the current stream's handle, as torch.cuda.current_stream(index)
            # .cuda_stream gives it, without building a Stream object
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = _entry()(*args)
    else:
        with torch.cuda.device(index):
            err = _entry()(*args)
    if err != 0:
        raise LaunchError(f"wkv6 failed: CUDA error {err}")
    return y, state


def _forward(r, k, v, wlog, u, init_state):
    """``(y, final state)`` on the tensors' device: the plain version on the
    CPU, the kernel (counted) on a card, its outputs' shapes on fake
    tensors."""
    B, S, H, dh = r.shape
    args = (r, k, v, wlog, u, init_state)
    counter = kernel_call("wkv6", lambda: wkv6_work(*args)) if S and B * H else None
    if is_fake(r) and S and B * H:
        return _launch(*args, fake=True)
    if r.device.type == "cpu":
        return plain_call(counter, wkv6_ref, *args)
    if S == 0 or B * H == 0:
        state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device) \
            if init_state is None else init_state.clone()
        return torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device), state
    out = _launch(*args)
    wkv6.launches += 1
    return out


class Wkv6Fn(torch.autograd.Function):
    """The recurrence as an autograd node: forward ``_forward``, backward
    ``wkv6_bwd`` (the kernel on a card, ``wkv6_bwd_ref`` on the CPU).  Saves
    the inputs, not the states: the backward recomputes them."""

    @staticmethod
    def forward(ctx, r, k, v, wlog, u, init_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, wlog, u, init_state)
        return _forward(r, k, v, wlog, u, init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, wlog, u, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = wkv6_bwd(r, k, v, wlog, u, init_state, dy, dstate)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r, k, v, wlog, u, init_state=None):
    """``r, k, v, wlog``: (B, S, H, dh); ``u``: (H, dh); ``init_state``: None
    (zeros) or (B, H, dh, dh) float32; all on one device.  Returns ``(y, s)``:
    y (B, S, H, dh) float32 and the final state (B, H, dh, dh) float32, both
    differentiable through ``Wkv6Fn``."""
    _check(r, k, v, wlog, u, init_state)
    kind = r.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cpu or cuda tensors, not {kind}")
    return Wkv6Fn.apply(r, k, v, wlog, u, init_state)


wkv6.launches = 0


# ------------------------------------------------------------------ backward

def wkv6_bwd_ref(r, k, v, wlog, u, init_state, dy, dstate=None):
    """Plain PyTorch version of the backward kernel, on any device: the VJP
    of ``wkv6_ref`` written out.  The forward loop keeps every state S_{t-1};
    the reverse loop carries G_t = dL/dS_t (from ``dstate``, or zeros):

        dr_t    = S_{t-1} dy_t + u k_t (dy_t . v_t)
        dk_t    = G_t v_t + r_t u (dy_t . v_t)
        dv_t    = G_t^T k_t + dy_t (r_t . u k_t)
        dwlog_t = -(exp(wlog_t) w_t) rowsum(G_t * S_{t-1})
        du      = sum over b, t of r_t k_t (dy_t . v_t)
        G_{t-1} = diag(w_t) G_t + r_t^T dy_t

    Returns ``(dr, dk, dv, dwlog, du, d init_state)``, each in its input's
    dtype (float32 arithmetic); the last is None without an ``init_state``."""
    B, S, H, dh = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, wlog))
    uf, dyf = u.float(), dy.float()
    zeros = dict(dtype=torch.float32, device=r.device)
    s = torch.zeros((B, H, dh, dh), **zeros) if init_state is None else init_state.float()
    before = []                                             # S_{t-1}
    for t in range(S):
        before.append(s)
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        s = torch.exp(-torch.exp(wf[:, t]))[..., None] * s + kv
    g = torch.zeros((B, H, dh, dh), **zeros) if dstate is None else dstate.float()
    dr, dk, dv, dw = (torch.zeros((B, S, H, dh), **zeros) for _ in range(4))
    du = torch.zeros((H, dh), **zeros)
    for t in reversed(range(S)):
        sp = before[t]
        rt, kt, vt, wt, dyt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dyf[:, t]
        dyv = (dyt * vt).sum(-1, keepdim=True)              # (B, H, 1)
        ruk = (rt * uf * kt).sum(-1, keepdim=True)
        e = torch.exp(wt)
        w = torch.exp(-e)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uf * kt * dyv
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + rt * uf * dyv
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + dyt * ruk
        dw[:, t] = -(e * w) * (g * sp).sum(-1)
        du += (rt * kt * dyv).sum(0)
        g = w[..., None] * g + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(wlog.dtype),
            du.to(u.dtype), None if init_state is None else g)


@functools.cache
def _bwd_entry():
    """``wkv6_bwd_launch`` of the backward kernel's library, built if needed,
    with its ctypes signature set once."""
    from repro_torch.kernels.build import load
    fn = load("wkv6_bwd").wkv6_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


CHUNK_BWD = 8   # steps between the backward kernel's saved states (kC, csrc/wkv6_bwd.cu)


def _bwd_launch(r, k, v, wlog, u, init_state, dy, dstate, fake: bool = False):
    """Launch the backward kernel (and its deterministic sum of du over the
    batch); returns the gradients or raises.  ``fake``: everything but the
    launch (fake tensors)."""
    from repro_torch.kernels.build import LaunchError
    B, S, H, dh = r.shape
    if dh not in DH:
        raise ValueError(f"the wkv6_bwd kernel is built for dh in {DH}, got {dh}")
    r, k, v, wlog = (t.contiguous() for t in (r, k, v, wlog))
    uf = u.float().contiguous()
    dy = dy.float().contiguous()
    s0 = _aligned(init_state)
    ds = None if dstate is None else _aligned(dstate.float())
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, wlog))
    du = torch.empty((H, dh), dtype=u.dtype, device=r.device)
    du_part = r.new_empty((B, H, dh), dtype=torch.float32)
    ds0 = None if s0 is None else torch.empty_like(s0)
    ckpt = r.new_empty((B, H, -(-S // CHUNK_BWD), dh, dh), dtype=torch.float32)
    if fake:
        return dr, dk, dv, dw, du, ds0
    ptr = lambda t: 0 if t is None else t.data_ptr()
    index = r.device.index
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), wlog.data_ptr(),
            _CODE[r.dtype], _CODE[k.dtype], _CODE[v.dtype], _CODE[wlog.dtype],
            _CODE[u.dtype], uf.data_ptr(), ptr(s0), dy.data_ptr(), ptr(ds),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            du_part.data_ptr(), ptr(ds0), ckpt.data_ptr(), B, S, H, dh,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = _bwd_entry()(*args)
    else:
        with torch.cuda.device(index):
            err = _bwd_entry()(*args)
    if err != 0:
        raise LaunchError(f"wkv6_bwd failed: CUDA error {err}")
    return dr, dk, dv, dw, du, ds0


def wkv6_bwd(r, k, v, wlog, u, init_state, dy, dstate=None):
    """The VJP of ``wkv6`` at ``(r, k, v, wlog, u, init_state)`` for the
    cotangents ``dy`` (B, S, H, dh) of ``y`` and ``dstate`` (None for zeros,
    or (B, H, dh, dh)) of the final state.  Returns ``(dr, dk, dv, dwlog, du,
    d init_state)`` as ``wkv6_bwd_ref`` does: the plain version on CPU
    tensors, the kernel on CUDA tensors."""
    _check(r, k, v, wlog, u, init_state)
    if dy.shape != r.shape or dy.device != r.device:
        raise ValueError(f"dy must be {tuple(r.shape)} on {r.device}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    B, S, H, dh = r.shape
    if dstate is not None and (dstate.shape != (B, H, dh, dh) or dstate.device != r.device):
        raise ValueError(f"dstate must be (B, H, dh, dh) = {(B, H, dh, dh)} on "
                         f"{r.device}, got {tuple(dstate.shape)} on {dstate.device}")
    kind = r.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"wkv6_bwd runs on cpu or cuda tensors, not {kind}")
    args = (r, k, v, wlog, u, init_state, dy, dstate)
    counter = kernel_call("wkv6_bwd", lambda: wkv6_bwd_work(*args)) if S and B * H else None
    if is_fake(r) and S and B * H:
        return _bwd_launch(*args, fake=True)
    if kind == "cpu":
        return plain_call(counter, wkv6_bwd_ref, *args)
    if S == 0 or B * H == 0:
        zeros = [torch.zeros_like(t) for t in (r, k, v, wlog, u)]
        d0 = None if init_state is None else (
            torch.zeros_like(init_state) if dstate is None else dstate.float().clone())
        return (*zeros, d0)
    out = _bwd_launch(*args)
    wkv6_bwd.launches += 1
    return out


wkv6_bwd.launches = 0


def wkv6_bwd_resources(dh: int, bh: int) -> dict:
    """What the card makes of the backward kernel at head width ``dh`` for
    ``bh`` = B*H clusters: threads and dynamic shared bytes a block, blocks a
    cluster, blocks resident per SM, clusters resident on the card (0 for a
    cluster of 1), registers a thread and local (spilled) bytes a thread, as
    the CUDA runtime reports them.  Needs a card."""
    from repro_torch.kernels.build import load
    lib = load("wkv6_bwd")
    occ = lib.wkv6_bwd_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    err = occ(dh, bh, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"wkv6_bwd_occupancy failed: CUDA error {err}")
    keys = ("threads", "smem_bytes", "cluster", "blocks_per_sm", "clusters_resident",
            "registers", "local_bytes")
    return dict(zip(keys, out))
