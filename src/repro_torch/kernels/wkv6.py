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

Dispatch is by the tensors' device alone: CPU tensors go to ``wkv6_ref``,
CUDA tensors to the kernel in ``csrc/wkv6.cu`` (its header states the bound
and the design); anything else raises.  ``wkv6.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

DH = (8, 16, 32, 64)   # the kernel's instantiations of the head width
# the input dtypes, with their codes in csrc/wkv6.cu
_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


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


def _launch(r, k, v, wlog, u, init_state):
    """Launch the kernel on r, k, v, wlog in their own dtypes (no cast, and no
    copy of a contiguous tensor); returns ``(y, final state)`` or raises."""
    B, S, H, dh = r.shape
    if dh not in DH:
        raise ValueError(f"the wkv6 kernel is built for dh in {DH}, got {dh}")
    r, k, v, wlog = (t.contiguous() for t in (r, k, v, wlog))
    u = u.float().contiguous()
    s0 = init_state
    if s0 is not None:
        s0 = s0.contiguous()
        if s0.data_ptr() % 16:   # the kernel reads a thread's state 16 bytes at a time
            s0 = s0.clone()
    y = r.new_empty((B, S, H, dh), dtype=torch.float32)
    state = r.new_empty((B, H, dh, dh), dtype=torch.float32)
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
        raise RuntimeError(f"wkv6 failed: CUDA error {err}")
    return y, state


def wkv6(r, k, v, wlog, u, init_state=None):
    """``r, k, v, wlog``: (B, S, H, dh); ``u``: (H, dh); ``init_state``: None
    (zeros) or (B, H, dh, dh) float32; all on one device.  Returns ``(y, s)``:
    y (B, S, H, dh) float32 and the final state (B, H, dh, dh) float32."""
    _check(r, k, v, wlog, u, init_state)
    kind = r.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"wkv6 runs on cpu or cuda tensors, not {kind}")
    if kind == "cpu":
        return wkv6_ref(r, k, v, wlog, u, init_state)
    B, S, H, dh = r.shape
    if S == 0 or B * H == 0:
        state = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device) \
            if init_state is None else init_state.clone()
        return torch.empty((B, S, H, dh), dtype=torch.float32, device=r.device), state
    out = _launch(r, k, v, wlog, u, init_state)
    wkv6.launches += 1
    return out


wkv6.launches = 0
