"""Per-cell failure-probability grid (the DIVA model eval): plain versions and
CUDA kernels.

``fail_prob`` replaces the Pallas TPU kernel
``repro/kernels/fail_prob.py::fail_prob`` (``:114``); ``fail_prob_op``
replaces its operating-point variant ``fail_prob_op`` (``:161``), whose
15-coefficient rows append the voltage shift and the retention channel.
Each takes one DIMM (``row_src (R,)``, ``coeffs (9,)`` / ``(15,)``) or a
population (``(D, R)``, ``(D, 9)`` / ``(D, 15)``) and returns the
``(M, R, C)`` or ``(D, M, R, C)`` float32 grid.  The DIMM axis is inside the
CUDA grid (the reference vmaps the kernels instead).  ``fail_prob_rows``
returns ``fail_prob``'s grid summed over mats and columns, ``(R,)`` or
``(D, R)``, and on the card never writes the grid: its kernel adds the cells
in a fixed order on chip (``csrc/fail_prob.cu``).

Dispatch is by the tensors' device alone: CPU tensors go to
``fail_prob_ref`` / ``fail_prob_op_ref``, CUDA tensors to the kernels in
``csrc/fail_prob.cu`` (its header states the bounds and the design);
anything else raises.
``fail_prob.launches``, ``fail_prob_op.launches`` and
``fail_prob_rows.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.latency import (div_t, fail_mixture_t,
                                      retention_fail_mixture_t)

N_COEFFS = 9  # base_eff, k_bl', k_wl', k_mat', k_row', t_op, sigma, rate, ns
# operating-point row: N_COEFFS access coefficients plus the voltage shift
# and the retention channel (ret_base, ret_k, ret_x, ret_sigma, ret_drop)
N_OP_COEFFS = 15


def op_cell_probs(rf, colf, even, d_mat, cf, n_rows: int, n_cols: int,
                  open_bitline: bool = True, voltage: bool = False,
                  retention: bool = False):
    """Failure probability of each cell at a full operating point (the
    reference's ``op_cell_probs``): the access channel shifted by ``cf[9]``
    when ``voltage``, plus the retention channel on the design slowness when
    ``retention``.  The channel probabilities add.  With both flags off this
    is the reference's ``cell_probs`` on ``cf[:9]``, operation for
    operation.  ``rf``/``colf``/``even``/``d_mat`` broadcast to the grid;
    each entry of ``cf`` is broadcastable too."""
    if open_bitline:
        d_bl = div_t(torch.where(even, rf, (n_rows - 1.0) - rf), n_rows - 1.0)
    else:
        d_bl = div_t(rf, n_rows - 1.0)
    d_wl = div_t(colf, n_cols - 1.0)
    d_row = div_t(rf, n_rows - 1.0)
    t = cf[0] + cf[1] * d_bl + cf[2] * d_wl + cf[3] * d_mat + cf[4] * d_row
    if voltage:
        t = t + cf[9]
    p = fail_mixture_t(t, cf[5], cf[6], cf[7], cf[8])
    if retention:
        slow = cf[1] * d_bl + cf[2] * d_wl + cf[3] * d_mat + cf[4] * d_row
        p = p + retention_fail_mixture_t(slow, cf[10], cf[11], cf[12], cf[13],
                                         cf[7], cf[14])
    return p


def _grid_ref(row_src, d_mat, coeffs, cols: int, open_bitline: bool,
              voltage: bool = False, retention: bool = False):
    batched = row_src.dim() == 2
    rs = row_src if batched else row_src[None]
    cf = coeffs if batched else coeffs[None]
    R, dev = rs.shape[1], rs.device
    rf = rs.to(torch.float32)[:, None, :, None]                # (D, 1, R, 1)
    colf = torch.arange(cols, dtype=torch.float32, device=dev)[None, None, None, :]
    even = (torch.arange(cols, device=dev) % 2 == 0)[None, None, None, :]
    dm = d_mat.to(torch.float32)[None, :, None, None]          # (1, M, 1, 1)
    cfs = [cf[:, i, None, None, None] for i in range(cf.shape[1])]
    out = op_cell_probs(rf, colf, even, dm, cfs, R, cols, open_bitline,
                        voltage, retention)
    return out if batched else out[0]


def fail_prob_ref(row_src, d_mat, coeffs, *, cols: int,
                  open_bitline: bool = True):
    """Plain PyTorch version of the ``fail_prob`` kernel, on any device."""
    return _grid_ref(row_src, d_mat, coeffs, cols, open_bitline)


def fail_prob_op_ref(row_src, d_mat, coeffs, *, cols: int,
                     open_bitline: bool = True, voltage: bool = False,
                     retention: bool = False):
    """Plain PyTorch version of the ``fail_prob_op`` kernel, on any device."""
    return _grid_ref(row_src, d_mat, coeffs, cols, open_bitline, voltage,
                     retention)


def fail_prob_rows_ref(row_src, d_mat, coeffs, *, cols: int,
                      open_bitline: bool = True):
    """Plain PyTorch version of the ``fail_prob_rows`` kernel: the grid's
    row sums over mats and columns, in ``torch.sum``'s order."""
    return fail_prob_ref(row_src, d_mat, coeffs, cols=cols,
                         open_bitline=open_bitline).sum(dim=(-3, -1))


def _check(row_src, d_mat, coeffs, cols: int, n_coeffs: int):
    if row_src.dim() not in (1, 2) or row_src.dim() != coeffs.dim():
        raise ValueError(f"row_src {tuple(row_src.shape)} and coeffs "
                         f"{tuple(coeffs.shape)} must both be 1-D or both 2-D")
    if coeffs.shape[-1] != n_coeffs or d_mat.dim() != 1:
        raise ValueError(f"coeffs must end in {n_coeffs}, d_mat must be 1-D")
    if row_src.dim() == 2 and row_src.shape[0] != coeffs.shape[0]:
        raise ValueError("row_src and coeffs disagree on the DIMM count")
    if row_src.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"row_src must be int32 or int64, got {row_src.dtype}")
    if d_mat.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError("d_mat and coeffs must be float32")
    if not (row_src.device == d_mat.device == coeffs.device):
        raise ValueError("row_src, d_mat and coeffs must share one device")
    if cols < 1 or row_src.shape[-1] < 1:
        raise ValueError("the grid needs at least one row and one column")


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _entry(entry: str, argtypes: tuple):
    """``entry`` of the fail_prob library, built if needed, with its ctypes
    signature set once."""
    from repro_torch.kernels.build import load
    fn = getattr(load("fail_prob"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def _launch(entry: str, row_src, d_mat, coeffs, cols: int, flags: tuple):
    """Launch ``entry`` of the fail_prob library with the trailing int
    ``flags`` (open_bitline, then voltage and retention for the
    operating-point entry).  Returns the grid, or its row sums for the
    row-sum entry, or raises."""
    from repro_torch.kernels.build import LaunchError
    rs = row_src if row_src.dim() == 2 else row_src[None]
    cf = coeffs if coeffs.dim() == 2 else coeffs[None]
    for name, t in (("row_src", rs), ("d_mat", d_mat), ("coeffs", cf)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rs = rs.to(torch.int32)
    D, R = rs.shape
    M = d_mat.shape[0]
    shape = (D, R) if entry == "fail_prob_rows_launch" else (D, M, R, cols)
    out = torch.empty(shape, dtype=torch.float32, device=rs.device)
    if out.numel():
        fn = _entry(entry, (_P,) * 4 + (_I,) * (4 + len(flags)) + (_P,))
        with torch.cuda.device(rs.device):
            stream = torch.cuda.current_stream(rs.device).cuda_stream
            err = fn(rs.data_ptr(), d_mat.data_ptr(), cf.data_ptr(),
                     out.data_ptr(), D, M, R, cols, *map(int, flags), stream)
        if err != 0:
            raise LaunchError(f"{entry} failed: CUDA error {err}")
    return out if row_src.dim() == 2 else out[0]


def _device_kind(row_src, name: str) -> str:
    kind = row_src.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {kind}")
    return kind


def _grid(fn, entry: str, plain, row_src, d_mat, coeffs, cols: int, flags: dict):
    """``fn``'s output: its plain version on the CPU, else ``entry``
    (counted in ``fn.launches``)."""
    if _device_kind(row_src, fn.__name__) == "cpu":
        return plain(row_src, d_mat, coeffs, cols=cols, **flags)
    out = _launch(entry, row_src, d_mat, coeffs, cols, tuple(flags.values()))
    if out.numel():
        fn.launches += 1
    return out


def fail_prob(row_src, d_mat, coeffs, *, cols: int, open_bitline: bool = True):
    """``row_src`` (R,) or (D, R) int repair-resolved internal rows;
    ``d_mat`` (M,) f32 precharge-arrival delays; ``coeffs`` (9,) or (D, 9)
    f32 folded coefficient rows.  Returns (M, R, C) or (D, M, R, C) f32."""
    _check(row_src, d_mat, coeffs, cols, N_COEFFS)
    return _grid(fail_prob, "fail_prob_launch", fail_prob_ref, row_src, d_mat,
                 coeffs, cols, dict(open_bitline=open_bitline))


def fail_prob_op(row_src, d_mat, coeffs, *, cols: int,
                 open_bitline: bool = True, voltage: bool = False,
                 retention: bool = False):
    """The operating-point grid: as ``fail_prob`` with (15,) or (D, 15)
    coefficient rows ``[*access 0-8, vdd_shift, ret_base, ret_k, ret_x,
    ret_sigma, ret_drop]``; ``voltage``/``retention`` switch the extra terms
    on (both off gives ``fail_prob`` on ``coeffs[..., :9]``, bit for bit).
    Returns the summed two-channel grid."""
    _check(row_src, d_mat, coeffs, cols, N_OP_COEFFS)
    return _grid(fail_prob_op, "fail_prob_op_launch", fail_prob_op_ref, row_src,
                 d_mat, coeffs, cols, dict(open_bitline=open_bitline,
                                           voltage=voltage, retention=retention))


def fail_prob_rows(row_src, d_mat, coeffs, *, cols: int,
                   open_bitline: bool = True):
    """``fail_prob``'s grid summed over mats and columns: (R,) or (D, R)
    f32, for the same arguments.  On the card the kernel adds each row's
    cells in a fixed order on chip (``csrc/fail_prob.cu``: within about
    1e-6 relative of ``torch.sum``'s) and writes no grid."""
    _check(row_src, d_mat, coeffs, cols, N_COEFFS)
    return _grid(fail_prob_rows, "fail_prob_rows_launch", fail_prob_rows_ref,
                 row_src, d_mat, coeffs, cols, dict(open_bitline=open_bitline))


def division_check(divisors) -> list[int]:
    """On the card: how many float32 operands give other bits through the
    kernel's fast divisions than through IEEE division, for each of its three
    (x / sigma for each of ``divisors``, z / sqrt 2, 1 / d), over every
    operand of the ranges where the kernel takes them (``csrc/fail_prob.cu``).
    ``divisors``: a CUDA tensor of at most 256 clamped sigmas."""
    if divisors.device.type != "cuda" or divisors.dim() != 1 or len(divisors) > 256:
        raise ValueError("division_check takes at most 256 divisors on a CUDA device")
    y = divisors.to(torch.float32).contiguous()
    bad = torch.zeros(3, dtype=torch.int64, device=y.device)
    fn = _entry("fail_prob_div_check", (_P, _I, _P, _P))
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), len(y), bad.data_ptr(),
                 torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fail_prob_div_check failed: CUDA error {err}")
    return bad.tolist()


fail_prob.launches = 0
fail_prob_op.launches = 0
fail_prob_rows.launches = 0
