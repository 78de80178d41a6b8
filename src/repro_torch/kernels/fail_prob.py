"""Per-cell failure-probability grid (the DIVA model eval): plain version and
CUDA kernel.

``fail_prob`` replaces the Pallas TPU kernel
``repro/kernels/fail_prob.py::fail_prob`` (``:114``).  It takes one DIMM
(``row_src (R,)``, ``coeffs (9,)``) or a population (``(D, R)``, ``(D, 9)``)
and returns the ``(M, R, C)`` or ``(D, M, R, C)`` float32 grid.  The DIMM
axis is inside the CUDA grid (the reference vmaps the kernel instead).

Dispatch is by the tensors' device alone: CPU tensors go to
``fail_prob_ref``, CUDA tensors to the kernel in ``csrc/fail_prob.cu``
(its header states the bound and the design); anything else raises.
``fail_prob.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.latency import div_t, fail_mixture_t

N_COEFFS = 9  # base_eff, k_bl', k_wl', k_mat', k_row', t_op, sigma, rate, ns


def cell_probs(rf, colf, even, d_mat, cf, n_rows: int, n_cols: int,
               open_bitline: bool = True):
    """Failure probability of each cell (the reference's ``cell_probs``):
    ``rf``/``colf``/``even``/``d_mat`` broadcast to the grid; ``cf`` is the
    folded 9-coefficient row, each entry broadcastable too."""
    if open_bitline:
        d_bl = div_t(torch.where(even, rf, (n_rows - 1.0) - rf), n_rows - 1.0)
    else:
        d_bl = div_t(rf, n_rows - 1.0)
    d_wl = div_t(colf, n_cols - 1.0)
    d_row = div_t(rf, n_rows - 1.0)
    t = cf[0] + cf[1] * d_bl + cf[2] * d_wl + cf[3] * d_mat + cf[4] * d_row
    return fail_mixture_t(t, cf[5], cf[6], cf[7], cf[8])


def fail_prob_ref(row_src, d_mat, coeffs, *, cols: int,
                  open_bitline: bool = True):
    """Plain PyTorch version of the kernel, on any device."""
    batched = row_src.dim() == 2
    rs = row_src if batched else row_src[None]
    cf = coeffs if batched else coeffs[None]
    R, dev = rs.shape[1], rs.device
    rf = rs.to(torch.float32)[:, None, :, None]                # (D, 1, R, 1)
    colf = torch.arange(cols, dtype=torch.float32, device=dev)[None, None, None, :]
    even = (torch.arange(cols, device=dev) % 2 == 0)[None, None, None, :]
    dm = d_mat.to(torch.float32)[None, :, None, None]          # (1, M, 1, 1)
    cfs = [cf[:, i, None, None, None] for i in range(N_COEFFS)]
    out = cell_probs(rf, colf, even, dm, cfs, R, cols, open_bitline)
    return out if batched else out[0]


def _check(row_src, d_mat, coeffs, cols: int):
    if row_src.dim() not in (1, 2) or row_src.dim() != coeffs.dim():
        raise ValueError(f"row_src {tuple(row_src.shape)} and coeffs "
                         f"{tuple(coeffs.shape)} must both be 1-D or both 2-D")
    if coeffs.shape[-1] != N_COEFFS or d_mat.dim() != 1:
        raise ValueError(f"coeffs must end in {N_COEFFS}, d_mat must be 1-D")
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


def _launch(row_src, d_mat, coeffs, cols: int, open_bitline: bool):
    from repro_torch.kernels.build import load
    rs = row_src if row_src.dim() == 2 else row_src[None]
    cf = coeffs if coeffs.dim() == 2 else coeffs[None]
    for name, t in (("row_src", rs), ("d_mat", d_mat), ("coeffs", cf)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rs = rs.to(torch.int32)
    D, R = rs.shape
    M = d_mat.shape[0]
    out = torch.empty((D, M, R, cols), dtype=torch.float32, device=rs.device)
    if out.numel():
        fn = load("fail_prob").fail_prob_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        with torch.cuda.device(rs.device):
            stream = torch.cuda.current_stream(rs.device).cuda_stream
            err = fn(rs.data_ptr(), d_mat.data_ptr(), cf.data_ptr(),
                     out.data_ptr(), D, M, R, cols, int(open_bitline), stream)
        if err != 0:
            raise RuntimeError(f"fail_prob kernel launch failed: CUDA error {err}")
        fail_prob.launches += 1
    return out if row_src.dim() == 2 else out[0]


def fail_prob(row_src, d_mat, coeffs, *, cols: int, open_bitline: bool = True):
    """``row_src`` (R,) or (D, R) int repair-resolved internal rows;
    ``d_mat`` (M,) f32 precharge-arrival delays; ``coeffs`` (9,) or (D, 9)
    f32 folded coefficient rows.  Returns (M, R, C) or (D, M, R, C) f32."""
    _check(row_src, d_mat, coeffs, cols)
    if row_src.device.type == "cpu":
        return fail_prob_ref(row_src, d_mat, coeffs, cols=cols,
                             open_bitline=open_bitline)
    if row_src.device.type == "cuda":
        return _launch(row_src, d_mat, coeffs, cols, open_bitline)
    raise ValueError(f"fail_prob runs on cpu or cuda tensors, not "
                     f"{row_src.device.type}")


fail_prob.launches = 0
