"""RC-ladder transient integrator (the Appendix B circuit model's hot loop):
plain version and CUDA kernel.

``rc_transient`` replaces the Pallas TPU kernel
``repro/kernels/rc_transient.py::rc_transient`` (``:80``): for (N,) float32
cells at normalized bitline distance ``row_frac`` and wordline distance
``col_frac`` it integrates the ladder of ``core/spice.py`` through every
Euler step and returns ``{"v_probe", "v_cell", "sense_t"}``, each (N,)
float32: the bitline at the cell's tap and the cell after the last step, and
the first step time at which the probe reached ``v_ready`` (``inf`` if it
never did).

Dispatch is by the tensors' device alone: CPU tensors go to
``rc_transient_ref``, CUDA tensors to the kernel in ``csrc/rc_transient.cu``
(its header states the bound and the design); anything else raises.
``rc_transient.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.spice import (SA_STEEPNESS, WL_SLOPE_NS, CircuitParams,
                                    divisors, euler_step, ladder_init, n_steps,
                                    step_phases, step_times, time_constants)

N_SEGS = (4, 8, 16)   # the kernel's instantiations of the ladder length


def rc_transient_ref(row_frac, col_frac, *, cp: CircuitParams = CircuitParams(),
                     t_total_ns: float = 45.0, t_pre_ns: float = 30.0,
                     v_ready: float = 0.9, cell_charged: bool = True):
    """Plain PyTorch version of the kernel, on any device: ``spice``'s Euler
    step in a Python loop, keeping only the state and the running first
    crossing (the reference's oracle records every step's trace)."""
    dev = row_frac.device
    div = divisors(cp, dev)
    tap, t_wl, v_bl, v_cell = ladder_init(row_frac, col_frac, cp, cell_charged)
    t_host = step_times(cp, t_total_ns)
    times = torch.as_tensor(t_host, device=dev)
    sense = torch.full_like(row_frac, float("inf"))
    v_probe = v_bl[:, 0]
    for i, t in enumerate(t_host):
        phases = step_phases(t, cp, t_pre_ns)
        v_bl, v_cell, _, v_probe = euler_step(v_bl, v_cell, tap, t_wl,
                                              times[i], phases, cp, div)
        sense = torch.where((v_probe >= v_ready) & torch.isinf(sense),
                            times[i], sense)
    return {"v_probe": v_probe, "v_cell": v_cell, "sense_t": sense}


def _check(row_frac, col_frac, cp: CircuitParams, t_total_ns: float):
    for name, t in (("row_frac", row_frac), ("col_frac", col_frac)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 1 or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (N,) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if row_frac.shape != col_frac.shape or row_frac.device != col_frac.device:
        raise ValueError("row_frac and col_frac must share one shape and "
                         "one device")
    time_constants(cp)
    if n_steps(cp, t_total_ns) < 1:
        raise ValueError(f"t_total_ns={t_total_ns} gives no Euler step")


def _launch(row_frac, col_frac, cp: CircuitParams, t_total_ns: float,
            t_pre_ns: float, v_ready: float, cell_charged: bool):
    from repro_torch.kernels.build import load
    if cp.n_seg not in N_SEGS:
        raise ValueError(f"the rc_transient kernel is built for n_seg in "
                         f"{N_SEGS}, got {cp.n_seg}")
    for name, t in (("row_frac", row_frac), ("col_frac", col_frac)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = row_frac.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=row_frac.device)
    if n:
        taus = time_constants(cp)
        scalars = (cp.vdd, cp.v_half, cp.wl_delay_ns_max, cp.sa_gain_per_ns,
                   cp.sa_enable_ns, cp.dt_ns, taus["tau_seg"],
                   taus["tau_acc_cell"], taus["tau_acc_node"],
                   cp.precharge_tau_ns, WL_SLOPE_NS, SA_STEEPNESS, t_pre_ns,
                   v_ready, cp.vdd if cell_charged else 0.0)
        fn = load("rc_transient").rc_transient_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_float] * len(scalars) + [ctypes.c_void_p]
        with torch.cuda.device(row_frac.device):
            stream = torch.cuda.current_stream(row_frac.device).cuda_stream
            err = fn(row_frac.data_ptr(), col_frac.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), out[2].data_ptr(), n, cp.n_seg,
                     n_steps(cp, t_total_ns), *scalars, stream)
        if err != 0:
            raise RuntimeError(f"rc_transient failed: CUDA error {err}")
    return out


def rc_transient(row_frac, col_frac, *, cp: CircuitParams = CircuitParams(),
                 t_total_ns: float = 45.0, t_pre_ns: float = 30.0,
                 v_ready: float = 0.9, cell_charged: bool = True):
    """``row_frac``/``col_frac``: (N,) float32 in [0, 1] on one device.
    Returns {"v_probe", "v_cell", "sense_t"}, each (N,) float32."""
    _check(row_frac, col_frac, cp, t_total_ns)
    kind = row_frac.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"rc_transient runs on cpu or cuda tensors, not {kind}")
    kw = dict(cp=cp, t_total_ns=t_total_ns, t_pre_ns=t_pre_ns,
              v_ready=v_ready, cell_charged=cell_charged)
    if kind == "cpu":
        return rc_transient_ref(row_frac, col_frac, **kw)
    out = _launch(row_frac, col_frac, **kw)
    if out.shape[1]:
        rc_transient.launches += 1
    return {"v_probe": out[0], "v_cell": out[1], "sense_t": out[2]}


rc_transient.launches = 0
