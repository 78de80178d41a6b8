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

The kernel runs the wordline-open, sense-amp and precharge phases as step
ranges (``phase_bounds``), divides with IEEE division's fast sequences where
``fast_route`` allows them (``division_check`` proves them on the card), and
reruns with IEEE divisions any cell whose operands leave their ranges;
``route_counts`` reads how many cells it reran and how many warps ran on a
shared tap.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.spice import (SA_STEEPNESS, WL_SLOPE_NS, CircuitParams,
                                    divisors, euler_step, ladder_init, n_steps,
                                    step_phases, step_times, time_constants)

N_SEGS = (4, 8, 16)   # the kernel's instantiations of the ladder length
#: the fast divisions' divisor range and the bound the wrapper keeps every
#: numerator under (csrc/fast_div.cuh: |x| <= 2^40)
DIV_LO, DIV_HI, VALUE_HI = 2.0 ** -20, 2.0 ** 20, 2.0 ** 36
ROUTE_COUNTERS = ("ieee_cells", "shared_tap_warps", "mixed_tap_warps")


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


def phase_bounds(cp: CircuitParams, t_total_ns: float, t_pre_ns: float):
    """(i_sa, i_pre, steps): the first step of the sense-amp phase and of the
    precharge phase, and the step count.  Steps [0, i_sa) have the wordline
    open, [i_sa, i_pre) also the sense amp, [i_pre, steps) precharge: the
    phases ``step_phases`` gives each step's float32 time, as ranges (the
    times are nondecreasing in the step index)."""
    t = step_times(cp, t_total_ns)
    steps = len(t)

    def first(mask):
        return int(np.argmax(mask)) if mask.any() else steps

    i_pre = first(t >= np.float32(t_pre_ns))
    return min(first(t >= np.float32(cp.sa_enable_ns)), i_pre), i_pre, steps


def launch_divisors(cp: CircuitParams) -> np.ndarray:
    """The kernel's five launch divisors as float32: tau_seg, the wordline
    slope, tau_acc_cell, tau_acc_node and the precharge tau."""
    taus = time_constants(cp)
    return np.array([taus["tau_seg"], WL_SLOPE_NS, taus["tau_acc_cell"],
                     taus["tau_acc_node"], cp.precharge_tau_ns], np.float32)


def fast_route(cp: CircuitParams, t_total_ns: float) -> bool:
    """Whether the kernel may take its fast divisions at all: every divisor
    in [2^-20, 2^20], and the voltages and step times that the numerators
    are built from within [0, 2^36] (so every numerator stays below 2^40)."""
    d = launch_divisors(cp)
    f32 = np.float32
    t_last = step_times(cp, t_total_ns)[-1]
    return bool((d >= f32(DIV_LO)).all() and (d <= f32(DIV_HI)).all()
                and f32(0) <= f32(cp.v_half) <= f32(cp.vdd) <= f32(VALUE_HI)
                and f32(0) <= t_last <= f32(VALUE_HI))


def _counters(device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_counters(dev)


@functools.cache
def _device_counters(dev: torch.device) -> torch.Tensor:
    return torch.zeros(len(ROUTE_COUNTERS), dtype=torch.int64, device=dev)


def route_counts(device) -> dict:
    """On the card: the kernel's counts on ``device`` since the last
    ``reset_route_counts``: cells it ran with IEEE divisions (the fast route
    off, or an operand outside the fast divisions' ranges), warps whose 32
    cells shared a tap and warps of mixed taps (fast route only)."""
    return dict(zip(ROUTE_COUNTERS, _counters(device).tolist()))


def reset_route_counts(device) -> None:
    _counters(device).zero_()


def _entry(name: str, argtypes: list):
    from repro_torch.kernels.build import load
    fn = getattr(load("rc_transient"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def division_check(divisors) -> list[int]:
    """On the card: how many float32 operands give other bits through the
    kernel's fast divisions than through IEEE division, for its two (x / y
    for each of ``divisors`` with |x| in [2^-100, 2^40] and +-0; 1 / d for d
    in [1, 2^60]).  ``divisors``: a CUDA tensor of at most 64 divisors in
    [2^-20, 2^20] (``launch_divisors``)."""
    if divisors.device.type != "cuda" or divisors.dim() != 1 or len(divisors) > 64:
        raise ValueError("division_check takes at most 64 divisors on a CUDA device")
    y = divisors.to(torch.float32).contiguous()
    if len(y) and not bool(((y >= DIV_LO) & (y <= DIV_HI)).all()):
        raise ValueError(f"divisors must lie in [{DIV_LO}, {DIV_HI}]")
    bad = torch.zeros(2, dtype=torch.int64, device=y.device)
    fn = _entry("rc_transient_div_check", [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), len(y), bad.data_ptr(),
                 torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rc_transient_div_check failed: CUDA error {err}")
    return bad.tolist()


def _launch(row_frac, col_frac, cp: CircuitParams, t_total_ns: float,
            t_pre_ns: float, v_ready: float, cell_charged: bool):
    """Launch the kernel, adding its route counts to the device's
    counters; returns the (3, N) outputs."""
    from repro_torch.kernels.build import LaunchError
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
        fn = _entry("rc_transient_launch", [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 6 + [ctypes.c_float] * len(scalars)
                    + [ctypes.c_void_p, ctypes.c_void_p])
        i_sa, i_pre, steps = phase_bounds(cp, t_total_ns, t_pre_ns)
        with torch.cuda.device(row_frac.device):
            stream = torch.cuda.current_stream(row_frac.device).cuda_stream
            err = fn(row_frac.data_ptr(), col_frac.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), out[2].data_ptr(), n, cp.n_seg, steps,
                     i_sa, i_pre, int(fast_route(cp, t_total_ns)), *scalars,
                     _counters(row_frac.device).data_ptr(), stream)
        if err != 0:
            raise LaunchError(f"rc_transient failed: CUDA error {err}")
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
