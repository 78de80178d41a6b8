"""Appendix B analogue: RC-ladder transient simulation of a DRAM bitline.

We model a bitline as an N-segment RC ladder with the sense amplifier at
node 0 and a cell capacitor attached at the tap corresponding to its row.
Three phases (Fig 21): charge sharing (wordline opens the access transistor,
delayed by the wordline RC for far columns), sense amplification (cross-
coupled amp modeled as saturating positive feedback at node 0), precharge
(equalizer pulls the ladder back to VDD/2).

Units: volts, ns, kOhm, fF (kOhm x fF = 1e-3 ns).  Explicit Euler; dt is kept
below half the fastest time constant for stability.

The counterpart of ``repro.core.spice``: the same ``CircuitParams`` and the
same discrete update, run as an eager torch loop over time steps on the
caller's device (default: the CUDA device).  ``euler_step`` is that update;
``simulate`` records every step's trace, and the plain version of the
``rc_transient`` kernel (kernels/rc_transient.py) runs the same step keeping
only the final state and the first sense crossing.  ``sense_time``,
``restored_voltage`` and ``precharge_time`` read the traces in numpy, as in
the reference.

Float32 throughout, in the reference's operation order: divisions by the time
constants are IEEE divisions by a float32 constant (``latency.div_t``'s
convention), and a step's time is ``float32(i) * dt`` compared in float32 with
the precharge and sense-enable times, so step 3000 lands on 30.0 ns exactly
as it does in the reference.  The reference's one-hot products at the tap
(``sum(v_bl * tap_oh)`` and ``tap_oh * x``) are a gather and a scatter-add
here: the other terms are exact zeros added to a finite value, so the bits
are the same.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class CircuitParams:
    vdd: float = 1.2
    v_half: float = 0.6
    c_cell_fF: float = 24.0
    c_bl_fF: float = 144.0        # total bitline capacitance [Vogelsang]
    r_bl_kohm: float = 15.0       # total bitline resistance
    r_acc_kohm: float = 10.0      # access transistor on-resistance
    n_seg: int = 8
    wl_delay_ns_max: float = 2.5  # wordline RC arrival delay at the far column
    sa_gain_per_ns: float = 0.30  # sense-amp regeneration rate (V/ns at full drive)
    sa_enable_ns: float = 1.5     # sensing starts while signal still develops
    precharge_tau_ns: float = 0.5 # equalizer time constant (applied at the SA node)
    dt_ns: float = 0.01

    @property
    def tau_seg_ns(self) -> float:
        return (self.r_bl_kohm / self.n_seg) * (self.c_bl_fF / self.n_seg) * 1e-3


WL_SLOPE_NS = 0.3    # the wordline's soft turn-on: sigmoid((t - t_wl) / 0.3)
SA_STEEPNESS = 25.0  # the sense amp's tanh((v0 - v_half) * 25)


def time_constants(cp: CircuitParams) -> dict:
    """The ladder's time constants (ns, Python floats) after the explicit
    Euler stability check the reference asserts (``dt <= 0.49 *`` the
    fastest one); raises ``ValueError`` when ``cp`` violates it."""
    c_seg = cp.c_bl_fF / cp.n_seg
    taus = dict(tau_seg=cp.tau_seg_ns,                       # neighbour equilibration
                tau_acc_cell=cp.r_acc_kohm * cp.c_cell_fF * 1e-3,   # cell side
                tau_acc_node=cp.r_acc_kohm * c_seg * 1e-3)          # bitline-node side
    if not cp.dt_ns <= 0.49 * min(*taus.values(), cp.precharge_tau_ns):
        raise ValueError(f"explicit Euler stability: dt_ns={cp.dt_ns} must be "
                         f"<= 0.49 x the fastest time constant {taus}")
    return taus


def n_steps(cp: CircuitParams, t_total_ns: float) -> int:
    return int(t_total_ns / cp.dt_ns)


def step_times(cp: CircuitParams, t_total_ns: float) -> np.ndarray:
    """Each step's time, ``float32(i) * dt`` in float32 as in the reference."""
    return np.arange(n_steps(cp, t_total_ns), dtype=np.float32) \
        * np.float32(cp.dt_ns)


def step_phases(t: np.float32, cp: CircuitParams, t_pre_ns: float):
    """Which of the three phases act on a step at float32 time ``t``,
    decided in float32 as the reference's weakly typed constants are:
    (wordline open, sense amp on, precharge on)."""
    t_pre = np.float32(t_pre_ns)
    return (bool(t < t_pre), bool((t >= np.float32(cp.sa_enable_ns))
                                  & (t < t_pre)), bool(t >= t_pre))


def divisors(cp: CircuitParams, dev) -> dict:
    """Every constant the step divides by, as a float32 0-d tensor on
    ``dev``: ``x / c`` is then an IEEE float32 division on any device (the
    ``latency.div_t`` convention), built once per run instead of per step."""
    taus = time_constants(cp)
    f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=dev)
    return dict({k: f32(v) for k, v in taus.items()},
                wl_slope=f32(WL_SLOPE_NS), precharge_tau=f32(cp.precharge_tau_ns))


def ladder_init(row_frac, col_frac, cp: CircuitParams, cell_charged: bool):
    """Initial state of (N,) cells: the (N, 1) int64 tap node of each row,
    its (N,) wordline arrival time, the (N, n_seg) ladder at VDD/2 and the
    (N,) cell at VDD (charged) or 0."""
    n = cp.n_seg
    tap = torch.clamp(torch.round(row_frac * (n - 1)).to(torch.int64), 0, n - 1)
    t_wl = col_frac * cp.wl_delay_ns_max
    v_bl = torch.full((row_frac.shape[0], n), cp.v_half, dtype=torch.float32,
                      device=row_frac.device)
    v_cell = torch.full_like(row_frac, cp.vdd if cell_charged else 0.0)
    return tap[:, None], t_wl, v_bl, v_cell


def euler_step(v_bl, v_cell, tap, t_wl, t, phases, cp: CircuitParams,
               div: dict):
    """One explicit Euler step (``repro/core/spice.py:85-111``) of (N,) cells:
    ``v_bl`` (N, n_seg), ``v_cell`` (N,), ``tap`` (N, 1) int64, ``t_wl``
    (N,), ``t`` the step's float32 time as a 0-d tensor on their device and
    ``phases`` = (wordline open, sense amp on, precharge on) from
    ``step_phases``.  A phase that is off adds an exact zero in the
    reference, so it is skipped here.  Returns the new ``v_bl`` and
    ``v_cell``, the sense-amp node before the step and the probe (the
    bitline at the tap) after it."""
    wl_open, sa_on, pre_on = phases
    # RC ladder diffusion (reflecting ends)
    left = torch.cat([v_bl[:, :1], v_bl[:, :-1]], dim=1)
    right = torch.cat([v_bl[:, 1:], v_bl[:, -1:]], dim=1)
    dv = (left - 2 * v_bl + right) / div["tau_seg"]
    v0 = v_bl[:, 0]
    if wl_open:
        # access transistor: soft turn-on after the wordline's RC arrival
        wl_on = torch.sigmoid((t - t_wl) / div["wl_slope"])
        v_tap = torch.gather(v_bl, 1, tap)[:, 0]
        dv_cell = wl_on * (v_tap - v_cell) / div["tau_acc_cell"]
        dv = dv.scatter_add(1, tap, (wl_on * (v_cell - v_tap)
                                     / div["tau_acc_node"])[:, None])
    if sa_on:
        # sense amplifier at node 0 (regenerative), enabled early: the race
        # with the far taps' diffusing signal is the bitline mechanism
        dv[:, 0] = dv[:, 0] + cp.sa_gain_per_ns * torch.tanh(
            (v0 - cp.v_half) * SA_STEEPNESS)
    if pre_on:
        # precharge: the equalizer sits at the SA; far nodes settle through
        # the ladder (the tRP distance mechanism)
        dv[:, 0] = dv[:, 0] + (cp.v_half - v0) / div["precharge_tau"]
    v_bl = torch.clamp(v_bl + dv * cp.dt_ns, 0.0, cp.vdd)
    if wl_open:
        v_cell = torch.clamp(v_cell + dv_cell * cp.dt_ns, 0.0, cp.vdd)
    return v_bl, v_cell, v0, torch.gather(v_bl, 1, tap)[:, 0]


def simulate(row_frac, col_frac, *, t_total_ns: float = 45.0,
             t_precharge_at_ns: float = 30.0, cp: CircuitParams = CircuitParams(),
             cell_charged: bool = True, device=None):
    """Simulate cells at normalized bitline distance ``row_frac`` in [0,1] and
    wordline distance ``col_frac`` in [0,1] (arrays broadcast together) on
    ``device`` (default: the CUDA device).

    Returns {"t_ns" (steps,) float64 numpy, "v_sa" (bitline @ sense amp),
    "v_probe" (bitline @ the cell's tap), "v_cell"}, the last three float32
    tensors of shape (..., steps) on ``device``.
    """
    dev = resolve_device(device)
    rf = torch.as_tensor(row_frac, dtype=torch.float32, device=dev)
    cf = torch.as_tensor(col_frac, dtype=torch.float32, device=dev)
    rf, cf = torch.broadcast_tensors(rf, cf)
    shape = rf.shape
    div = divisors(cp, dev)
    tap, t_wl, v_bl, v_cell = ladder_init(rf.reshape(-1), cf.reshape(-1), cp,
                                          cell_charged)
    t_host = step_times(cp, t_total_ns)
    steps, times = len(t_host), torch.as_tensor(t_host, device=dev)
    out = torch.empty((3, v_cell.shape[0], steps), dtype=torch.float32,
                      device=dev)
    for i, t in enumerate(t_host):
        phases = step_phases(t, cp, t_precharge_at_ns)
        v_bl, v_cell, v0, v_probe = euler_step(v_bl, v_cell, tap, t_wl,
                                               times[i], phases, cp, div)
        out[0, :, i], out[1, :, i], out[2, :, i] = v0, v_probe, v_cell
    out = out.reshape((3,) + tuple(shape) + (steps,))
    return {"t_ns": np.arange(steps) * cp.dt_ns, "v_sa": out[0],
            "v_probe": out[1], "v_cell": out[2]}


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def sense_time(res, v_ready: float = 0.9):
    """Time for the bitline near the accessed cell to reach v_ready (App. B
    probes the bitline 'measured near the accessed cells')."""
    v = _np(res["v_probe"])
    t = np.asarray(res["t_ns"])
    reached = v >= v_ready
    idx = np.argmax(reached, axis=-1)
    ok = reached.any(axis=-1)
    return np.where(ok, t[idx], np.inf)


def restored_voltage(res, t_ras_ns: float = 30.0):
    """Cell voltage right before precharge (restoration quality, label B)."""
    t = np.asarray(res["t_ns"])
    i = max(int(np.searchsorted(t, t_ras_ns)) - 1, 0)
    return _np(res["v_cell"])[..., i]


def precharge_time(res, t_pre_ns: float = 30.0, tol: float = 0.02):
    """Time after precharge start for the whole bitline (both ends) to return
    to VDD/2 +- tol — the next row anywhere on the bitline needs this."""
    t = np.asarray(res["t_ns"])
    dev = np.abs(_np(res["v_probe"]) - 0.6)
    settled = (dev <= tol) & (t >= t_pre_ns)
    # require it to STAY settled: find the last unsettled time after t_pre
    unsettled = (~settled) & (t >= t_pre_ns)
    has_un = unsettled.any(axis=-1)
    last_un = t[dev.shape[-1] - 1 - np.argmax(unsettled[..., ::-1], axis=-1)]
    return np.where(has_un, last_un - t_pre_ns + res["t_ns"][1], 0.0)


def fit_latency_coefficients(cp: CircuitParams = CircuitParams(), device=None):
    """Slopes (ns per unit normalized distance) of sense time along the
    bitline/wordline directions — physical inputs for core/latency.py."""
    res = simulate(np.array([0.05, 0.95, 0.05]), np.array([0.0, 0.0, 1.0]),
                   cp=cp, device=device)
    ts = sense_time(res)
    return {"t0_ns": float(ts[0]),
            "k_bl_ns": float(ts[1] - ts[0]) / 0.9,
            "k_wl_ns": float(ts[2] - ts[0])}
