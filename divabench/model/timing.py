"""DRAM timing parameters (DDR3-1600 defaults, per the paper's Section 4).

A frozen copy of the port's ``core/timing.py``, kept with the benchmark:
its inputs and its plain reference import nothing of the program.

Standard values 13.75/35.0/13.75/15.0 ns for tRCD/tRAS/tRP/tWR [Micron
MT41J512M8]; the testing infrastructure reduces them on a grid down to 5 ns
(2.5 ns steps — the FPGA quantization the paper reports, which explains the 24
no-variation DIMMs in Fig 14).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

CYCLE_NS = 1.25  # DDR3-1600 clock period
TCL_NS = 13.75  # CAS latency, fixed (not swept by the paper)
TCWL_NS = 10.0  # CAS write latency (DDR3-1600 CWL=8), fixed like tCL
PARAMS = ("trcd", "tras", "trp", "twr")

# Inter-command constraints consumed by the FR-FCFS memory-system simulator
# (repro.memsim): not swept by the paper's per-DIMM profiling, fixed at the
# DDR3-1600 datasheet values like tCL/tCWL.
TBL_NS = 5.0    # BL8 data-burst occupancy of the channel bus (4 bus clocks)
TRRD_NS = 6.0   # min ACTIVATE->ACTIVATE gap within a rank
TFAW_NS = 30.0  # four-activate window per rank

TBL_CYCLES = round(TBL_NS / CYCLE_NS)
TRRD_CYCLES = round(TRRD_NS / CYCLE_NS)
TFAW_CYCLES = round(TFAW_NS / CYCLE_NS)


@dataclass(frozen=True)
class TimingParams:
    trcd: float = 13.75
    tras: float = 35.0
    trp: float = 13.75
    twr: float = 15.0

    def replace(self, **kw) -> "TimingParams":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict[str, float]:
        return {p: getattr(self, p) for p in PARAMS}

    def cycles(self, name: str) -> int:
        return round(getattr(self, name) / CYCLE_NS)

    # Latency accounting used for Fig 18-style reporting: the read path pays
    # tRCD + tRAS + tRP (+ fixed tCL); the write path pays tRCD + tWR + tRP.
    def read_latency_ns(self) -> float:
        return self.trcd + self.tras + self.trp

    def write_latency_ns(self) -> float:
        return self.trcd + self.twr + self.trp

    def read_cycles(self) -> int:
        return round(self.read_latency_ns() / CYCLE_NS)

    def write_cycles(self) -> int:
        return round(self.write_latency_ns() / CYCLE_NS)


STANDARD = TimingParams()

# Non-timing operating-point axes (the VAR-DRAM / AL-DRAM direction): the
# nominal DDR3 supply rail and the JEDEC retention interval at 85 C.
VDD_STD = 1.35        # V — DDR3 nominal VDD/VDDQ
REFRESH_STD_MS = 64.0  # ms — JEDEC tREFW at normal temperature range
TEMP_STD_C = 85.0      # C — the latency model's coefficient anchor


# The FPGA infrastructure's timing grid (Section 4): multiples of the 2.5 ns
# step below the standard value, down to 5 ns (the paper's tRP points are
# 12.5/10/7.5/5). tRAS is additionally bounded below by (current tRCD + 10).
def timing_grid(param: str, step: float = 2.5, floor: float = 5.0) -> list[float]:
    hi = getattr(STANDARD, param)
    v = (hi // step) * step  # largest grid point <= standard
    vals = []
    while v >= floor - 1e-9:
        vals.append(round(v, 3))
        v -= step
    return vals


@dataclass(frozen=True)
class AxisSpec:
    """One operating-point axis: a named knob with a sweep grid and a
    quantized hash key.

    The counter-hash RNG (``substrate.query_uniform``) keys every draw on
    ``(serial, axis index, quantized axis value, ...)`` — never on ambient
    conditions — so draws are reproducible across chunking/sharding and
    monotone sweeps stay monotone.  ``quantize`` must therefore be *exact*
    and *injective* on the grid: two grid points that collapse to the same
    integer key would silently share failure draws.  Construction validates
    both (the quarter-ns timing quantization rejects e.g. a 0.1 ns step).

    ``grid`` is ordered from least to most aggressive: descending for
    timing/voltage (lower = faster/riskier), ascending for refresh (longer
    interval = more energy saved, more retention risk).
    """

    name: str
    unit: str
    index: int          # global hash lane; timing axes == PARAMS.index(name)
    standard: float
    grid: tuple[float, ...]
    quant: float = 0.25  # hash-key quantization step (quarter-ns for timing)
    descending: bool = True

    def __post_init__(self) -> None:
        if self.quant <= 0:
            raise ValueError(f"axis {self.name}: quant must be positive")
        keys = []
        for v in (*self.grid, self.standard):
            q = self.quantize(v)
            if abs(q * self.quant - v) > 1e-9:
                raise ValueError(
                    f"axis {self.name}: grid value {v} does not survive "
                    f"quantization by {self.quant} (aliases to {q * self.quant})")
            keys.append(q)
        grid_keys = keys[:-1]
        if len(set(grid_keys)) != len(grid_keys):
            raise ValueError(
                f"axis {self.name}: quantized grid keys collide: {grid_keys}")

    def quantize(self, value: float) -> int:
        """Integer hash key for one axis value (timing: ``quantize_t``)."""
        return int(round(float(value) / self.quant))


def timing_axis(param: str, step: float = 2.5, floor: float = 5.0,
                quant: float = 0.25) -> AxisSpec:
    """Build the AxisSpec for one of the paper's four timing parameters.

    Raises ``ValueError`` (via AxisSpec validation) for step/floor combos
    whose grid points alias under the quarter-ns hash quantization.
    """
    return AxisSpec(name=param, unit="ns", index=PARAMS.index(param),
                    standard=getattr(STANDARD, param),
                    grid=tuple(timing_grid(param, step, floor)), quant=quant)


# Voltage grid: nominal 1.35 V down to 0.90 V in 50 mV steps (the VAR-DRAM
# sweep range); 12.5 mV quantization keys every 50 mV point exactly.
VDD_GRID = tuple(round(1.35 - 0.05 * i, 3) for i in range(1, 10))
# Refresh grid: doublings of the JEDEC 64 ms interval (the retention-aware
# refresh direction — longer interval = lower refresh energy).
REFRESH_GRID_MS = (128.0, 256.0, 512.0, 1024.0)

# Global axis registry. Hash lane indices: the four timing axes reuse their
# historical PARAMS indices (0..3) so every pre-refactor draw is unchanged;
# the new axes take fresh lanes 4/5; lane 6 keys combined operating-grid
# points (see ``op_point_key``).
AXES: dict[str, AxisSpec] = {p: timing_axis(p) for p in PARAMS}
AXES["vdd"] = AxisSpec(name="vdd", unit="V", index=4, standard=VDD_STD,
                       grid=VDD_GRID, quant=0.0125)
AXES["refresh"] = AxisSpec(name="refresh", unit="ms", index=5,
                           standard=REFRESH_STD_MS, grid=REFRESH_GRID_MS,
                           quant=0.25, descending=False)
OP_GRID_LANE = 6  # hash lane for cross-product operating-grid evaluations

DEFAULT_AXES = PARAMS  # the pre-refactor sweep: exactly the 4 timing knobs
EXTENDED_AXES = PARAMS + ("vdd", "refresh")


def op_point_key(timing_q: int, vdd_q: int, refresh_q: int) -> int:
    """Deterministic uint32 hash key for one cross-product operating point.

    Operating-grid evaluations sweep several axes at once, so no single
    axis value can key the draw; instead the three quantized coordinates
    are folded into one 32-bit key (serial-keyed draws then stay identical
    across chunking/sharding, like single-axis sweeps).
    """
    h = (timing_q * 0x9E3779B9 + vdd_q) & 0xFFFFFFFF
    h = (h * 0x85EBCA6B + refresh_q) & 0xFFFFFFFF
    return h


@dataclass(frozen=True)
class OperatingPoint:
    """A full operating point: timing knobs plus voltage/temperature/refresh.

    The 4-parameter ``TimingParams`` is the paper's original sweep space;
    an ``OperatingPoint`` extends it with the ambient axes the successors
    sweep (voltage scaling, retention-aware refresh) without disturbing it.
    """

    timing: TimingParams = STANDARD
    vdd: float = VDD_STD
    temp_C: float = 55.0
    refresh_ms: float = REFRESH_STD_MS

    def replace(self, **kw) -> "OperatingPoint":
        return dataclasses.replace(self, **kw)

    def as_dict(self) -> dict[str, float]:
        d = self.timing.as_dict()
        d.update(vdd=self.vdd, temp_C=self.temp_C, refresh_ms=self.refresh_ms)
        return d

    def read_latency_ns(self) -> float:
        return self.timing.read_latency_ns()

    def write_latency_ns(self) -> float:
        return self.timing.write_latency_ns()

    def energy_proxy(self) -> float:
        return energy_proxy(self.vdd, self.refresh_ms)


def energy_proxy(vdd: float = VDD_STD,
                 refresh_ms: float = REFRESH_STD_MS) -> float:
    """Relative DRAM energy at an operating point (1.0 at nominal).

    Core/IO power scales ~VDD^2; refresh power scales with refresh *rate*
    and is ~15% of the budget at the nominal 64 ms interval — a coarse
    proxy, but monotone in both knobs, which is all the Pareto frontier
    figure needs.
    """
    return (vdd / VDD_STD) ** 2 * 0.85 + 0.15 * (REFRESH_STD_MS / refresh_ms)
