"""One run of one cell: set up, measure for a fixed time, check, report.

Everything is found by name.  ``BENCHMARK.json`` (at the checkout's root)
names the cell's configuration and traffic mix; the configuration's file
holds its sizes (``configs/``), the traffic mix its parameters and the
entry driver it runs (``traffic/<name>.json``, ``entries/<entry>.py``), and
each metric has a reader of its own (``metrics/<name>.py``).  A new cell,
configuration or metric is new files and new entries in ``BENCHMARK.json``.

A run: set-up (imports, inputs from the seed, the program's objects, one
warm-up unit of every shape the window uses; ``setup_s`` counts from the
process's start), then whole units of work, closed loop, until ``seconds``
have passed (the window ends with the unit that crosses it), then the
check: the plain reference re-derives a sample of the window's units, drawn
from the seed (reservoir sampling over the units as they complete), after
the program's device state is freed.  With ``trace`` the window runs under
``torch.profiler`` and the program's span tracer, and the per-layer metrics
are read from them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    name = "divabench._found." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(name: str) -> ModuleType:
    return importlib.import_module(f"divabench.entries.{name}")


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py").read


def metrics_for(manifest: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    """A cell resolved from the manifest: its entry, its configuration's
    sizes and its traffic parameters."""
    name: str
    chips: int
    config: dict
    traffic: dict

    @classmethod
    def load(cls, manifest: dict, name: str) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        return cls(name=name, chips=int(w["chips"]),
                   config=load_json(ROOT / conf["file"]),
                   traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def _ctx(cell: Cell, seed: int, device):
    """What an entry driver's set-up reads: the cell's sizes and traffic,
    the seed, the device, and the DIMM geometry as the program's fields and
    as the benchmark's own ``DimmGeometry`` (both None where the
    configuration has no ``geometry``, as a model's has none)."""
    fields = geom = None
    if "geometry" in cell.config:
        from divabench.model.geometry import DimmGeometry
        fields = dict(cell.config["geometry"])
        geom = DimmGeometry(**fields)
    return SimpleNamespace(config=cell.config, traffic=cell.traffic,
                           seed=int(seed) % (1 << 64), device=device,
                           geom_fields=fields, geom=geom)


def _forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / ".divabench_cache" / sub))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, manifest: dict | None = None,
             cell: Cell | None = None, fault=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``device`` None means the card, which must be there; tests pass "cpu"
    and a ``cell`` at a small size.  ``fault(entry, state)``, where given,
    breaks the program underneath the timed path after set-up (tests)."""
    import torch
    manifest = manifest if manifest is not None else \
        load_json(ROOT / "BENCHMARK.json")
    cell = cell if cell is not None else Cell.load(manifest, name)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {cell.chips}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card \
        else (lambda: None)

    entry = entry_module(cell.traffic["entry"])
    ctx = _ctx(cell, seed, device)
    state = entry.setup(ctx)
    if fault is not None:
        fault(entry, state)
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # the unit the check re-derives: one drawn from the seed among all the
    # window's units, by reservoir sampling as they complete
    pick = np.random.default_rng([ctx.seed, 1])
    kept = None
    prof = spans = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch import obs
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        obs.start_tracing()
        window_range = record_function("divabench.window")
        window_range.__enter__()
    units = dimms = 0
    counts: dict = {}
    t0 = time.perf_counter()
    while True:
        rec = entry.step(state, units)
        units += 1
        dimms += int(rec.get("dimms", 0))
        for k, v in rec.get("counts", {}).items():
            counts[k] = counts.get(k, 0) + v
        if pick.integers(units) == 0:
            kept = rec
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    tr = None
    if trace:
        window_range.__exit__(None, None, None)
        spans = obs.stop_tracing()
        prof.__exit__(None, None, None)
        from divabench.trace import summarize
        tr = summarize(prof)
        del prof
    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0
    loaded = _forbidden_loaded()
    if loaded:
        raise RuntimeError("loaded in the reporting process: "
                           + ", ".join(loaded))

    run = SimpleNamespace(cell=cell.name, setup_s=setup_s, window_s=window_s,
                          units=units, dimms=dimms, counts=counts,
                          peak_window_bytes=peak_window, trace=tr,
                          spans=spans or [], work=entry.kernel_work(state))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(manifest, kind, cell.name):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, once the window's state is freed
    entry.release(state)
    if on_card:
        torch.cuda.empty_cache()
    checks = check(entry, state, kept, cell.traffic["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": max(setup_peak, peak_window)}
    if on_card:
        dev["power_limit"] = power_limit()
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": correct, "attempted": units,
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def check(entry, state, unit: dict, limits: dict) -> dict:
    """The plain reference, in the configuration's float32, against the
    sampled unit: each number compared beside its limit."""
    import torch
    got = entry.compare(unit, entry.reference_unit(state, unit, torch.float32))
    if set(limits) != set(got):
        raise KeyError(f"compared numbers {sorted(got)} and limits "
                       f"{sorted(limits)} differ")
    return {k: {"value": got[k], "limit": limits[k]} for k in sorted(got)}
