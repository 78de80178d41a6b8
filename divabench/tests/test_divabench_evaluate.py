"""``paper96.evaluate`` on the CPU at test sizes: its plain reference
(``reference_eval.py``) against the port's own plain paths, the cell through
the harness, faults under its timed path, its controls failing their
limits; and the harness running a configuration that has no DIMM geometry
and counts tokens."""
import dataclasses
import sys
import time
import types

import numpy as np
import pytest
import torch

from divabench import harness, reference_eval as RE
from divabench.control import readings
from divabench.model.geometry import DimmGeometry
from divabench.population import paper96_leaves
from divabench_cells import TINY, manifest, small_cell
from test_divabench_imports import FORBIDDEN, _loaded

CELL = "paper96.evaluate"
TABLES = np.asarray([[13.75, 35.0, 13.75, 15.0], [10.0, 25.0, 8.75, 7.5],
                     [7.5, 21.25, 6.25, 10.0]])


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def eval_cell(dimms: int = 12, accesses: int = 200, requests: int = 300):
    """The cell at TINY geometry with ``dimms`` DIMMs, ``accesses`` column
    accesses a DIMM and ``requests`` a workload trace."""
    cell = small_cell(CELL, TINY, dimms)
    return dataclasses.replace(cell, traffic=dict(
        cell.traffic, n_accesses=accesses, n_requests=requests))


def _run(fault=None, trace=False, seed=2**33 + 7):
    return harness.run_cell(CELL, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu",
                            manifest=manifest(), cell=eval_cell(),
                            fault=fault)


# ------------------------------------------- the reference against the port

def test_traces_are_the_ports():
    from repro_torch.memsim import sim
    seed = 2**31 - 20
    traces = RE.make_traces(400, 16, seed)
    assert [w.name for w in RE.WORKLOADS] == [w.name for w in sim.WORKLOADS]
    for w, wl in enumerate(sim.WORKLOADS):
        np.testing.assert_array_equal(
            traces[w], sim.pack_trace(sim.make_trace(wl, 400, 16, seed + w)))


@pytest.mark.parametrize("scheduler", ["frfcfs", "inorder"])
def test_walk_equals_the_ports_loop_total_for_total(scheduler):
    """The vectorised walk against the port's per-request numpy walker
    (``memsim/reference.simulate_trace_loop``), 3 tables x 12 workloads."""
    from repro_torch.core.timing import TimingParams
    from repro_torch.memsim import reference, sim
    system, cfg = {"frfcfs": (RE.FRFCFS, sim.MemSimConfig()),
                   "inorder": (RE.IN_ORDER, sim.inorder_config(16))}[scheduler]
    n, seed = 500, 77
    traces = RE.make_traces(n, 16, seed)
    got = RE.walk_totals(traces, RE.table_cycles(TABLES, 16), system,
                         device="cpu")
    want = [[reference.simulate_trace_loop(
        dict(zip(sim.TRACE_KEYS, traces[w].T)), TimingParams(*t),
        config=cfg)["total_latency_cycles"] for w in range(len(traces))]
        for t in TABLES]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_speedups_are_the_ports_scoring():
    from repro_torch.memsim import sim
    traces = RE.make_traces(300, 16, 5)
    totals = RE.walk_totals(traces, RE.table_cycles(TABLES, 16),
                            device="cpu")
    want = sim._speedups(totals.astype(np.int32), 300)["per_dimm_speedup"]
    np.testing.assert_allclose(RE.speedups(totals, 300), want, rtol=1e-12)


def test_syndromes_and_layouts_are_the_ports_bit_for_bit():
    from repro_torch.core import ecc
    from repro_torch.kernels.shuffle import shuffle_permutation
    words = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, (4096, 72)), dtype=torch.int32)
    words[:72] = torch.eye(72, dtype=torch.int32)        # every single error
    bits = ecc.syndrome(words).to(torch.int64)
    want = (bits << torch.arange(8)).sum(-1)
    torch.testing.assert_close(RE.syndrome_values(words), want, rtol=0,
                               atol=0)
    for shuffle in (False, True):
        np.testing.assert_array_equal(RE.burst_layout(shuffle),
                                      shuffle_permutation(shuffle))


def test_profile_and_counts_are_the_ports():
    from repro_torch.core.substrate import (DimmBatch,
                                            burst_bit_profile_population,
                                            shuffling_gain_population)
    from divabench.entries.evaluate import _codewords
    leaves = paper96_leaves(DimmGeometry(**TINY), 12)
    batch = DimmBatch.from_arrays(TINY, leaves, "cpu")
    kw = dict(temp_C=85.0, refresh_ms=256.0)
    prof = burst_bit_profile_population(batch, "trp", 7.5, **kw)
    want = RE.burst_profile(leaves, DimmGeometry(**TINY), "trp", 7.5,
                            device="cpu", **kw)
    np.testing.assert_allclose(prof, want, rtol=1e-6, atol=0)
    seeds = np.random.default_rng(9).integers(0, 2**32, 12)
    got = _codewords(shuffling_gain_population(prof, seeds=seeds,
                                               n_accesses=300, device="cpu"))
    ref = RE.codeword_counts(prof, seeds, 300, device="cpu", block=5)
    for k in RE.COUNT_KEYS:
        np.testing.assert_array_equal(got[k], ref[k], k)
    assert ref["undetected_shuffle"].sum() > 0


# ---------------------------------------------- the cell's rounds

def test_rounds_take_every_evaluation_and_build_no_traces():
    """A run's rounds take the traffic's 8 evaluations in a seeded order,
    each once a cycle, with the DIMMs' serials fixed; the window builds no
    traces (the traffic keeps the program's default trace seed)."""
    from repro_torch.memsim import sim
    from divabench.entries import evaluate
    ctx = harness._ctx(eval_cell(), 2**33 + 5, torch.device("cpu"))
    state = evaluate.setup(ctx)
    n = len(state["evaluations"])
    assert n == 8 and sorted(state["order"]) == list(range(n))
    assert sorted(evaluate._point(state, i) for i in range(1, n + 1)) \
        == sorted(state["evaluations"])
    serials, builds = state["serials"].copy(), sim.N_TRACE_BUILDS
    for i in range(1, 3):
        evaluate.step(state, i)
    assert sim.N_TRACE_BUILDS == builds
    np.testing.assert_array_equal(state["serials"], serials)
    other = evaluate.setup(harness._ctx(eval_cell(), 6, torch.device("cpu")))
    assert not np.array_equal(other["serials"], serials)


# ---------------------------------------------- the cell through the harness

@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    out = _run(trace=trace)
    assert out["correct"] is True and out["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"]
             for m in harness.metrics_for(manifest(), kind, CELL)}
    assert set(out["metrics"]) <= set(units)
    if not trace:
        assert {"setup_s", "eval_dimms_per_s"} <= set(out["metrics"])
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


def _half(state):
    """Every evaluation run on the first half of the DIMMs, its per-DIMM
    outputs tiled to the whole: half the batch left out."""
    from repro_torch.core.substrate import DimmBatch
    ctx, h = state["ctx"], state["D"] // 2
    half = DimmBatch.from_arrays(ctx.geom_fields, {
        k: v[:h] for k, v in state["leaves"].items()}, ctx.device)
    profile, shuffle, speedup = (state[k] for k in
                                 ("profile", "shuffle", "speedup"))
    state["profile"] = lambda batch, *a, **kw: np.tile(
        profile(half, *a, **kw), (2, 1, 1))
    state["shuffle"] = lambda prof, seeds, **kw: {
        k: np.tile(v, 2) for k, v in shuffle(prof[:h], seeds=seeds[:h],
                                             **kw).items()}

    def halved(tables, **kw):
        res = speedup(tables[:h], **kw)
        tot = res["total_latency_cycles"]
        return dict(res, total_latency_cycles=np.concatenate(
            [tot[:1], tot[1:], tot[1:]]),
            per_dimm_speedup=np.tile(res["per_dimm_speedup"], 2))
    state["speedup"] = halved


def _altered(stage):
    """One answer altered where the port produces it: a burst bit's
    probability, a codeword count, a walk's total latency."""
    def plant(state):
        real = state[stage]

        def run(*a, **kw):
            res = real(*a, **kw)
            if stage == "profile":
                res = res.copy()
                res[0, 0, np.argmax(res[0, 0])] *= 1.01
            elif stage == "shuffle":
                res = dict(res, undetected_shuffle=res["undetected_shuffle"]
                           + np.eye(len(res["total"]), dtype=np.int64)[0])
            else:
                tot = res["total_latency_cycles"].copy()
                tot[1, 0] += 1
                res = dict(res, total_latency_cycles=tot)
            return res
        state[stage] = run
    return plant


@pytest.mark.parametrize("fault", [_half, _altered("profile"),
                                   _altered("shuffle"), _altered("speedup")],
                         ids=["half", "profile", "count", "total"])
def test_fault_under_the_timed_path_is_not_correct(fault):
    out = _run(fault=lambda entry, state: fault(state))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_controls_fail_their_limits():
    """The program passes every limit; the bfloat16 control fails the float
    numbers, the first-come first-served and one-cycle-off controls the
    walks' totals, the skipped shuffle the codeword counts."""
    cell = eval_cell()
    limits = cell.traffic["limits"]
    r = readings(cell, [11, 2**33 + 12], device="cpu")
    for k, vals in r["program"].items():
        assert max(vals) <= limits[k], k
    c = r["controls"]
    fails = lambda name, k: min(c[name][k]) > limits[k]
    assert fails("bfloat16", "burst_rel_err")
    assert fails("bfloat16", "speedup_rel_err")
    assert fails("fcfs", "total_cycles_mismatches")
    assert fails("cycle_off", "total_cycles_mismatches")
    assert fails("no_shuffle", "codeword_count_mismatches")


def test_reference_loads_nothing_of_the_program():
    assert not _loaded("from divabench import reference_eval") \
        & (FORBIDDEN | {"repro_torch"})


# ------------------------------- a configuration without a DIMM geometry

def _stub_entry() -> types.ModuleType:
    """A model-like entry: a "model" that doubles its tokens, 8 tokens a
    step, no DIMMs."""
    mod = types.ModuleType("divabench.entries.stub_tokens")

    def setup(ctx):
        assert ctx.geom is None and ctx.geom_fields is None
        return {"width": int(ctx.config["hidden_size"])}

    def step(state, i):
        toks = np.arange(8) + i
        return {"i": i, "out": 2 * toks, "counts": {"tokens": len(toks)}}

    mod.setup, mod.step = setup, step
    mod.release = lambda state: None
    mod.reference_unit = lambda state, unit, dtype: {
        "out": 2 * (np.arange(8) + unit["i"])}
    mod.compare = lambda unit, ref: {
        "token_mismatches": int(np.sum(unit["out"] != ref["out"]))}
    mod.kernel_work = lambda state: {}
    return mod


def test_a_config_without_geometry_runs_and_counts_tokens(monkeypatch):
    monkeypatch.setitem(sys.modules, "divabench.entries.stub_tokens",
                        _stub_entry())
    real = harness.metric_reader
    readers = {"tokens_per_s": lambda run: run.counts["tokens"]
               / run.window_s,
               "tokens_done": lambda run: float(run.counts["tokens"]),
               "units_done": lambda run: float(run.units),
               "dimms_done": lambda run: float(run.dimms) or None}
    monkeypatch.setattr(harness, "metric_reader",
                        lambda name: readers.get(name) or real(name))
    m = {"end_to_end": [
        {"name": n, "unit": u, "better": "higher", "bound": 0.05,
         "source": "host_clock"}
        for n, u in (("setup_s", "s"), ("tokens_per_s", "tokens/s"),
                     ("tokens_done", "tokens"), ("units_done", "units"),
                     ("dimms_done", "DIMMs"))], "per_layer": []}
    cell = harness.Cell(name="stub.tokens", chips=1,
                        config={"name": "stub", "hidden_size": 64},
                        traffic={"entry": "stub_tokens",
                                 "limits": {"token_mismatches": 0}})
    out = harness.run_cell("stub.tokens", 4, 0.05, False,
                           t_start=time.perf_counter(), device="cpu",
                           manifest=m, cell=cell)
    met = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"] is True and "dimms_done" not in met
    assert met["tokens_done"] == 8 * met["units_done"] == 8 * out["attempted"]
    assert met["tokens_per_s"] > 0 and met["setup_s"] > 0
