"""The paper's two evaluations of a profiled population, a round at a time:
DIVA Shuffling under SECDED (Fig 17: ``substrate.burst_bit_profile_population``
feeding ``substrate.shuffling_gain_population``) and the system speedup at
the DIMMs' DIVA timing tables (Fig 19: ``memsim.system_speedup_population``,
FR-FCFS).

Set-up profiles the resident population once at each of the traffic's
profiling temperatures (``substrate.profile_population``, DIVA Profiling of
the worst rows) and draws the DIMMs' serial numbers from the run seed; the
serials key each DIMM's error draws, as the program's callers pass
``seeds=batch.serial``.  A round takes one evaluation of the traffic's
product of table sets, Fig 17 latencies and refresh intervals, in an order
drawn from the run seed, and runs both evaluations over every DIMM; the
traces keep the program's default seed, as every caller's.

Traffic keys: ``region``, ``profile_temps_C``, ``profile_refresh_ms``,
``guard_cycles`` (the set-up's tables); ``param``, ``t_ops``, ``temp_C``,
``refresh_ms``, ``pattern``, ``subarray``, ``n_accesses`` (Fig 17);
``n_requests``, ``banks``, ``trace_seed`` (Fig 19).  Compared over the
sampled round, every DIMM: the burst profile (``burst_rel_err``), the
codeword counts of both layouts (``codeword_count_mismatches``), every
walk's total latency (``total_cycles_mismatches``) and the per-DIMM
speedups (``speedup_rel_err``).  The reference derives the profile, the
codeword counts, the timing tables, the traces, the walks and the speedups
itself.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from divabench import reference, reference_eval
from divabench.entries.common import rel_err
from divabench.model.timing import STANDARD
from divabench.population import paper96_leaves
from divabench.reference_eval import COUNT_KEYS, FRFCFS, WORKLOADS

_FIG17 = ("temp_C", "pattern", "subarray")


def _evaluations(t) -> list:
    """Every (table set, Fig 17 latency, Fig 17 refresh interval) of the
    traffic."""
    return list(itertools.product(range(len(t["profile_temps_C"])),
                                  t["t_ops"], t["refresh_ms"]))


def _point(state, i: int):
    """Round ``i``'s evaluation: the run's order of the traffic's
    evaluations, taken in turn."""
    order = state["order"]
    return state["evaluations"][order[i % len(order)]]


def setup(ctx):
    t = ctx.traffic
    D = int(ctx.config["n_dimms"])
    leaves = paper96_leaves(ctx.geom, D)
    from repro_torch.core.substrate import (DimmBatch,
                                            burst_bit_profile_population,
                                            profile_population,
                                            shuffling_gain_population)
    from repro_torch.memsim import system_speedup_population
    batch = DimmBatch.from_arrays(ctx.geom_fields, leaves, ctx.device)
    tables = [profile_population(
        batch, region=t["region"], temp_C=float(temp),
        refresh_ms=float(t["profile_refresh_ms"]),
        guard_cycles=int(t["guard_cycles"]))
        for temp in t["profile_temps_C"]]
    evaluations = _evaluations(t)
    rng = np.random.default_rng([ctx.seed, 3])
    state = dict(ctx=ctx, D=D, leaves=leaves, batch=batch, tables=tables,
                 serials=rng.integers(0, 1 << 32, D, dtype=np.int64),
                 evaluations=evaluations,
                 order=rng.permutation(len(evaluations)),
                 memo={}, profile=burst_bit_profile_population,
                 shuffle=shuffling_gain_population,
                 speedup=system_speedup_population)
    step(state, 0)              # every shape of the window, once
    return state


def _codewords(g17: dict) -> dict:
    """The codeword counts of ``shuffling_gain_population``'s result; the
    corrected ones from its fractions of the errors drawn (exact: a count
    below 2**53 over the same total, multiplied back and rounded)."""
    total = g17["total"]
    out = {"total": total}
    for mode in ("no_shuffle", "shuffle"):
        frac = np.where(total > 0, g17[f"frac_{mode}"], 0.0)
        out[f"corrected_{mode}"] = np.rint(
            frac * np.maximum(total, 1)).astype(np.int64)
        for kind in ("uncorrectable", "undetected"):
            out[f"{kind}_{mode}"] = g17[f"{kind}_{mode}"]
    return out


def step(state, i: int) -> dict:
    ctx = state["ctx"]
    t = ctx.traffic
    k, t_op, refresh = _point(state, i)
    profile = state["profile"](state["batch"], t["param"], t_op,
                               refresh_ms=refresh,
                               **{key: t[key] for key in _FIG17})
    g17 = state["shuffle"](profile, seeds=state["serials"],
                           n_accesses=int(t["n_accesses"]), device=ctx.device)
    g19 = state["speedup"](state["tables"][k],
                           n_requests=int(t["n_requests"]),
                           banks=int(t["banks"]), seed=int(t["trace_seed"]),
                           scheduler="frfcfs", device=ctx.device)
    return {"i": i, "dimms": state["D"], "profile": profile,
            "codewords": _codewords(g17),
            "totals": g19["total_latency_cycles"],
            "speedups": g19["per_dimm_speedup"]}


def release(state) -> None:
    state["batch"] = None


def _memo(state, key, fn):
    if key not in state["memo"]:
        state["memo"][key] = fn()
    return state["memo"][key]


def _reference(state, i: int, dtype, *, hits_first: bool = True,
               cycle_offset: int = 0, shuffle: bool = True) -> dict:
    """The plain reference's outputs for round ``i`` in ``dtype``: its own
    burst profile, codeword counts of that profile, timing tables, traces,
    walks and speedups.  The keywords break one guarantee each, for the
    controls."""
    ctx = state["ctx"]
    t, dev = ctx.traffic, ctx.device
    k, t_op, refresh = _point(state, i)
    n, banks, trace_seed = (int(t[key]) for key in
                            ("n_requests", "banks", "trace_seed"))
    profile = _memo(state, ("profile", dtype, t_op, refresh), lambda:
                    reference_eval.burst_profile(
                        state["leaves"], ctx.geom, t["param"], t_op,
                        device=dev, dtype=dtype, refresh_ms=refresh,
                        **{key: t[key] for key in _FIG17}))
    tables = _memo(state, ("tables", dtype, k), lambda:
                   reference.profile_tables(
                       state["leaves"], ctx.geom, device=dev, dtype=dtype,
                       region=t["region"],
                       temp_C=float(t["profile_temps_C"][k]),
                       refresh_ms=float(t["profile_refresh_ms"]),
                       guard_cycles=int(t["guard_cycles"])))
    traces = _memo(state, ("traces",), lambda: reference_eval
                   .make_traces(n, banks, trace_seed))

    def walk():
        base = [[getattr(STANDARD, p) for p in ("trcd", "tras", "trp",
                                                "twr")]]
        cycles = reference_eval.table_cycles(np.concatenate([base, tables]),
                                             banks)
        cycles[..., :4] += cycle_offset
        return reference_eval.walk_totals(
            traces, cycles, FRFCFS, device=dev, row_hits_first=hits_first)

    totals = _memo(state, ("totals", dtype, k, hits_first, cycle_offset),
                   walk)
    codewords = reference_eval.codeword_counts(
        profile, state["serials"], int(t["n_accesses"]), device=dev,
        shuffle=shuffle)
    return {"profile": profile, "codewords": codewords, "totals": totals,
            "speedups": reference_eval.speedups(totals, n, dtype)}


def reference_unit(state, unit: dict, dtype) -> dict:
    return _reference(state, unit["i"], dtype)


def controls(state, unit: dict) -> dict:
    """The reference in the program's place: in bfloat16 throughout; and in
    float32 with one fault each — plain first-come first-served walks,
    every table's four timings one cycle longer, DIVA Shuffling skipped."""
    f32, i = torch.float32, unit["i"]
    return {"bfloat16": _reference(state, i, torch.bfloat16),
            "fcfs": _reference(state, i, f32, hits_first=False),
            "cycle_off": _reference(state, i, f32, cycle_offset=1),
            "no_shuffle": _reference(state, i, f32, shuffle=False)}


def compare(unit: dict, ref: dict) -> dict:
    got, want = np.asarray(unit["speedups"]), np.asarray(ref["speedups"])
    return {
        "burst_rel_err": rel_err(unit["profile"], ref["profile"],
                                 axis=(1, 2)),
        "codeword_count_mismatches": int(sum(
            np.sum(np.asarray(unit["codewords"][k]) != ref["codewords"][k])
            for k in COUNT_KEYS)),
        "total_cycles_mismatches": int(np.sum(
            np.asarray(unit["totals"], np.int64) != ref["totals"])),
        "speedup_rel_err": float(np.max(np.abs(got - want)
                                        / np.abs(want))),
    }


def kernel_work(state) -> dict:
    from divabench.roofline import (bank_sched_work, fail_prob_work,
                                    permute_work, syndrome_work)
    t, D, g = state["ctx"].traffic, state["D"], state["ctx"].geom
    n, accesses = int(t["n_requests"]), int(t["n_accesses"])
    return {"fail_prob": fail_prob_work(D, g.mats_x, g.rows_per_mat,
                                        g.cols_per_mat),
            "bank_sched": bank_sched_work(1 + D, len(WORKLOADS), n,
                                          min(FRFCFS.queue, n),
                                          int(t["banks"])),
            "syndrome": syndrome_work(2 * D * accesses * 8),
            "permute": permute_work(D * accesses)}
