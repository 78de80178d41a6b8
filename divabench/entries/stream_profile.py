"""DIVA profiling of a fleet streamed in chunks:
``streaming.stream_profile_population`` over a pool of host chunks, chunk
after chunk, pass after pass, each call returning its per-DIMM timing
tables (``collect=True``).

Traffic keys: ``chunk_dimms``, ``region``, ``temp_C``, ``refresh_ms``,
``guard_cycles``.  The configuration gives the pool: ``n_dimms`` DIMMs
made in chunks of ``chunk_dimms``.  Compared: the tables of every DIMM of
the sampled chunks, entry for entry (``table_mismatches``).
"""
from __future__ import annotations

import numpy as np

from divabench import reference
from divabench.entries.common import port_stream
from divabench.population import fleet_pool


def setup(ctx):
    t = ctx.traffic
    C = int(t["chunk_dimms"])
    n_chunks = int(ctx.config["n_dimms"]) // C
    pool = fleet_pool(ctx.geom, ctx.seed, C, n_chunks)
    from repro_torch.core.streaming import stream_profile_population
    state = dict(ctx=ctx, pool=pool, C=C,
                 streams=[port_stream(p, ctx.geom_fields, ctx.device)
                          for p in pool],
                 run=stream_profile_population,
                 kw=dict(chunk_size=C, region=t["region"],
                         temp_C=float(t["temp_C"]),
                         refresh_ms=float(t["refresh_ms"]),
                         guard_cycles=int(t["guard_cycles"]), collect=True))
    step(state, 0)              # every shape of the window, once
    return state


def step(state, i: int) -> dict:
    k = i % len(state["pool"])
    res = state["run"](state["streams"][k], **state["kw"])
    return {"k": k, "dimms": state["C"], "tables": res["tables"]}


def release(state) -> None:
    state["streams"] = None


def reference_unit(state, unit: dict, dtype) -> dict:
    ctx, kw = state["ctx"], state["kw"]
    return {"tables": reference.profile_tables(
        state["pool"][unit["k"]], ctx.geom, device=ctx.device, dtype=dtype,
        region=kw["region"], temp_C=kw["temp_C"],
        refresh_ms=kw["refresh_ms"], guard_cycles=kw["guard_cycles"])}


def compare(unit: dict, ref: dict) -> dict:
    return {"table_mismatches": int(np.sum(unit["tables"] != ref["tables"]))}


def kernel_work(state) -> dict:
    return {}
