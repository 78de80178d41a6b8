"""The fleet error summary streamed in chunks:
``streaming.stream_error_summary`` over a pool of host chunks, chunk after
chunk, pass after pass, each call collecting its per-DIMM lambdas and row
fail maps (``collect_fail_maps=True``).

Traffic keys: ``chunk_dimms``, ``param``, ``t_op``, ``temp_C``,
``refresh_ms``, ``vdd``, ``retention``, ``pattern``, ``chip``,
``subarray``, ``threshold``, ``check_block`` (the reference's DIMMs a
block).  Compared over the sampled chunks: each DIMM's lambda
(``lam_rel_err``), the largest cell (``worst_rel_err``), the fleet
cell-sum (``grid_sum_rel_err``), the hot-cell counts
(``hot_cell_mismatches``) and the row fail maps (``row_fail_mismatches``).
"""
from __future__ import annotations

import numpy as np

from divabench import reference
from divabench.entries.common import port_stream, rel_err
from divabench.model.timing import VDD_STD
from divabench.population import fleet_pool

_KEYS = ("param", "t_op", "temp_C", "refresh_ms", "vdd", "retention",
         "pattern", "chip", "subarray", "threshold")


def setup(ctx):
    t = ctx.traffic
    C = int(t["chunk_dimms"])
    n_chunks = int(ctx.config["n_dimms"]) // C
    pool = fleet_pool(ctx.geom, ctx.seed, C, n_chunks)
    from repro_torch.core.streaming import stream_error_summary
    state = dict(ctx=ctx, pool=pool, C=C,
                 streams=[port_stream(p, ctx.geom_fields, ctx.device)
                          for p in pool],
                 run=stream_error_summary, kw={k: t[k] for k in _KEYS})
    step(state, 0)              # every shape of the window, once
    return state


def step(state, i: int) -> dict:
    k = i % len(state["pool"])
    kw = dict(state["kw"])
    param, t_op = kw.pop("param"), kw.pop("t_op")
    res = state["run"](state["streams"][k], param, t_op,
                       chunk_size=state["C"], collect_fail_maps=True, **kw)
    maps = [np.unpackbits(m.bits, count=int(np.prod(m.shape))).astype(bool)
            .reshape(m.shape) for m in res["fail_maps"]]
    return {"k": k, "dimms": state["C"], "lam_total": res["lam_total"],
            "worst_cell": float(res["worst_cell_max"]["value"]),
            "grid_sum": res["grid_sum"], "hot_cells": res["hot_cells"],
            "row_fail": np.concatenate(maps, axis=0)}


def release(state) -> None:
    state["streams"] = None


def reference_unit(state, unit: dict, dtype) -> dict:
    ctx, kw = state["ctx"], state["kw"]
    ref = reference.error_summary(
        state["pool"][unit["k"]], ctx.geom, device=ctx.device, dtype=dtype,
        block=int(ctx.traffic["check_block"]), **kw)
    ref["worst_cell"] = float(np.max(ref["worst_cell"]))
    return ref


def compare(unit: dict, ref: dict) -> dict:
    return {
        "lam_rel_err": float(np.max(
            np.abs(unit["lam_total"].astype(np.float64) - ref["lam_total"])
            / np.maximum(np.abs(ref["lam_total"].astype(np.float64)),
                         1e-30))),
        "worst_rel_err": rel_err(unit["worst_cell"], ref["worst_cell"]),
        "grid_sum_rel_err": rel_err(unit["grid_sum"], ref["grid_sum"]),
        "hot_cell_mismatches": int(np.sum(unit["hot_cells"]
                                          != ref["hot_cells"])),
        "row_fail_mismatches": int(np.sum(unit["row_fail"]
                                          != ref["row_fail"])),
    }


def kernel_work(state) -> dict:
    from divabench.roofline import fail_prob_op_work, fail_prob_work
    g, kw = state["ctx"].geom, state["kw"]
    shape = (state["C"], g.mats_x, g.rows_per_mat, g.cols_per_mat)
    if kw["retention"] and kw["vdd"] != VDD_STD:
        return {"fail_prob_op": fail_prob_op_work(*shape)}
    if not kw["retention"] and kw["vdd"] == VDD_STD:
        return {"fail_prob": fail_prob_work(*shape)}
    return {}
