"""Characterization rounds: ``substrate.row_error_lambda`` on a resident
population for each of tRCD, tRAS, tRP and tWR, at a reduced latency and a
temperature drawn for the round from the seed.

Traffic keys: ``latencies`` (per parameter, the ns values a round draws
from), ``temps_C`` (the temperatures it draws from), ``refresh_ms``.
Compared: the per-row expected error counts of every DIMM of the sampled
rounds, each DIMM's largest gap over its largest count (``lam_rel_err``).
"""
from __future__ import annotations

import numpy as np

from divabench import reference
from divabench.entries.common import rel_err
from divabench.model.timing import PARAMS
from divabench.population import paper96_leaves


def _draw(ctx, i: int) -> dict:
    """Round ``i``'s operating point: a function of (seed, i) alone."""
    rng = np.random.default_rng([ctx.seed, 2, i])
    t = ctx.traffic
    pick = lambda vals: float(vals[rng.integers(len(vals))])
    d = {p: pick(t["latencies"][p]) for p in PARAMS}
    d["temp_C"] = pick(t["temps_C"])
    return d


def setup(ctx):
    leaves = paper96_leaves(ctx.geom, int(ctx.config["n_dimms"]))
    from repro_torch.core.substrate import DimmBatch, row_error_lambda
    batch = DimmBatch.from_arrays(ctx.geom_fields, leaves, ctx.device)
    state = dict(ctx=ctx, leaves=leaves, batch=batch, run=row_error_lambda,
                 refresh_ms=float(ctx.traffic["refresh_ms"]))
    step(state, 0)              # every shape of the window, once
    return state


def step(state, i: int) -> dict:
    d = _draw(state["ctx"], i)
    out = {f"lam_{p}": state["run"](state["batch"], p, d[p],
                                    temp_C=d["temp_C"],
                                    refresh_ms=state["refresh_ms"])
           for p in PARAMS}
    return dict(out, i=i, dimms=state["batch"].n_dimms)


def release(state) -> None:
    state["batch"] = None


def reference_unit(state, unit: dict, dtype) -> dict:
    ctx = state["ctx"]
    d = _draw(ctx, unit["i"])
    return {f"lam_{p}": reference.row_lambda(
        state["leaves"], ctx.geom, p, d[p], device=ctx.device, dtype=dtype,
        temp_C=d["temp_C"], refresh_ms=state["refresh_ms"]) for p in PARAMS}


def compare(unit: dict, ref: dict) -> dict:
    return {"lam_rel_err": max(rel_err(unit[k], ref[k], axis=1)
                               for k in ref)}


def kernel_work(state) -> dict:
    from divabench.roofline import fail_prob_work
    g = state["ctx"].geom
    return {"fail_prob": fail_prob_work(len(state["leaves"]["serial"]),
                                        g.mats_x, g.rows_per_mat,
                                        g.cols_per_mat)}

