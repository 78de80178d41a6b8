"""The harness on the CPU at test sizes: the result line's shape, no run
without a card or without the program, faults under the timed path and the
bfloat16 control failing the cells' limits; and one card-only run."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from divabench import harness
from divabench.control import readings
from divabench.entries.common import port_stream
from divabench.population import take
from divabench_cells import CELLS, SMALL, TINY, manifest, small_cell

RUN = [sys.executable, str(harness.HERE / "run.py"), "--workload",
       "fleet.summary", "--seed", "5", "--seconds", "1", "--trace", "0"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, trace=False, fault=None, cell=None, seed=2**33 + 3):
    return harness.run_cell(name, seed, 0.3, trace,
                            t_start=time.perf_counter(), device="cpu",
                            manifest=manifest(),
                            cell=cell or small_cell(name), fault=fault)


def test_no_card_no_result():
    res = subprocess.run(RUN, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 2 and res.stdout.strip() == ""
    assert "cuda" in res.stderr.lower()


def test_no_program_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "divabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "divabench/run.py", *RUN[2:]],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(name, trace):
    out = _run(name, trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"]
             for m in harness.metrics_for(manifest(), kind, name)}
    assert set(out["metrics"]) <= set(units)
    for k, v in out["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0
    if not trace:
        assert {"setup_s"} < set(out["metrics"])
    else:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(out))


def _half(name, state):
    """The port run over the first half of the chunk, its outputs tiled to
    the whole (fleet aggregates doubled): half the batch left out."""
    ctx = state["ctx"]
    if name == "paper96.characterize":
        from repro_torch.core.substrate import DimmBatch
        real = state["run"]
        h = state["batch"].n_dimms // 2
        half = DimmBatch.from_arrays(
            ctx.geom_fields, take(state["leaves"], slice(0, h)), ctx.device)

        def run(batch, *a, **kw):
            return np.tile(real(half, *a, **kw), (2, 1))
        return run
    real, h = state["run"], state["C"] // 2
    halves = [port_stream(take(p, slice(0, h)), ctx.geom_fields, ctx.device)
              for p in state["pool"]]

    def run(stream, *a, **kw):
        k = state["streams"].index(stream)
        kw["chunk_size"] = h
        res = real(halves[k], *a, **kw)
        if "tables" in res:
            return dict(res, tables=np.tile(res["tables"], (2, 1)))
        maps = res["fail_maps"][0]
        return dict(res, lam_total=np.tile(res["lam_total"], 2),
                    grid_sum=2 * res["grid_sum"],
                    hot_cells=2 * res["hot_cells"],
                    fail_maps=[type(maps)(np.concatenate([maps.bits] * 2),
                                          (2 * maps.shape[0],
                                           *maps.shape[1:]))])
    return run


def _altered(name, state):
    """One answer altered where the port produces it."""
    real = state["run"]

    def run(*a, **kw):
        res = real(*a, **kw)
        if name == "paper96.characterize":
            res = res.copy()
            res[0, np.argmax(res[0])] *= 1.01
            return res
        if "tables" in res:
            tables = res["tables"].copy()
            tables[0, 2] += 1.25
            return dict(res, tables=tables)
        lam = res["lam_total"].copy()
        lam[0] *= 1.01
        return dict(res, lam_total=lam)
    return run


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_half, _altered])
def test_fault_under_the_timed_path_is_not_correct(name, fault):
    def plant(entry, state):
        state["run"] = fault(name, state)
    out = _run(name, fault=plant)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


# sizes a CPU test holds: a profiled chunk of 128 SMALL DIMMs (the tables of
# smaller chunks may all survive bfloat16), bfloat16 grids at TINY
CONTROL_SIZES = {"fleet.profile": (SMALL, 256),
                 "paper96.characterize": (TINY, 12),
                 "fleet.summary": (SMALL, 64)}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in bfloat16 in the program's place fails at least one
    of the cell's numbers; the program at float32 passes every one."""
    cell = small_cell(name, *CONTROL_SIZES[name])
    limits = cell.traffic["limits"]
    r = readings(cell, [11, 2**33 + 12], device="cpu")
    for k, vals in r["program"].items():
        assert max(vals) <= limits[k], k
    for i in range(2):
        assert any(r["controls"]["bfloat16"][k][i] > limits[k]
                   for k in limits)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(RUN[:-3] + ["3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
