"""BENCHMARK.json against the benchmark's contract, and discovery by name:
a cell, a configuration and a metric added as files alone are found."""
import json
import os
import re
import shutil
import subprocess
import sys

from divabench import harness
from divabench_cells import TINY, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    m = manifest()
    assert set(m) == TOP
    assert m["command"] == ["python3", "divabench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in m["paths"])
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("divabench/")
        assert (harness.ROOT / c["file"]).is_file()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for kind in ("end_to_end", "per_layer"):
        for x in m[kind]:
            assert NAME.match(x["name"]) and UNIT.match(x["unit"])
            assert x["better"] in ("lower", "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in m[k]]
    metrics = [x["name"] for k in ("end_to_end", "per_layer") for x in m[k]]
    assert len(set(names)) == len(names) and len(set(metrics)) == len(metrics)
    assert len(json.dumps(m)) < 64 * 1024


def test_metrics_bound_and_move():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in e2e.values():
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and _line(x["layer"])
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reporting = {c for c in cells if c in
                     e2e[x["moves"]].get("workloads", cells)}
        assert set(x.get("workloads", cells)) <= reporting
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    for c in cells:
        ends = harness.metrics_for(m, "end_to_end", c)
        assert "setup_s" in {x["name"] for x in ends} and len(ends) >= 2
        assert harness.metrics_for(m, "per_layer", c)


def test_every_name_has_its_file():
    m = manifest()
    for w in m["workloads"]:
        cell = harness.Cell.load(m, w["name"])
        entry = harness.entry_module(cell.traffic["entry"])
        for fn in ("setup", "step", "release", "reference_unit", "compare",
                   "kernel_work"):
            assert callable(getattr(entry, fn))
        assert cell.traffic["limits"]
    for kind in ("end_to_end", "per_layer"):
        for x in m[kind]:
            assert callable(harness.metric_reader(x["name"]))


def test_check_budget_fits_full_benchmark():
    # 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell
    # to compile, 1200 s spare, within 43200 s
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and a
    per-layer metric as new files and manifest entries only, and run the
    new cell on the CPU from the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "divabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
    conf = dict(harness.load_json(harness.ROOT / "divabench/configs/"
                                  "fleet-full.json"),
                name="fleet-tiny", geometry=TINY, n_dimms=32)
    (root / "divabench/configs/fleet-tiny.json").write_text(json.dumps(conf))
    traffic = dict(harness.load_json(harness.HERE / "traffic/profile.json"),
                   chunk_dimms=16)
    (root / "divabench/traffic/profile-tiny.json").write_text(
        json.dumps(traffic))
    (root / "divabench/metrics/units_done.py").write_text(
        "def read(run):\n    return float(run.units)\n")
    m["configs"].append({"name": "fleet-tiny", "source": "test",
                         "file": "divabench/configs/fleet-tiny.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny.profile", "config": "fleet-tiny",
                           "traffic": "profile-tiny", "chips": 1,
                           "why": "test"})
    m["end_to_end"][0]["workloads"].append("tiny.profile")
    m["per_layer"].append({"name": "units_done", "unit": "units",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "profile_dimms_per_s",
                           "workloads": ["tiny.profile"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {str(harness.ROOT / 'src')!r}]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from divabench import harness\n"
        "assert harness.ROOT.resolve() != "
        f"{str(harness.ROOT.resolve())!r}\n"
        "out = harness.run_cell('tiny.profile', 5, 0.2, True,\n"
        "    t_start=time.perf_counter(), device='cpu')\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["units_done"]["value"] >= 1
