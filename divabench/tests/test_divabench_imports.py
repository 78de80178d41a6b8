"""What the benchmark loads, by top-level module name compared whole: the
harness and a run of it load neither JAX nor the JAX package (``repro``;
``repro_torch`` is another name), and the inputs and the reference load
nothing of the program either."""
import json
import os
import subprocess
import sys

from divabench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(harness.ROOT)!r}, "
            f"{str(harness.ROOT / 'src')!r}]\n" + code +
            "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _loaded(
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "sys.path.insert(0, " + repr(str(harness.HERE / "tests")) + ")\n"
        "from divabench import harness, control\n"
        "from divabench_cells import small_cell\n"
        "for name in ('fleet.profile', 'paper96.characterize',"
        " 'fleet.summary'):\n"
        "    harness.run_cell(name, 1, 0.1, True, t_start=time.perf_counter(),"
        " device='cpu', cell=small_cell(name))\n")
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_inputs_and_reference_load_nothing_of_the_program():
    loaded = _loaded("from divabench import reference, population, roofline, "
                     "trace\nimport divabench.model.geometry, "
                     "divabench.model.hashing, divabench.model.latency, "
                     "divabench.model.timing")
    assert not loaded & (FORBIDDEN | {"repro_torch"})
