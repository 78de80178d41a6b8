"""The port stands alone: repro_torch and chip_smoke.py import neither jax nor
the reference package (nor ml_dtypes, jax's numpy dtypes: the port carries
bfloat16 through torch), and an entry point never falls back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "ml_dtypes"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_reference():
    assert len(PORT_FILES) > 10
    for path in PORT_FILES:
        bad = FORBIDDEN & set(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


_CHILD = """
import sys
import numpy as np
from repro_torch.core.geometry import TINY
from repro_torch.core.population import make_population
from repro_torch.core.substrate import (DimmBatch, profile_population_arrays,
                                        row_error_lambda)
batch = DimmBatch.from_population(make_population(TINY, 4), device="cpu")
tables = profile_population_arrays(batch, multibit_only=True)
lam = row_error_lambda(batch, "trp", 7.5)
assert tables.shape == (4, 4) and np.isfinite(lam).all()
from repro_torch.core.shuffling import design_stripe_profiles
from repro_torch.core.substrate import shuffling_gain_population
from repro_torch.memsys.codec import protect_blob, recover_blob
gain = shuffling_gain_population(design_stripe_profiles(2), n_accesses=50,
                                 device="cpu")
assert gain["total"].shape == (2,)
lanes = protect_blob(b"port" * 40, device="cpu")
assert recover_blob(lanes, 160, device="cpu")[0] == b"port" * 40
from repro_torch.memsim import sim
speed = sim.system_speedup_population(tables, n_requests=40, device="cpu")
assert speed["per_dimm_speedup"].shape == (4,)
tr = sim.make_trace(sim.WORKLOADS[0], 40, 16)
assert sim.simulate(tr, sim.STANDARD, device="cpu")["total_latency_cycles"] > 0
from repro_torch.core.streaming import stream_error_summary
from repro_torch.core.substrate import operating_points_population
assert len(operating_points_population(batch)) == 4
summary = stream_error_summary(batch, "tras", 25.0, chunk_size=3, vdd=1.2,
                               retention=True)
assert summary["hot_cells"].shape == (4, 64, 64)
from repro_torch.discovery import BlindDiva
from repro_torch.discovery.blind import campaign_counts
counts, expected = campaign_counts(make_population(TINY, 4), batch)
disc = BlindDiva().discover(counts, expected, device="cpu")
assert disc.ext_rows.shape == (4, 2)
import torch
from repro_torch.core import spice
from repro_torch.core.profiling import ALDRAM, DivaProfiler
from repro_torch.core.substrate import lifetime_population
from repro_torch.kernels.rc_transient import rc_transient
res = spice.simulate([0.05, 0.95], [0.0, 0.0], t_total_ns=12.0, device="cpu")
assert spice.sense_time(res).shape == (2,)
out = rc_transient(torch.tensor([0.1, 0.9]), torch.tensor([0.0, 1.0]),
                   t_total_ns=12.0)
assert out["sense_t"].shape == (2,)
life = lifetime_population(batch, np.array([0.0, 5.0], np.float32),
                           np.full(2, 55.0))
assert life["stale_fail"].shape == (2, 4)
pop = make_population(TINY, 4)
assert DivaProfiler(pop[0], device="cpu").timing().trcd > 0
assert ALDRAM.install(pop[0], device="cpu").timing(55.0).trcd > 0
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.serve import generate
from repro_torch.models.model import init_params
cfg = get_smoke_config("rwkv6-1.6b")
prompts = make_batch(cfg, 2, 8, seed=0, step=0)
prompts["tokens"] = prompts["tokens"][:, :-1]
toks, _ = generate(cfg, init_params(0, cfg, device="cpu"), prompts, max_new=3,
                   device="cpu")
assert toks.shape == (2, 3)
import tempfile
from repro_torch import obs
from repro_torch.core.population import synthetic_fleet
from repro_torch.core.streaming import hash_poisson_counts, stream_secded_scrub
from repro_torch.serve import FleetConfig, FleetServer
fleet = synthetic_fleet(4, TINY, seed=0, device="cpu")
assert hash_poisson_counts(fleet.chunk(0, 2), "trp", 7.5).shape == (2, 2, 64)
code = np.zeros((10, 72), np.int32)
assert stream_secded_scrub(code, chunk_size=4, device="cpu")["clean"] == 10
obs.start_tracing()
with tempfile.TemporaryDirectory() as d:
    server = FleetServer(fleet, FleetConfig(chunk_size=2), checkpoint_dir=d)
    assert server.ingest(now=0.0)["ingested"] == 4
    server.save(step=0)
    again = FleetServer(fleet, FleetConfig(chunk_size=2), checkpoint_dir=d)
    again.load()
    assert (again.query_batch(np.arange(4)) == server.query_batch(np.arange(4))).all()
assert any(e["name"] == "serve.ingest_chunk" for e in obs.stop_tracing())
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


def test_port_runs_without_loading_jax_or_reference():
    # one intra-op thread: the child's tensors are small (~8 s alone), and a
    # full thread pool contending with the suite's other workers for the
    # host's cores took it past 300 s
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_entry_points_raise_without_cuda_and_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.geometry import TINY
    from repro_torch.core.population import make_population
    from repro_torch.core.profiling import diva_profile
    from repro_torch.core.substrate import DimmBatch
    pop = make_population(TINY, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        DimmBatch.from_population(pop)
    with pytest.raises(RuntimeError, match="CUDA"):
        diva_profile(pop[0])
    from repro_torch.core.shuffling import design_stripe_profiles
    from repro_torch.core.substrate import shuffling_gain_population
    from repro_torch.memsys.codec import protect_blob, recover_blob
    with pytest.raises(RuntimeError, match="CUDA"):
        shuffling_gain_population(design_stripe_profiles(2), n_accesses=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        protect_blob(b"port")
    lanes = protect_blob(b"port", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_blob(lanes, 4)
    from repro_torch.memsim import sim
    tr = sim.make_trace(sim.WORKLOADS[0], 20, 16)
    for call in (
            lambda: sim.system_speedup_population(np.full((2, 4), 10.0),
                                                  n_requests=20),
            lambda: sim.system_speedup_population(np.full((2, 4), 10.0),
                                                  n_requests=20,
                                                  scheduler="inorder"),
            lambda: sim.simulate(tr, sim.STANDARD),
            lambda: sim.simulate_trace(tr, sim.STANDARD),
            lambda: sim.evaluate_system_grid([sim.STANDARD], n_requests=20)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_new_entry_points_raise_without_cuda_and_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.geometry import TINY
    from repro_torch.core.population import make_population
    from repro_torch.core.profiling import diva_operating_point
    from repro_torch.core.streaming import (PopulationStream,
                                            stream_error_summary)
    from repro_torch.core.substrate import (DimmBatch,
                                            operating_points_population)
    from repro_torch.discovery import (BlindDiva, bit_signature_population,
                                       recover_mapping_population)
    from repro_torch.discovery.blind import campaign_counts
    pop = make_population(TINY, 2)
    stream = PopulationStream(len(pop), TINY, lambda lo, hi:
                              DimmBatch.from_population(pop[lo:hi]))
    counts = np.random.default_rng(0).integers(0, 50, (2, 2, 64))
    expected = counts.astype(np.float64) + 0.5
    for call in (
            lambda: stream_error_summary(stream, "tras", 25.0, vdd=1.2,
                                         retention=True),
            lambda: operating_points_population(DimmBatch.from_population(pop)),
            lambda: diva_operating_point(pop[0]),
            lambda: bit_signature_population(counts),
            lambda: recover_mapping_population(counts, expected),
            lambda: campaign_counts(pop),
            lambda: BlindDiva().discover(counts, expected)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_slice5_entry_points_raise_without_cuda_and_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import spice
    from repro_torch.core.geometry import TINY
    from repro_torch.core.population import make_population
    from repro_torch.core.profiling import ALDRAM, DivaProfiler
    dimm = make_population(TINY, 4)[0]
    for call in (lambda: spice.simulate([0.5], [0.5]),
                 lambda: spice.fit_latency_coefficients(),
                 lambda: DivaProfiler(dimm).timing(),
                 lambda: ALDRAM.install(dimm)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_slice6_entry_points_raise_without_cuda_and_without_device():
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import wkv6
    assert ops.KERNELS["wkv6"] is wkv6
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import generate, main
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import init_params, params_from_numpy
    from repro_torch.models.rwkv6 import rwkv_init_state
    cfg = get_smoke_config("rwkv6-1.6b")
    params = init_params(0, cfg, device="cpu")
    prompts = {"tokens": np.zeros((1, 4), np.int32)}
    for call in (lambda: init_params(0, cfg),
                 lambda: init_cache(cfg, 1),
                 lambda: rwkv_init_state(cfg, 1),
                 lambda: params_from_numpy({"w": np.zeros(2)}),
                 lambda: generate(cfg, params, prompts),
                 lambda: main(["--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_slice9_entry_points_raise_without_cuda_and_without_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.geometry import TINY
    from repro_torch.core.population import make_population, synthetic_fleet
    from repro_torch.core.streaming import (PopulationStream,
                                            hash_poisson_counts,
                                            stream_bit_signature,
                                            stream_secded_scrub,
                                            stream_shuffling_gain)
    from repro_torch.core.substrate import DimmBatch
    from repro_torch.launch.serve import main
    from repro_torch.serve import FleetServer
    pop = make_population(TINY, 2)
    cpu_fleet = synthetic_fleet(4, TINY, device="cpu")
    stream = PopulationStream(4, TINY, cpu_fleet.chunk_fn)   # no device
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"a": np.zeros(3, np.float32)}, device="cpu")
    counts = np.zeros((2, 2, 64), np.int64)
    for call in (
            lambda: synthetic_fleet(4, TINY).chunk(0, 2),
            lambda: FleetServer(stream),
            lambda: hash_poisson_counts(DimmBatch.from_population(pop),
                                        "trp", 7.5),
            lambda: stream_secded_scrub(np.zeros((4, 72), np.int32)),
            lambda: stream_shuffling_gain(np.zeros((2, 9, 64))),
            lambda: stream_bit_signature(lambda lo, hi: counts[lo:hi], 2),
            lambda: mgr.restore({"a": torch.zeros(3)}),
            lambda: mgr.restore({"a": torch.zeros(3)}, verify=False),
            lambda: mgr.save(1, {"a": np.zeros(3)}),
            lambda: main(["--fleet", "4", "--chunk", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu"), "meta"])
def test_resolve_device_passes_other_devices_through(device):
    from repro_torch.device import resolve_device
    assert resolve_device(device) == torch.device(device)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolve_device_gives_an_indexed_cuda_device_or_raises(device):
    from repro_torch.device import resolve_device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
        return
    dev = resolve_device(device)
    assert dev.type == "cuda" and dev.index is not None
    assert dev == torch.zeros(1, device=device or "cuda").device


def test_slice13_entry_points_raise_without_cuda_and_without_device():
    """The dense and MoE families: no CUDA and no device raises; with
    ``device="cpu"`` each runs."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import build_state
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import init_params
    prompts = {"tokens": np.zeros((1, 4), np.int32)}
    for arch in ("qwen2-0.5b", "moonshot-v1-16b-a3b"):
        cfg = get_smoke_config(arch)
        params = init_params(0, cfg, device="cpu")
        toks, _ = generate(cfg, params, prompts, max_new=2, device="cpu")
        assert toks.shape == (1, 2)
        assert init_cache(cfg, 1, 8, device="cpu")["k"].device.type == "cpu"
        if torch.cuda.is_available():
            continue
        for call in (lambda: init_params(0, cfg),
                     lambda: init_cache(cfg, 1, 8),
                     lambda: build_state(cfg),
                     lambda: generate(cfg, params, prompts),
                     lambda: serve_main(["--arch", arch, "--smoke"]),
                     lambda: train_main(["--arch", arch, "--smoke", "--steps", "1"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    if not torch.cuda.is_available():   # the default arch is qwen2-0.5b
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_main(["--smoke"])
