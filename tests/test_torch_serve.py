"""Port parity of the fleet serving layer (``repro_torch.serve``) against
``repro.serve`` on the reference test's fleet — ``synthetic_fleet(128, TINY,
seed=0)`` in chunks of 64 — on the CPU.

The port's campaign sampler draws other bits than ``jax.random.poisson``, so
the parity server is fed repro's counts through ``counts_fn``; from there
every decision must be repro's: ingest stats, labels, paths, tables,
``profiled_at``, ``due_at``, ``horizon``, ``founding_stats``, tick
re-profiles and the whole ``state_dict``, all identical.  Checkpoints cross
between the packages in both directions.  The port's server on its own
counts is held to the serve bench's oracle rule in
tests/test_torch_serve_own.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as RManager
from repro.core import streaming as rst
from repro.core import substrate as rsub
from repro.core.geometry import TINY as RTINY
from repro.core.population import synthetic_fleet as ref_fleet
from repro.serve import FleetConfig as RConfig
from repro.serve import FleetServer as RServer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.geometry import TINY
from repro_torch.core.population import synthetic_fleet
from repro_torch.serve import FleetConfig, FleetServer

N, CHUNK = 128, 64
TICK_NOW = 3.0
QUERY = np.asarray([3, 90, 3, 41, 127, 0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_counts(batch, param, t_op, *, temp_C, refresh_ms, seed):
    """repro's campaign counts for a port batch: the ``counts_fn`` hook."""
    leaves = {n: getattr(batch, n).cpu().numpy() for n in rsub._LEAVES}
    leaves["serial"] = leaves["serial"].astype(np.uint32)
    return rst.hash_poisson_counts(rsub.DimmBatch(geom=RTINY, **leaves),
                                   param, t_op, temp_C=temp_C,
                                   refresh_ms=refresh_ms, seed=seed)


def port_server(n=N, chunk=CHUNK, **kw):
    kw.setdefault("counts_fn", ref_counts)
    return FleetServer(synthetic_fleet(n, TINY, seed=0, device="cpu"),
                       FleetConfig(chunk_size=chunk), **kw)


def ref_server(n=N, chunk=CHUNK, **kw):
    return RServer(ref_fleet(n, RTINY, seed=0), RConfig(chunk_size=chunk),
                   **kw)


@pytest.fixture(scope="module")
def served():
    """(repro's server, the port's server on repro's counts), both ingested
    at fleet age 0 with their stats; tests must not mutate them."""
    ref, port = ref_server(), port_server()
    return ref, ref.ingest(now=0.0), port, port.ingest(now=0.0)


def _same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _flip_run(step_dir, leaf: int, n_bits: int = 8):
    """Flip a contiguous run of stored lanes in one leaf's ECC sidecar."""
    path = step_dir / f"leaf_{leaf}.ecc.npy"
    lanes = np.unpackbits(np.load(path), axis=1)
    lanes[0, 100:100 + n_bits] ^= 1
    np.save(path, np.packbits(lanes, axis=1))


# ------------------------------------------------------------------ ingest

def test_ingest_matches_reference(served):
    ref, ref_stats, port, stats = served
    assert stats == ref_stats
    assert stats["hits"] > 0 and stats["misses"] > 0
    assert stats["conventional"] > 0
    for field in ("serial", "table", "label", "path", "profiled_at",
                  "due_at", "horizon"):
        want = ref.state.view(field)
        got = port.state.view(field)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert port.founding_stats == ref.founding_stats
    _same_state(port.state_dict(), ref.state_dict())
    assert sorted(port._heap) == sorted(ref._heap)


def test_queries_and_staleness_match_reference(served):
    ref, _, port, _ = served
    for s in (0, 7, 127):
        got, want = port.query(s), ref.query(s)
        np.testing.assert_array_equal(got.pop("table"), want.pop("table"))
        assert got == want
    np.testing.assert_array_equal(port.query_batch(QUERY),
                                  ref.query_batch(QUERY))
    with pytest.raises(KeyError):
        port.query(N + 17)
    assert port.staleness() == ref.staleness()
    assert port.staleness(5.0) == ref.staleness(5.0)


def test_metrics_match_reference_less_compile_counts(served):
    ref, ref_stats, port, stats = served
    got, want = port.metrics(), ref.metrics()
    want.pop("chunk_compiles")
    assert sorted(got) == sorted(want)
    assert got["paths"] == want["paths"] == {
        "hit": stats["hits"], "discover": stats["misses"],
        "conventional": stats["conventional"]}
    for key in ("ingested", "hit_rate", "generations", "reprofiled",
                "max_table_age_years"):
        assert got[key] == want[key], key


def test_tick_reprofiles_like_reference(served):
    """Fresh servers loaded with the ingested state (``load_state``: the
    deadline heap included) tick at 3 years like the reference."""
    ref, port = ref_server(), port_server()
    ref.load_state(served[0].state_dict())
    port.load_state(served[2].state_dict())
    was_due = port.state.view("due_at").copy() <= TICK_NOW
    got, want = port.tick(TICK_NOW), ref.tick(TICK_NOW)
    assert got == want and got["reprofiled"] == int(was_due.sum()) > 0
    _same_state(port.state_dict(), ref.state_dict())
    np.testing.assert_array_equal(port.state.view("profiled_at")[was_due],
                                  np.float32(TICK_NOW))
    assert port.staleness(TICK_NOW) == ref.staleness(TICK_NOW)


# -------------------------------------------------------------- checkpoint

def test_reference_checkpoint_restores_into_port(served, tmp_path):
    ref, _, port, _ = served
    saved = RManager(str(tmp_path)).save(0, ref.state_dict())
    _flip_run(saved, leaf=11)                         # fleet_table's lanes
    fresh = port_server(checkpoint_dir=str(tmp_path))
    info = fresh.load()
    assert info["step"] == 0 and info["corrected_codewords"] >= 1
    _same_state(fresh.state_dict(), ref.state_dict())
    np.testing.assert_array_equal(fresh.query_batch(QUERY),
                                  ref.query_batch(QUERY))
    assert fresh._ingested == N and sorted(fresh._heap) == sorted(ref._heap)


def test_port_checkpoint_restores_into_reference(served, tmp_path):
    ref, _, port, _ = served
    saved = CheckpointManager(str(tmp_path)).save(0, port.state_dict(),
                                                  device="cpu")
    _flip_run(saved, leaf=6)                          # fleet_horizon's lanes
    fresh = ref_server(checkpoint_dir=str(tmp_path))
    info = fresh.load()
    assert info["step"] == 0 and info["corrected_codewords"] >= 1
    _same_state(fresh.state_dict(), port.state_dict())
    np.testing.assert_array_equal(fresh.query_batch(QUERY),
                                  port.query_batch(QUERY))


def test_save_and_load_require_checkpoint_dir():
    server = port_server(8, 8)
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        server.save(step=0)
    with pytest.raises(RuntimeError, match="checkpoint_dir"):
        server.load()


def test_checkpoint_orphan_sweep_keep_and_tensor_leaves(tmp_path):
    state = {"b": np.arange(6, dtype=np.int64),
             "a": torch.linspace(0, 1, 5)}
    CheckpointManager(str(tmp_path)).save(0, state, device="cpu")
    orphan = tmp_path / ".tmp_step_7"
    orphan.mkdir()
    (orphan / "leaf_0.npy").write_bytes(b"torn write")
    mgr = CheckpointManager(str(tmp_path))
    assert not orphan.exists() and mgr.steps() == [0]
    restored, info = mgr.restore({"b": np.zeros(6, np.int64),
                                  "a": torch.zeros(5)}, device="cpu")
    assert info == {"step": 0, "corrected_codewords": 0}
    np.testing.assert_array_equal(restored["b"], state["b"])
    assert isinstance(restored["a"], torch.Tensor)
    assert torch.equal(restored["a"], state["a"])
    # sorted-key leaf order, the reference's layout
    assert [leaf["shape"] for leaf in mgr.meta()["leaves"]] == [[5], [6]]
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CheckpointManager(str(tmp_path / "bad"), keep=0)
    keep1 = CheckpointManager(str(tmp_path / "k"), keep=1)
    keep1.save(0, {"a": np.ones(3, np.float32)}, device="cpu")
    keep1.save(1, {"a": np.ones(3, np.float32)}, device="cpu")
    assert keep1.steps() == [1]
