"""The port's fleet server on its own campaign counts (``synthetic_fleet(128,
TINY, seed=0)`` in chunks of 64, on the CPU): the serve bench's oracle rule
(``benchmarks/serve_bench.py:54``) — every HIT / DISCOVER table equals the
dense DIVA sweep (``region="worst"``), every CONVENTIONAL table the
every-row sweep, bit for bit — and a checkpoint taken mid-ingest resumes to
the single-shot server's exact state."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.geometry import TINY
from repro_torch.core.population import synthetic_fleet
from repro_torch.core.substrate import _LEAVES, profile_population_arrays
from repro_torch.serve import (PATH_CONVENTIONAL, PATH_DISCOVER, PATH_HIT,
                               FleetConfig, FleetServer)

N, CHUNK = 128, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_server(**kw):
    return FleetServer(synthetic_fleet(N, TINY, seed=0, device="cpu"),
                       FleetConfig(chunk_size=CHUNK), **kw)


def _same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def served():
    server = port_server()
    return server, server.ingest(now=0.0)


def test_own_counts_pass_the_oracle_rule(served):
    """Every table is the dense oracle's for its path, at the oracle's own
    operating point (multibit_only included)."""
    server, stats = served
    assert stats["ingested"] == N
    assert stats["hits"] > 0 and stats["misses"] > 0
    assert stats["conventional"] > 0
    cfg = server.cfg
    batch = server.stream.chunk(0, N)
    kw = dict(temp_C=cfg.profile_temp_C, refresh_ms=cfg.profile_refresh_ms,
              guard_cycles=cfg.guard_cycles, multibit_only=cfg.multibit_only)
    path = server.state.view("path")
    conv = path == PATH_CONVENTIONAL
    table = server.state.view("table")
    diva = profile_population_arrays(batch, region="worst", **kw)[:, :4]
    np.testing.assert_array_equal(table[~conv], diva[~conv])
    idx = torch.as_tensor(np.flatnonzero(conv))
    sub = dataclasses.replace(batch, **{n: getattr(batch, n)[idx]
                                        for n in _LEAVES})
    full = profile_population_arrays(sub, region="all", **kw)[:, :4]
    np.testing.assert_array_equal(table[conv], full)
    assert set(np.unique(path)) <= {PATH_HIT, PATH_DISCOVER,
                                    PATH_CONVENTIONAL}
    # every DIMM is served
    np.testing.assert_array_equal(server.query_batch(np.arange(N)), table)


def test_checkpoint_mid_ingest_resume(served, tmp_path):
    """Save after half the fleet, restore into a fresh server, ingest the
    rest: the single-shot server's state, labels and deadlines exactly."""
    single_shot, _ = served
    half = port_server(checkpoint_dir=str(tmp_path))
    half.ingest(CHUNK, now=0.0)
    assert half._ingested == CHUNK
    half.save(step=0)
    resumed = port_server(checkpoint_dir=str(tmp_path))
    info = resumed.load()
    assert info["step"] == 0 and info["corrected_codewords"] == 0
    assert resumed._ingested == CHUNK and len(resumed.state) == CHUNK
    resumed.ingest(now=0.0)
    _same_state(resumed.state_dict(), single_shot.state_dict())
    np.testing.assert_array_equal(resumed.state.view("label"),
                                  single_shot.state.view("label"))
