"""The benchmark's frozen inputs and plain reference against the port's
plain CPU path, at TINY and SMALL geometry: the same leaves as the port's
population makers, and for each timed entry the same outputs."""
import numpy as np
import pytest
import torch

from divabench import reference
from divabench.model.geometry import DimmGeometry
from divabench.population import LEAVES, fleet_leaves, paper96_leaves
from divabench_cells import SMALL, TINY

GEOMS = {"tiny": TINY, "small": SMALL}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_geom(fields):
    from repro_torch.core.geometry import DimmGeometry as PortGeometry
    return PortGeometry(**fields)


def _batch(fields, leaves):
    from repro_torch.core.substrate import DimmBatch
    return DimmBatch.from_arrays(fields, leaves, "cpu")


@pytest.mark.parametrize("g", list(GEOMS))
def test_population_leaves_are_the_ports(g):
    from repro_torch.core.population import make_population, synthetic_fleet
    from repro_torch.core.substrate import DimmBatch
    fields = GEOMS[g]
    geom = _port_geom(fields)
    ours = paper96_leaves(DimmGeometry(**fields), 96)
    port = DimmBatch.from_population(make_population(geom, 96), "cpu")
    for k in LEAVES:
        np.testing.assert_array_equal(ours[k], getattr(port, k).numpy(), k)
    seed = 2**33 + 11
    ours = fleet_leaves(DimmGeometry(**fields), seed, 40, 72)
    port = synthetic_fleet(100, geom, seed=seed % 2**32,
                           device="cpu").chunk(40, 72)
    for k in LEAVES:
        np.testing.assert_array_equal(ours[k], getattr(port, k).numpy(), k)


# conventional every-row profiling at SMALL takes minutes on the CPU
@pytest.mark.parametrize("g,region", [("tiny", "worst"), ("small", "worst"),
                                      ("tiny", "all")])
def test_profile_tables(g, region):
    from repro_torch.core.substrate import profile_population_arrays
    fields = GEOMS[g]
    leaves = fleet_leaves(DimmGeometry(**fields), 7, 0, 24)
    got = profile_population_arrays(_batch(fields, leaves), region=region,
                                    temp_C=55.0, refresh_ms=64.0)
    want = reference.profile_tables(leaves, DimmGeometry(**fields),
                                    device="cpu", region=region)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g", list(GEOMS))
@pytest.mark.parametrize("param,t_op,temp", [("trcd", 7.5, 55.0),
                                             ("tras", 20.0, 85.0),
                                             ("trp", 7.5, 70.0),
                                             ("twr", 5.0, 85.0)])
def test_row_lambda(g, param, t_op, temp):
    from repro_torch.core.substrate import row_error_lambda
    fields = GEOMS[g]
    leaves = paper96_leaves(DimmGeometry(**fields), 12)
    got = row_error_lambda(_batch(fields, leaves), param, t_op, temp_C=temp)
    want = reference.row_lambda(leaves, DimmGeometry(**fields), param, t_op,
                                device="cpu", temp_C=temp)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("g", list(GEOMS))
@pytest.mark.parametrize("vdd,retention", [(1.20, True), (1.35, False)])
def test_error_summary(g, vdd, retention):
    from repro_torch.core.streaming import stream_error_summary
    from divabench.entries.common import port_stream
    fields = GEOMS[g]
    leaves = fleet_leaves(DimmGeometry(**fields), 3, 0, 20)
    kw = dict(temp_C=85.0, refresh_ms=256.0, vdd=vdd, retention=retention)
    got = stream_error_summary(port_stream(leaves, fields, "cpu"), "tras",
                               25.0, chunk_size=20, collect_fail_maps=True,
                               **kw)
    want = reference.error_summary(leaves, DimmGeometry(**fields), "tras",
                                   25.0, device="cpu", block=7, **kw)
    np.testing.assert_allclose(got["lam_total"], want["lam_total"],
                               rtol=1e-6)
    assert float(got["worst_cell_max"]["value"]) == want["worst_cell"].max()
    np.testing.assert_allclose(got["grid_sum"], want["grid_sum"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(got["hot_cells"], want["hot_cells"])
    m = got["fail_maps"][0]
    maps = np.unpackbits(m.bits, count=int(np.prod(m.shape))).astype(bool)
    np.testing.assert_array_equal(maps.reshape(m.shape), want["row_fail"])
