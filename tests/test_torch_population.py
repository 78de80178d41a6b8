"""Port parity: the port's population and DimmBatch lowering give exactly the
reference's leaves, and ``from_arrays`` carries the reference batch's state
across unchanged.  Tier: exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core.population import make_population as ref_make_population
from repro.core.substrate import _LEAVES as REF_LEAVES
from repro.core.substrate import DimmBatch as RefBatch
from repro_torch.core import geometry as tgeom
from repro_torch.core.population import make_population
from repro_torch.core.substrate import _LEAVES, DimmBatch


def _host_leaves(batch):
    return {n: getattr(batch, n).numpy() for n in _LEAVES}


@pytest.fixture(scope="module", params=["TINY", "SMALL"])
def pair(request):
    name = request.param
    ref = RefBatch.from_population(ref_make_population(getattr(rgeom, name), 12))
    port = DimmBatch.from_population(
        make_population(getattr(tgeom, name), 12), device="cpu")
    return ref, port


def test_leaf_names_match_reference():
    assert _LEAVES == REF_LEAVES


def test_geometry_presets_match_reference():
    for name in ("TINY", "SMALL", "FULL"):
        assert dataclasses.asdict(getattr(tgeom, name)) == \
            dataclasses.asdict(getattr(rgeom, name))


def test_make_population_leaves_identical(pair):
    ref, port = pair
    assert dataclasses.asdict(port.geom) == dataclasses.asdict(ref.geom)
    leaves = _host_leaves(port)
    for name in _LEAVES:
        want = np.asarray(getattr(ref, name))
        got = leaves[name]
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port.serial.dtype == torch.int64
    assert port.row_src.dtype == torch.int32


def test_from_arrays_round_trips_reference_leaves(pair):
    ref, _ = pair
    leaves = {n: np.asarray(getattr(ref, n)) for n in REF_LEAVES}
    port = DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                 device="cpu")
    back = _host_leaves(port)
    for name in _LEAVES:
        np.testing.assert_array_equal(back[name], leaves[name], err_msg=name)
    assert port.geom == tgeom.DimmGeometry(**dataclasses.asdict(ref.geom))
    assert port.device.type == "cpu" and port.n_dimms == 12


def test_from_arrays_rejects_missing_leaf(pair):
    ref, _ = pair
    leaves = {n: np.asarray(getattr(ref, n)) for n in REF_LEAVES[1:]}
    with pytest.raises(ValueError, match="serial"):
        DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves, device="cpu")
