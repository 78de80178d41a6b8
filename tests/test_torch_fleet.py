"""Port parity of the synthetic fleet: ``hashing.fleet_uniform`` bits and
``population.synthetic_fleet`` leaves of repro_torch against repro, on the
CPU.  The leaves are built on the host in numpy exactly as in the reference,
so every leaf is identical (the serial is int64 in the port, uint32 in the
reference: the same values)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import substrate as rsub
from repro.core.geometry import TINY as RTINY
from repro.core.population import fleet_templates as ref_templates
from repro.core.population import synthetic_fleet as ref_fleet
from repro_torch.core import hashing
from repro_torch.core import substrate as tsub
from repro_torch.core.geometry import SMALL, TINY
from repro_torch.core.population import fleet_templates, synthetic_fleet
from repro_torch.core.streaming import PopulationStream

D, SEED = 13, 7
SPANS = ((0, 4), (4, 9), (9, 13), (0, 13))


@pytest.fixture(scope="module")
def fleets():
    return (ref_fleet(D, RTINY, seed=SEED),
            synthetic_fleet(D, TINY, seed=SEED, device="cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_fleet_uniform_bits_match_reference(seed):
    serial = np.arange(0, 5000, 7, dtype=np.uint32)[:, None]
    lane = np.arange(40)[None, :]
    got = hashing.fleet_uniform(seed, serial, lane)
    want = rsub.fleet_uniform(seed, serial, lane)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_fleet_templates_match_reference():
    got, want = fleet_templates(TINY), ref_templates(RTINY)
    assert len(got) == len(want) == 11
    rows = np.arange(TINY.rows_per_mat)
    for t, r in zip(got, want):
        assert (t.name, t.die) == (r.name, r.die)
        for attr in ("base", "k_bl", "k_wl", "k_mat", "k_row", "sigma",
                     "chip_sigma", "aging_coef", "vdd_coef", "ret_k"):
            assert getattr(t, attr) == getattr(r, attr), attr
        np.testing.assert_array_equal(t.scramble.int_to_ext(rows),
                                      r.scramble.int_to_ext(rows))


@pytest.mark.parametrize("span", SPANS, ids=[f"{lo}-{hi}" for lo, hi in SPANS])
def test_synthetic_fleet_leaves_match_reference(fleets, span):
    ref, port = fleets
    lo, hi = span
    want, got = ref.chunk(lo, hi), port.chunk(lo, hi)
    assert dataclasses.asdict(got.geom) == dataclasses.asdict(want.geom)
    assert got.device == torch.device("cpu")
    for leaf in tsub._LEAVES:
        a, b = getattr(got, leaf).numpy(), np.asarray(getattr(want, leaf))
        assert a.shape == b.shape, leaf
        if leaf == "serial":
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b.astype(np.int64))
        else:
            assert a.dtype == b.dtype, leaf
            np.testing.assert_array_equal(a, b, err_msg=leaf)


def test_synthetic_fleet_chunks_are_position_invariant(fleets):
    _, port = fleets
    whole = port.chunk(0, D)
    for cuts in ((0, 5, 13), (0, 4, 9, 13), (0, 1, 2, 13)):
        parts = [port.chunk(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
        for leaf in tsub._LEAVES:
            got = torch.cat([getattr(p, leaf) for p in parts])
            assert torch.equal(got, getattr(whole, leaf)), leaf


def test_synthetic_fleet_is_a_stream_on_its_device(fleets):
    _, port = fleets
    assert isinstance(port, PopulationStream)
    assert port.n_dimms == D and port.geom == TINY
    assert port.device == torch.device("cpu")
    with pytest.raises(ValueError):
        port.chunk(5, D + 1)
    # templates cycle by serial; a pristine fleet (identity row sources)
    b = synthetic_fleet(24, SMALL, seed=0, device="cpu").chunk(0, 24)
    assert torch.equal(b.k_bl[0], b.k_bl[11]) and torch.equal(b.k_bl[1],
                                                               b.k_bl[12])
    assert torch.equal(b.row_src, torch.arange(SMALL.rows_per_mat,
                                               dtype=torch.int32)
                       .expand_as(b.row_src))
    # another seed moves the process variation, never the design
    other = synthetic_fleet(24, SMALL, seed=1, device="cpu").chunk(0, 24)
    assert torch.equal(other.k_bl, b.k_bl)
    assert not torch.equal(other.chip_offsets, b.chip_offsets)
