"""Port parity of the operating-point sweep: profiled operating values,
``OperatingPoint``s and the operating-grid evaluation of repro_torch against
repro, both fed the same state (``DimmBatch.from_arrays`` on the reference
batch's leaves), on the CPU.

Tiers: tables, ``OperatingPoint``s and grid ``fails`` identical (decisions
ride the shared counter hash); grid ``lam`` within rtol 1e-5 (the sums run in
another order, and the reference's jitted program multiplies by reciprocals
where the port divides).  Multibit ``lam`` (expected SECDED-uncorrectable
codewords) also gets an absolute floor of 1e-8: a cell probability in the
erf tail is float32 ``0.5 * (1 - y)`` with y near 1, so it comes in steps of
2**-25 (3e-8); the reference's ulp-different ``t`` moves a tail cell by one
step, and the multibit tail squares it, so regions whose lam is ~1e-9 move
by up to ~1e-9 (measured 1.2e-9).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core import profiling as rprof
from repro.core import substrate as rsub
from repro.core import timing as rtiming
from repro.core.population import make_population as ref_make_population
from repro_torch.core import geometry as tgeom
from repro_torch.core import profiling as tprof
from repro_torch.core import substrate as tsub
from repro_torch.core import timing as ttiming
from repro_torch.core.population import make_population


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LAM_RTOL = 1e-5
MULTIBIT_LAM_ATOL = 1e-8
N_DIMMS = 8
# tests/test_operating_point.py's grid
POINTS = [dict(), dict(vdd=1.05), dict(refresh_ms=256.0, temp_C=75.0),
          dict(timing=(10.0, 25.0, 10.0, 10.0), vdd=1.20)]


def _points(mod):
    out = []
    for kw in POINTS:
        kw = dict(kw)
        if "timing" in kw:
            kw["timing"] = mod.TimingParams(*kw["timing"])
        out.append(mod.OperatingPoint(**kw))
    return out


@pytest.fixture(scope="module")
def tiny():
    ref = rsub.DimmBatch.from_population(
        ref_make_population(rgeom.TINY, N_DIMMS))
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port


@pytest.mark.parametrize("kw", [dict(temp_C=55.0), dict(vdd=1.25),
                                dict(banks=2), dict(multibit_only=True)],
                         ids=["55C", "vdd1.25", "banks2", "multibit"])
def test_extended_tables_identical(tiny, kw):
    ref, port = tiny
    kw = dict(kw, axes=ttiming.EXTENDED_AXES, retention=True)
    want = rsub.profile_population_arrays(ref, **kw)
    got = tsub.profile_population_arrays(port, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ambient_vdd_moves_the_timing_sweep_as_in_the_reference(tiny):
    ref, port = tiny
    want = rsub.profile_population_arrays(ref, vdd=1.20)
    got = tsub.profile_population_arrays(port, vdd=1.20)
    np.testing.assert_array_equal(got, want)
    nominal = tsub.profile_population_arrays(port)
    assert (got >= nominal).all() and (got > nominal).any()


def test_operating_points_identical(tiny):
    ref, port = tiny
    want = rsub.operating_points_population(ref)
    got = tsub.operating_points_population(port)
    assert len(got) == len(want) == port.n_dimms
    assert [p.as_dict() for p in got] == [p.as_dict() for p in want]


def test_profile_population_keeps_the_timing_prefix(tiny):
    ref, port = tiny
    kw = dict(axes=ttiming.EXTENDED_AXES, retention=True)
    want = rsub.profile_population(ref, **kw)
    got = tsub.profile_population(port, **kw)
    assert [t.as_dict() for t in got] == [t.as_dict() for t in want]


@pytest.mark.parametrize("i", [0, 3])
def test_diva_operating_point_identical(i):
    want = rprof.diva_operating_point(
        ref_make_population(rgeom.TINY, N_DIMMS)[i])
    got = tprof.diva_operating_point(make_population(tgeom.TINY, N_DIMMS)[i],
                                     device="cpu")
    assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("banks,multibit", [(1, False), (2, True)])
def test_operating_grid_identical(tiny, banks, multibit):
    ref, port = tiny
    kw = dict(banks=banks, multibit_only=multibit)
    want = rsub.operating_grid_arrays(ref, _points(rtiming), **kw)
    got = tsub.operating_grid_arrays(port, _points(ttiming), **kw)
    shape = (port.n_dimms, len(POINTS)) + ((banks,) if banks > 1 else ())
    assert got["fails"].shape == got["lam"].shape == shape
    np.testing.assert_array_equal(got["fails"], want["fails"])
    np.testing.assert_allclose(got["lam"], want["lam"], rtol=LAM_RTOL,
                               atol=MULTIBIT_LAM_ATOL if multibit else 0)


def test_operating_grid_matches_the_numpy_walker(tiny):
    """Each (DIMM, point) equals ``DimmModel.operating_point_eval``."""
    _, port = tiny
    pop = make_population(tgeom.TINY, N_DIMMS)
    pts = _points(ttiming)
    got = tsub.operating_grid_arrays(port, pts)
    rows = np.array([0, tgeom.TINY.rows_per_mat - 1])
    for d in (0, 5):
        for g, pt in enumerate(pts):
            fails, lam = pop[d].operating_point_eval(pt, rows)
            assert bool(got["fails"][d, g]) == fails
            np.testing.assert_allclose(got["lam"][d, g], lam, rtol=LAM_RTOL)


def test_grids_and_axis_checks(tiny):
    _, port = tiny
    assert tsub.GRIDS["vdd"] == ttiming.AXES["vdd"].grid
    assert tsub.GRIDS["refresh"] == ttiming.AXES["refresh"].grid
    assert tsub.GRIDS == {k: tuple(v) for k, v in rsub.GRIDS.items()}
    with pytest.raises(ValueError, match="prefix"):
        tsub.profile_population_arrays(port, axes=("vdd",))
    with pytest.raises(ValueError, match="axis"):
        tsub.profile_population_arrays(port, axes=ttiming.PARAMS + ("temp",))
