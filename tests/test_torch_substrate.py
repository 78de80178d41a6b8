"""Port parity of the main path: failure grids, row lambdas and profiled
timing tables of repro_torch against repro, both fed the same state
(``DimmBatch.from_arrays`` on the reference batch's leaves), on the CPU.

Tiers:
  * timing tables: identical (decisions ride the shared counter hash);
  * failure grids: atol 1e-6, the kernel-against-oracle bound;
  * row lambdas: rtol 5e-5.  The reference's jitted program multiplies by
    the float32 reciprocal of constant divisors and contracts FMAs, so its
    ``t`` differs from the port's IEEE divisions by about an ulp (1e-6 ns at
    8 ns).  A cell in the Gaussian tail has d ln p / dt = |z| / sigma (about
    30 per ns at z = -4, sigma = 0.15), so its probability moves by up to
    ~3e-5 relative; a row's sum averages that down.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core import profiling as rprof
from repro.core import substrate as rsub
from repro.core.population import make_population as ref_make_population
from repro_torch.core import geometry as tgeom
from repro_torch.core import profiling as tprof
from repro_torch.core import substrate as tsub
from repro_torch.core.population import make_population

GRID_ATOL = 1e-6
LAMBDA_RTOL = 5e-5
N_DIMMS = 12


def _pair(name: str, n: int = N_DIMMS):
    ref = rsub.DimmBatch.from_population(
        ref_make_population(getattr(rgeom, name), n))
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def tiny():
    return _pair("TINY")


@pytest.fixture(scope="module")
def small():
    return _pair("SMALL")


# ------------------------------------------------------- grids and lambdas

@pytest.mark.parametrize("param,t_op,pattern,subarray,chip",
                         [("trp", 7.5, "0101", 0, 0),
                          ("trcd", 10.0, "0000", 2, 3),
                          ("tras", 22.5, "1001", 1, 0)])
def test_fail_prob_grids_match_reference(small, param, t_op, pattern,
                                         subarray, chip):
    """Against the reference's eager oracle on the reference's own packed
    coefficients at 1e-6; against its jitted ``fail_prob_grids`` at 1e-6
    plus the gap between that program and the eager oracle (jitted XLA
    multiplies by the reciprocal of a constant divisor and contracts FMAs)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    ref, port = small
    kw = dict(refresh_ms=256.0, pattern=pattern, subarray=subarray, chip=chip)
    want_jit = np.asarray(rsub.fail_prob_grids(ref, param, t_op, **kw))
    adder = rsub.condition_adders(ref, 85.0, 256.0)
    coeffs = np.asarray(rsub._pack_coeffs(
        ref, rsub.PARAMS.index(param), np.float32(t_op),
        np.float32(rsub.PATTERN_STRESS[pattern]), jnp.asarray(adder), chip,
        subarray))
    _, d_mat, _ = rsub._geom_consts(ref.geom)
    want_eager = np.stack([np.asarray(jref.fail_prob(
        np.asarray(ref.row_src)[d, subarray], d_mat, coeffs[d],
        cols=ref.geom.cols_per_mat)) for d in range(ref.n_dimms)])
    got = tsub.fail_prob_grids(port, param, t_op, **kw)
    assert tuple(got.shape) == want_jit.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_eager, atol=GRID_ATOL, rtol=0)
    jit_gap = float(np.abs(want_jit - want_eager).max())
    np.testing.assert_allclose(got.numpy(), want_jit, atol=GRID_ATOL + jit_gap,
                               rtol=0)


@pytest.mark.parametrize("geom", ["tiny", "small"])
@pytest.mark.parametrize("internal_order", [True, False])
def test_row_error_lambda_matches_reference(request, geom, internal_order):
    ref, port = request.getfixturevalue(geom)
    kw = dict(refresh_ms=256.0, internal_order=internal_order)
    want = rsub.row_error_lambda(ref, "trp", 7.5, **kw)
    got = tsub.row_error_lambda(port, "trp", 7.5, **kw)
    assert got.shape == want.shape == (N_DIMMS, port.geom.subarrays
                                       * port.geom.rows_per_mat)
    np.testing.assert_allclose(got, want, rtol=LAMBDA_RTOL, atol=0)


def test_row_error_lambda_external_order_is_scrambled_internal(tiny):
    _, port = tiny
    lam_int = tsub.row_error_lambda(port, "trcd", 7.5, internal_order=True)
    lam_ext = tsub.row_error_lambda(port, "trcd", 7.5)
    R, S = port.geom.rows_per_mat, port.geom.subarrays
    e2i = port.ext_to_int.numpy()
    for d in range(N_DIMMS):
        for s in range(S):
            np.testing.assert_array_equal(lam_ext[d, s * R:(s + 1) * R],
                                          lam_int[d, s * R:(s + 1) * R][e2i[d]])


# --------------------------------------------------------- timing tables

def _region(kind: str, geom, n: int):
    R = geom.rows_per_mat
    if kind in ("worst", "all"):
        return kind
    if kind == "shared":                       # one (Rr,) region for all DIMMs
        return np.array([0, 3, R // 2, R - 1])
    rng = np.random.default_rng(11)            # a (D, Rr) region per DIMM
    return rng.integers(0, R, (n, 3))


TABLE_CASES = [(region, multibit, banks)
               for region in ("worst", "all", "shared", "per_dimm")
               for multibit in (False, True)
               for banks in (1, 2)]


@pytest.mark.parametrize("region,multibit,banks", TABLE_CASES)
def test_profile_tables_identical_tiny(tiny, region, multibit, banks):
    _check_tables(tiny, region, multibit, banks)


@pytest.mark.parametrize("region,multibit,banks",
                         [("worst", True, 1), ("worst", False, 2),
                          ("all", False, 1), ("all", True, 2),
                          ("shared", True, 2), ("per_dimm", False, 1)])
def test_profile_tables_identical_small(small, region, multibit, banks):
    _check_tables(small, region, multibit, banks)


def _check_tables(pair, region, multibit, banks):
    ref, port = pair
    reg = _region(region, port.geom, port.n_dimms)
    kw = dict(region=reg, multibit_only=multibit, banks=banks)
    want = rsub.profile_population_arrays(ref, **kw)
    got = tsub.profile_population_arrays(port, **kw)
    assert got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_profile_population_returns_timing_params(tiny):
    ref, port = tiny
    want = rsub.profile_population(ref, multibit_only=True)
    got = tsub.profile_population(port, multibit_only=True)
    assert [t.as_dict() for t in got] == [t.as_dict() for t in want]


def test_profile_rejects_bad_banks_and_regions(tiny):
    _, port = tiny
    with pytest.raises(ValueError, match="banks"):
        tsub.profile_population_arrays(port, banks=3)
    with pytest.raises(ValueError, match="region"):
        tsub.profile_population_arrays(port, region="middle")
    with pytest.raises(ValueError, match="rows"):
        tsub.profile_population_arrays(port, region=np.zeros((5, 2), int))
    with pytest.raises(ValueError, match="region rows"):
        tsub.profile_population_arrays(port, region=np.array([0, 64]))


# ------------------------------------------------ walkers and wrappers

WALKER_DIMMS = (0, 4, 7, 11)


@pytest.fixture(scope="module")
def tiny_dimms():
    return (make_population(tgeom.TINY, N_DIMMS),
            ref_make_population(rgeom.TINY, N_DIMMS))


@pytest.mark.parametrize("i", WALKER_DIMMS)
def test_diva_profile_equals_numpy_walker(tiny_dimms, i):
    port_pop, ref_pop = tiny_dimms
    got = tprof.diva_profile(port_pop[i], device="cpu")
    assert got == tprof.diva_profile_loop(port_pop[i])
    assert got.as_dict() == rprof.diva_profile_loop(ref_pop[i]).as_dict()


@pytest.mark.parametrize("i", WALKER_DIMMS)
def test_conventional_profile_equals_numpy_walker(tiny_dimms, i):
    port_pop, ref_pop = tiny_dimms
    got = tprof.conventional_profile(port_pop[i], device="cpu")
    assert got == tprof.conventional_profile_loop(port_pop[i])
    assert got.as_dict() == \
        rprof.conventional_profile_loop(ref_pop[i]).as_dict()


def test_reporting_helpers_match_reference(tiny_dimms):
    port_pop, _ = tiny_dimms
    t = tprof.diva_profile(port_pop[0], device="cpu")
    from repro.core.timing import TimingParams as RefTiming
    assert tprof.latency_reduction(t) == \
        rprof.latency_reduction(RefTiming(**t.as_dict()))
    assert tprof.profiling_time_s(tprof.diva_test_bytes(4 * 2**30)) == \
        rprof.profiling_time_s(rprof.diva_test_bytes(4 * 2**30))
