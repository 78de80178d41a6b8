"""Port parity of the lifetime lifecycle (Sec 6.1 fn 2): repro_torch's epoch
loop (``substrate.lifetime_population``), its numpy walker
(``profiling.lifetime_loop``) and the ``DivaProfiler`` / ``ALDRAM`` wrappers
against repro's, on ``make_population(SMALL, 3)`` on the CPU.

Tolerances: timings, stale-table decisions, served tables and installed
tables are decisions on identical hash draws and must be identical.
``ecc_lambda`` is a float sum of multi-bit tails: rtol 1e-4, atol 1e-6 (the
reference's own bound between its jitted scan and its loop); the reference's
jitted program multiplies by reciprocals and sums in another order, and the
expm1/log1p form of the tail amplifies an ulp (measured: 7.2e-5 relative at
most on these inputs)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import profiling as rprof
from repro.core import substrate as rsub
from repro.core.geometry import SMALL as RSMALL
from repro.core.population import make_population as ref_make_population
from repro.core.timing import EXTENDED_AXES
from repro_torch.core import profiling as tprof
from repro_torch.core import substrate as tsub
from repro_torch.core.geometry import SMALL
from repro_torch.core.latency import worst_rows_internal
from repro_torch.core.population import make_population
from repro_torch.core.timing import PARAMS
from repro_torch.discovery.blind import BlindDiscovery
from repro_torch.kernels import ops

AGES = np.array([0.0, 2.5, 5.0, 8.0], np.float32)
TEMPS = np.array([55.0, 55.0, 70.0, 85.0])
ECC_RTOL, ECC_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pops():
    return make_population(SMALL, 3), ref_make_population(RSMALL, 3)


@pytest.fixture(scope="module")
def batches(pops):
    pop, rpop = pops
    return (tsub.DimmBatch.from_population(pop, "cpu"),
            rsub.DimmBatch.from_population(rpop))


@pytest.fixture(scope="module")
def lifecycles(batches):
    port, ref = batches
    ops.reset_launches()
    out = tsub.lifetime_population(port, AGES, TEMPS)
    assert all(n == 0 for n in ops.launch_counts().values())
    return out, rsub.lifetime_population(ref, AGES, TEMPS)


def _same_lifecycle(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "ecc_lambda":
            assert got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=ECC_RTOL,
                                       atol=ECC_ATOL)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


def _tp(t) -> tuple:
    return dataclasses.astuple(t)


def test_lifetime_matches_reference(lifecycles):
    got, want = lifecycles
    assert got["timings"].shape == (4, 3, len(PARAMS))
    _same_lifecycle(got, want)
    assert got["stale_fail"].any() and not got["stale_fail"].all()


def test_ecc_exposure_float32_sits_near_float64(batches, lifecycles,
                                               monkeypatch):
    """The multi-bit tail cancels (terms ~72q, result ~2556q^2), so its
    float32 ECC exposure carries ~1e-4 relative error: the same lifecycle
    with the tail in float64 stays within rtol 1e-3 of it (1.7e-4 measured),
    and every timing and stale decision is unchanged."""
    port, _ = batches
    got, _ = lifecycles
    f32_tail = tsub.multibit_tail_t
    monkeypatch.setattr(tsub, "multibit_tail_t",
                        lambda q, width=72: f32_tail(q.double(), width).float())
    wide = tsub.lifetime_population(port, AGES, TEMPS)
    np.testing.assert_array_equal(wide["timings"], got["timings"])
    np.testing.assert_array_equal(wide["stale_fail"], got["stale_fail"])
    np.testing.assert_allclose(got["ecc_lambda"], wide["ecc_lambda"],
                               rtol=1e-3)
    assert not np.array_equal(got["ecc_lambda"], wide["ecc_lambda"])


def test_lifetime_loop_matches_lifetime_population(pops, lifecycles):
    """The port's numpy walker against the port's epoch loop, one DIMM."""
    pop, _ = pops
    got, _ = lifecycles
    ref = tprof.lifetime_loop(pop[1], AGES, TEMPS)
    np.testing.assert_array_equal(got["timings"][:, 1], ref["timings"])
    np.testing.assert_array_equal(got["stale_fail"][:, 1], ref["stale_fail"])
    np.testing.assert_allclose(got["ecc_lambda"][:, 1], ref["ecc_lambda"],
                               rtol=ECC_RTOL, atol=ECC_ATOL)


def test_lifetime_loop_restores_dimm_age(pops):
    d = pops[0][0]
    age0 = d.age_years
    tprof.lifetime_loop(d, AGES[:1], TEMPS[:1])
    assert d.age_years == age0


def test_timing_only_mode_and_epoch_zero(batches, lifecycles):
    """diagnostics=False profiles identically and drops the diagnostics;
    epoch 0 (age 0, 55 C) is exactly the one-shot DIVA profile."""
    port, _ = batches
    got, _ = lifecycles
    fast = tsub.lifetime_population(port, AGES[:2], TEMPS[:2],
                                    diagnostics=False)
    np.testing.assert_array_equal(fast["timings"], got["timings"][:2])
    assert "stale_fail" not in fast and "ecc_lambda" not in fast
    one_shot = tsub.profile_population_arrays(port, temp_C=55.0,
                                              multibit_only=True)
    np.testing.assert_array_equal(got["timings"][0], one_shot)


def test_per_bank_lifetime_matches_reference(batches):
    port, ref = batches
    kw = dict(banks=4)
    got = tsub.lifetime_population(port, AGES[:3], TEMPS[:3], **kw)
    want = rsub.lifetime_population(ref, AGES[:3], TEMPS[:3], **kw)
    assert got["timings"].shape == (3, 3, 4, len(PARAMS))
    assert got["stale_fail"].shape == (3, 3, 4)
    _same_lifecycle(got, want)
    # a bank's table never exceeds the whole-DIMM table of the same epoch
    whole = tsub.lifetime_population(port, AGES[:3], TEMPS[:3],
                                     diagnostics=False)["timings"]
    np.testing.assert_array_equal(got["timings"].max(axis=2), whole)


def test_extended_axes_with_retention_match_reference(batches):
    port, ref = batches
    kw = dict(axes=EXTENDED_AXES, retention=True, vdd=1.25)
    got = tsub.lifetime_population(port, AGES[:2], TEMPS[:2], **kw)
    want = rsub.lifetime_population(ref, AGES[:2], TEMPS[:2], **kw)
    assert got["timings"].shape == (2, 3, len(EXTENDED_AXES))
    _same_lifecycle(got, want)


def test_drift_moves_timings_up_and_stale_tables_fail(batches):
    port, _ = batches
    calm = tsub.lifetime_population(port, np.zeros(2, np.float32),
                                    np.full(2, 55.0))
    assert not calm["stale_fail"].any()
    drift = tsub.lifetime_population(port, np.array([0.0, 10.0], np.float32),
                                     np.full(2, 55.0))
    t = drift["timings"]
    assert (t[1] >= t[0]).all() and (t[1] > t[0]).any()
    assert drift["stale_fail"][1].any()
    assert (calm["ecc_lambda"] >= 0).all()


def test_lifetime_rejects_bad_schedules_and_banks(batches):
    port, _ = batches
    with pytest.raises(ValueError, match="n_epochs"):
        tsub.lifetime_population(port, np.zeros((2, 5), np.float32),
                                 np.full(2, 55.0))
    with pytest.raises(ValueError, match="banks"):
        tsub.lifetime_population(port, AGES[:1], TEMPS[:1], banks=3)


# ------------------------------------------------------------ thin wrappers

def test_diva_profiler_serves_the_reference_trajectory(pops):
    pop, rpop = pops
    prof = tprof.DivaProfiler(pop[0], period_steps=2, years_per_period=4.0,
                              device="cpu")
    ref = rprof.DivaProfiler(rpop[0], period_steps=2, years_per_period=4.0)
    served = [_tp(prof.timing()) for _ in range(6)]
    assert served == [_tp(ref.timing()) for _ in range(6)]
    assert served[0] == served[1] and served[2] == served[3]
    np.testing.assert_array_equal(prof.bank_table(), ref.bank_table())


def test_diva_profiler_tracks_external_aging_and_extends_horizon(pops):
    pop, rpop = pops
    d, rd = dataclasses.replace(pop[2]), dataclasses.replace(rpop[2])
    prof = tprof.DivaProfiler(d, period_steps=1, years_per_period=1.0,
                              device="cpu")
    ref = rprof.DivaProfiler(rd, period_steps=1, years_per_period=1.0)
    served, want = [], []
    for step in range(6):
        if step == 3:
            d.age_years = rd.age_years = 9.0
        served.append(_tp(prof.timing()))
        want.append(_tp(ref.timing()))
    assert served == want
    assert len(prof._timings) == len(ref._timings)
    assert all(a >= b for a, b in zip(served[-1], served[0]))


def test_diva_profiler_blind_mode_matches_reference(pops):
    """External rows (an array, or a BlindDiscovery matched by serial) are
    decoded by the DIMM's own scramble; at the true worst rows the blind
    profiler serves the oracle's table."""
    pop, rpop = pops
    d, rd = pop[1], rpop[1]
    ext = d.vendor.scramble.int_to_ext(worst_rows_internal(d.geom))
    art = BlindDiscovery(
        serials=np.array([pop[0].serial, d.serial]),
        labels=np.zeros(2, np.int64), ext_rows=np.stack([ext[::-1], ext]),
        ext_to_int=np.zeros((2, d.geom.rows_per_mat), np.int64),
        confidence=np.ones((2, 1)), canonical=np.zeros((1, 1)),
        vuln_rows=np.zeros((1, 2), np.int64))
    oracle = _tp(tprof.DivaProfiler(d, device="cpu").timing())
    for disc in (ext, art):
        prof = tprof.DivaProfiler(d, discovery=disc, device="cpu")
        ref = rprof.DivaProfiler(rd, discovery=ext)
        assert _tp(prof.timing()) == _tp(ref.timing()) == oracle
    prof = tprof.DivaProfiler(d, discovery=art, banks=2, device="cpu")
    ref = rprof.DivaProfiler(rd, discovery=ext, banks=2)
    assert _tp(prof.timing()) == _tp(ref.timing())
    np.testing.assert_array_equal(prof.bank_table(), ref.bank_table())


def test_diva_profiler_operating_point_matches_reference(pops):
    pop, rpop = pops
    kw = dict(axes=EXTENDED_AXES, retention=True, period_steps=5)
    prof = tprof.DivaProfiler(pop[0], device="cpu", **kw)
    ref = rprof.DivaProfiler(rpop[0], **kw)
    assert _tp(prof.timing()) == _tp(ref.timing())
    np.testing.assert_array_equal(prof.axis_table(), ref.axis_table())
    assert prof.operating_point().as_dict() == ref.operating_point().as_dict()


def test_aldram_install_matches_reference(pops):
    """ALDRAM.install (temperature bins as epochs of a zero-aging schedule)
    installs the reference's table, even for an aged DIMM, and equals the
    conventional walker per bin."""
    pop, rpop = pops
    d, rd = dataclasses.replace(pop[1]), dataclasses.replace(rpop[1])
    d.age_years = rd.age_years = 6.0
    al = tprof.ALDRAM.install(d, device="cpu")
    ref = rprof.ALDRAM.install(rd)
    assert sorted(al.table) == sorted(ref.table)
    for t in al.table:
        np.testing.assert_array_equal(al.table[t], ref.table[t])
    d.age_years = 0.0
    assert _tp(al.timing(55.0)) == _tp(tprof.conventional_profile_loop(
        d, temp_C=55.0))
    assert _tp(al.timing(60.0)) == _tp(al.timing(55.0))   # nearest bin
    np.testing.assert_array_equal(al.bank_table(85.0), ref.bank_table(85.0))

