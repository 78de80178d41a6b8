"""Port parity: the memory-system simulator of repro_torch.memsim against
repro.memsim, on the CPU (``device="cpu"``: the plain walk).

Tiers and tolerances:
  * hash bits, traces, cycle rows, per-request walks, ``simulate`` dicts and
    integer latency totals: exact;
  * IPC and speedup ratios: rtol 1e-6.  The port scores the exact totals in
    numpy float32 (multiply, multiply-add, divide as written); the reference
    scores them in one jitted XLA program, which contracts the multiply-add
    into an FMA (``repro/memsim/sim.py:464``), so the two differ by an ulp or
    two (measured: up to 2.4e-7 relative);
  * ``simulate_trace`` p99: within 1 float32 ulp (linear interpolation,
    ``torch.quantile`` against ``jnp.percentile``; equal in every case
    measured).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.core import ramlite
from repro.core import substrate as ref_substrate
from repro.core.geometry import SMALL
from repro.core.population import make_population
from repro.core.timing import STANDARD as REF_STANDARD
from repro.core.timing import TimingParams as RefTimingParams
from repro.memsim import sim as ref_sim
from repro_torch.core import hashing
from repro_torch.core.timing import STANDARD, TimingParams
from repro_torch.memsim import reference, sim

RTOL = 1e-6
TABLES = np.array([[8.75, 23.75, 8.75, 6.25],
                   [11.25, 30.0, 11.25, 12.5],
                   [12.5, 32.5, 12.5, 13.75]])
u32s = st.integers(0, 2**32 - 1)


def _ref_config(cfg):
    return ref_sim.MemSimConfig(**{f: getattr(cfg, f) for f in (
        "banks", "ranks", "channels", "queue", "bus", "act_window", "tbl",
        "trrd", "tfaw")})


# ------------------------------------------------------------ hash streams

@settings(max_examples=40, deadline=None)
@given(seed=u32s, idx=st.lists(u32s, min_size=1, max_size=64),
       lane=st.integers(0, 7))
def test_trace_and_mix_hashes_match_reference(seed, idx, lane):
    i = np.asarray(idx, np.uint32)
    np.testing.assert_array_equal(hashing.trace_uniform(seed, i, lane),
                                  ref_substrate.trace_uniform(seed, i, lane))
    np.testing.assert_array_equal(hashing.mix_uniform(seed, i, lane),
                                  ref_substrate.mix_uniform(seed, i, lane))


# ------------------------------------------------------------------ traces

@pytest.mark.parametrize("wi", range(len(sim.WORKLOADS)))
def test_traces_equal_reference_for_every_workload(wi):
    w = sim.WORKLOADS[wi]
    assert (w.name, w.mpki, w.row_hit_rate, w.write_frac, w.ipc_peak) == (
        lambda r: (r.name, r.mpki, r.row_hit_rate, r.write_frac,
                   r.ipc_peak))(ref_sim.WORKLOADS[wi])
    fast = sim.make_trace(w, 1200, 16, seed=wi)
    loop = sim.make_trace_loop(w, 1200, 16, seed=wi)
    want = ref_sim.make_trace(ref_sim.WORKLOADS[wi], 1200, 16, seed=wi)
    for k in want:
        assert fast[k].dtype == want[k].dtype
        assert np.array_equal(fast[k], want[k]), (w.name, k)
        assert np.array_equal(loop[k], want[k]), (w.name, k)


def test_traces_with_empty_banks_and_prefix_property():
    w = sim.WORKLOADS[0]
    fast = sim.make_trace(w, 20, 64, seed=3)     # most banks untouched
    loop = sim.make_trace_loop(w, 20, 64, seed=3)
    want = ref_sim.make_trace_loop(ref_sim.WORKLOADS[0], 20, 64, seed=3)
    for k in want:
        assert np.array_equal(fast[k], want[k]) and np.array_equal(loop[k],
                                                                   want[k])
    short = sim.make_trace(sim.WORKLOADS[1], 200, 16, seed=5)
    long = sim.make_trace(sim.WORKLOADS[1], 400, 16, seed=5)
    for k in ("bank", "write", "arrive"):
        assert np.array_equal(short[k], long[k][:200]), k


# ------------------------------------------------------------- cycle rows

@pytest.mark.parametrize("banks", [8, 16])
@pytest.mark.parametrize("timing", [
    "standard", "custom", (8.75, 23.75, 8.75, 6.25), 1, 2, 4, 8])
def test_timing_cycles_banks_equal_reference(timing, banks):
    if timing == "standard":
        port, ref = STANDARD, REF_STANDARD
    elif timing == "custom":
        port = TimingParams(trcd=10.0, tras=27.5, trp=11.25, twr=7.5)
        ref = RefTimingParams(trcd=10.0, tras=27.5, trp=11.25, twr=7.5)
    elif isinstance(timing, tuple):
        port = ref = np.array(timing)
    else:                                   # (Bp, 4) per-bank tables
        port = ref = 5.0 + 2.5 * np.random.default_rng(timing).integers(
            0, 5, (timing, 4))
    got = sim.timing_cycles_banks(port, banks)
    assert got.dtype == np.int32 and got.shape == (banks, 6)
    assert np.array_equal(got, ref_sim.timing_cycles_banks(ref, banks))


def test_timing_cycles_banks_rejects_what_the_reference_rejects():
    for bad in (np.zeros((17, 4)), np.zeros((2, 3)), np.zeros((2, 2, 4))):
        with pytest.raises(ValueError):
            ref_sim.timing_cycles_banks(bad, 16)
        with pytest.raises(ValueError):
            sim.timing_cycles_banks(bad, 16)


# -------------------------------------------------------------- simulate

CONFIGS = [sim.MemSimConfig(banks=8),
           sim.MemSimConfig(banks=8, channels=1, ranks=1),
           sim.MemSimConfig(banks=8, queue=4, bus=False),
           sim.inorder_config(8)]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=["default", "1ch1rk", "q4_nobus", "inorder"])
def test_simulate_equals_reference_and_numpy_walker(cfg):
    tr = sim.make_trace(sim.WORKLOADS[3], 500, 8, seed=1)
    got = sim.simulate(tr, STANDARD, config=cfg, device="cpu")
    assert got == ref_sim.simulate(tr, REF_STANDARD, config=_ref_config(cfg))
    assert got == reference.simulate_trace_loop(tr, STANDARD, config=cfg)


def test_per_bank_split_table_charges_each_request_its_bank():
    tr = sim.make_trace(sim.WORKLOADS[4], 800, 8, seed=2)
    cfg = sim.MemSimConfig(banks=8)
    fast = np.array([[8.75, 23.75, 8.75, 6.25]])
    split = np.array([[8.75, 23.75, 8.75, 6.25], [13.75, 35.0, 13.75, 15.0]])
    a_fast = sim.simulate(tr, fast, config=cfg,
                          device="cpu")["avg_latency_cycles"]
    a_std = sim.simulate(tr, STANDARD, config=cfg,
                         device="cpu")["avg_latency_cycles"]
    m = sim.simulate(tr, split, config=cfg, device="cpu")
    assert a_fast < m["avg_latency_cycles"] < a_std
    assert m == ref_sim.simulate(tr, split, config=_ref_config(cfg))
    assert m == reference.simulate_trace_loop(tr, split, config=cfg)


@pytest.mark.parametrize("wi", [0, 2, 3])
def test_simulate_trace_equals_retained_walker(wi):
    tr = sim.make_trace(sim.WORKLOADS[wi], 800, 8, seed=wi)
    want = ramlite.simulate_trace(tr, REF_STANDARD, banks=8)
    got = sim.simulate_trace(tr, STANDARD, banks=8, device="cpu")
    assert got["avg_latency_cycles"] == want["avg_latency_cycles"]
    assert got["row_hit_rate"] == want["row_hit_rate"]
    p99 = np.float32(want["p99_latency_cycles"])
    assert abs(got["p99_latency_cycles"] - p99) <= np.spacing(p99)


# ------------------------------------------------------ population grid

def _ref_totals(tables, cfg, n):
    """repro's (1 + D, W) int32 grid totals, base first."""
    import jax.numpy as jnp
    traces = ref_sim._stack_traces(n, cfg.banks, 0)
    tcs = jnp.asarray(np.stack([ref_sim.timing_cycles_banks(t, cfg.banks)
                                for t in tables]))
    met = ref_sim._memsim_grid_jit(traces, tcs, cfg=_ref_config(cfg),
                                   pallas=False)
    return np.asarray(met["total_latency_cycles"])


def _check_population(got, want, totals):
    assert np.array_equal(got["total_latency_cycles"], totals)
    np.testing.assert_allclose(got["per_dimm_workload_speedup"],
                               want["per_dimm_workload_speedup"], rtol=RTOL)
    np.testing.assert_allclose(got["per_dimm_speedup"],
                               want["per_dimm_speedup"], rtol=RTOL)
    for k in ("mean_speedup", "median_speedup", "min_speedup", "max_speedup"):
        assert got[k] == pytest.approx(want[k], rel=RTOL), k


@pytest.mark.parametrize("scheduler", ["inorder", "frfcfs"])
def test_population_speedups_match_reference(scheduler):
    n = 250
    got = sim.system_speedup_population(TABLES, n_requests=n,
                                        scheduler=scheduler, device="cpu")
    want = ref_sim.system_speedup_population(TABLES, n_requests=n,
                                             scheduler=scheduler)
    cfg = sim._scheduler_config(scheduler, 16)
    totals = _ref_totals([REF_STANDARD, *TABLES], cfg, n)
    assert got["total_latency_cycles"].dtype == np.int32
    _check_population(got, want, totals)
    loop = reference.system_speedup_loop(TABLES, n_requests=n,
                                         scheduler=scheduler)
    for k in ("per_dimm_workload_speedup", "total_latency_cycles"):
        assert np.array_equal(loop[k], got[k]), k


@pytest.fixture(scope="module")
def small_tables():
    """Whole-DIMM and 4-bank-group DIVA tables of 8 SMALL DIMMs at 55 C, from
    repro's profiler (the port takes them as they are)."""
    batch = ref_substrate.DimmBatch.from_population(make_population(SMALL, 8))
    kw = dict(temp_C=55.0, multibit_only=True)
    return (ref_substrate.profile_population_arrays(batch, **kw),
            ref_substrate.profile_population_arrays(batch, banks=4, **kw))


@pytest.mark.parametrize("per_bank", [False, True], ids=["whole", "banks4"])
def test_population_speedups_match_reference_on_profiled_tables(
        small_tables, per_bank):
    tables = small_tables[per_bank]
    n = 600
    got = sim.system_speedup_population(tables, n_requests=n, device="cpu")
    want = ref_sim.system_speedup_population(tables, n_requests=n)
    totals = _ref_totals([REF_STANDARD, *tables], sim.MemSimConfig(), n)
    _check_population(got, want, totals)


def test_per_bank_decisions_match_reference(small_tables):
    whole, pb = small_tables
    n = 600
    port = [sim.system_speedup_population(t, n_requests=n, device="cpu")
            for t in (whole, pb)]
    ref = [ref_sim.system_speedup_population(t, n_requests=n)
           for t in (whole, pb)]
    for s_whole, s_bank in (port, ref):
        assert s_bank["mean_speedup"] >= s_whole["mean_speedup"]
    assert np.array_equal(
        port[1]["per_dimm_speedup"] >= port[0]["per_dimm_speedup"] - 1e-12,
        ref[1]["per_dimm_speedup"] >= ref[0]["per_dimm_speedup"] - 1e-12)
    assert (port[1]["mean_speedup"] > port[0]["mean_speedup"]) == \
        (ref[1]["mean_speedup"] > ref[0]["mean_speedup"])


@pytest.mark.parametrize("cores", [1, 2, 4, 8])
def test_speedup_summary_matches_reference(cores):
    fast = (8.75, 23.75, 8.75, 6.25)
    ipcs = sim.evaluate_system_grid([STANDARD, TimingParams(*fast)],
                                    n_requests=500, device="cpu")
    ref_ipcs = ref_sim.evaluate_system_grid(
        [REF_STANDARD, RefTimingParams(*fast)], n_requests=500)
    assert ipcs.dtype == np.float32
    np.testing.assert_allclose(ipcs, ref_ipcs, rtol=RTOL)
    got = sim.speedup_summary(TimingParams(*fast), STANDARD, cores=cores,
                              ipcs=ipcs)
    want = ref_sim.speedup_summary(RefTimingParams(*fast), REF_STANDARD,
                                   cores=cores, ipcs=ref_ipcs)
    for k, v in want["per_workload_speedup"].items():
        assert got["per_workload_speedup"][k] == pytest.approx(v, rel=RTOL)
    for k in ("mean_singlecore_speedup", "mean_weighted_speedup"):
        assert got[k] == pytest.approx(want[k], rel=RTOL), k


def test_evaluate_system_and_ipc_match_reference():
    t = TimingParams(trcd=10.0)
    got = sim.evaluate_system(t, n_requests=300, device="cpu")
    want = ref_sim.evaluate_system(RefTimingParams(trcd=10.0), n_requests=300)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=RTOL), k
    for w, rw in zip(sim.WORKLOADS, ref_sim.WORKLOADS):
        assert sim.ipc(w, 37.5) == ref_sim.ipc(rw, 37.5)


# ------------------------------------------------------------ trace cache

def test_trace_cache_is_bounded_lru_and_builds_once_per_sweep():
    assert sim._stack_traces_cached.cache_info().maxsize == \
        sim.TRACE_CACHE_MAX == 16
    sim._stack_traces_cached.cache_clear()
    for seed in range(sim.TRACE_CACHE_MAX + 2):   # 2 tuples past the bound
        sim._stack_traces(16, 1, seed, "cpu")
    assert sim._stack_traces_cached.cache_info().currsize == sim.TRACE_CACHE_MAX
    b0 = sim.N_TRACE_BUILDS
    sim._stack_traces(16, 1, sim.TRACE_CACHE_MAX + 1, "cpu")   # cached
    assert sim.N_TRACE_BUILDS == b0
    sim._stack_traces(16, 1, 0, "cpu")                         # evicted
    assert sim.N_TRACE_BUILDS == b0 + 1
    sim._stack_traces_cached.cache_clear()

    sim.system_speedup_population(TABLES, n_requests=60, device="cpu")
    b0 = sim.N_TRACE_BUILDS
    for k in range(3):                         # a sweep over table values
        sim.system_speedup_population(TABLES - 1.25 * k, n_requests=60,
                                      device="cpu")
    sim.evaluate_system_grid([STANDARD, TimingParams(trcd=10.0)],
                             n_requests=60, config=sim.MemSimConfig(),
                             device="cpu")
    assert sim.N_TRACE_BUILDS == b0
    traces = sim._stack_traces(60, 16, 0, "cpu")
    assert traces.shape == (len(sim.WORKLOADS), 60, 4)
    assert traces.dtype == torch.int32
