"""The DIMM axis over several devices in repro_torch (``mesh=``), on the CPU.

A mesh that repeats the CPU (``DimmMesh(["cpu"] * N)``) runs the whole
split: clone padding up to a multiple of N, N contiguous shards each through
the entry point's program, and the gather.  Every entry point that takes
``mesh=`` in ``repro`` is held, at N = 1, 2, 3 and D = 6, 7 (D = 7 pads at
N = 2 and 3, and the stream scans' ragged last chunks pad too), to the
port's own ``mesh=None`` result, and four of them to ``repro``'s
``mesh=dimm_mesh(1)`` result on the same population.

Tiers: integers, decisions, tables, counts, signatures, mappings and memsim
totals identical; per-DIMM floats (lambdas, grids, ECC exposure, burst-bit
profiles) bit for bit as well — on one torch thread each per-DIMM sum runs
serially in one order whatever the shard's width (measured gap 0; with
several threads torch splits a reduction with a single output, a shard of
one DIMM, over the threads, and its sum then moves by an ulp).  The error
summary's fleet cell-sum adds the shards' float32 partials in mesh order, not
DIMM by DIMM: rtol 1e-6, the reference's own bound for its sharded sum
(tests/test_streaming.py) — at most D adds of relative error 2**-24 each.
Against ``repro``: the tiers of tests/test_torch_substrate.py,
test_torch_streaming.py and test_torch_memsim.py.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core.packing import unpack_bool as ref_unpack_bool
from repro.core import streaming as rst
from repro.core import substrate as rsub
from repro.core.population import make_population as ref_make_population
from repro.memsim import sim as rsim
from repro.sharding import chunk_spans as ref_chunk_spans
from repro.sharding import dimm_mesh as ref_dimm_mesh
from repro_torch import sharding
from repro_torch.core import streaming as tst
from repro_torch.core import substrate as tsub
from repro_torch.core.geometry import TINY
from repro_torch.core.packing import unpack_bool
from repro_torch.core.population import make_population
from repro_torch.core.shuffling import design_stripe_profiles
from repro_torch.core.timing import EXTENDED_AXES, OperatingPoint, TimingParams
from repro_torch.discovery import blind, recover, signatures
from repro_torch.kernels import ops
from repro_torch.memsim import sim as tsim
from repro_torch.sharding import DimmMesh, chunk_spans, dimm_mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH_SIZES = (1, 2, 3)
N_DIMMS = (6, 7)
GRID_SUM_RTOL = 1e-6
LAMBDA_RTOL = 5e-5      # tests/test_torch_substrate.py: the jitted reference's t
CELL_ATOL = 1e-6        # the kernel-against-oracle bound, per DIMM and cell
SPEEDUP_RTOL = 1e-6     # tests/test_torch_memsim.py
CHUNK = 4
AGES, TEMPS = np.array([0.0, 6.0], np.float32), np.array([55.0, 70.0])
OP_POINTS = [OperatingPoint(), OperatingPoint(vdd=1.05),
             OperatingPoint(timing=TimingParams(10.0, 25.0, 10.0, 10.0),
                            vdd=1.20)]
OP_SUMMARY = dict(vdd=1.20, refresh_ms=256.0, retention=True)


def cpu_mesh(n: int) -> DimmMesh:
    return DimmMesh(["cpu"] * n)


def assert_same(got, want, tol=None, path=""):
    """``got`` equals ``want`` leaf for leaf (dicts, lists, arrays, numbers):
    exactly, but for the keys named in ``tol`` (key -> rtol)."""
    tol = tol or {}
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        leaf = path.rsplit("/", 1)[-1]
        if leaf in tol:
            np.testing.assert_allclose(got, want, rtol=tol[leaf], atol=0,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


# ------------------------------------------------------ sharding.py itself

@pytest.mark.parametrize("n,c", [(0, 4), (3, 4), (8, 4), (13, 4), (13, 13),
                                 (13, 100), (7, 1)])
def test_chunk_spans_match_reference_and_tile(n, c):
    want = ref_chunk_spans(n, c)
    assert chunk_spans(n, c) == want
    assert chunk_spans(n, c, cpu_mesh(1)) == ref_chunk_spans(
        n, c, ref_dimm_mesh(1)) == want
    for k in (2, 3):
        # the reference reads only the mesh's device count
        fake = types.SimpleNamespace(devices=np.empty(k))
        spans = chunk_spans(n, c, cpu_mesh(k))
        assert spans == ref_chunk_spans(n, c, fake)
        assert [i for lo, hi in spans for i in range(lo, hi)] == list(range(n))
        assert all((hi - lo) % k == 0 for lo, hi in spans[:-1])
    assert tst.chunk_spans is chunk_spans


def test_chunk_spans_reject_bad_sizes():
    for n, c in ((5, 0), (-1, 4)):
        with pytest.raises(ValueError):
            chunk_spans(n, c, cpu_mesh(2))


def test_dimm_mesh_on_the_cpu():
    assert dimm_mesh(device="cpu") == DimmMesh(["cpu"])
    mesh = dimm_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert DimmMesh([torch.device("cpu"), "cpu"]).size == 2
    for bad in (lambda: dimm_mesh(0, device="cpu"), lambda: DimmMesh([]),
                lambda: dimm_mesh(device="meta")):
        with pytest.raises(ValueError):
            bad()


def test_dimm_mesh_raises_without_cuda_and_beyond_the_visible_count(
        monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for make in (dimm_mesh, lambda: dimm_mesh(1), lambda: DimmMesh(["cuda:0"]),
                 lambda: DimmMesh(["cuda"] * 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for n in (0, 3):
        with pytest.raises(ValueError, match="only 2 device"):
            dimm_mesh(n)


def test_mesh_device_is_the_gather_device():
    mesh = cpu_mesh(2)
    assert sharding.mesh_device(mesh) == torch.device("cpu")
    assert sharding.mesh_device(None, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharding.mesh_device(None)


def test_pad0_clones_the_last_entry_on_tensors_arrays_and_trees():
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tsub._pad0(t, 2), torch.cat([t, t[2:], t[2:]]))
    assert tsub._pad0(t, 0) is t
    a = np.arange(3, dtype=np.int32)
    np.testing.assert_array_equal(tsub._pad0(a, 1), [0, 1, 2, 2])
    tree = {"x": t, "k": (a, 3.5), "n": None}
    out = tsub._pad0(tree, 1)
    assert torch.equal(out["x"], torch.cat([t, t[2:]]))
    np.testing.assert_array_equal(out["k"][0], [0, 1, 2, 2])
    assert out["k"][1] == 3.5 and out["n"] is None
    batch = tsub.DimmBatch.from_population(make_population(TINY, 3), "cpu")
    padded = tsub._pad0(batch, 2)
    assert padded.n_dimms == 5 and padded.geom == batch.geom
    for name in tsub._LEAVES:
        leaf = getattr(batch, name)
        assert torch.equal(getattr(padded, name),
                           torch.cat([leaf, leaf[-1:], leaf[-1:]])), name
    assert tst.pad_batch is tsub._pad0


@pytest.mark.parametrize("D", [7, 4])
def test_shards_are_contiguous_and_every_shard_is_launched(D):
    """The split itself: shard k holds DIMMs [k*per, (k+1)*per) of the
    clone-padded axis (at D = 4 the last shard is clones only), replicated
    arguments pass whole, and the gather slices the padding off."""
    seen = []

    def impl(x, rep, *, scale):
        seen.append((x.clone(), rep))
        return {"y": x * scale, "pair": (x + 1, x.sum(dim=1))}

    x = torch.arange(2.0 * D).reshape(D, 2)
    rep = np.arange(3)
    out = tsub._run_sharded(cpu_mesh(3), impl, (x, rep), dict(scale=2.0),
                            (0,))
    assert len(seen) == 3
    per = -(-D // 3)
    padded = torch.cat([x] + [x[-1:]] * (3 * per - D))
    for k, (shard, r) in enumerate(seen):
        assert torch.equal(shard, padded[per * k:per * (k + 1)]) and r is rep
    assert torch.equal(out["y"], x * 2)
    assert torch.equal(out["pair"][0], x + 1)
    assert torch.equal(out["pair"][1], x.sum(dim=1))


# --------------------------------------------- every entry point's parity

def _tables(rows):
    return np.asarray([[t.trcd, t.tras, t.trp, t.twr] for t in rows])


def _campaign(pop, batch, mesh):
    counts, expected = blind.campaign_counts(pop, batch, mesh=mesh)
    return {"counts": counts, "expected": expected}


_CAMPAIGNS: dict = {}


def _counts(pop, batch):
    """The unsharded campaign of ``pop`` (T, D, S, R): the shared input of
    the signature, recovery and discovery cases."""
    D = batch.n_dimms
    if D not in _CAMPAIGNS:
        _CAMPAIGNS[D] = blind.campaign_counts(pop, batch)
    return _CAMPAIGNS[D]


def _discover(pop, batch, mesh):
    counts, expected = _counts(pop, batch)
    disc = blind.BlindDiva().discover(counts, expected,
                                      serials=batch.serial.numpy(),
                                      device="cpu", mesh=mesh)
    out = {f.name: getattr(disc, f.name) for f in dataclasses.fields(disc)
           if f.name != "recovery"}
    out["per_point"] = disc.recovery["per_point"]
    return out


def _blind_tables(pop, batch, mesh):
    counts, expected = _counts(pop, batch)
    disc = blind.BlindDiva().discover(counts, expected, device="cpu")
    bvo = blind.blind_vs_oracle(batch, disc, temp_C=55.0, multibit_only=True,
                                mesh=mesh)
    return {"profile": blind.BlindDiva().profile(batch, disc, mesh=mesh,
                                                 multibit_only=True),
            **bvo}


def _error_summary(batch, mesh, chunk, **kw):
    out = tst.stream_error_summary(batch, "tras", 25.0, chunk_size=chunk,
                                   collect_fail_maps=True, mesh=mesh, **kw)
    out["fail_maps"] = [unpack_bool(m) for m in out["fail_maps"]]
    return out


CASES = {
    # core/substrate.py
    "profile_population": lambda pop, b, m, c: _tables(
        tsub.profile_population(b, multibit_only=True, mesh=m)),
    "profile_banks_extended_axes": lambda pop, b, m, c:
        tsub.profile_population_arrays(b, banks=2, axes=EXTENDED_AXES,
                                       retention=True, vdd=1.25, mesh=m),
    "profile_per_dimm_region": lambda pop, b, m, c:
        tsub.profile_population_arrays(
            b, region=np.random.default_rng(b.n_dimms).integers(
                0, b.geom.rows_per_mat, (b.n_dimms, 5)), mesh=m),
    "operating_points": lambda pop, b, m, c: np.asarray(
        [[p.vdd, p.refresh_ms, *dataclasses.astuple(p.timing)]
         for p in tsub.operating_points_population(b, mesh=m)]),
    "lifetime_population": lambda pop, b, m, c:
        tsub.lifetime_population(b, AGES, TEMPS, mesh=m),
    "operating_grid_arrays": lambda pop, b, m, c:
        tsub.operating_grid_arrays(b, OP_POINTS, mesh=m),
    "fail_prob_grids": lambda pop, b, m, c:
        tsub.fail_prob_grids(b, "trp", 7.5, refresh_ms=256.0, mesh=m),
    "row_error_lambda": lambda pop, b, m, c:
        tsub.row_error_lambda(b, "trp", 7.5, refresh_ms=256.0, mesh=m),
    "shuffling_gain_population": lambda pop, b, m, c:
        tsub.shuffling_gain_population(
            design_stripe_profiles(b.n_dimms, seed=3), seeds=b.serial,
            n_accesses=150, device="cpu", mesh=m),
    "burst_bit_profile_population": lambda pop, b, m, c:
        tsub.burst_bit_profile_population(b, "trp", 7.5, refresh_ms=256.0,
                                          mesh=m),
    # core/streaming.py
    "stream_profile_population": lambda pop, b, m, c:
        tst.stream_profile_population(b, chunk_size=c, collect=True,
                                      multibit_only=True, mesh=m),
    "stream_lifetime_population": lambda pop, b, m, c:
        tst.stream_lifetime_population(b, AGES, TEMPS, chunk_size=c,
                                       collect=True, mesh=m),
    "stream_shuffling_gain": lambda pop, b, m, c: tst.stream_shuffling_gain(
        design_stripe_profiles(b.n_dimms, seed=5), chunk_size=c,
        n_accesses=150, collect=True, device="cpu", mesh=m),
    "stream_error_summary": lambda pop, b, m, c: _error_summary(b, m, c),
    "stream_error_summary_op_point": lambda pop, b, m, c:
        _error_summary(b, m, c, **OP_SUMMARY),
    "stream_operating_grid": lambda pop, b, m, c: tst.stream_operating_grid(
        b, OP_POINTS, chunk_size=c, collect=True, mesh=m),
    "stream_bit_signature": lambda pop, b, m, c: tst.stream_bit_signature(
        lambda lo, hi: _counts(pop, b)[0][1][lo:hi], b.n_dimms,
        chunk_size=c, device="cpu", mesh=m),
    "hash_poisson_counts": lambda pop, b, m, c: tst.hash_poisson_counts(
        b, "trp", 7.5, refresh_ms=256.0, seed=3, mesh=m),
    "stream_discover_generations": lambda pop, b, m, c:
        tst.stream_discover_generations(b, chunk_size=c, mesh=m),
    # discovery/
    "bit_signature_population": lambda pop, b, m, c:
        signatures.bit_signature_population(_counts(pop, b)[0][2],
                                            device="cpu", mesh=m),
    "recover_mapping_population": lambda pop, b, m, c:
        recover.recover_mapping_population(_counts(pop, b)[0][1],
                                           _counts(pop, b)[1][1],
                                           device="cpu", mesh=m),
    "campaign_counts": lambda pop, b, m, c: _campaign(pop, b, m),
    "blind_discover": lambda pop, b, m, c: _discover(pop, b, m),
    "blind_profile_and_vs_oracle": lambda pop, b, m, c: _blind_tables(pop, b, m),
    # memsim/sim.py
    "system_speedup_population": lambda pop, b, m, c:
        tsim.system_speedup_population(
            tsub.profile_population_arrays(b, multibit_only=True),
            n_requests=60, device="cpu", mesh=m),
}
# float leaves that may take another order: the error summary's fleet sum
TOL = {"stream_error_summary": {"grid_sum": GRID_SUM_RTOL},
       "stream_error_summary_op_point": {"grid_sum": GRID_SUM_RTOL}}
# the scans whose chunk size a mesh rounds up: held to the unsharded scan
# at the rounded size (a float fold over chunks, Welford's, depends on the
# chunk size even without a mesh)
ROUNDED = {"stream_profile_population", "stream_lifetime_population",
           "stream_bit_signature",
           "stream_shuffling_gain", "stream_error_summary",
           "stream_error_summary_op_point", "stream_operating_grid",
           "stream_discover_generations"}

_POPS: dict = {}
_WANT: dict = {}


def _population(D: int):
    if D not in _POPS:
        pop = make_population(TINY, D)
        _POPS[D] = pop, tsub.DimmBatch.from_population(pop, "cpu")
    return _POPS[D]


@pytest.mark.parametrize("n_devices", MESH_SIZES)
@pytest.mark.parametrize("n_dimms", N_DIMMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_entry_point_equals_unsharded(case, n_dimms, n_devices):
    pop, batch = _population(n_dimms)
    fn = CASES[case]
    rounded = CHUNK + (-CHUNK) % n_devices if case in ROUNDED else CHUNK
    if (case, n_dimms, rounded) not in _WANT:
        _WANT[case, n_dimms, rounded] = fn(pop, batch, None, rounded)
    want = _WANT[case, n_dimms, rounded]
    ops.reset_launches()
    got = fn(pop, batch, cpu_mesh(n_devices), CHUNK)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions
    assert_same(got, want, TOL.get(case))


def test_error_summary_shards_keep_clone_padding_out_of_the_fleet_sums():
    """A chunk whose width the mesh does not divide: the shard split pads it
    with clones of the last DIMM, and ``keep`` (padded with False) must drop
    them from ``grid_sum`` and ``hot_cells``."""
    _, batch = _population(7)
    g = batch.geom
    adder = torch.as_tensor(tsub.condition_adders(batch, 85.0, 64.0))
    coeffs = tsub._pack_coeffs(batch, 1, 25.0, 1.0, adder, 0, 0)
    args = (batch.row_src[:, 0].contiguous(),
            torch.as_tensor(tsub._geom_consts(g)[1]), coeffs,
            torch.tensor([True] * 5 + [False] * 2))
    statics = dict(cols=g.cols_per_mat, threshold=0.5)
    want = tst._error_summary_impl(*args, **statics)
    got = tst._error_summary_sharded(*args, mesh=cpu_mesh(3), **statics)
    assert_same(got, want, {"grid_sum": GRID_SUM_RTOL})


# ------------------------------------------------------------ against repro

def _pair(D: int):
    ref = rsub.DimmBatch.from_population(ref_make_population(rgeom.TINY, D))
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port


@pytest.mark.parametrize("n_devices", MESH_SIZES)
def test_profile_population_arrays_matches_reference_mesh(n_devices):
    ref, port = _pair(7)
    want = rsub.profile_population_arrays(ref, multibit_only=True,
                                          mesh=ref_dimm_mesh(1))
    got = tsub.profile_population_arrays(port, multibit_only=True,
                                         mesh=cpu_mesh(n_devices))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_devices", MESH_SIZES)
def test_row_error_lambda_matches_reference_mesh(n_devices):
    ref, port = _pair(7)
    want = rsub.row_error_lambda(ref, "trp", 7.5, refresh_ms=256.0,
                                 mesh=ref_dimm_mesh(1))
    got = tsub.row_error_lambda(port, "trp", 7.5, refresh_ms=256.0,
                                mesh=cpu_mesh(n_devices))
    np.testing.assert_allclose(got, want, rtol=LAMBDA_RTOL, atol=1e-6)


@pytest.mark.parametrize("n_devices", MESH_SIZES)
def test_stream_error_summary_matches_reference_mesh(n_devices):
    ref, port = _pair(7)
    kw = dict(chunk_size=3, collect_fail_maps=True, **OP_SUMMARY)
    want = rst.stream_error_summary(ref, "tras", 25.0, mesh=ref_dimm_mesh(1),
                                    **kw)
    got = tst.stream_error_summary(port, "tras", 25.0,
                                   mesh=cpu_mesh(n_devices), **kw)
    np.testing.assert_allclose(got["lam_stats"]["mean"],
                               want["lam_stats"]["mean"], rtol=LAMBDA_RTOL)
    for key in ("lam_min", "lam_max", "worst_cell_max"):
        np.testing.assert_array_equal(got[key]["serial"], want[key]["serial"])
        np.testing.assert_allclose(got[key]["value"], want[key]["value"],
                                   rtol=LAMBDA_RTOL)
    np.testing.assert_allclose(got["grid_sum"], want["grid_sum"], rtol=0,
                               atol=port.n_dimms * CELL_ATOL)
    np.testing.assert_array_equal(got["hot_cells"], want["hot_cells"])
    np.testing.assert_array_equal(
        np.concatenate([unpack_bool(m) for m in got["fail_maps"]]),
        np.concatenate([ref_unpack_bool(m) for m in want["fail_maps"]]))


@pytest.mark.parametrize("n_devices", MESH_SIZES)
def test_system_speedup_population_matches_reference_mesh(n_devices):
    tables = np.array([[8.75, 23.75, 8.75, 6.25], [11.25, 30.0, 11.25, 12.5],
                       [12.5, 32.5, 12.5, 13.75], [10.0, 27.5, 10.0, 10.0],
                       [12.5, 35.0, 13.75, 15.0]])
    want = rsim.system_speedup_population(tables, n_requests=120,
                                          mesh=ref_dimm_mesh(1))
    got = tsim.system_speedup_population(tables, n_requests=120, device="cpu",
                                         mesh=cpu_mesh(n_devices))
    unsharded = tsim.system_speedup_population(tables, n_requests=120,
                                               device="cpu")
    np.testing.assert_array_equal(got["total_latency_cycles"],
                                  unsharded["total_latency_cycles"])
    for k in ("per_dimm_workload_speedup", "per_dimm_speedup"):
        np.testing.assert_allclose(got[k], want[k], rtol=SPEEDUP_RTOL)
    for k in ("mean_speedup", "median_speedup", "min_speedup", "max_speedup"):
        assert got[k] == pytest.approx(want[k], rel=SPEEDUP_RTOL), k
