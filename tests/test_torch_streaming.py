"""Port parity of the streaming layer: chunk spans, packing, the online
reductions and the fleet error summary (``stream_error_summary``) of
repro_torch against repro on the same inputs, on the CPU.

Tiers: spans, packed bytes, integer folds, extreme serials, hot-cell counts
and fail maps identical; float folds within rtol 1e-12 on the same chunks
(the same float64 numpy arithmetic).  Against the reference's streamed
summary: per-DIMM lambdas within rtol 5e-5 (tests/test_torch_substrate.py's
lambda tier: the reference's jitted grids differ by about an ulp in ``t``),
and the (mats, rows, cols) fleet cell-sum within D x 1e-6 absolute — each of
the D DIMMs' cells within 1e-6, the kernel-against-oracle bound.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeom
from repro.core import packing as rpack
from repro.core import streaming as rst
from repro.core import substrate as rsub
from repro.core.population import make_population as ref_make_population
from repro.sharding import chunk_spans as ref_chunk_spans
from repro_torch.core import packing as tpack
from repro_torch.core import streaming as tst
from repro_torch.core import substrate as tsub
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

D = 12
LAMBDA_RTOL = 5e-5
CELL_ATOL = 1e-6
OP_POINT = dict(vdd=1.20, refresh_ms=256.0, retention=True)


@pytest.fixture(scope="module")
def tiny():
    ref = rsub.DimmBatch.from_population(ref_make_population(rgeom.TINY, D))
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port


# ------------------------------------------------- spans, packing, folds

@pytest.mark.parametrize("n,c", [(0, 4), (3, 4), (8, 4), (13, 4), (13, 13),
                                 (13, 100)])
def test_chunk_spans_match_reference(n, c):
    assert tst.chunk_spans(n, c) == ref_chunk_spans(n, c)


def test_chunk_spans_reject_bad_sizes():
    with pytest.raises(ValueError):
        tst.chunk_spans(5, 0)
    with pytest.raises(ValueError):
        tst.chunk_spans(-1, 4)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 11), (2, 64)])
def test_pack_bool_bytes_match_reference(shape):
    grid = np.random.default_rng(len(shape)).random(shape) < 0.3
    got, want = tpack.pack_bool(grid), rpack.pack_bool(grid)
    assert got.shape == want.shape and got.nbytes == want.nbytes
    np.testing.assert_array_equal(got.bits, want.bits)
    np.testing.assert_array_equal(tpack.unpack_bool(got), grid)


def test_narrow_counts_and_accumulator_match_reference():
    rng = np.random.default_rng(1)
    for hi in (200, 60000, 2 ** 31):
        c = rng.integers(0, hi, (6, 9))
        assert tpack.narrow_counts(c).dtype == rpack.narrow_counts(c).dtype
    acc_t, acc_r = tpack.CountAccumulator(), rpack.CountAccumulator()
    for _ in range(3):
        c = rng.integers(0, 255, (4, 5)).astype(np.uint8)
        acc_t.update(c)
        acc_r.update(c)
    np.testing.assert_array_equal(acc_t.result(), acc_r.result())


def _chunks(kind, seed=2):
    rng = np.random.default_rng(seed)
    sizes = (4, 5, 3)
    if kind == "int":
        vals = [rng.integers(-50, 50, (n, 6)) for n in sizes]
    else:
        vals = [rng.normal(0, 3, (n, 6)) for n in sizes]
    vals[1][0] = vals[0][0]                       # ties across chunks
    serials = np.split(np.arange(sum(sizes)) * 3, np.cumsum(sizes)[:-1])
    return vals, serials


@pytest.mark.parametrize("kind", ["int", "float"])
def test_online_reductions_match_reference(kind):
    vals, serials = _chunks(kind)
    for name in ("Sum", "Min", "Max", "Welford", "Collect"):
        got, want = getattr(tst, name)(), getattr(rst, name)()
        for v, s in zip(vals, serials):
            got.update(v, s)
            want.update(v, s)
        g, w = got.result(), want.result()
        for key in (w if isinstance(w, dict) else [None]):
            a = np.asarray(g if key is None else g[key])
            b = np.asarray(w if key is None else w[key])
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
            else:
                np.testing.assert_array_equal(a, b)
    p_t, p_r = tst.Passthrough(), rst.Passthrough()
    for v, s in zip(vals, serials):
        p_t.update(v.sum(axis=0), s)
        p_r.update(v.sum(axis=0), s)
    np.testing.assert_array_equal(p_t.result(), p_r.result())


def test_stream_batches_pad_by_cloning_and_slice_as_views(tiny):
    _, port = tiny
    chunk = tst.slice_batch(port, 9, 12)
    assert chunk.serial.data_ptr() == port.serial[9:].data_ptr()
    padded = tst.pad_batch(chunk, 2)
    assert padded.n_dimms == 5
    assert torch.equal(padded.row_src[3], port.row_src[11])
    assert torch.equal(padded.serial[3:], port.serial[11:].repeat(2))
    stream = tst.as_stream(port)
    assert tst.as_stream(stream) is stream and stream.n_dimms == D
    with pytest.raises(ValueError):
        stream.chunk(5, D + 1)
    with pytest.raises(TypeError):
        tst.as_stream(np.zeros(3))


# ------------------------------------------------ the fleet error summary

def _compare(got, want, n_dimms):
    for key in ("lam_stats",):
        np.testing.assert_allclose(got[key]["mean"], want[key]["mean"],
                                   rtol=LAMBDA_RTOL)
        assert got[key]["count"] == want[key]["count"] == n_dimms
    for key in ("lam_min", "lam_max", "worst_cell_max"):
        np.testing.assert_array_equal(got[key]["serial"], want[key]["serial"])
        np.testing.assert_allclose(got[key]["value"], want[key]["value"],
                                   rtol=LAMBDA_RTOL)
    np.testing.assert_allclose(got["grid_sum"], want["grid_sum"], rtol=0,
                               atol=n_dimms * CELL_ATOL)
    np.testing.assert_array_equal(got["hot_cells"], want["hot_cells"])
    assert len(got["fail_maps"]) == len(want["fail_maps"])
    for g, w in zip(got["fail_maps"], want["fail_maps"]):
        np.testing.assert_array_equal(tpack.unpack_bool(g),
                                      rpack.unpack_bool(w))
    for key in ("n_dimms", "n_chunks", "chunk_size"):
        assert got[key] == want[key]
    assert got["lam_total"].shape == (n_dimms,)
    np.testing.assert_allclose(got["lam_total"].mean(),
                               want["lam_stats"]["mean"], rtol=LAMBDA_RTOL)
    assert got["lam_total"].min() == got["lam_min"]["value"]


@pytest.mark.parametrize("chunk", [3, 5])
@pytest.mark.parametrize("op", [False, True], ids=["nominal", "op_point"])
def test_error_summary_matches_reference(tiny, chunk, op):
    ref, port = tiny
    kw = dict(chunk_size=chunk, collect_fail_maps=True,
              **(OP_POINT if op else {}))
    want = rst.stream_error_summary(rst.PopulationStream.from_batch(ref),
                                    "tras", 25.0, **kw)
    ops.reset_launches()
    got = tst.stream_error_summary(tst.PopulationStream.from_batch(port),
                                   "tras", 25.0, **kw)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions
    _compare(got, want, D)


def test_error_summary_is_chunk_invariant(tiny):
    _, port = tiny
    runs = [tst.stream_error_summary(port, "tras", 25.0, chunk_size=c,
                                     collect_fail_maps=True, **OP_POINT)
            for c in (3, 5, D)]
    for other in runs[1:]:
        np.testing.assert_array_equal(other["hot_cells"], runs[0]["hot_cells"])
        np.testing.assert_array_equal(
            np.concatenate([tpack.unpack_bool(p) for p in other["fail_maps"]]),
            np.concatenate([tpack.unpack_bool(p) for p in runs[0]["fail_maps"]]))
        for key in ("lam_min", "lam_max", "worst_cell_max"):
            np.testing.assert_array_equal(other[key]["value"],
                                          runs[0][key]["value"])
            np.testing.assert_array_equal(other[key]["serial"],
                                          runs[0][key]["serial"])
        # each chunk sums its DIMMs' cells in float32 on the device: at most
        # D adds of relative error 2**-24 each (7e-7)
        np.testing.assert_allclose(other["grid_sum"], runs[0]["grid_sum"],
                                   rtol=1e-6)


def test_error_summary_lambdas_equal_dense_grids(tiny):
    """The streamed per-DIMM lambdas are the dense grids' sums."""
    _, port = tiny
    out = tst.stream_error_summary(port, "trp", 7.5, chunk_size=D)
    dense = tsub.fail_prob_grids(port, "trp", 7.5)
    lam = dense.sum(dim=(1, 2, 3)).numpy()
    assert out["lam_min"]["value"] == lam.min()
    assert out["lam_max"]["value"] == lam.max()
    np.testing.assert_allclose(out["grid_sum"], dense.sum(dim=0).numpy(),
                               rtol=1e-6)


def test_operating_point_raises_the_fleet_lambdas(tiny):
    _, port = tiny
    nominal = tst.stream_error_summary(port, "tras", 25.0, chunk_size=5)
    op = tst.stream_error_summary(port, "tras", 25.0, chunk_size=5,
                                  **OP_POINT)
    assert op["lam_stats"]["mean"] > nominal["lam_stats"]["mean"]
    assert (op["hot_cells"] >= nominal["hot_cells"]).all()
