"""Port parity of the streamed scans of ``core/streaming``: repro_torch's
``stream_profile_population``, ``stream_operating_grid``,
``stream_lifetime_population``, ``stream_bit_signature``,
``stream_shuffling_gain``, ``stream_secded_scrub``,
``stream_discover_generations`` and ``hash_poisson_counts`` against repro's,
on the 13-DIMM TINY synthetic fleet at chunk sizes 4, 5 and 13 (4 and 5 do
not divide 13), on the CPU.

Tiers: tables, decisions, signatures, codeword counts and codewords, labels,
canonical profiles and vulnerable rows identical; operating-grid ``lam``
within rtol 1e-5 (tests/test_torch_op_points.py's tier) and lifetime ECC
exposure within rtol 1e-4, atol 1e-6 (tests/test_torch_lifetime.py's); the
online float folds of identical values within rtol 1e-12 (the same float64
numpy arithmetic).  ``hash_poisson_counts`` draws its own bits (a numpy
generator per serial, not ``jax.random.poisson``), so the generation scan is
held to repro fed repro's counts through ``counts_fn``, and the sampler is
held to its distribution.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ecc as recc
from repro.core import streaming as rst
from repro.core import substrate as rsub
from repro.core import timing as rtiming
from repro.core.geometry import TINY as RTINY
from repro.core.population import synthetic_fleet as ref_fleet
from repro.core.shuffling import design_stripe_profiles
from repro_torch.core import ecc as tecc
from repro_torch.core import streaming as tst
from repro_torch.core import substrate as tsub
from repro_torch.core import timing as ttiming
from repro_torch.core.geometry import TINY
from repro_torch.core.population import synthetic_fleet
from repro_torch.kernels import ops

D, SEED = 13, 7
CHUNKS = (4, 5, 13)
LAM_RTOL = 1e-5                      # tests/test_torch_op_points.py
ECC_RTOL, ECC_ATOL = 1e-4, 1e-6      # tests/test_torch_lifetime.py
FOLD_RTOL = 1e-12
AGES = np.array([0.0, 2.0, 5.0], np.float32)
TEMPS = np.array([45.0, 55.0, 70.0])
POINTS = [dict(), dict(vdd=1.05), dict(refresh_ms=256.0, temp_C=75.0),
          dict(timing=(10.0, 25.0, 10.0, 10.0), vdd=1.20)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleets():
    return (ref_fleet(D, RTINY, seed=SEED),
            synthetic_fleet(D, TINY, seed=SEED, device="cpu"))


def _ref_batch(batch):
    """The reference batch of a port batch's leaves (serial as uint32)."""
    leaves = {n: getattr(batch, n).cpu().numpy() for n in rsub._LEAVES}
    leaves["serial"] = leaves["serial"].astype(np.uint32)
    return rsub.DimmBatch(geom=RTINY, **leaves)


def ref_counts(batch, param, t_op, *, temp_C, refresh_ms, seed):
    """repro's campaign counts for a port batch: the ``counts_fn`` hook."""
    return rst.hash_poisson_counts(_ref_batch(batch), param, t_op,
                                   temp_C=temp_C, refresh_ms=refresh_ms,
                                   seed=seed)


def _same_extremes(got, want, key):
    np.testing.assert_array_equal(got[key]["value"], want[key]["value"])
    np.testing.assert_array_equal(got[key]["serial"], want[key]["serial"])


def _points(mod):
    out = []
    for kw in POINTS:
        kw = dict(kw)
        if "timing" in kw:
            kw["timing"] = mod.TimingParams(*kw["timing"])
        out.append(mod.OperatingPoint(**kw))
    return out


# ------------------------------------------------------------- profiling

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_profile_matches_reference(fleets, chunk):
    ref, port = fleets
    want = rst.stream_profile_population(ref, chunk_size=chunk, collect=True,
                                         multibit_only=True)
    ops.reset_launches()
    got = tst.stream_profile_population(port, chunk_size=chunk, collect=True,
                                        multibit_only=True)
    assert set(ops.launch_counts().values()) == {0}   # CPU: plain versions
    np.testing.assert_array_equal(got["tables"], want["tables"])
    for key in ("tables_min", "tables_max"):
        _same_extremes(got, want, key)
    np.testing.assert_allclose(got["tables_stats"]["mean"],
                               want["tables_stats"]["mean"], rtol=FOLD_RTOL)
    np.testing.assert_allclose(got["tables_stats"]["var"],
                               want["tables_stats"]["var"], rtol=FOLD_RTOL,
                               atol=1e-12)
    for key in ("n_dimms", "n_chunks", "chunk_size"):
        assert got[key] == want[key]
    # the streamed tables are the dense path's
    dense = tsub.profile_population_arrays(port.chunk(0, D),
                                           multibit_only=True)
    np.testing.assert_array_equal(got["tables"], dense)


def test_stream_profile_rejects_per_dimm_regions_and_bad_banks(fleets):
    _, port = fleets
    with pytest.raises(ValueError):
        tst.stream_profile_population(port, banks=3)
    with pytest.raises(ValueError):
        tst.stream_profile_population(port, region=np.zeros((D, 2), int))


# ---------------------------------------------------------- operating grid

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_operating_grid_matches_reference(fleets, chunk):
    ref, port = fleets
    want = rst.stream_operating_grid(ref, _points(rtiming), chunk_size=chunk,
                                     collect=True)
    got = tst.stream_operating_grid(port, _points(ttiming), chunk_size=chunk,
                                    collect=True)
    np.testing.assert_array_equal(got["fails"], want["fails"])
    np.testing.assert_array_equal(got["fail_count"], want["fail_count"])
    np.testing.assert_allclose(got["fail_stats"]["mean"],
                               want["fail_stats"]["mean"], rtol=FOLD_RTOL)
    np.testing.assert_allclose(got["lam"], want["lam"], rtol=LAM_RTOL)
    np.testing.assert_array_equal(got["lam_max"]["serial"],
                                  want["lam_max"]["serial"])
    np.testing.assert_allclose(got["lam_max"]["value"],
                               want["lam_max"]["value"], rtol=LAM_RTOL)
    assert len(got["points"]) == len(POINTS)


# ---------------------------------------------------------------- lifetime

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_lifetime_matches_reference(fleets, chunk):
    ref, port = fleets
    want = rst.stream_lifetime_population(ref, AGES, TEMPS, chunk_size=chunk,
                                          collect=True)
    got = tst.stream_lifetime_population(port, AGES, TEMPS, chunk_size=chunk,
                                         collect=True)
    np.testing.assert_array_equal(got["timings"], want["timings"])
    np.testing.assert_array_equal(got["stale_fail"], want["stale_fail"])
    np.testing.assert_array_equal(got["stale_count"], want["stale_count"])
    for key in ("timings_min", "timings_max"):
        _same_extremes(got, want, key)
    np.testing.assert_allclose(got["ecc_lambda"], want["ecc_lambda"],
                               rtol=ECC_RTOL, atol=ECC_ATOL)
    np.testing.assert_allclose(got["ecc_lambda_total"],
                               want["ecc_lambda_total"], rtol=ECC_RTOL,
                               atol=D * ECC_ATOL)
    np.testing.assert_array_equal(got["ages"], want["ages"])


def test_stream_lifetime_rejects_per_dimm_schedules(fleets):
    _, port = fleets
    with pytest.raises(ValueError):
        tst.stream_lifetime_population(port, np.zeros((3, D)), TEMPS)


# -------------------------------------------------------------- signatures

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_bit_signature_matches_reference(chunk):
    counts = np.random.default_rng(chunk).integers(
        0, 3000, (D, TINY.subarrays, TINY.rows_per_mat))
    fn = lambda lo, hi: counts[lo:hi]
    got = tst.stream_bit_signature(fn, D, chunk_size=chunk, device="cpu")
    want = rst.stream_bit_signature(fn, D, chunk_size=chunk)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- Fig 17

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_shuffling_gain_matches_reference(chunk):
    probs = design_stripe_profiles(D, seed=3)
    kw = dict(chunk_size=chunk, seed=5, n_accesses=300, collect=True)
    want = rst.stream_shuffling_gain(probs, **kw)
    got = tst.stream_shuffling_gain(probs, device="cpu", **kw)
    for key in tst._SHUFFLING_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert int(got[f"{key}_sum"]) == int(want[f"{key}_sum"]), key
    for key in ("frac_no_shuffle", "frac_shuffle", "gain", "n_dimms",
                "n_chunks", "chunk_size"):
        assert got[key] == want[key], key
    # a chunk factory gives the same sums
    fact = tst.stream_shuffling_gain(lambda lo, hi: probs[lo:hi], n_dimms=D,
                                     device="cpu", **kw)
    assert fact["gain"] == got["gain"]
    with pytest.raises(ValueError):
        tst.stream_shuffling_gain(lambda lo, hi: probs[lo:hi],
                                  chunk_size=chunk, device="cpu")


# ------------------------------------------------------------- ECC scrub

def _flipped_codewords(n_words: int, seed: int) -> np.ndarray:
    """Encoded random words with single flips, double flips and clean ones."""
    rng = np.random.default_rng(seed)
    code = tecc.encode(rng.integers(0, 2, (n_words, 64))).numpy()
    for i in range(n_words):
        k = i % 3                                 # 0 clean, 1 or 2 flips
        pos = rng.choice(72, k, replace=False)
        code[i, pos] ^= 1
    return code.astype(np.int32)


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_secded_scrub_matches_reference(chunk, donate):
    code = _flipped_codewords(8 * D, seed=chunk)
    want = rst.stream_secded_scrub(code, chunk_size=chunk, collect=True,
                                   donate=donate)
    got = tst.stream_secded_scrub(code, chunk_size=chunk, collect=True,
                                  donate=donate, device="cpu")
    for key in ("n_words", "n_chunks", "chunk_size", "clean", "corrected",
                "uncorrectable"):
        assert got[key] == want[key], key
    assert got["donated"] is donate
    np.testing.assert_array_equal(got["codewords"], want["codewords"])
    assert got["corrected"] > 0 and got["uncorrectable"] > 0
    # the chunk factory: the same words, never resident as one array
    fact = tst.stream_secded_scrub(lambda lo, hi: code[lo:hi], len(code),
                                   chunk_size=chunk, collect=True,
                                   donate=donate, device="cpu")
    np.testing.assert_array_equal(fact["codewords"], want["codewords"])
    assert fact["corrected"] == want["corrected"]
    # corrected single flips decode to the data that was encoded
    fixed = recc.decode(got["codewords"])[1]
    assert (np.asarray(fixed) != 1).all()


def test_stream_secded_scrub_checks_its_chunks():
    with pytest.raises(ValueError):
        tst.stream_secded_scrub(lambda lo, hi: np.zeros((hi - lo, 72)),
                                device="cpu")
    with pytest.raises(ValueError):
        tst.stream_secded_scrub(lambda lo, hi: np.zeros((hi - lo, 64)), 10,
                                device="cpu")


# ------------------------------------------------ campaigns and generations

@pytest.mark.parametrize("chunk", CHUNKS)
def test_stream_discover_generations_matches_reference(fleets, chunk):
    ref, port = fleets
    want = rst.stream_discover_generations(ref, chunk_size=chunk)
    got = tst.stream_discover_generations(
        port, chunk_size=chunk,
        counts_fn=lambda b: ref_counts(b, "trp", 7.5, temp_C=85.0,
                                       refresh_ms=256.0, seed=0))
    for key in ("labels", "serials", "members", "n_profiles", "canonical"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["n_generations"] == want["n_generations"]
    assert len(got["vulnerable_rows"]) == len(want["vulnerable_rows"])
    for a, b in zip(got["vulnerable_rows"], want["vulnerable_rows"]):
        np.testing.assert_array_equal(a, b)


def test_stream_discover_generations_own_counts_chunk_invariant(fleets):
    _, port = fleets
    outs = [tst.stream_discover_generations(port, chunk_size=c)
            for c in (4, 13)]
    for key in ("labels", "canonical", "members"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])


def test_hash_poisson_counts_whole_and_in_chunks(fleets):
    _, port = fleets
    whole = tst.hash_poisson_counts(port.chunk(0, D), "trp", 7.5)
    parts = np.concatenate([tst.hash_poisson_counts(port.chunk(lo, hi),
                                                    "trp", 7.5)
                            for lo, hi in tst.chunk_spans(D, 5)])
    assert whole.dtype == np.int64
    assert whole.shape == (D, TINY.subarrays, TINY.rows_per_mat)
    np.testing.assert_array_equal(whole, parts)
    # keyed by serial, not by position: a DIMM alone draws what it drew
    # beside the others; another seed draws other counts
    np.testing.assert_array_equal(
        tst.hash_poisson_counts(port.chunk(7, 8), "trp", 7.5)[0], whole[7])
    assert not np.array_equal(
        tst.hash_poisson_counts(port.chunk(0, D), "trp", 7.5, seed=1), whole)
    # external order, like the reference's lambdas
    lam = tsub.row_error_lambda(port.chunk(0, D), "trp", 7.5).reshape(
        whole.shape)
    assert np.corrcoef(lam.ravel(), whole.ravel())[0, 1] > 0.9


LADDER = np.array([0.0, 1e-3, 0.1, 1.0, 10.0, 100.0, 1e3, 1e4, 1e5])


def test_hash_poisson_counts_distribution(fleets, monkeypatch):
    """Fed a ladder of lambdas: 0 where lambda is 0, and the sample mean of
    every rung within 4 standard errors of its lambda."""
    _, port = fleets
    batch = port.chunk(0, D)
    n_rows = TINY.subarrays * TINY.rows_per_mat
    lam = LADDER[np.arange(D * n_rows) % len(LADDER)].reshape(D, n_rows)
    monkeypatch.setattr(tst, "row_error_lambda",
                        lambda *a, **k: lam.astype(np.float32))
    counts = tst.hash_poisson_counts(batch, "trp", 7.5).reshape(D, n_rows)
    assert (counts[lam == 0] == 0).all()
    assert (counts >= 0).all()
    for rung in LADDER[1:]:
        x = counts[lam == rung]
        se = np.sqrt(rung / x.size)
        assert abs(x.mean() - rung) <= 4 * se, (rung, x.mean(), se)
