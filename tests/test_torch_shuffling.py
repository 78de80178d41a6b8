"""Port parity of DIVA Shuffling (Fig 17): the burst-error hash, the numpy
walker and the batched ``shuffling_gain_population`` /
``burst_bit_profile_population`` of repro_torch against repro, on the CPU.

Tiers:
  * hash bits, error masks and every count: identical;
  * profiled burst-bit probabilities: rtol 1e-5 / atol 1e-7.  They are row
    means of failure grids, and the reference's jitted grid differs from the
    port's IEEE divisions by about an ulp in ``t`` (tests/
    test_torch_substrate.py), which a mean over the rows averages down.
    Counts are compared exactly only when both packages get the same
    probabilities: ``u < p`` flips on a one-ulp change in ``p``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro.core import geometry as rgeom
from repro.core import shuffling as rshuf
from repro.core import substrate as rsub
from repro.core.population import make_population as ref_make_population
from repro_torch.core import hashing
from repro_torch.core import shuffling as tshuf
from repro_torch.core import substrate as tsub
from repro_torch.kernels import ops

PROB_RTOL, PROB_ATOL = 1e-5, 1e-7
KEYS = ("total", "frac_no_shuffle", "frac_shuffle", "gain",
        "uncorrectable_no_shuffle", "uncorrectable_shuffle",
        "undetected_no_shuffle", "undetected_shuffle")


def _assert_same_counts(got, want):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------------ hashing

@settings(max_examples=60, deadline=None)
@given(seeds=st.lists(st.integers(2**31, 2**32 - 1), min_size=1, max_size=6)
       | st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=6),
       n_acc=st.integers(1, 12), lane0=st.integers(0, 2**32 - 64))
def test_burst_uniform_matches_reference(seeds, n_acc, lane0):
    """Seeds span the whole uint32 range, >= 2**31 (negative as int32)
    included."""
    seed = np.asarray(seeds, np.uint32)[:, None, None]
    acc = np.arange(n_acc, dtype=np.uint32)[None, :, None]
    lane = (lane0 + np.arange(64, dtype=np.uint64)).astype(np.uint32)[None, None, :]
    want = rsub.burst_uniform(seed, acc, lane)
    np.testing.assert_array_equal(hashing.burst_uniform(seed, acc, lane), want)
    got = hashing.burst_uniform_t(torch.as_tensor(seed.astype(np.int64)),
                                  torch.as_tensor(acc.astype(np.int64)),
                                  torch.as_tensor(lane.astype(np.int64)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ numpy walker

@pytest.mark.parametrize("shuffle", [True, False])
def test_error_masks_and_stats_match_reference(shuffle):
    rng = np.random.default_rng(2)
    for _ in range(5):
        e = (rng.random((9, 64)) < 0.05).astype(np.int32)
        np.testing.assert_array_equal(tshuf.assemble_error_masks(e, shuffle),
                                      rshuf.assemble_error_masks(e, shuffle))
        assert (tshuf.correctable_stats(e, shuffle)
                == rshuf.correctable_stats(e, shuffle))


def test_profiles_samples_and_loop_match_reference():
    np.testing.assert_array_equal(tshuf.design_stripe_profiles(8),
                                  rshuf.design_stripe_profiles(8))
    np.testing.assert_array_equal(tshuf.design_stripe_profiles(5, seed=7),
                                  rshuf.design_stripe_profiles(5, seed=7))
    prob = rshuf.design_stripe_profiles(1)[0]
    np.testing.assert_array_equal(tshuf.sample_chip_errors(prob, 5, 50),
                                  rshuf.sample_chip_errors(prob, 5, 50))
    got = tshuf.shuffling_gain_loop(prob, n_accesses=300, seed=5)
    assert got == rshuf.shuffling_gain_loop(prob, n_accesses=300, seed=5)
    assert got["total"] > 0


# ------------------------------------------------------ batched population

def test_shuffling_gain_population_matches_reference():
    probs = rshuf.design_stripe_profiles(8)
    got = tsub.shuffling_gain_population(probs, seeds=np.arange(8),
                                         n_accesses=200, device="cpu")
    want = rsub.shuffling_gain_population(probs, seeds=np.arange(8),
                                          n_accesses=200)
    _assert_same_counts(got, want)
    assert (got["total"] > 0).all() and (got["gain"] > 0).any()


def test_shuffling_gain_population_high_seeds_and_tensor_inputs():
    probs = rshuf.design_stripe_profiles(3, seed=4)
    seeds = np.array([2**32 - 1, 2**31, 12345], np.uint32)
    want = rsub.shuffling_gain_population(probs, seeds=seeds, n_accesses=150)
    got = tsub.shuffling_gain_population(
        torch.as_tensor(probs), seeds=torch.as_tensor(seeds.astype(np.int64)),
        n_accesses=150, device="cpu")
    _assert_same_counts(got, want)


def test_shuffling_gain_population_matches_port_loop_and_wrapper():
    prob = tshuf.design_stripe_profiles(1, seed=3)[0]
    loop = tshuf.shuffling_gain_loop(prob, n_accesses=250, seed=2)
    wrap = tshuf.shuffling_gain(prob, n_accesses=250, seed=2, device="cpu")
    assert wrap == loop
    assert wrap == rshuf.shuffling_gain(prob, n_accesses=250, seed=2)


def test_zero_probability_profile_is_all_clean():
    got = tsub.shuffling_gain_population(np.zeros((2, 9, 64)), n_accesses=50,
                                         device="cpu")
    _assert_same_counts(got, rsub.shuffling_gain_population(
        np.zeros((2, 9, 64)), n_accesses=50))
    assert (got["total"] == 0).all() and (got["frac_shuffle"] == 1.0).all()
    assert (got["gain"] == 0.0).all()


def test_shuffling_gain_population_checks_shapes():
    with pytest.raises(ValueError, match="9, 64"):
        tsub.shuffling_gain_population(np.zeros((2, 8, 64)), device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        tsub.shuffling_gain_population(np.zeros((2, 9, 64)), seeds=[1, 2, 3],
                                       device="cpu")


def test_cpu_run_launches_no_kernel():
    ops.reset_launches()
    tsub.shuffling_gain_population(tshuf.design_stripe_profiles(2),
                                   n_accesses=20, device="cpu")
    assert set(ops.launch_counts().values()) == {0}


@pytest.fixture(scope="module")
def small_pair():
    ref = rsub.DimmBatch.from_population(ref_make_population(rgeom.SMALL, 4))
    leaves = {k: np.asarray(getattr(ref, k)) for k in rsub._LEAVES}
    port = tsub.DimmBatch.from_arrays(dataclasses.asdict(ref.geom), leaves,
                                      device="cpu")
    return ref, port


def test_burst_bit_profile_population_matches_reference(small_pair):
    ref, port = small_pair
    want = rsub.burst_bit_profile_population(ref, "trp", 7.5, refresh_ms=256.0)
    got = tsub.burst_bit_profile_population(port, "trp", 7.5, refresh_ms=256.0)
    assert got.shape == want.shape == (4, 9, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PROB_RTOL, atol=PROB_ATOL)
    assert (want > 0).any()
    # the Fig 17 chain: identical counts when both get the reference's probs
    seeds = np.asarray(ref.serial)
    _assert_same_counts(
        tsub.shuffling_gain_population(want, seeds=port.serial,
                                       n_accesses=300, device="cpu"),
        rsub.shuffling_gain_population(want, seeds=seeds, n_accesses=300))
