"""The bit_signature kernel's plain version against the reference's Pallas
kernel (interpret mode), its jnp oracle and the numpy reference, and the
wrapper's device dispatch.  Integer work: the results must be identical,
int32, including where the sums wrap.  The CUDA kernel against the plain
version is in test_torch_kernels_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mapping import _signature_sums
from repro.kernels import ref as jref
from repro.kernels.bit_signature import bit_signature as pallas_bit_signature
from repro_torch.kernels.bit_signature import bit_signature, bit_signature_ref
from repro_torch.kernels.ops import launch_counts


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(n, nbits, high=1000, seed=0):
    rng = np.random.default_rng(seed + nbits)
    return rng.integers(0, high, (n, 2 ** nbits)).astype(np.int32)


@pytest.mark.parametrize("nbits", range(1, 11))
@pytest.mark.parametrize("n", [1, 37])
def test_plain_equals_pallas_oracle_and_numpy(nbits, n):
    counts = _counts(n, nbits)
    got = bit_signature_ref(torch.as_tensor(counts), nbits=nbits)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, nbits)
    got = got.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_bit_signature(counts, nbits=nbits,
                                             interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.bit_signature(counts,
                                                                     nbits)))
    np.testing.assert_array_equal(
        got, np.stack([_signature_sums(c, nbits) for c in counts]))


@pytest.mark.parametrize("n", [1, 255, 257, 600])
def test_ragged_n_matches_pallas_tiles(n):
    counts = _counts(n, 6, seed=n)
    np.testing.assert_array_equal(
        bit_signature(torch.as_tensor(counts), nbits=6).numpy(),
        np.asarray(pallas_bit_signature(counts, nbits=6, interpret=True)))


def test_sums_wrap_like_int32():
    """Counts near 2**31 overflow int32 sums; the plain version wraps as the
    reference's int32 arithmetic does."""
    counts = _counts(9, 5, high=2 ** 31 - 1, seed=3)
    got = bit_signature_ref(torch.as_tensor(counts), nbits=5).numpy()
    want = np.asarray(jref.bit_signature(counts, 5))
    np.testing.assert_array_equal(got, want)
    exact = np.stack([_signature_sums(c, 5) for c in counts])
    assert (np.abs(exact) > 2 ** 31).any()          # the test does overflow
    np.testing.assert_array_equal(got, exact.astype(np.int32))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    counts = torch.as_tensor(_counts(20, 7))
    before = launch_counts()["bit_signature"]
    assert torch.equal(bit_signature(counts, nbits=7),
                       bit_signature_ref(counts, nbits=7))
    assert launch_counts()["bit_signature"] == before


@pytest.mark.parametrize("bad", ["dtype", "nbits", "rank", "device",
                                 "too_wide"])
def test_wrapper_rejects_bad_inputs(bad):
    counts = torch.as_tensor(_counts(4, 3))
    nbits = 3
    if bad == "dtype":
        counts = counts.long()
    elif bad == "nbits":
        nbits = 4
    elif bad == "rank":
        counts = counts[0]
    elif bad == "device":
        counts = counts.to("meta")
    else:
        counts, nbits = torch.zeros((1, 2 ** 17), dtype=torch.int32), 17
    with pytest.raises((TypeError, ValueError)):
        bit_signature(counts, nbits=nbits)
