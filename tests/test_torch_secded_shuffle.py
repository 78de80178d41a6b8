"""The port's SECDED and shuffle kernel wrappers on CPU tensors (their plain
versions) against the reference's Pallas kernels in interpret mode and its
jnp oracles, and the wrappers' argument checks and device dispatch.  The CUDA
kernels against the plain versions are in test_torch_kernels_cuda.py.
Tier: exact (integer bits)."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.secded import encode_checks as pallas_encode
from repro.kernels.secded import syndrome as pallas_syndrome
from repro.kernels.shuffle import apply_shuffle as pallas_shuffle
from repro.kernels.shuffle import shuffle_permutation as ref_perm
from repro.memsys.codec import interleave_permutation as ref_interleave
from repro_torch.core.ecc import H_DATA
from repro_torch.kernels import ops
from repro_torch.kernels.secded import (encode_checks, encode_checks_ref,
                                        syndrome, syndrome_ref)
from repro_torch.kernels.shuffle import apply_shuffle, shuffle_permutation
from repro_torch.memsys.codec import interleave_permutation

SIZES = [1, 7, 513, 2049]
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _bits(n, width, seed):
    return np.random.default_rng(seed).integers(0, 2, (n, width)).astype(np.int32)


def test_cuda_parity_table_is_h_data():
    """The kernel's __constant__ masks are the rows of H_DATA."""
    src = (CSRC / "secded.cu").read_text()
    body = re.search(r"kHData\[kDataBits\] = \{([^}]*)\}", src).group(1)
    masks = np.array([int(v, 16) for v in re.findall(r"0x[0-9A-Fa-f]+", body)])
    np.testing.assert_array_equal(masks, (H_DATA << np.arange(8)).sum(axis=1))


@pytest.mark.parametrize("n", SIZES)
def test_encode_checks_matches_reference_kernel(n):
    data = _bits(n, 64, seed=n)
    got = encode_checks(torch.as_tensor(data))
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas_encode(data)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.secded_encode(data)))


@pytest.mark.parametrize("n", SIZES)
def test_syndrome_matches_reference_kernel(n):
    code = _bits(n, 72, seed=n + 1)
    got = syndrome(torch.as_tensor(code))
    assert got.dtype == torch.int32 and got.shape == (n, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas_syndrome(code)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.secded_syndrome(code)))


def test_empty_inputs_give_empty_outputs():
    assert encode_checks(torch.zeros((0, 64), dtype=torch.int32)).shape == (0, 8)
    assert syndrome(torch.zeros((0, 72), dtype=torch.int32)).shape == (0, 8)
    assert apply_shuffle(torch.zeros((0, 576), dtype=torch.int32)).shape == (0, 576)


def test_permutations_match_reference():
    for shuffle in (True, False):
        np.testing.assert_array_equal(shuffle_permutation(shuffle),
                                      ref_perm(shuffle))
    np.testing.assert_array_equal(interleave_permutation(), ref_interleave())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("shuffle,inverse", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_apply_shuffle_matches_reference_kernel(n, shuffle, inverse):
    b = _bits(n, 576, seed=n + 2)
    got = apply_shuffle(torch.as_tensor(b), shuffle=shuffle, inverse=inverse)
    assert got.dtype == torch.int32 and got.shape == (n, 576)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pallas_shuffle(b, shuffle=shuffle,
                                               inverse=inverse)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.diva_shuffle(b, inverse, shuffle)))


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_shuffle_codec_perm_matches_reference_kernel(inverse):
    b = _bits(300, 576, seed=11)
    got = apply_shuffle(torch.as_tensor(b), inverse=inverse,
                        perm=interleave_permutation())
    want = pallas_shuffle(b, inverse=inverse, perm=ref_interleave())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = apply_shuffle(got, inverse=not inverse, perm=interleave_permutation())
    np.testing.assert_array_equal(back.numpy(), b)


@pytest.mark.parametrize("bad", [
    np.zeros(576, np.int32),                                  # not a bijection
    np.r_[np.arange(575), 576].astype(np.int32),              # out of range
    np.r_[np.arange(1, 576), -1].astype(np.int32),            # negative
    np.arange(575, dtype=np.int32),                           # wrong length
])
def test_apply_shuffle_rejects_a_non_permutation(bad):
    with pytest.raises(ValueError, match="perm"):
        apply_shuffle(torch.zeros((2, 576), dtype=torch.int32), perm=bad)


def test_wrappers_check_shape_dtype_and_device():
    with pytest.raises(ValueError, match="64"):
        encode_checks(torch.zeros((3, 72), dtype=torch.int32))
    with pytest.raises(ValueError, match="72"):
        syndrome(torch.zeros((3, 64), dtype=torch.int32))
    with pytest.raises(ValueError, match="576"):
        apply_shuffle(torch.zeros((3, 575), dtype=torch.int32))
    for fn, width in ((encode_checks, 64), (syndrome, 72), (apply_shuffle, 576)):
        with pytest.raises(TypeError, match="int32"):
            fn(torch.zeros((3, width), dtype=torch.int64))
        with pytest.raises(TypeError, match="tensor"):
            fn(np.zeros((3, width), np.int32))
        meta = torch.empty((3, width), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(meta)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launches()
    data = torch.as_tensor(_bits(50, 64, seed=3))
    code = torch.as_tensor(_bits(50, 72, seed=4))
    assert torch.equal(encode_checks(data), encode_checks_ref(data))
    assert torch.equal(syndrome(code), syndrome_ref(code))
    apply_shuffle(torch.as_tensor(_bits(5, 576, seed=5)))
    assert ops.launch_counts() == {"fail_prob": 0, "secded_encode": 0,
                                   "secded_syndrome": 0, "diva_shuffle": 0,
                                   "bank_sched": 0, "fail_prob_op": 0,
                                   "bit_signature": 0, "rc_transient": 0,
                                   "wkv6": 0, "wkv6_bwd": 0, "fail_prob_rows": 0,
                                   "adamw": 0, "grad_sq_norm": 0}
