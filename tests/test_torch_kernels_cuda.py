"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  The file imports nothing of the JAX reference, so it also runs on a
GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: ``fail_prob`` atol 1e-6, the reference's kernel-against-oracle
bound (the kernel performs the plain version's float32 operations in its
order); the SECDED and shuffle kernels are integer work and must equal their
plain versions exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fail_prob import fail_prob, fail_prob_ref
from repro_torch.kernels.secded import (encode_checks, encode_checks_ref,
                                        syndrome, syndrome_ref)
from repro_torch.kernels.shuffle import _perm_tensor, apply_shuffle, apply_shuffle_ref
from repro_torch.memsys.codec import interleave_permutation

ATOL = 1e-6
COEFFS = np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(D, M, R, dev, seed=3):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 0.05, (D, 9)) * (np.arange(9) < 6)  # t terms only
    return (torch.as_tensor(rng.integers(0, R, (D, R)), dtype=torch.int32,
                            device=dev),
            torch.linspace(0.1, 1.0, M, device=dev),
            torch.as_tensor((COEFFS + noise).astype(np.float32), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("D,M,R,C,open_bitline",
                         [(4, 16, 512, 512, True), (3, 5, 100, 96, True),
                          (2, 3, 7, 5, False)])
def test_fail_prob_kernel_matches_plain_version(cuda, D, M, R, C,
                                                open_bitline):
    row_src, d_mat, coeffs = _inputs(D, M, R, cuda)
    before = fail_prob.launches
    got = fail_prob(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    want = fail_prob_ref(row_src, d_mat, coeffs, cols=C,
                         open_bitline=open_bitline)
    torch.cuda.synchronize()
    assert fail_prob.launches == before + 1
    assert got.shape == (D, M, R, C)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    one = fail_prob(row_src[0], d_mat, coeffs[0], cols=C,
                    open_bitline=open_bitline)
    torch.testing.assert_close(one, want[0], rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_fail_prob_rejects_non_contiguous(cuda):
    row_src, d_mat, coeffs = _inputs(2, 3, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fail_prob(row_src[:, ::2], d_mat, coeffs, cols=8)


def _bits(n, width, dev, seed=5):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 2, (n, width)), dtype=torch.int32,
                           device=dev)


SECDED = [(encode_checks, encode_checks_ref, 64), (syndrome, syndrome_ref, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 128, 129, 4096, 1000003])
@pytest.mark.parametrize("kernel,plain,width", SECDED)
def test_secded_kernels_equal_plain_versions(cuda, kernel, plain, width, n):
    x = _bits(n, width, cuda, seed=n)
    before = kernel.launches
    got = kernel(x)
    want = plain(x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (n, 8) and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,plain,width", SECDED)
def test_secded_kernels_unaligned_empty_and_non_contiguous(cuda, kernel, plain,
                                                           width):
    flat = _bits(1, 300 * width + 1, cuda)[0]
    x = flat[1:].view(300, width)                  # 4 bytes off 16-byte alignment
    assert torch.equal(kernel(x), plain(x))
    before = kernel.launches
    assert kernel(x[:0]).shape == (0, 8) and kernel.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        kernel(_bits(8, 2 * width, cuda)[:, ::2])


PERMS = [dict(shuffle=True), dict(shuffle=False), dict(shuffle=True, inverse=True),
         dict(perm=interleave_permutation()),
         dict(perm=interleave_permutation(), inverse=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 4096, 1000003])
@pytest.mark.parametrize("kw", PERMS)
def test_shuffle_kernel_equals_plain_version(cuda, kw, n):
    x = _bits(n, 576, cuda, seed=n)
    before = apply_shuffle.launches
    got = apply_shuffle(x, **kw)
    perm = kw.get("perm")
    if perm is None:
        from repro_torch.kernels.shuffle import shuffle_permutation
        perm = shuffle_permutation(kw["shuffle"])
    index = _perm_tensor(np.asarray(perm, np.int32).tobytes(),
                         kw.get("inverse", False), x.device)
    want = apply_shuffle_ref(x, index)
    torch.cuda.synchronize()
    assert apply_shuffle.launches == before + 1
    assert got.shape == (n, 576) and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got, torch.index_select(x, 1, index))


@pytest.mark.cuda
def test_shuffle_kernel_unaligned_empty_and_non_contiguous(cuda):
    x = _bits(1, 50 * 576 + 1, cuda)[0][1:].view(50, 576)
    back = apply_shuffle(apply_shuffle(x), inverse=True)
    assert torch.equal(back, x)
    before = apply_shuffle.launches
    assert apply_shuffle(x[:0]).shape == (0, 576)
    assert apply_shuffle.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        apply_shuffle(_bits(4, 1152, cuda)[:, ::2])
