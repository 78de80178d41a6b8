"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  The file imports nothing of the JAX reference, so it also runs on a
GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: atol 1e-6, the reference's kernel-against-oracle bound; the
kernel performs the plain version's float32 operations in its order."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fail_prob import fail_prob, fail_prob_ref

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
