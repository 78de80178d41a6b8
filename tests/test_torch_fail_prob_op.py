"""The fail_prob_op kernel's plain version against the reference's jnp oracle
and its Pallas kernel (interpret mode), for every pair of channel flags and
both bitline layouts, and the CUDA kernel's regrouped order of operations
against the plain version.  The CUDA kernel itself against the plain version
is in test_torch_kernels_cuda.py.

Tolerance: as tests/test_torch_fail_prob.py — atol 1e-6 (the reference's
kernel-against-oracle bound) against the reference's eager jnp oracle, and
1e-6 plus the measured gap between the Pallas kernel and that oracle on the
same inputs against the kernel (jit-compiled XLA multiplies by the float32
reciprocal of a constant divisor and contracts FMAs).  The kernel's regrouped
order (test_torch_fail_prob.regrouped_grid) must equal the plain version bit
for bit (``torch.equal``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.fail_prob import fail_prob_op as pallas_fail_prob_op
from repro_torch.kernels.fail_prob import (N_OP_COEFFS, fail_prob,
                                           fail_prob_op, fail_prob_op_ref,
                                           fail_prob_ref)
from repro_torch.core.latency import (PATTERN_STRESS, access_vdd_shift,
                                      retention_stress)
from repro_torch.core.substrate import _pack_op_coeffs, condition_adders
from repro_torch.kernels.ops import launch_counts
from test_torch_fail_prob import full_population_inputs, regrouped_grid


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ATOL = 1e-6
M, R, C = 4, 64, 32
# access row (tests/test_torch_fail_prob.py), voltage shift, retention channel
COEFFS = np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5,
                   0.3, 4.0, 0.25, 2.0, 0.25, 1.2], np.float32)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _inputs(D=None, seed=3):
    rng = np.random.default_rng(seed)
    shape = (R,) if D is None else (D, R)
    row_src = rng.integers(0, R, shape).astype(np.int32)
    d_mat = np.linspace(0.1, 1.0, M).astype(np.float32)
    cf_shape = (N_OP_COEFFS,) if D is None else (D, N_OP_COEFFS)
    noisy = (np.arange(N_OP_COEFFS) < 6) | (np.arange(N_OP_COEFFS) >= 9)
    coeffs = (COEFFS + rng.normal(0, 0.05, cf_shape) * noisy).astype(np.float32)
    return row_src, d_mat, coeffs


@pytest.mark.parametrize("voltage,retention", FLAGS)
@pytest.mark.parametrize("open_bitline", [True, False])
def test_plain_matches_jnp_oracle_and_pallas_interpret(voltage, retention,
                                                       open_bitline):
    row_src, d_mat, coeffs = _inputs()
    kw = dict(cols=C, open_bitline=open_bitline, voltage=voltage,
              retention=retention)
    want_ref = np.asarray(jref.fail_prob_op(row_src, d_mat, coeffs, **kw))
    want_pallas = np.asarray(pallas_fail_prob_op(row_src, d_mat, coeffs,
                                                 interpret=True, **kw))
    got = fail_prob_op_ref(*map(torch.as_tensor, (row_src, d_mat, coeffs)),
                           **kw).numpy()
    assert got.shape == (M, R, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    ref_gap = float(np.abs(want_pallas - want_ref).max())
    np.testing.assert_allclose(got, want_pallas, atol=ATOL + ref_gap, rtol=0)
    assert (got >= 0).all()


@pytest.mark.parametrize("open_bitline", [True, False])
def test_flags_off_is_fail_prob_bit_for_bit(open_bitline):
    row_src, d_mat, coeffs = map(torch.as_tensor, _inputs(D=3))
    got = fail_prob_op(row_src, d_mat, coeffs, cols=C,
                       open_bitline=open_bitline)
    assert torch.equal(got, fail_prob(row_src, d_mat, coeffs[:, :9].contiguous(),
                                      cols=C, open_bitline=open_bitline))
    assert torch.equal(got, fail_prob_ref(row_src, d_mat, coeffs[:, :9],
                                          cols=C, open_bitline=open_bitline))


@pytest.mark.parametrize("voltage,retention", FLAGS)
def test_batched_equals_per_dimm_and_launches_nothing(voltage, retention):
    row_src, d_mat, coeffs = map(torch.as_tensor, _inputs(D=3, seed=5))
    kw = dict(cols=C, voltage=voltage, retention=retention)
    before = launch_counts()["fail_prob_op"]
    batched = fail_prob_op(row_src, d_mat, coeffs, **kw)
    assert launch_counts()["fail_prob_op"] == before
    assert batched.shape == (3, M, R, C)
    for d in range(3):
        one = fail_prob_op(row_src[d], d_mat, coeffs[d], **kw)
        assert torch.equal(batched[d], one)


def test_channels_add():
    """Voltage raises the access probabilities; retention adds a channel."""
    row_src, d_mat, coeffs = map(torch.as_tensor, _inputs(D=2, seed=7))
    base = fail_prob_op(row_src, d_mat, coeffs, cols=C)
    volt = fail_prob_op(row_src, d_mat, coeffs, cols=C, voltage=True)
    ret = fail_prob_op(row_src, d_mat, coeffs, cols=C, retention=True)
    assert (volt >= base).all() and (volt > base).any()
    assert (ret >= base).all() and (ret > base).any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    row_src, d_mat, coeffs = map(torch.as_tensor, _inputs(D=2))
    if bad == "dtype":
        coeffs = coeffs.double()
    elif bad == "shape":
        coeffs = coeffs[:, :9]
    else:
        row_src, d_mat, coeffs = (t.to("meta") for t in (row_src, d_mat, coeffs))
    with pytest.raises((TypeError, ValueError)):
        fail_prob_op(row_src, d_mat, coeffs, cols=C)


@pytest.mark.parametrize("voltage,retention", FLAGS)
def test_kernel_order_equals_plain_at_full_geometry(voltage, retention):
    """chip_smoke.py's phase-10 coefficients (tRAS 25 ns, 85 C, 256 ms,
    1.20 V) on 2 DIMMs of the FULL geometry."""
    batch, row_src, d_mat, _ = full_population_inputs()
    adder = torch.as_tensor(condition_adders(batch, 85.0, 256.0))
    shift = access_vdd_shift(batch.vdd_coef.numpy(), 1.20)
    coeffs = _pack_op_coeffs(batch, 1, 25.0, PATTERN_STRESS["0101"], adder, 0, 0,
                             shift, retention_stress(85.0, 256.0, 1.20))
    kw = dict(voltage=voltage, retention=retention)
    got = regrouped_grid(row_src, d_mat, coeffs, 512, **kw)
    want = fail_prob_op_ref(row_src, d_mat, coeffs, cols=512, **kw)
    assert got.shape == (2, 16, 512, 512)
    assert torch.equal(got, want)


@pytest.mark.parametrize("voltage,retention", FLAGS)
@pytest.mark.parametrize("D,R,C,open_bitline",
                         [(3, 100, 96, True), (1, 33, 5, False), (2, 31, 1000, True)])
def test_kernel_order_equals_plain_at_ragged_shapes(voltage, retention, D, R, C,
                                                    open_bitline):
    _, d_mat, coeffs = map(torch.as_tensor, _inputs(D=D, seed=R + C))
    row_src = torch.as_tensor(np.random.default_rng(R).integers(0, R, (D, R)),
                              dtype=torch.int32)
    kw = dict(open_bitline=open_bitline, voltage=voltage, retention=retention)
    got = regrouped_grid(row_src, d_mat, coeffs, C, **kw)
    want = fail_prob_op_ref(row_src, d_mat, coeffs, cols=C, **kw)
    assert torch.equal(got, want)
