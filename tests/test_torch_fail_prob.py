"""The fail_prob kernel's plain version against the reference's jnp oracle and
its Pallas kernel (interpret mode), the CUDA kernel's regrouped order of
operations against the plain version, and the wrapper's device dispatch.  The
CUDA kernel itself against the plain version is in test_torch_kernels_cuda.py.

Tolerance: atol 1e-6, the reference's own kernel-against-oracle bound
(tests/test_fail_prob_substrate.py), against the reference's eager jnp
oracle, which divides as the port does.  Against the Pallas kernel the bound
is 1e-6 plus the gap between that kernel and its own oracle on the same
inputs: jit-compiled XLA multiplies by the float32 reciprocal of a constant
divisor and contracts FMAs, which moves t by an ulp and p by more than
1e-6 on some of these inputs (the reference's own test meets 1e-6 at its
one fixed coefficient row).  The kernel's regrouped order (per-row, per-column
and per-mat terms of t computed once) must equal the plain version bit for
bit (``torch.equal``): it keeps every rounding of the plain version.
``fail_prob_rows``' plain version is the plain grid summed by ``torch.sum``
(bit for bit); the row-sum kernel's own order of additions
(``torch_fail_prob_order.py``) stays within 1e-6 of the float64 sum (the
largest row gap over the largest row)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.fail_prob import fail_prob as pallas_fail_prob
from repro_torch.core.geometry import FULL
from repro_torch.core.latency import (PATTERN_STRESS, div_t, fail_mixture_t,
                                      retention_fail_mixture_t)
from repro_torch.core.population import make_population
from repro_torch.core.substrate import (DimmBatch, _geom_consts, _pack_coeffs,
                                        condition_adders)
from repro_torch.core import substrate
from repro_torch.core.geometry import TINY
from repro_torch.core.latency import DEFAULT_PATTERNS
from repro_torch.kernels.fail_prob import (fail_prob, fail_prob_ref, fail_prob_rows,
                                           fail_prob_rows_ref)
from repro_torch.kernels.ops import launch_counts
from torch_fail_prob_order import kernel_order_row_sums

ATOL = 1e-6
COEFFS = np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)


def _inputs(R, M, D=None, seed=3):
    rng = np.random.default_rng(seed)
    shape = (R,) if D is None else (D, R)
    row_src = rng.integers(0, R, shape).astype(np.int32)
    d_mat = np.linspace(0.1, 1.0, M).astype(np.float32)
    cf_shape = (9,) if D is None else (D, 9)
    noise = rng.normal(0, 0.05, cf_shape) * (np.arange(9) < 6)  # t terms only
    coeffs = (COEFFS + noise).astype(np.float32)
    return row_src, d_mat, coeffs


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("R,C,M", [(64, 64, 4), (100, 96, 3), (37, 20, 2)])
@pytest.mark.parametrize("open_bitline", [True, False])
def test_plain_matches_jnp_oracle_and_pallas_interpret(R, C, M, open_bitline):
    row_src, d_mat, coeffs = _inputs(R, M)
    want_ref = np.asarray(jref.fail_prob(row_src, d_mat, coeffs, cols=C,
                                         open_bitline=open_bitline))
    want_pallas = np.asarray(pallas_fail_prob(
        row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline,
        interpret=True))
    got = fail_prob_ref(*_t(row_src, d_mat, coeffs), cols=C,
                        open_bitline=open_bitline).numpy()
    assert got.shape == (M, R, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    ref_gap = float(np.abs(want_pallas - want_ref).max())
    np.testing.assert_allclose(got, want_pallas, atol=ATOL + ref_gap, rtol=0)
    assert (got >= 0).all() and (got <= 1).all()


def test_batched_equals_per_dimm():
    """The DIMM axis the port puts inside the grid gives each DIMM's own
    unbatched grid, bit for bit (the reference vmaps instead)."""
    row_src, d_mat, coeffs = _inputs(48, 3, D=4)
    batched = fail_prob_ref(*_t(row_src, d_mat, coeffs), cols=40)
    assert batched.shape == (4, 3, 48, 40)
    for d in range(4):
        one = fail_prob_ref(*_t(row_src[d], d_mat, coeffs[d]), cols=40)
        torch.testing.assert_close(batched[d], one, rtol=0, atol=0)
        want = np.asarray(jref.fail_prob(row_src[d], d_mat, coeffs[d], cols=40))
        np.testing.assert_allclose(batched[d].numpy(), want, atol=ATOL, rtol=0)


def test_cpu_tensors_dispatch_to_plain_version_without_launching():
    row_src, d_mat, coeffs = _t(*_inputs(32, 2, D=2))
    before = launch_counts()["fail_prob"]
    got = fail_prob(row_src, d_mat, coeffs, cols=32)
    torch.testing.assert_close(got, fail_prob_ref(row_src, d_mat, coeffs,
                                                  cols=32), rtol=0, atol=0)
    assert launch_counts()["fail_prob"] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "mixed"])
def test_wrapper_rejects_bad_inputs(bad):
    row_src, d_mat, coeffs = _t(*_inputs(16, 2, D=2))
    if bad == "dtype":
        coeffs = coeffs.double()
    elif bad == "shape":
        coeffs = coeffs[:, :8]
    elif bad == "device":   # neither cpu nor cuda: no silent route exists
        row_src, d_mat, coeffs = (t.to("meta") for t in (row_src, d_mat, coeffs))
    else:
        row_src = row_src[0]
    with pytest.raises((TypeError, ValueError)):
        fail_prob(row_src, d_mat, coeffs, cols=16)


def regrouped_grid(row_src, d_mat, coeffs, cols, open_bitline=True,
                   voltage=False, retention=False):
    """csrc/fail_prob.cu's order of operations in float32 torch: per row
    A[par] = cf0 + cf1*d_bl[par], P[par] = cf1*d_bl[par] and E = cf4*d_row,
    per column W = cf2*d_wl, per (DIMM, mat) B = cf3*d_mat, then
    t = ((A + W) + B) + E and slow = ((P + W) + B) + E.  (D, R) rows and
    (D, 9 or 15) coefficients; returns (D, M, R, C)."""
    D, R = row_src.shape
    rf = row_src.to(torch.float32)
    cf = [coeffs[:, i] for i in range(coeffs.shape[1])]
    col = lambda x: x[:, None, None, None]                  # noqa: E731
    d_row = div_t(rf, R - 1.0)
    d_odd = div_t((R - 1.0) - rf, R - 1.0) if open_bitline else div_t(rf, R - 1.0)
    par = torch.arange(cols) % 2                              # column parity
    a = torch.stack([cf[0][:, None] + cf[1][:, None] * d_row,
                     cf[0][:, None] + cf[1][:, None] * d_odd], -1)[:, :, par]
    p = torch.stack([cf[1][:, None] * d_row, cf[1][:, None] * d_odd], -1)[:, :, par]
    e = (cf[4][:, None] * d_row)[:, None, :, None]            # (D, 1, R, 1)
    w = (cf[2][:, None] * div_t(torch.arange(cols, dtype=torch.float32),
                                cols - 1.0))[:, None, None, :]
    b = (cf[3][:, None] * d_mat.to(torch.float32))[:, :, None, None]
    t = ((a[:, None] + w) + b) + e
    if voltage:
        t = t + col(cf[9])
    out = fail_mixture_t(t, col(cf[5]), col(cf[6]), col(cf[7]), col(cf[8]))
    if retention:
        slow = ((p[:, None] + w) + b) + e
        out = out + retention_fail_mixture_t(slow, col(cf[10]), col(cf[11]),
                                             col(cf[12]), col(cf[13]),
                                             col(cf[7]), col(cf[14]))
    return out


def full_population_inputs(n_dimms=2):
    """Row sources, mat delays and tRP 7.5 ns coefficient rows of
    ``make_population(FULL, n_dimms)``: chip_smoke.py's phase-2 inputs."""
    batch = DimmBatch.from_population(make_population(FULL, n_dimms), "cpu")
    adder = torch.as_tensor(condition_adders(batch, 85.0, 64.0))
    coeffs = _pack_coeffs(batch, 2, 7.5, PATTERN_STRESS["0101"], adder, 0, 0)
    return (batch, batch.row_src[:, 0].contiguous(),
            torch.as_tensor(_geom_consts(batch.geom)[1]), coeffs)


@pytest.mark.parametrize("open_bitline", [True, False])
def test_kernel_order_equals_plain_at_full_geometry(open_bitline):
    _, row_src, d_mat, coeffs = full_population_inputs()
    got = regrouped_grid(row_src, d_mat, coeffs, 512, open_bitline)
    want = fail_prob_ref(row_src, d_mat, coeffs, cols=512, open_bitline=open_bitline)
    assert got.shape == (2, 16, 512, 512)
    assert torch.equal(got, want)


@pytest.mark.parametrize("D,M,R,C,open_bitline",
                         [(3, 5, 100, 96, True), (1, 1, 33, 5, True),
                          (2, 3, 31, 1000, False), (1, 2, 65, 7, True)])
def test_kernel_order_equals_plain_at_ragged_shapes(D, M, R, C, open_bitline):
    row_src, d_mat, coeffs = _t(*_inputs(R, M, D=D, seed=R + C))
    got = regrouped_grid(row_src, d_mat, coeffs, C, open_bitline)
    want = fail_prob_ref(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    assert torch.equal(got, want)


# ------------------------------------------------ fail_prob_rows: the grid's row sums

RAGGED = [(3, 5, 100, 96, True), (1, 1, 33, 5, True), (2, 3, 31, 1000, False),
          (1, 2, 65, 7, True)]


@pytest.mark.parametrize("D,M,R,C,open_bitline", RAGGED)
def test_rows_plain_is_the_grid_summed(D, M, R, C, open_bitline):
    row_src, d_mat, coeffs = _t(*_inputs(R, M, D=D, seed=R + C))
    before = launch_counts()["fail_prob_rows"]
    got = fail_prob_rows(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    grid = fail_prob_ref(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    assert got.shape == (D, R) and got.dtype == torch.float32
    assert torch.equal(got, grid.sum(dim=(1, 3)))
    assert torch.equal(got, fail_prob_rows_ref(row_src, d_mat, coeffs, cols=C,
                                               open_bitline=open_bitline))
    one = fail_prob_rows(row_src[0], d_mat, coeffs[0], cols=C, open_bitline=open_bitline)
    assert torch.equal(one, grid[0].sum(dim=(0, 2)))
    assert launch_counts()["fail_prob_rows"] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "mixed"])
def test_rows_wrapper_rejects_bad_inputs(bad):
    row_src, d_mat, coeffs = _t(*_inputs(16, 2, D=2))
    if bad == "dtype":
        row_src = row_src.float()
    elif bad == "shape":
        coeffs = torch.cat([coeffs, coeffs[:, :1]], dim=1)
    elif bad == "device":
        row_src, d_mat, coeffs = (t.to("meta") for t in (row_src, d_mat, coeffs))
    else:
        coeffs = coeffs[0]
    with pytest.raises((TypeError, ValueError)):
        fail_prob_rows(row_src, d_mat, coeffs, cols=16)


def _row_gap(got, grid):
    want = grid.double().sum(dim=(1, 3))
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("open_bitline", [True, False])
def test_kernel_row_sum_order_at_full_geometry(open_bitline):
    _, row_src, d_mat, coeffs = full_population_inputs()
    grid = fail_prob_ref(row_src, d_mat, coeffs, cols=512, open_bitline=open_bitline)
    assert _row_gap(kernel_order_row_sums(grid), grid) <= 1e-6
    assert _row_gap(grid.sum(dim=(1, 3)), grid) <= 1e-6


@pytest.mark.parametrize("D,M,R,C,open_bitline", RAGGED)
def test_kernel_row_sum_order_at_ragged_shapes(D, M, R, C, open_bitline):
    row_src, d_mat, coeffs = _t(*_inputs(R, M, D=D, seed=R + C))
    grid = fail_prob_ref(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    assert _row_gap(kernel_order_row_sums(grid), grid) <= 1e-6


def test_row_lambda_sums_rows_without_a_grid(monkeypatch):
    """``row_error_lambda`` takes one ``fail_prob_rows`` call per (subarray,
    pattern) and no grid; on the CPU its lambdas are the grids summed."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fail_prob_rows(*args, **kw)

    def no_grid(*args, **kw):
        raise AssertionError("row_error_lambda asked for a grid")

    batch = DimmBatch.from_population(make_population(TINY, 3), "cpu")
    want = substrate.row_error_lambda(batch, "trp", 7.5, internal_order=True)
    monkeypatch.setattr(substrate, "fail_prob_rows", counted)
    monkeypatch.setattr(substrate, "fail_prob", no_grid)
    got = substrate.row_error_lambda(batch, "trp", 7.5, internal_order=True)
    assert len(calls) == TINY.subarrays * len(DEFAULT_PATTERNS)
    assert all(shape == (3, TINY.rows_per_mat) for shape in calls)
    np.testing.assert_array_equal(got, want)
    adder = torch.as_tensor(condition_adders(batch, 85.0, 64.0))
    d_mat = torch.as_tensor(_geom_consts(TINY)[1])
    lam = torch.zeros((3, TINY.rows_per_mat))
    for stress in DEFAULT_PATTERNS:
        coeffs = _pack_coeffs(batch, 2, 7.5, PATTERN_STRESS[stress], adder, 0, 0)
        grid = fail_prob_ref(batch.row_src[:, 0].contiguous(), d_mat, coeffs,
                             cols=TINY.cols_per_mat)
        lam = lam + 2 * grid.sum(dim=(1, 3)) * TINY.chips
    np.testing.assert_array_equal(got[:, :TINY.rows_per_mat],
                                  (lam * substrate.DEFAULT_ITERS).numpy())
