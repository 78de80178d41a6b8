"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  The file imports nothing of the JAX reference, so it also runs on a
GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: ``fail_prob`` and ``fail_prob_op`` equal their plain versions bit
for bit (``torch.equal``: the kernels keep every rounding of the plain
versions' float32 operations, and their fast divisions give IEEE division's
bits, checked over every operand of their ranges); so does ``rc_transient``,
on its shared-tap and mixed-tap routes and for cells rerun with IEEE
divisions; ``fail_prob_rows`` equals its order of additions run in plain
PyTorch on the card's own grid (``torch_fail_prob_order.py``) bit for bit,
and ``torch.sum``'s row sums within 1e-5 relative (the largest row gap over
the largest row); ``wkv6`` rtol = atol = 3e-4 for float32 inputs and 2e-3 for
float16, the reference's kernel-against-scan bounds (the kernel sums over
the head in another order than the plain version's einsum; the final
state is held to the same bound), also at sequence lengths around its 12-step
chunk and for the serving path's mix of dtypes; ``fail_prob_op`` with both channels off must
equal ``fail_prob`` bit for bit; the SECDED, shuffle, bank_sched and
bit_signature kernels are integer work and must equal their plain versions
exactly.  Every kernel gives the same bits on two launches at shapes its
launch constants do not tile evenly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels.bank_sched import _launch as bank_sched_launch
from repro_torch.kernels.bank_sched import memsim_walk, memsim_walk_ref, walk_route
from repro_torch.kernels.bit_signature import bit_signature, bit_signature_ref
from repro_torch.core.spice import CircuitParams
from repro_torch.kernels.fail_prob import (division_check, fail_prob, fail_prob_op,
                                           fail_prob_op_ref, fail_prob_ref, fail_prob_rows)
from repro_torch.kernels.rc_transient import division_check as rc_division_check
from repro_torch.kernels.rc_transient import (fast_route, launch_divisors, rc_transient,
                                              rc_transient_ref, reset_route_counts,
                                              route_counts)
from repro_torch.kernels.secded import (encode_checks, encode_checks_ref,
                                        syndrome, syndrome_ref)
from repro_torch.kernels.shuffle import _perm_tensor, apply_shuffle, apply_shuffle_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref
from repro_torch.memsim import sim as memsim
from repro_torch.memsys.codec import interleave_permutation
from torch_fail_prob_order import kernel_order_row_sums

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


# shapes at the edges of the kernel's tiling: 32-row tiles, 4 x 128 columns
FP_SHAPES = [(4, 16, 512, 512, True), (3, 5, 100, 96, True), (2, 3, 7, 5, False),
             (1, 1, 33, 5, True), (2, 1, 40, 1000, True), (1, 2, 65, 7, True),
             (2, 3, 31, 1000, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,M,R,C,open_bitline", FP_SHAPES)
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
    assert torch.equal(got, want)
    one = fail_prob(row_src[0], d_mat, coeffs[0], cols=C,
                    open_bitline=open_bitline)
    assert torch.equal(one, want[0])


@pytest.mark.cuda
def test_fail_prob_fast_divisions_give_ieee_bits(cuda):
    sigmas = torch.tensor([1e-6, 0.05, 0.13, 0.15, 0.25, 1.0, 3.7, 2.0 ** 30],
                          device=cuda)
    assert division_check(sigmas) == [0, 0, 0]


@pytest.mark.cuda
def test_fail_prob_rejects_non_contiguous(cuda):
    row_src, d_mat, coeffs = _inputs(2, 3, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fail_prob(row_src[:, ::2], d_mat, coeffs, cols=8)


# the row sums' edges: FULL widths, C not a multiple of 4, R not a multiple
# of any row tile, more columns than the 128 slots' quads, one partial quad
ROW_SHAPES = [(4, 16, 512, 512, True), (3, 5, 100, 94, True), (2, 3, 45, 1000, False),
              (1, 2, 65, 7, True), (2, 1, 40, 3, True)]


def _row_sums_check(row_src, d_mat, coeffs, C, open_bitline):
    """fail_prob_rows against the card's grid summed: the kernel's order bit
    for bit, torch.sum's within 1e-5 of the largest row; a second call and
    each DIMM alone give the same bits.  Returns the row sums."""
    grid = fail_prob(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    before = fail_prob_rows.launches
    got = fail_prob_rows(row_src, d_mat, coeffs, cols=C, open_bitline=open_bitline)
    torch.cuda.synchronize()
    assert fail_prob_rows.launches == before + 1
    assert got.shape == row_src.shape and got.dtype == torch.float32
    want = grid.sum(dim=(1, 3))
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, kernel_order_row_sums(grid))
    assert torch.equal(fail_prob_rows(row_src, d_mat, coeffs, cols=C,
                                      open_bitline=open_bitline), got)
    one = fail_prob_rows(row_src[-1], d_mat, coeffs[-1], cols=C, open_bitline=open_bitline)
    assert torch.equal(one, got[-1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("D,M,R,C,open_bitline", ROW_SHAPES)
def test_fail_prob_rows_kernel_sums_the_grid(cuda, D, M, R, C, open_bitline):
    _row_sums_check(*_inputs(D, M, R, cuda), C, open_bitline)


@pytest.mark.cuda
def test_fail_prob_rows_reruns_rows_outside_the_fast_divisions(cuda):
    """A sigma above the fast divisions' range takes every cell of its DIMM
    through IEEE division; the grid kernel takes the same route."""
    row_src, d_mat, coeffs = _inputs(3, 16, 512, cuda)
    coeffs[1, 6] = 2.0 ** 21
    grid = fail_prob(row_src, d_mat, coeffs, cols=512)
    assert torch.equal(grid, fail_prob_ref(row_src, d_mat, coeffs, cols=512))
    got = _row_sums_check(row_src, d_mat, coeffs, 512, True)
    assert (got[1] > 0).all()


@pytest.mark.cuda
def test_fail_prob_rows_rejects_what_the_kernel_does_not_take(cuda):
    row_src, d_mat, coeffs = _inputs(2, 3, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fail_prob_rows(row_src[:, ::2], d_mat, coeffs, cols=8)
    with pytest.raises(ValueError, match="device"):
        fail_prob_rows(row_src, d_mat.cpu(), coeffs, cols=8)
    with pytest.raises(TypeError):
        fail_prob_rows(row_src, d_mat, coeffs.double(), cols=8)
    with pytest.raises(ValueError):
        fail_prob_rows(row_src, d_mat, coeffs[:, :8], cols=8)


@pytest.mark.cuda
def test_row_error_lambda_launches_fail_prob_rows_alone(cuda):
    from repro_torch.core.geometry import SMALL
    from repro_torch.core.latency import DEFAULT_PATTERNS
    from repro_torch.core.population import make_population
    from repro_torch.core.substrate import DimmBatch, row_error_lambda
    pop = make_population(SMALL, 5)
    rows_before, grid_before = fail_prob_rows.launches, fail_prob.launches
    got = row_error_lambda(DimmBatch.from_population(pop, cuda), "trp", 7.5)
    assert fail_prob_rows.launches == rows_before + SMALL.subarrays * len(DEFAULT_PATTERNS)
    assert fail_prob.launches == grid_before
    want = row_error_lambda(DimmBatch.from_population(pop, "cpu"), "trp", 7.5)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


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


MEMSIM_CONFIGS = {
    "default": memsim.MemSimConfig(),
    "one_channel_one_rank": memsim.MemSimConfig(channels=1, ranks=1),
    "queue4_no_bus": memsim.MemSimConfig(queue=4, bus=False),
    "inorder": memsim.inorder_config(16),
    "queue32": memsim.MemSimConfig(queue=32),
    # the fast kernel walks two traces a warp up to 16 slots, one above
    "queue16": memsim.MemSimConfig(queue=16),
    "queue17": memsim.MemSimConfig(queue=17),
}
MEMSIM_TABLES = [memsim.STANDARD, np.array([8.75, 23.75, 8.75, 6.25]),
                 np.array([[8.75, 23.75, 8.75, 6.25], [10.0, 27.5, 10.0, 7.5],
                           [13.75, 35.0, 13.75, 15.0], [12.5, 30.0, 11.25, 10.0]])]


def _walk_inputs(cfg, n, dev):
    traces = memsim._stack_traces(n, cfg.banks, 0, dev)
    tc = torch.as_tensor(np.stack([memsim.timing_cycles_banks(t, cfg.banks)
                                   for t in MEMSIM_TABLES]), device=dev)
    return traces, tc, memsim._walk_kw(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 33, 700])
@pytest.mark.parametrize("name", sorted(MEMSIM_CONFIGS))
def test_bank_sched_kernel_equals_plain_walk(cuda, name, n):
    """The fast kernel, which the wrapper takes for memsim's traces."""
    traces, tc, kw = _walk_inputs(MEMSIM_CONFIGS[name], n, cuda)
    before = memsim_walk.launches
    fast = memsim_walk.route_launches["fast"]
    lat, hit = memsim_walk(traces, tc, **kw)
    want_lat, want_hit = memsim_walk_ref(traces, tc, **kw)
    torch.cuda.synchronize()
    assert memsim_walk.launches == before + 1
    assert memsim_walk.route_launches["fast"] == fast + 1
    assert lat.shape == (len(MEMSIM_TABLES), len(memsim.WORKLOADS), n)
    assert lat.dtype == hit.dtype == torch.int32
    assert torch.equal(lat, want_lat) and torch.equal(hit, want_hit)


@pytest.mark.cuda
@pytest.mark.parametrize("tables,workloads", [(1, 1), (1, 3), (13, 1)])
@pytest.mark.parametrize("name", ["default", "inorder", "queue32"])
def test_bank_sched_fast_kernel_on_odd_walk_counts(cuda, name, tables, workloads):
    """An odd number of walks leaves half of the last warp without a walk
    of its own: it must store nothing."""
    traces, tc, kw = _walk_inputs(MEMSIM_CONFIGS[name], 100, cuda)
    tr = traces[:workloads].contiguous()
    tcx = tc.repeat(5, 1, 1)[:tables].contiguous()
    got = memsim_walk(tr, tcx, **kw)
    want = memsim_walk_ref(tr, tcx, **kw)
    torch.cuda.synchronize()
    assert got[0].shape[:2] == (tables, workloads)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _general_case(case, dev):
    """Inputs of a case for the general kernel: one decreasing arrival, tied
    arrivals (pairs of requests arriving together), or 40 banks."""
    cfg = memsim.MemSimConfig(banks=40 if case == "banks_40" else 16)
    traces, tc, kw = _walk_inputs(cfg, 400, dev)
    traces = traces.clone()
    if case == "decreasing":
        traces[:, 200, 3] = traces[:, 199, 3] - 7
    if case == "tied":
        traces[:, 1::2, 3] = traces[:, 0::2, 3]
    return traces, tc, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decreasing", "tied", "banks_40"])
def test_bank_sched_general_kernel_equals_plain_walk(cuda, case):
    traces, tc, kw = _general_case(case, cuda)
    want = memsim_walk_ref(traces, tc, **kw)
    route = walk_route(traces, tc.shape[1], kw["ranks"], kw["channels"])
    assert route == ("fast" if case == "tied" else "general")
    before = dict(memsim_walk.route_launches)
    got = memsim_walk(traces, tc, **kw)
    assert memsim_walk.route_launches[route] == before[route] + 1
    forced = bank_sched_launch(traces, tc, kw["queue"], route="general",
                               **{k: v for k, v in kw.items() if k != "queue"})
    torch.cuda.synchronize()
    for run in (got, forced):
        assert all(torch.equal(g, w) for g, w in zip(run, want))


@pytest.mark.cuda
def test_bank_sched_route_launch_counters(cuda):
    """Each route's counter moves with its own launches only, and their sum
    is the wrapper's count."""
    ops.reset_launches()
    traces, tc, kw = _walk_inputs(MEMSIM_CONFIGS["default"], 64, cuda)
    memsim_walk(traces, tc, **kw)
    dec, dec_tc, dec_kw = _general_case("decreasing", cuda)
    memsim_walk(dec, dec_tc, **dec_kw)
    memsim_walk(traces, tc, **kw)
    assert memsim_walk.route_launches == {"fast": 2, "general": 1}
    assert ops.launch_counts()["bank_sched"] == 3
    ops.reset_launches()
    assert memsim_walk.route_launches == {"fast": 0, "general": 0}


@pytest.mark.cuda
def test_bank_sched_population_on_the_card_equals_the_cpu(cuda):
    tables = np.array([[8.75, 23.75, 8.75, 6.25], [11.25, 30.0, 11.25, 12.5]])
    before = memsim_walk.launches
    got = memsim.system_speedup_population(tables, n_requests=300)
    assert memsim_walk.launches == before + 1
    want = memsim.system_speedup_population(tables, n_requests=300,
                                            device="cpu")
    assert np.array_equal(got["total_latency_cycles"],
                          want["total_latency_cycles"])
    assert np.array_equal(got["per_dimm_workload_speedup"],
                          want["per_dimm_workload_speedup"])


@pytest.mark.cuda
def test_bank_sched_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    traces, tc, kw = _walk_inputs(memsim.MemSimConfig(), 64, cuda)
    with pytest.raises(ValueError, match="queue"):
        memsim_walk(traces, tc, **dict(kw, queue=33))
    with pytest.raises(ValueError, match="contiguous"):
        memsim_walk(traces[:, ::2], tc, **kw)
    with pytest.raises(TypeError, match="int32"):
        memsim_walk(traces.long(), tc, **kw)
    with pytest.raises(ValueError, match="cpu"):
        memsim_walk(traces, tc.cpu(), **kw)
    before = memsim_walk.launches
    lat, _ = memsim_walk(traces[:, :0].contiguous(), tc, **kw)
    assert lat.shape == (len(MEMSIM_TABLES), len(memsim.WORKLOADS), 0)
    assert memsim_walk.launches == before


# ------------------------------------------------------------ fail_prob_op

OP_EXTRA = np.array([0.3, 4.0, 0.25, 2.0, 0.25, 1.2], np.float32)


def _op_inputs(D, M, R, dev, seed=3):
    row_src, d_mat, coeffs = _inputs(D, M, R, dev, seed)
    rng = np.random.default_rng(seed + 1)
    extra = OP_EXTRA + rng.normal(0, 0.05, (D, 6)).astype(np.float32)
    return row_src, d_mat, torch.cat(
        [coeffs, torch.as_tensor(extra, device=dev)], dim=1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("voltage,retention",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
@pytest.mark.parametrize("D,M,R,C,open_bitline", FP_SHAPES)
def test_fail_prob_op_kernel_matches_plain_version(cuda, D, M, R, C,
                                                   open_bitline, voltage,
                                                   retention):
    row_src, d_mat, coeffs = _op_inputs(D, M, R, cuda)
    kw = dict(cols=C, open_bitline=open_bitline, voltage=voltage,
              retention=retention)
    before = fail_prob_op.launches
    got = fail_prob_op(row_src, d_mat, coeffs, **kw)
    want = fail_prob_op_ref(row_src, d_mat, coeffs, **kw)
    torch.cuda.synchronize()
    assert fail_prob_op.launches == before + 1
    assert got.shape == (D, M, R, C)
    assert torch.equal(got, want)
    one = fail_prob_op(row_src[0], d_mat, coeffs[0], **kw)
    assert torch.equal(one, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("open_bitline", [True, False])
def test_fail_prob_op_without_channels_is_fail_prob(cuda, open_bitline):
    row_src, d_mat, coeffs = _op_inputs(3, 16, 512, cuda)
    got = fail_prob_op(row_src, d_mat, coeffs, cols=512,
                       open_bitline=open_bitline)
    want = fail_prob(row_src, d_mat, coeffs[:, :9].contiguous(), cols=512,
                     open_bitline=open_bitline)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_fail_prob_op_rejects_what_the_kernel_does_not_take(cuda):
    row_src, d_mat, coeffs = _op_inputs(2, 3, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fail_prob_op(row_src[:, ::2], d_mat, coeffs, cols=8, retention=True)
    with pytest.raises(ValueError, match="15"):
        fail_prob_op(row_src, d_mat, coeffs[:, :9].contiguous(), cols=8)


# ------------------------------------------------------------ bit_signature

def _counts(n, nbits, dev, high=1000, seed=7):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, high, (n, 2 ** nbits)),
                           dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 3, 5, 9, 12, 16])
@pytest.mark.parametrize("n", [1, 31, 768, 4099])
def test_bit_signature_kernel_equals_plain_version(cuda, nbits, n):
    if n * 2 ** nbits > 1 << 26:
        n = (1 << 26) >> nbits
    counts = _counts(n, nbits, cuda)
    before = bit_signature.launches
    got = bit_signature(counts, nbits=nbits)
    want = bit_signature_ref(counts, nbits=nbits)
    torch.cuda.synchronize()
    assert bit_signature.launches == before + 1
    assert got.shape == (n, nbits) and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 9])
def test_bit_signature_unaligned_rows_and_int32_wrap(cuda, nbits):
    big = _counts(65, nbits, cuda, high=2 ** 31 - 1, seed=9)
    flat = torch.cat([big.new_zeros(1), big.reshape(-1)])
    unaligned = flat[1:].view(big.shape)   # starts 4 bytes past an alignment
    assert unaligned.data_ptr() % 16 != 0
    for counts in (big, unaligned):
        assert torch.equal(bit_signature(counts, nbits=nbits),
                           bit_signature_ref(counts, nbits=nbits))
    before = bit_signature.launches
    out = bit_signature(big[:0], nbits=nbits)
    assert out.shape == (0, nbits) and bit_signature.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        bit_signature(big[:, ::2], nbits=nbits - 1)
    with pytest.raises(TypeError, match="int32"):
        bit_signature(big.long(), nbits=nbits)


def _cells(n, dev, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                                 device=dev) for _ in range(2))


RC_CASES = {"default": dict(cp=CircuitParams()),
            "uncharged": dict(cp=CircuitParams(), cell_charged=False),
            "n_seg4_tpre12": dict(cp=CircuitParams(n_seg=4), t_pre_ns=12.0),
            # 16 segments need a shorter step for the Euler stability bound
            "n_seg16": dict(cp=CircuitParams(n_seg=16, dt_ns=0.004),
                            t_total_ns=20.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 130, 100003])
@pytest.mark.parametrize("case", sorted(RC_CASES))
def test_rc_transient_kernel_matches_plain_version(cuda, case, n):
    rf, cf = _cells(n, cuda, seed=n)
    kw = RC_CASES[case]
    before = rc_transient.launches
    got = rc_transient(rf, cf, **kw)
    want = rc_transient_ref(rf, cf, **kw)
    torch.cuda.synchronize()
    assert rc_transient.launches == before + 1
    for k in ("v_probe", "v_cell", "sense_t"):
        assert torch.equal(got[k], want[k]), k
    if kw.get("cell_charged", True) is False:
        assert bool(torch.isinf(got["sense_t"]).all())


def _mat(rows, cols, dev):
    """A sense map's cells in row-major order: 32 consecutive cells share a
    row, and so a tap."""
    r = (np.arange(rows) / (rows - 1)).astype(np.float32)
    c = (np.arange(cols) / (cols - 1)).astype(np.float32)
    return (torch.as_tensor(np.repeat(r, cols), device=dev),
            torch.as_tensor(np.tile(c, rows), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RC_CASES))
def test_rc_transient_shared_tap_route_matches_plain_version(cuda, case):
    """The mat layout: every warp runs the loop instantiated for its tap."""
    rf, cf = _mat(64, 64, cuda)
    kw = RC_CASES[case]
    reset_route_counts(cuda)
    got = rc_transient(rf, cf, **kw)
    routes = route_counts(cuda)
    want = rc_transient_ref(rf, cf, **kw)
    assert routes == {"ieee_cells": 0, "shared_tap_warps": 64 * 64 // 32,
                      "mixed_tap_warps": 0}
    for k in ("v_probe", "v_cell", "sense_t"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_rc_transient_reruns_cells_outside_the_fast_ranges(cuda):
    """A cell whose wordline delay could drive the sigmoid's 1 + e past the
    fast reciprocal's range, and a whole launch whose voltages leave the
    fast divisions' bound, run with IEEE divisions and are counted."""
    rf, cf = _cells(256, cuda, seed=3)
    cf[::5] = 5.0                       # t_wl = 12.5 ns > 32 x 0.3 ns
    reset_route_counts(cuda)
    got = rc_transient(rf, cf)
    assert route_counts(cuda)["ieee_cells"] == len(cf[::5])
    want = rc_transient_ref(rf, cf)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cp = CircuitParams(vdd=2.0 ** 40, v_half=0.6)
    assert not fast_route(cp, 10.0)
    reset_route_counts(cuda)
    got = rc_transient(rf, cf, cp=cp, t_total_ns=10.0)
    assert route_counts(cuda) == {"ieee_cells": 256, "shared_tap_warps": 0,
                                  "mixed_tap_warps": 0}
    want = rc_transient_ref(rf, cf, cp=cp, t_total_ns=10.0)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RC_CASES))
def test_rc_transient_fast_divisions_give_ieee_bits(cuda, case):
    divisors = torch.as_tensor(launch_divisors(RC_CASES[case]["cp"]), device=cuda)
    assert rc_division_check(divisors) == [0, 0]


@pytest.mark.cuda
def test_rc_transient_rejects_what_the_kernel_does_not_take(cuda):
    rf, cf = _cells(64, cuda, seed=1)
    with pytest.raises(ValueError, match="n_seg"):
        rc_transient(rf, cf, cp=CircuitParams(n_seg=5))
    with pytest.raises(ValueError, match="contiguous"):
        rc_transient(torch.stack([rf, cf], dim=1)[:, 0], cf)
    before = rc_transient.launches
    out = rc_transient(rf[:0], cf[:0])
    assert out["sense_t"].shape == (0,) and rc_transient.launches == before
    with pytest.raises(ValueError, match="device"):
        rc_transient(rf, cf.cpu())


# ------------------------------------------------ the slice's paths, card vs CPU

@pytest.mark.cuda
def test_error_summary_and_discovery_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core.geometry import SMALL
    from repro_torch.core.population import make_population
    from repro_torch.core.streaming import stream_error_summary
    from repro_torch.core.substrate import DimmBatch
    from repro_torch.discovery.blind import BlindDiva, campaign_counts
    pop = make_population(SMALL, 6)
    card, cpu = (DimmBatch.from_population(pop, d) for d in (cuda, "cpu"))
    kw = dict(chunk_size=4, vdd=1.20, refresh_ms=256.0, retention=True)
    before = fail_prob_op.launches
    got = stream_error_summary(card, "tras", 25.0, **kw)
    assert fail_prob_op.launches == before + 2
    want = stream_error_summary(cpu, "tras", 25.0, **kw)
    np.testing.assert_allclose(got["lam_stats"]["mean"],
                               want["lam_stats"]["mean"], rtol=1e-5)
    assert np.array_equal(got["lam_max"]["serial"], want["lam_max"]["serial"])
    counts, expected = campaign_counts(pop, card)
    before = bit_signature.launches
    disc = BlindDiva().discover(counts, expected, serials=np.arange(6))
    assert bit_signature.launches == before + 2 * counts.shape[0]
    disc_cpu = BlindDiva().discover(counts, expected, serials=np.arange(6),
                                    device="cpu")
    for f in ("labels", "ext_rows", "ext_to_int", "vuln_rows", "canonical",
              "confidence"):
        assert np.array_equal(getattr(disc, f), getattr(disc_cpu, f)), f


# ------------------------------------------------ wkv6 and the RWKV-6 serving path

WKV6_TOL = {torch.float32: 3e-4, torch.float16: 2e-3}


def _wkv6_inputs(B, S, H, dh, dev, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, w = (torch.as_tensor(rng.normal(0, 0.5, (B, S, H, dh)), dtype=dtype,
                                  device=dev) for _ in range(4))
    u = torch.as_tensor(rng.normal(0, 0.1, (H, dh)), dtype=torch.float32, device=dev)
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh", [(1, 64, 1, 8), (2, 96, 2, 16), (3, 130, 4, 32),
                                      (2, 64, 2, 64), (8, 1, 32, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_kernel_matches_plain_version(cuda, B, S, H, dh, dtype, with_state):
    args = _wkv6_inputs(B, S, H, dh, cuda, dtype, seed=S + dh)
    s0 = None
    if with_state:
        gen = torch.Generator(device=cuda).manual_seed(dh)
        s0 = torch.randn((B, H, dh, dh), generator=gen, device=cuda)
    before = wkv6.launches
    y, s = wkv6(*args, init_state=s0)
    yr, sr = wkv6_ref(*args, init_state=s0)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert y.dtype == s.dtype == torch.float32
    tol = WKV6_TOL[dtype]
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(s, sr, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [11, 12, 13, 25])   # around the kernel's 12-step chunk
@pytest.mark.parametrize("dh", [8, 16, 32, 64])
def test_wkv6_kernel_around_its_chunk_length(cuda, S, dh):
    args = _wkv6_inputs(2, S, 3, dh, cuda, seed=S * dh)
    gen = torch.Generator(device=cuda).manual_seed(S)
    s0 = torch.randn((2, 3, dh, dh), generator=gen, device=cuda)
    y, s = wkv6(*args, init_state=s0)
    yr, sr = wkv6_ref(*args, init_state=s0)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(s, sr, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh", [(8, 1, 32, 64), (2, 100, 4, 64), (3, 37, 2, 16)])
def test_wkv6_kernel_reads_the_serving_dtypes(cuda, B, S, H, dh):
    """r and wlog float32, k and v bfloat16 (the serving path's), read as they
    are and held to the plain version on the same tensors."""
    r, k, v, w, u = _wkv6_inputs(B, S, H, dh, cuda, seed=B + S)
    k, v = k.bfloat16(), v.bfloat16()
    y, s = wkv6(r, k, v, w, u)
    yr, sr = wkv6_ref(r, k, v, w, u)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(s, sr, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_wkv6_start_state_off_16_byte_alignment(cuda):
    args = _wkv6_inputs(2, 5, 2, 64, cuda, seed=9)
    flat = torch.randn(1 + 2 * 2 * 64 * 64, device=cuda)
    s0 = flat[1:].view(2, 2, 64, 64)                  # 4 bytes past an alignment
    assert s0.data_ptr() % 16
    y, s = wkv6(*args, init_state=s0)
    yr, sr = wkv6_ref(*args, init_state=s0)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(s, sr, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_wkv6_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u = _wkv6_inputs(1, 4, 2, 12, cuda)
    with pytest.raises(ValueError, match="dh in"):
        wkv6(r, k, v, w, u)
    r, k, v, w, u = _wkv6_inputs(1, 4, 2, 8, cuda)
    with pytest.raises(ValueError, match="one device"):
        wkv6(r, k, v, w, u.cpu())
    before = wkv6.launches
    y, s = wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    assert y.shape == (1, 0, 2, 8) and not bool(s.any())
    assert wkv6.launches == before
    # a strided view is made contiguous by the wrapper
    y, _ = wkv6(r[:, ::2], k[:, ::2], v[:, ::2], w[:, ::2], u)
    yr, _ = wkv6_ref(r[:, ::2], k[:, ::2], v[:, ::2], w[:, ::2], u)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_rwkv6_serving_on_the_card_equals_the_cpu(cuda):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models import cache, model
    cfg = get_smoke_config("rwkv6-1.6b")
    cpu_params = model.init_params(0, cfg, device="cpu")
    card_params = model.params_to(cpu_params, cuda)
    batch = make_batch(cfg, 2, 16, seed=1, step=0)
    batch["tokens"] = batch["tokens"][:, :-1]
    before = wkv6.launches
    got, _ = generate(cfg, card_params, batch, max_new=5, device=cuda)
    assert wkv6.launches == before + cfg.n_layers * 5
    want, _ = generate(cfg, cpu_params, batch, max_new=5, device="cpu")
    assert torch.equal(got.cpu(), want)
    toks = torch.as_tensor(batch["tokens"])
    lg, _ = cache.prefill(cfg, card_params, {"tokens": toks.to(cuda)})
    lc, _ = cache.prefill(cfg, cpu_params, {"tokens": toks})
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def _ragged_calls(name, dev):
    """Small calls of kernel ``name`` at shapes its launch constants do not
    tile evenly."""
    if name in ("secded_encode", "secded_syndrome"):
        kern, width = (encode_checks, 64) if name == "secded_encode" else (syndrome, 72)
        x = _bits(4099, width, dev)
        return [lambda: kern(x)]
    if name in ("fail_prob", "fail_prob_op", "fail_prob_rows"):
        calls = []
        for D, M, R, C, ob in FP_SHAPES:
            if name in ("fail_prob", "fail_prob_rows"):
                args, kern = _inputs(D, M, R, dev), ops.KERNELS[name]
                calls.append(lambda a=args, C=C, ob=ob, kern=kern:
                             kern(*a, cols=C, open_bitline=ob))
            else:
                args = _op_inputs(D, M, R, dev)
                calls.append(lambda a=args, C=C, ob=ob:
                             fail_prob_op(*a, cols=C, open_bitline=ob, voltage=True,
                                          retention=True))
        return calls
    if name == "bit_signature":
        x = _counts(4099, 9, dev)
        return [lambda: bit_signature(x, nbits=9)]
    if name == "bank_sched":
        calls = []
        for cfg_name, tables in (("default", 3), ("inorder", 1), ("queue32", 2)):
            traces, tc, kw = _walk_inputs(MEMSIM_CONFIGS[cfg_name], 33, dev)
            calls.append(lambda t=traces[:1], c=tc[:tables], kw=kw:
                         memsim_walk(t, c, **kw))
        return calls
    if name == "diva_shuffle":
        x = _bits(1003, 576, dev)
        return [lambda: apply_shuffle(x),
                lambda: apply_shuffle(x, inverse=True)]
    if name == "rc_transient":
        cells = _cells(130, dev, seed=3)
        return [lambda: rc_transient(*cells)]
    if name == "wkv6":
        calls = []
        for B, S, H, dh in ((2, 13, 3, 64), (1, 13, 2, 8), (2, 9, 2, 16), (1, 1, 2, 32)):
            args = _wkv6_inputs(B, S, H, dh, dev, seed=S + dh)
            calls.append(lambda a=args: wkv6(*a))
        return calls
    if name == "adamw":
        from repro_torch.kernels.adamw import adamw_update
        calls = []
        for dtype, shapes in ((torch.float32, ((3, 5, 7), (1001,), (64, 4099))),
                              (torch.bfloat16, ((2, 3, 33), (5,)))):
            gen = torch.Generator(device=dev).manual_seed(len(shapes))
            leaves = [[torch.randn(sh, generator=gen, device=dev) * 1e-2 for sh in shapes]
                      for _ in range(4)]
            leaves[0] = [g.to(dtype) for g in leaves[0]]
            leaves[3] = [p.to(dtype) for p in leaves[3]]
            leaves[2] = [v.square() for v in leaves[2]]
            rates = [torch.tensor(x, device=dev) for x in (3e-3, 0.271, 0.1426, 0.37)]
            calls.append(lambda a=(*leaves, *rates): adamw_update(*a))
        return calls
    from repro_torch.kernels.wkv6 import wkv6_bwd
    args = _wkv6_inputs(2, 9, 3, 64, dev, seed=4)
    dy = torch.randn(args[0].shape, device=dev)
    return [lambda: wkv6_bwd(*args, None, dy)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ops.KERNELS))
def test_every_kernel_repeats_its_bits_at_ragged_shapes(cuda, name):
    """Each kernel's output depends on its inputs alone: two launches at a
    shape its launch constants do not tile evenly give the same bits."""
    for call in _ragged_calls(name, cuda):
        assert ops.same_bits(call(), call()), name
