"""The port's kernel inventory against the reference's registry, and what
every wrapper does apart from its kernel.

``repro_torch.kernels.ops.KERNELS`` lists the reference's nine dispatch
sites, in its order, plus ``wkv6_bwd``, ``fail_prob_rows`` and ``adamw``:
twelve kernels, and ``COUNTED`` adds ``grad_sq_norm``.  For each wrapper: on
the CPU it gives its plain version's bits, and for an empty call the plain
version's empty outputs, launching nothing; a tensor on a device other than
cpu or cuda raises; no wrapper takes a launch setting (each kernel launches
at the constants of its ``csrc/*.cu`` source).  On fake tensors (the dry
run) the wrappers the dry run reaches return their outputs' shapes without
running the plain version, and launch nothing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import registry as ref_registry
from repro_torch.core.spice import CircuitParams
from repro_torch.counting import fake_mode
from repro_torch.kernels import ops
from repro_torch.kernels.adamw import adamw_update_ref, grad_sq_norm_ref
from repro_torch.kernels.bank_sched import memsim_walk_ref
from repro_torch.kernels.bit_signature import bit_signature_ref
from repro_torch.kernels.fail_prob import fail_prob_op_ref, fail_prob_ref, fail_prob_rows_ref
from repro_torch.kernels.rc_transient import rc_transient_ref
from repro_torch.kernels.secded import encode_checks_ref, syndrome_ref
from repro_torch.kernels.shuffle import _perm_tensor, apply_shuffle_ref, shuffle_permutation
from repro_torch.kernels.wkv6 import wkv6_bwd_ref, wkv6_ref
from repro_torch.memsim import sim as memsim

KERNEL_NAMES = tuple(ops.KERNELS)
WRAPPERS = tuple(ops.COUNTED)
RNG_SEED = 0
COEFFS = np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)
OP_EXTRA = np.array([0.3, 4.0, 0.25, 2.0, 0.25, 1.2], np.float32)
# a short circuit run: 200 Euler steps of the plain version's eager loop
RC_KW = dict(cp=CircuitParams(), t_total_ns=2.0, t_pre_ns=1.5)
PLAIN = {"secded_encode": encode_checks_ref, "secded_syndrome": syndrome_ref,
         "fail_prob": fail_prob_ref, "fail_prob_op": fail_prob_op_ref,
         "bit_signature": bit_signature_ref, "bank_sched": memsim_walk_ref,
         "diva_shuffle": apply_shuffle_ref, "rc_transient": rc_transient_ref,
         "wkv6": wkv6_ref, "wkv6_bwd": wkv6_bwd_ref, "fail_prob_rows": fail_prob_rows_ref,
         "adamw": adamw_update_ref, "grad_sq_norm": grad_sq_norm_ref}


def test_names_are_the_reference_sites_then_wkv6_bwd():
    assert KERNEL_NAMES == ref_registry.KERNEL_NAMES + ("wkv6_bwd", "fail_prob_rows",
                                                        "adamw")
    assert len(KERNEL_NAMES) == 12
    assert WRAPPERS == KERNEL_NAMES + ("grad_sq_norm",)
    assert all(PLAIN[n].__module__ == ops.COUNTED[n].__module__ for n in WRAPPERS)


def _args(name, rows: int = 37, steps: int = 3):
    """(args, kw) of one small CPU call of wrapper ``name`` (``rows``: the
    leading extent, 0 for an empty call; ``steps``: wkv6's sequence)."""
    rng = np.random.default_rng(RNG_SEED)
    t = torch.as_tensor
    if name in ("secded_encode", "secded_syndrome", "diva_shuffle"):
        width = {"secded_encode": 64, "secded_syndrome": 72, "diva_shuffle": 576}[name]
        return (t(rng.integers(0, 2, (rows, width)), dtype=torch.int32),), {}
    if name in ("fail_prob", "fail_prob_op", "fail_prob_rows"):
        D = min(rows, 2)
        row_src = t(rng.integers(0, 20, (D, 20)), dtype=torch.int32)
        d_mat = t(np.linspace(0.1, 1.0, 3, dtype=np.float32))
        cf = COEFFS + rng.normal(0, 0.05, (D, 9)).astype(np.float32) * (np.arange(9) < 6)
        kw = dict(cols=10)
        if name == "fail_prob_op":
            cf = np.concatenate([cf, np.tile(OP_EXTRA, (D, 1))], axis=1)
            kw.update(voltage=True, retention=True)
        return (row_src, d_mat, t(cf.astype(np.float32))), kw
    if name == "bit_signature":
        return (t(rng.integers(0, 1000, (min(rows, 5), 16)), dtype=torch.int32),), dict(nbits=4)
    if name == "bank_sched":
        traces = memsim._stack_traces(6, 16, 0, "cpu")[:min(rows, 2)]
        tc = torch.as_tensor(memsim.timing_cycles_banks(memsim.STANDARD, 16))[None]
        return (traces, tc), memsim._walk_kw(memsim.MemSimConfig())
    if name == "rc_transient":
        return tuple(t(rng.uniform(0, 1, min(rows, 3)).astype(np.float32))
                     for _ in range(2)), RC_KW
    if name in ("adamw", "grad_sq_norm"):
        shapes = ((3, 5), (7,), (2, 3, 2)) if rows else ((0, 5),)
        grads, ms, vs, ps = ([t(rng.normal(0, 0.1, sh).astype(np.float32)) for sh in shapes]
                             for _ in range(4))
        if name == "grad_sq_norm":
            return (grads, 1.0), {}
        return (grads, ms, [v.abs() for v in vs], ps, 1e-2, t(0.271), t(0.0975), t(0.5)), {}
    S = steps if rows else 0
    r, k, v, w = (t(rng.normal(0, 0.5, (1, S, 2, 8)).astype(np.float32)) for _ in range(4))
    u = t(rng.normal(0, 0.1, (2, 8)).astype(np.float32))
    if name == "wkv6":
        return (r, k, v, w, u), {}
    return (r, k, v, w, u, None, t(rng.normal(0, 1, (1, S, 2, 8)).astype(np.float32))), {}


def _plain(name, args, kw):
    """The plain version's output for the wrapper's arguments."""
    if name == "diva_shuffle":
        index = _perm_tensor(shuffle_permutation(True).tobytes(), False, torch.device("cpu"))
        return apply_shuffle_ref(args[0], index)
    return PLAIN[name](*args, **kw)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_every_setting_gives_the_plain_bits_on_the_cpu(name):
    args, kw = _args(name)
    assert ops.same_bits(ops.KERNELS[name](*args, **kw), _plain(name, args, kw)), name


@pytest.mark.parametrize("name", WRAPPERS)
def test_an_empty_call_gives_the_plain_empty_outputs_and_launches_nothing(name):
    args, kw = _args(name, rows=0)
    before = ops.launch_counts()
    got = ops.COUNTED[name](*args, **kw)
    assert ops.same_bits(got, _plain(name, args, kw)), name
    assert ops.launch_counts() == before


def _map(tree, fn):
    """``fn`` of every tensor of the (nested) arguments ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn) for x in tree)
    return tree


@pytest.mark.parametrize("name", WRAPPERS)
def test_a_tensor_on_another_device_raises(name):
    args, kw = _args(name)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.COUNTED[name](*_map(args, lambda t: t.to("meta")), **kw)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_no_wrapper_takes_a_launch_setting(name):
    args, kw = _args(name)
    with pytest.raises(TypeError, match="launch"):
        ops.COUNTED[name](*args, **kw, launch={})


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [z for y in x for z in _flat(y)]
    return [x]


@pytest.mark.parametrize("name", ["wkv6", "wkv6_bwd", "adamw", "grad_sq_norm"])
def test_fake_tensors_take_the_kernel_path_to_their_shapes(name, monkeypatch):
    """The dry run's route: on fake tensors each wrapper returns outputs of the
    plain version's shapes and dtypes without running the plain version, and
    launches nothing."""
    args, kw = _args(name, steps=13)
    want = _plain(name, args, kw)

    def plain_run(*a, **k):
        raise AssertionError(f"{name}: the plain version ran on fake tensors")
    monkeypatch.setattr(f"{PLAIN[name].__module__}.{PLAIN[name].__name__}", plain_run)
    before = ops.launch_counts()
    with fake_mode():
        got = ops.COUNTED[name](*_map(args, lambda t: torch.empty(t.shape, dtype=t.dtype)),
                                 **kw)
    assert ops.launch_counts() == before
    pairs = list(zip(_flat(got), _flat(want), strict=True))
    assert pairs
    for g, w in pairs:
        assert (g is None) == (w is None), name
        if w is not None:
            assert (g.shape, g.dtype) == (w.shape, w.dtype), name
