"""The port's kernel registry against the reference's.

``repro_torch.kernels.registry`` lists the reference's nine dispatch sites,
in its order, plus ``wkv6_bwd``, ``fail_prob_rows`` and ``adamw``: twelve
kernels; every launch space starts with ``{}`` (the
kernels' constants) and holds at most 4 settings; each kernel with a
counterpart buckets a call as the reference buckets the same shapes (inputs
made with numpy from a seed, handed to both); ``launch=`` outside a space
raises, on the CPU too; and on the CPU every setting runs the plain version
and gives its bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import registry as ref_registry
from repro_torch.core.spice import CircuitParams
from repro_torch.kernels import ops, tune
from repro_torch.kernels.registry import KERNEL_NAMES, REGISTRY
from repro_torch.memsim import sim as memsim

RNG_SEED = 0
COEFFS = np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)
OP_EXTRA = np.array([0.3, 4.0, 0.25, 2.0, 0.25, 1.2], np.float32)
# a short circuit run: 200 Euler steps of the plain version's eager loop
RC_KW = dict(cp=CircuitParams(), t_total_ns=2.0, t_pre_ns=1.5)


@pytest.fixture(autouse=True)
def _no_opt_in(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    tune.clear()
    yield
    tune.clear()


def test_names_are_the_reference_sites_then_wkv6_bwd():
    assert KERNEL_NAMES == ref_registry.KERNEL_NAMES + ("wkv6_bwd", "fail_prob_rows",
                                                        "adamw")
    assert len(KERNEL_NAMES) == 12
    assert list(ops.KERNELS) == list(KERNEL_NAMES)
    assert all(ops.KERNELS[n] is REGISTRY[n].kernel for n in KERNEL_NAMES)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_every_space_starts_with_the_defaults(name):
    spec = REGISTRY[name]
    assert spec.launch_space[0] == {} and 1 <= len(spec.launch_space) <= 4
    assert spec.setting(None) == spec.setting({}) == spec.defaults
    settings = [spec.setting(s) for s in spec.launch_space]
    assert len({tuple(sorted(s.items())) for s in settings}) == len(settings)
    assert spec.plain.__name__ == spec.ref


# (port args, reference args) of one call: numpy from a seed, torch for the
# port, the same arrays for the reference (its buckets read shapes)
def _bucket_args(name, rng):
    if name in ("secded_encode", "secded_syndrome", "diva_shuffle"):
        width = {"secded_encode": 64, "secded_syndrome": 72, "diva_shuffle": 576}[name]
        x = rng.integers(0, 2, (137, width)).astype(np.int32)
        return [((x,), (x,))]
    if name in ("fail_prob", "fail_prob_op"):
        n = 9 if name == "fail_prob" else 15
        rows, d_mat = rng.integers(0, 100, (3, 100)).astype(np.int32), np.ones(5, np.float32)
        cf = np.ones((3, n), np.float32)
        # the port takes the population in one call, the reference one DIMM
        return [((rows, d_mat, cf), (rows[0], d_mat, cf[0])),
                ((rows[0], d_mat, cf[0]), (rows[0], d_mat, cf[0]))]
    if name == "bit_signature":
        x = rng.integers(0, 1000, (70, 512)).astype(np.int32)
        return [((x,), (x,))]
    if name == "rc_transient":
        x = rng.uniform(0, 1, 1000).astype(np.float32)
        return [((x, x), (x, x))]
    if name == "wkv6":
        x = rng.normal(0, 1, (2, 13, 3, 8)).astype(np.float32)
        return [((x, x, x, x, x[0, 0]), (x, x, x, x, x[0, 0]))]
    raise KeyError(name)


@pytest.mark.parametrize("name", [n for n in KERNEL_NAMES
                                  if n not in ("bank_sched", "wkv6_bwd",
                                               "fail_prob_rows", "adamw")])
def test_buckets_equal_the_references(name):
    rng = np.random.default_rng(RNG_SEED)
    for port_args, ref_args in _bucket_args(name, rng):
        got = REGISTRY[name].bucket(tuple(torch.from_numpy(a) for a in port_args), {})
        want = ref_registry.REGISTRY[name].bucket(ref_args, {})
        assert got == want, (name, got, want)
        assert tune.bucket_pow2(got) == tune.bucket_pow2(want)


def test_buckets_without_a_counterpart():
    traces, tc = torch.zeros((12, 7, 4), dtype=torch.int32), torch.zeros((5, 16, 6))
    assert REGISTRY["bank_sched"].bucket((traces, tc), {}) == 60          # T * W walks
    r = torch.zeros((2, 13, 3, 8))
    assert REGISTRY["wkv6_bwd"].bucket((r,), {}) == 2 * 3 * 13            # B * H * S
    rows, d_mat, cf = torch.zeros((3, 100), dtype=torch.int32), torch.ones(5), torch.ones((3, 9))
    assert REGISTRY["fail_prob_rows"].bucket((rows, d_mat, cf), {}) == 100   # R, as fail_prob
    leaves = (torch.zeros((3, 5)), torch.zeros(7), torch.zeros((2, 2, 2)))
    assert REGISTRY["adamw"].bucket(leaves, {}) == 30                     # the leaves' elements


def _calls(name):
    """(kernel(launch), plain()) of one small CPU call of ``name``."""
    rng = np.random.default_rng(RNG_SEED)
    t = torch.as_tensor
    spec = REGISTRY[name]
    if name in ("secded_encode", "secded_syndrome", "diva_shuffle"):
        width = {"secded_encode": 64, "secded_syndrome": 72, "diva_shuffle": 576}[name]
        x = t(rng.integers(0, 2, (37, width)), dtype=torch.int32)
        if name == "diva_shuffle":
            from repro_torch.kernels.shuffle import _perm_tensor, shuffle_permutation
            index = _perm_tensor(shuffle_permutation(True).tobytes(), False,
                                 torch.device("cpu"))
            return lambda lc: spec.kernel(x, launch=lc), lambda: spec.plain(x, index)
        return lambda lc: spec.kernel(x, launch=lc), lambda: spec.plain(x)
    if name in ("fail_prob", "fail_prob_op", "fail_prob_rows"):
        rows = t(rng.integers(0, 20, (2, 20)), dtype=torch.int32)
        d_mat = t(np.linspace(0.1, 1.0, 3, dtype=np.float32))
        cf = COEFFS + rng.normal(0, 0.05, (2, 9)).astype(np.float32) * (np.arange(9) < 6)
        kw = dict(cols=10)
        if name == "fail_prob_op":
            cf = np.concatenate([cf, np.tile(OP_EXTRA, (2, 1))], axis=1)
            kw.update(voltage=True, retention=True)
        cf = t(cf.astype(np.float32))
        return (lambda lc: spec.kernel(rows, d_mat, cf, **kw, launch=lc),
                lambda: spec.plain(rows, d_mat, cf, **kw))
    if name == "bit_signature":
        x = t(rng.integers(0, 1000, (5, 16)), dtype=torch.int32)
        return (lambda lc: spec.kernel(x, nbits=4, launch=lc),
                lambda: spec.plain(x, nbits=4))
    if name == "bank_sched":
        traces = memsim._stack_traces(6, 16, 0, "cpu")[:2]
        tc = torch.as_tensor(memsim.timing_cycles_banks(memsim.STANDARD, 16))[None]
        kw = memsim._walk_kw(memsim.MemSimConfig())
        return (lambda lc: spec.kernel(traces, tc, **kw, launch=lc),
                lambda: spec.plain(traces, tc, **kw))
    if name == "rc_transient":
        rf, cf = (t(rng.uniform(0, 1, 3).astype(np.float32)) for _ in range(2))
        return (lambda lc: spec.kernel(rf, cf, **RC_KW, launch=lc),
                lambda: spec.plain(rf, cf, **RC_KW))
    if name == "adamw":
        shapes = ((3, 5), (7,), (2, 3, 2))
        grads, ms, vs, ps = ([t(rng.normal(0, 0.1, sh).astype(np.float32)) for sh in shapes]
                             for _ in range(4))
        vs = [v.abs() for v in vs]
        args = (grads, ms, vs, ps, 1e-2, t(0.271), t(0.0975), t(0.5))
        return lambda lc: spec.kernel(*args, launch=lc), lambda: spec.plain(*args)
    r, k, v, w = (t(rng.normal(0, 0.5, (1, 3, 2, 8)).astype(np.float32)) for _ in range(4))
    u = t(rng.normal(0, 0.1, (2, 8)).astype(np.float32))
    if name == "wkv6":
        return lambda lc: spec.kernel(r, k, v, w, u, launch=lc), lambda: spec.plain(r, k, v, w, u)
    dy = t(rng.normal(0, 1, (1, 3, 2, 8)).astype(np.float32))
    return (lambda lc: spec.kernel(r, k, v, w, u, None, dy, launch=lc),
            lambda: spec.plain(r, k, v, w, u, None, dy))


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_launch_outside_the_space_raises(name):
    spec = REGISTRY[name]
    kernel, _ = _calls(name)
    with pytest.raises(ValueError, match="no launch constant"):
        kernel({"no_such_constant": 1})
    key = next(iter(spec.defaults))
    with pytest.raises(ValueError, match="outside its space"):
        kernel({key: 3})                      # no space holds 3 of anything
    assert spec.setting(dict(spec.defaults)) == spec.defaults   # the defaults by name


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_every_setting_gives_the_plain_bits_on_the_cpu(name):
    kernel, plain = _calls(name)
    want = plain()
    for setting in (None, *REGISTRY[name].launch_space):
        assert tune.same_bits(kernel(setting), want), (name, setting)
