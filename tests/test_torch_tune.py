"""The port's launch tuner against the reference's tile tuner.

Each comparison runs the same call sequence through both: the reference as
its own tests drive it (``REPRO_AUTOTUNE=1``,
``force_backend("cpu-pallas-interpret")``), the port on CPU tensors, where
the opt-in sweep runs the plain version for every setting.  Parity on:
``bucket_pow2``; one sweep per bucket (100, 100 and 97 rows: one sweep,
the counter moved by the same amount on both sides); no sweep without the
opt-in, and none under a trace (the reference's ``jax.jit``; the port's
fake tensors and ``WorkCounter``); the JSON cache's key format, each side
loading the other's file; a missing file loads 0.  Then the port's own
rules: a setting whose output differs raises, a refused launch is a skip
unless it is the default's, and an explicit ``launch=`` never sweeps."""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs
from repro.kernels import ops as ref_ops
from repro.kernels import tune as ref_tune
from repro_torch import obs
from repro_torch.counting import WorkCounter, fake_mode
from repro_torch.kernels import registry, tune
from repro_torch.kernels.build import LaunchError
from repro_torch.kernels.secded import syndrome, syndrome_ref
from repro_torch.kernels.wkv6 import wkv6

RNG = np.random.default_rng(0)
REF_TAG, PORT_TAG = "cpu-pallas-interpret", "cpu-plain"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_FORCE_REF", raising=False)
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    tune.clear()
    ref_tune.clear()
    yield
    tune.clear()
    ref_tune.clear()


def _ref_sweeps(kernel="secded_syndrome"):
    return int(ref_obs.REGISTRY.value("repro_kernel_tune_total", kernel=kernel,
                                      backend=REF_TAG))


def _sweeps(kernel="secded_syndrome"):
    return int(obs.REGISTRY.value("repro_kernel_tune_total", kernel=kernel,
                                  backend=PORT_TAG))


def _codes(*rows):
    code = RNG.integers(0, 2, (max(rows), 72)).astype(np.int32)
    return [code[:n] for n in rows]


def test_bucket_pow2_equals_the_references():
    ns = [0, 1, 2, 3, 5, 64, 97, 100, 128, 129, 1000003, 3 * 2 ** 40]
    assert [tune.bucket_pow2(n) for n in ns] == [ref_tune.bucket_pow2(n) for n in ns]


def test_syndrome_sweeps_once_per_bucket_like_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    codes = _codes(100, 100, 97)
    ref_before = _ref_sweeps()
    with ref_ops.force_backend(REF_TAG):
        ref_out = [np.asarray(ref_ops.secded_syndrome(c)) for c in codes]
    port_before = _sweeps()
    port_out = [syndrome(torch.from_numpy(c)) for c in codes]
    assert _sweeps() - port_before == _ref_sweeps() - ref_before == 1
    bucket = tune.bucket_pow2(100)
    assert bucket == ref_tune.bucket_pow2(100) == 128
    win = tune.lookup("secded_syndrome", PORT_TAG, bucket)
    assert win in registry.REGISTRY["secded_syndrome"].launch_space
    assert ref_tune.lookup("secded_syndrome", REF_TAG, bucket) is not None
    for got, want in zip(port_out, ref_out):
        np.testing.assert_array_equal(got.numpy(), want)


def test_no_sweep_without_the_opt_in_on_either_side():
    (code,) = _codes(32)
    ref_before, port_before = _ref_sweeps(), _sweeps()
    with ref_ops.force_backend(REF_TAG):
        ref_ops.secded_syndrome(code)
    syndrome(torch.from_numpy(code))
    assert _ref_sweeps() == ref_before and _sweeps() == port_before
    assert tune.lookup("secded_syndrome", PORT_TAG, tune.bucket_pow2(32)) is None


def test_no_sweep_under_a_trace_on_either_side(monkeypatch):
    """The reference's jit trace; the port's fake tensors (one wkv6 call in
    counting's fake mode) and WorkCounter (real CPU tensors under it)."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    (code,) = _codes(64)
    ref_before = _ref_sweeps()
    with ref_ops.force_backend(REF_TAG):
        jax.jit(lambda c: ref_ops.secded_syndrome(c))(code)
    assert _ref_sweeps() == ref_before
    wkv_before = _sweeps("wkv6")
    with fake_mode():
        r = torch.empty((2, 5, 3, 8))
        y, s = wkv6(r, r, r, r, torch.empty((3, 8)))
    assert y.shape == (2, 5, 3, 8) and s.shape == (2, 3, 8, 8)
    port_before = _sweeps()
    x = torch.from_numpy(code)
    with WorkCounter(track_memory=False):
        got = syndrome(x)
        wkv6(*(torch.ones((1, 4, 2, 8)) for _ in range(4)), torch.ones((2, 8)))
    assert _sweeps() == port_before and _sweeps("wkv6") == wkv_before
    assert tune.lookup("secded_syndrome", PORT_TAG, tune.bucket_pow2(64)) is None
    assert torch.equal(got, syndrome_ref(x))


def test_save_load_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    (code,) = _codes(40)
    syndrome(torch.from_numpy(code))
    bucket = tune.bucket_pow2(40)
    win = tune.lookup("secded_syndrome", PORT_TAG, bucket)
    assert win is not None
    path = tune.save_cache(tmp_path / "TUNE_kernels.json")
    assert list(json.loads(path.read_text())) == [f"secded_syndrome|{PORT_TAG}|{bucket}"]
    tune.clear()
    assert tune.lookup("secded_syndrome", PORT_TAG, bucket) is None
    assert tune.load_cache(path) == 1
    assert tune.lookup("secded_syndrome", PORT_TAG, bucket) == win
    before = _sweeps()
    syndrome(torch.from_numpy(code))                 # the loaded winner: no sweep
    assert _sweeps() == before


def test_each_side_loads_the_others_file(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    (code,) = _codes(40)
    bucket = tune.bucket_pow2(40)
    with ref_ops.force_backend(REF_TAG):
        ref_ops.secded_syndrome(code)
    ref_win = ref_tune.lookup("secded_syndrome", REF_TAG, bucket)
    syndrome(torch.from_numpy(code))
    port_win = tune.lookup("secded_syndrome", PORT_TAG, bucket)
    ref_path = ref_tune.save_cache(tmp_path / "ref.json")
    port_path = tune.save_cache(tmp_path / "port.json")
    assert set(json.loads(ref_path.read_text())) == {f"secded_syndrome|{REF_TAG}|{bucket}"}
    tune.clear()
    ref_tune.clear()
    assert tune.load_cache(ref_path) == 1 and ref_tune.load_cache(port_path) == 1
    assert tune.lookup("secded_syndrome", REF_TAG, bucket) == ref_win
    assert ref_tune.lookup("secded_syndrome", PORT_TAG, bucket) == port_win


def test_a_missing_file_loads_zero_on_either_side(tmp_path):
    assert tune.load_cache(tmp_path / "absent.json") == 0
    assert ref_tune.load_cache(tmp_path / "absent.json") == 0


@pytest.fixture
def stand_in(monkeypatch):
    """A kernel spec whose run(setting) is given by the test."""
    spec = registry.KernelSpec("stand_in", syndrome, "syndrome_ref", defaults={"k": 0},
                               launch_space=({}, {"k": 1}, {"k": 2}))
    monkeypatch.setitem(registry.REGISTRY, "stand_in", spec)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    return spec


def test_a_setting_with_other_bits_raises(stand_in):
    x = torch.zeros(8, dtype=torch.int32)
    run = lambda setting: x + (setting["k"] == 2)   # k = 2 flips a bit
    with pytest.raises(tune.SettingMismatch, match="other bits"):
        tune.get_launch("stand_in", (x,), {}, run)
    assert tune.lookup("stand_in", PORT_TAG, 8) is None


def test_a_refused_launch_is_a_skip_but_not_for_the_default(stand_in):
    x = torch.zeros(8, dtype=torch.int32)

    def refuse(k):
        def run(setting):
            if setting["k"] == k:
                raise LaunchError("stand-in: CUDA error 9")
            return x.clone()
        return run

    before = _sweeps("stand_in")
    assert tune.get_launch("stand_in", (x,), {}, refuse(1))["k"] in (0, 2)
    assert _sweeps("stand_in") == before + 1
    tune.clear()
    with pytest.raises(LaunchError):
        tune.get_launch("stand_in", (x,), {}, refuse(0))


def test_an_explicit_launch_never_sweeps(stand_in):
    x = torch.zeros(8, dtype=torch.int32)
    calls = []
    run = lambda setting: calls.append(setting) or x
    assert tune.resolve("stand_in", {"k": 2}, (x,), {}, run) == {"k": 2}
    assert calls == [] and tune.lookup("stand_in", PORT_TAG, 8) is None
    with pytest.raises(ValueError, match="outside its space"):
        tune.resolve("stand_in", {"k": 5}, (x,), {}, run)


def test_an_empty_call_is_not_tuned(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    before = _sweeps()
    out = syndrome(torch.zeros((0, 72), dtype=torch.int32))
    assert out.shape == (0, 8) and _sweeps() == before
