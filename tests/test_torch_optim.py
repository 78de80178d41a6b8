"""The port's optimizers and schedules (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same trees: values and states.

Tolerances: the schedules within rtol 1e-6 (float32 cos/pow, an ulp apart at
most), exactly 0 at step 0; the optimizers' parameters and states within
rtol = atol = 1e-6 over five updates (float32, the reference's order of
operations; only ``sqrt``/``rsqrt``/``pow`` and the sums of means may round
differently); the global norm within rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.optim import optimizers as ref_opt
from repro.optim import schedule as ref_sched
from repro_torch.optim import clip as port_clip
from repro_torch.optim import optimizers as port_opt
from repro_torch.optim import schedule as port_sched
from repro_torch.tree import tree_leaves

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"w": rng.normal(0, scale, (4, 6)).astype(np.float32),
            "b": rng.normal(0, scale, (6,)).astype(np.float32),
            "stack": {"x": rng.normal(0, scale, (2, 3, 5)).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(port, ref, tol=TOL):
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_port = tree_leaves(port)
    assert len(flat_ref) == len(flat_port)
    for (path, want), got in zip(flat_ref, flat_port):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), jax.tree_util.keystr(path)
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=tol, atol=tol, err_msg=jax.tree_util.keystr(path))


def test_warmup_cosine_matches_reference_and_starts_at_zero():
    ref = ref_sched.linear_warmup_cosine(3e-4, 100, 10_000)
    port = port_sched.linear_warmup_cosine(3e-4, 100, 10_000)
    steps = np.arange(0, 12_000, 37, dtype=np.int32)
    want = np.array([float(ref(jnp.asarray(s))) for s in steps], np.float32)
    got = np.array([float(port(torch.tensor(int(s), dtype=torch.int32))) for s in steps],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    assert float(port(0)) == 0.0 and port(torch.tensor(0)).dtype == torch.float32


def test_cosine_schedule_matches_reference():
    ref = ref_sched.cosine_schedule(1e-3, 200, min_frac=0.2)
    port = port_sched.cosine_schedule(1e-3, 200, min_frac=0.2)
    for s in (0, 1, 50, 199, 200, 500):
        np.testing.assert_allclose(float(port(s)), float(ref(jnp.asarray(s))), rtol=TOL)


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}),
    ("adafactor", {"momentum": True, "weight_decay": 0.01}),
    ("sgd_momentum", {}),
])
def test_optimizer_matches_reference_over_five_updates(name, kw):
    rng = np.random.default_rng(len(name) + len(kw))
    params = _tree(rng)
    ref, port = getattr(ref_opt, name)(**kw), getattr(port_opt, name)(**kw)
    rp, rs = jax.tree.map(jnp.asarray, params), None
    pp = _to_torch(params)
    rs, ps = ref.init(rp), port.init(pp)
    _assert_trees_close(ps, rs)
    for i, lr in enumerate((1e-2, 3e-3, 0.0, 5e-2, 1e-3)):
        grads = _tree(rng, scale=0.1 * (i + 1))
        rp, rs = ref.update(jax.tree.map(jnp.asarray, grads), rs, rp, lr)
        pp, ps = port.update(_to_torch(grads), ps, pp, torch.tensor(lr, dtype=torch.float32))
    _assert_trees_close(pp, rp)
    _assert_trees_close(ps, rs)


def test_update_leaves_its_arguments_untouched():
    rng = np.random.default_rng(0)
    params, grads = _to_torch(_tree(rng)), _to_torch(_tree(rng))
    opt = port_opt.adamw()
    state = opt.init(params)
    before = [t.clone() for t in tree_leaves({"p": params, "s": state})]
    opt.update(grads, state, params, 1e-2)
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves({"p": params, "s": state})))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(np.random.default_rng(2), scale=3.0)
    want, want_gn = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got, got_gn = port_clip.clip_by_global_norm(_to_torch(tree), max_norm)
    np.testing.assert_allclose(float(got_gn), float(want_gn), rtol=TOL)
    _assert_trees_close(got, want)
    np.testing.assert_allclose(float(port_clip.global_norm(got)), min(max_norm, float(got_gn)),
                               rtol=1e-5)


def test_bfloat16_leaves_keep_their_dtype():
    grads = {"g": torch.full((4,), 10.0, dtype=torch.bfloat16)}
    clipped, gn = port_clip.clip_by_global_norm(grads, 1.0)
    assert clipped["g"].dtype == torch.bfloat16 and float(gn) == pytest.approx(20.0)


def test_get_optimizer_names():
    for name in ("adamw", "adafactor", "sgd_momentum"):
        assert port_opt.get_optimizer(name).name == name
    with pytest.raises(KeyError):
        port_opt.get_optimizer("lion")
