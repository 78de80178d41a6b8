"""The backward of the port's ``wkv6`` on CPU tensors: ``wkv6_bwd_ref`` and
the autograd Function ``Wkv6Fn`` against ``jax.vjp`` of the reference's
sequence scan (``repro.models.rwkv6.wkv6_scan``, which the reference trains
through), and the wrapper's checks.  The CUDA backward kernel against
``wkv6_bwd_ref`` is in test_torch_train_cuda.py.

Tolerances: float32 cotangents within rtol = atol = 2e-5 of the
reference's (4.8e-6 measured at values up to ~22, over S = 130: both sum in
float32, in other orders); a cotangent stored in bfloat16 (``k``/``v`` on the
training path) within rtol 8e-3 (2 bfloat16 ulps) and atol 1e-3 (2.4e-4
measured: both round float32 sums that differ in their last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models.rwkv6 import wkv6_scan
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd, wkv6_bwd_ref

F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 8e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, S, H, dh, seed, with_state):
    rng = np.random.default_rng(seed)
    r, k, v, w = (rng.normal(0, 0.5, (B, S, H, dh)).astype(np.float32) for _ in range(4))
    u = rng.normal(0, 0.1, (H, dh)).astype(np.float32)
    dy = rng.normal(0, 1, (B, S, H, dh)).astype(np.float32)
    s0 = rng.normal(0, 0.5, (B, H, dh, dh)).astype(np.float32) if with_state else None
    ds = rng.normal(0, 1, (B, H, dh, dh)).astype(np.float32) if with_state else None
    return r, k, v, w, u, s0, dy, ds


def _reference_vjp(r, k, v, w, u, s0, dy, ds, kv_dtype):
    """jax.vjp of wkv6_scan: the cotangents of (r, k, v, wlog, u[, s0]), k and
    v given in ``kv_dtype``."""
    args = [jnp.asarray(r), jnp.asarray(k, kv_dtype), jnp.asarray(v, kv_dtype),
            jnp.asarray(w), jnp.asarray(u)]
    if s0 is None:
        out, vjp = jax.vjp(lambda *a: wkv6_scan(*a), *args)
        return vjp((jnp.asarray(dy), jnp.zeros_like(out[1]))) + (None,)
    _, vjp = jax.vjp(lambda *a: wkv6_scan(*a[:5], init_state=a[5]), *args, jnp.asarray(s0))
    return vjp((jnp.asarray(dy), jnp.asarray(ds)))


def _torch_args(r, k, v, w, u, s0, dy, ds, kv_dtype):
    t = lambda a: None if a is None else torch.from_numpy(a)
    kv = torch.bfloat16 if kv_dtype == jnp.bfloat16 else torch.float32
    return t(r), t(k).to(kv), t(v).to(kv), t(w), t(u), t(s0), t(dy), t(ds)


def _assert_close(got, want):
    """One cotangent against the reference's, by the dtype it is stored in."""
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dh", [8, 16])
@pytest.mark.parametrize("S", [1, 7, 130])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kv_dtype", [jnp.float32, jnp.bfloat16])
def test_plain_backward_matches_reference_vjp(dh, S, with_state, kv_dtype):
    case = _case(2, S, 3, dh, seed=S + dh, with_state=with_state)
    want = _reference_vjp(*case, kv_dtype)
    got = wkv6_bwd_ref(*_torch_args(*case, kv_dtype))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _assert_close(g, w)


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("S", [9, 17])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kv_dtype", [jnp.float32, jnp.bfloat16])
def test_plain_backward_matches_reference_vjp_at_card_widths(dh, S, with_state, kv_dtype):
    """The head widths the card's kernel splits across blocks (dh 64 the
    training width), at sequence lengths that are not a multiple of the
    kernel's 8-step chunk."""
    case = _case(1, S, 2, dh, seed=S * dh, with_state=with_state)
    want = _reference_vjp(*case, kv_dtype)
    got = wkv6_bwd_ref(*_torch_args(*case, kv_dtype))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            _assert_close(g, w)


@pytest.mark.parametrize("S", [1, 130])
def test_autograd_through_the_function_matches_reference_vjp(S):
    """Every leaf's gradient through ``wkv6`` with ``loss.backward()``,
    bfloat16 ``k``/``v`` and a start state, as the reference's vjp gives it."""
    case = _case(2, S, 3, 16, seed=40 + S, with_state=True)
    want = _reference_vjp(*case, jnp.bfloat16)
    r, k, v, w, u, s0, dy, ds = _torch_args(*case, jnp.bfloat16)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, s = wkv6(*ins[:5], init_state=ins[5])
    ((y * dy).sum() + (s * ds).sum()).backward()
    for t, w_ in zip(ins, want):
        _assert_close(t.grad, w_)


def test_wkv6_differentiates_through_the_function():
    """The gradients of ``wkv6`` on CPU tensors are ``wkv6_bwd_ref``'s, bit
    for bit, through ``Wkv6Fn``: the wrapper's outputs carry its grad_fn (the
    old wrapper's kernel outputs carried none, and on the CPU its gradients
    came from autograd through the plain loop)."""
    case = _case(2, 9, 2, 8, seed=3, with_state=True)
    r, k, v, w, u, s0, dy, ds = _torch_args(*case, jnp.float32)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, s = wkv6(*ins[:5], init_state=ins[5])
    assert type(y.grad_fn).__name__ == type(s.grad_fn).__name__ == "Wkv6FnBackward"
    torch.autograd.backward((y, s), (dy, ds))
    want = wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)
    for t, g in zip(ins, want):
        assert torch.equal(t.grad, g)


def test_unused_outputs_and_partial_grads():
    """Only ``y`` used, no start state, only ``k`` and ``wlog`` requiring
    grad: the others get none, and the final state's cotangent counts as 0."""
    case = _case(1, 5, 2, 8, seed=6, with_state=False)
    r, k, v, w, u, _, dy, _ = _torch_args(*case, jnp.float32)
    kk, ww = k.clone().requires_grad_(), w.clone().requires_grad_()
    y, _ = wkv6(r, kk, v, ww, u)
    (y * dy).sum().backward()
    want = wkv6_bwd_ref(r, k, v, w, u, None, dy)
    assert torch.equal(kk.grad, want[1]) and torch.equal(ww.grad, want[3])


def test_function_calls_the_plain_versions_once_each(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(wkv6_mod, "wkv6_ref", count("fwd", wkv6_mod.wkv6_ref))
    monkeypatch.setattr(wkv6_mod, "wkv6_bwd_ref", count("bwd", wkv6_mod.wkv6_bwd_ref))
    r, k, v, w, u, _, dy, _ = _torch_args(*_case(1, 4, 1, 8, 1, False), jnp.float32)
    y, _ = wkv6(r.requires_grad_(), k, v, w, u)
    (y * dy).sum().backward()
    assert calls == {"fwd": 1, "bwd": 1}


def test_bwd_wrapper_checks_and_cpu_dispatch():
    r, k, v, w, u, s0, dy, ds = _torch_args(*_case(1, 4, 2, 8, 2, True), jnp.float32)
    assert ops.KERNELS["wkv6_bwd"] is wkv6_bwd
    ops.reset_launches()
    out = wkv6_bwd(r, k, v, w, u, s0, dy, ds)
    assert ops.launch_counts()["wkv6_bwd"] == 0        # the CPU launches nothing
    assert all(torch.equal(a, b) for a, b in zip(out, wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds)))
    with pytest.raises(ValueError, match="dy must be"):
        wkv6_bwd(r, k, v, w, u, None, dy[:, :3])
    with pytest.raises(ValueError, match="dstate must be"):
        wkv6_bwd(r, k, v, w, u, s0, dy, ds[..., :4])
    with pytest.raises(ValueError, match="u must be"):
        wkv6_bwd(r, k, v, w, u[:1], None, dy)


def test_empty_sequence_passes_the_state_cotangent_through():
    r, k, v, w, u, s0, dy, ds = _torch_args(*_case(2, 0, 2, 8, 5, True), jnp.float32)
    dr, dk, dv, dw, du, d0 = wkv6_bwd(r, k, v, w, u, s0, dy, ds)
    assert dr.shape == (2, 0, 2, 8) and not bool(du.any())
    assert torch.equal(d0, ds)
