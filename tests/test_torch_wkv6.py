"""The port's ``wkv6`` wrapper on CPU tensors (its plain version ``wkv6_ref``)
against the reference's sequence scan (``repro.models.rwkv6.wkv6_scan``) and
its Pallas kernel in interpret mode, and the wrapper's argument checks and
device dispatch.  The CUDA kernel against the plain version is in
test_torch_kernels_cuda.py.

Tolerance: ``y`` within rtol = atol = 3e-4 for float32 inputs and 2e-3 for
float16 inputs, the reference's own kernel-against-scan bounds
(tests/test_kernels.py::test_wkv6_kernel_sweep): the Pallas kernel writes
``y`` in the input dtype, so against it float16 costs a float16 rounding
(1.9e-3 measured); against the scan the port's float32 ``y`` sits within
2e-6 (einsum sums in another order).  The final state, and runs from an
``init_state``, are held to the scan within rtol = atol = 1e-5 (1.2e-7
measured on these inputs).  The CUDA kernel's own order of operations
(csrc/wkv6.cu: fmaf chains over 8-row groups, the groups' partial sums added
in order, the rank-one u term by a 32-lane butterfly per half row) is
evaluated in float32 on the CPU and held to the plain version within the
kernel's own bound, rtol = atol = 3e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.wkv6 import wkv6 as pallas_wkv6
from repro.models.rwkv6 import wkv6_scan
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6 import wkv6, wkv6_ref

SHAPES = [(1, 64, 1, 8), (2, 96, 2, 16), (3, 130, 4, 32), (2, 64, 2, 64)]
TOL = {np.float32: 3e-4, np.float16: 2e-3}
STATE_TOL = 1e-5


def _inputs(B, S, H, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    r, k, v, w = (rng.normal(0, 0.5, (B, S, H, dh)).astype(dtype) for _ in range(4))
    u = rng.normal(0, 0.1, (H, dh)).astype(np.float32)
    return r, k, v, w, u


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,dh", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_version_matches_reference_scan(B, S, H, dh, dtype):
    arrays = _inputs(B, S, H, dh, dtype, seed=S + dh)
    y, s = wkv6(*_t(arrays))
    yr, sr = wkv6_scan(*(jnp.asarray(a) for a in arrays))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, S, H, dh) and s.shape == (B, H, dh, dh)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=tol, atol=tol)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=STATE_TOL,
                               atol=STATE_TOL)


@pytest.mark.parametrize("B,S,H,dh", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_version_matches_pallas_kernel(B, S, H, dh, dtype):
    arrays = _inputs(B, S, H, dh, dtype, seed=S * dh)
    y, _ = wkv6_ref(*_t(arrays))
    yk = np.asarray(pallas_wkv6(*arrays, interpret=True), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.numpy(), yk, rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [1, 130])
def test_final_state_and_init_state_match_reference_scan(S):
    B, H, dh = 2, 3, 16
    r, k, v, w, u = _inputs(B, S, H, dh, np.float32, seed=S)
    s0 = np.random.default_rng(7).normal(0, 1.0, (B, H, dh, dh)).astype(np.float32)
    y, s = wkv6(*_t((r, k, v, w, u)), init_state=torch.from_numpy(s0))
    yr, sr = wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                       init_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=STATE_TOL, atol=STATE_TOL)


def test_split_sequence_continues_from_the_state():
    """Prefill then decode: a scan over S equals a scan over its first part
    followed by one step at a time from the carried state."""
    r, k, v, w, u = _t(_inputs(2, 9, 2, 8, np.float32, seed=3))
    y, s = wkv6_ref(r, k, v, w, u)
    y1, s1 = wkv6_ref(r[:, :5], k[:, :5], v[:, :5], w[:, :5], u)
    ys = [y1]
    for t in range(5, 9):
        yt, s1 = wkv6_ref(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                          w[:, t:t + 1], u, init_state=s1)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, dim=1), y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s1, s, rtol=1e-6, atol=1e-6)


def test_bfloat16_and_mixed_inputs_compute_in_float32():
    r, k, v, w, u = _t(_inputs(1, 12, 2, 8, np.float32, seed=5))
    y, s = wkv6(r, k.bfloat16(), v.bfloat16(), w, u)
    yr, sr = wkv6_ref(r, k.bfloat16().float(), v.bfloat16().float(), w, u)
    assert torch.equal(y, yr) and torch.equal(s, sr)


def test_empty_sequence_keeps_the_state():
    r, k, v, w, u = _t(_inputs(2, 0, 2, 8, np.float32, seed=1))
    s0 = torch.ones((2, 2, 8, 8))
    y, s = wkv6(r, k, v, w, u, init_state=s0)
    assert y.shape == (2, 0, 2, 8) and torch.equal(s, s0)


def test_wrapper_checks_inputs():
    r, k, v, w, u = _t(_inputs(1, 4, 2, 8, np.float32, seed=2))
    with pytest.raises(ValueError, match="r must be"):
        wkv6(r[0], k[0], v[0], w[0], u)
    with pytest.raises(ValueError, match="k is"):
        wkv6(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        wkv6(r.double(), k, v, w, u)
    with pytest.raises(ValueError, match="init_state"):
        wkv6(r, k, v, w, u, init_state=torch.zeros((1, 2, 8, 4)))
    with pytest.raises(TypeError):
        wkv6(r.numpy(), k, v, w, u)
    with pytest.raises(ValueError, match="one device"):
        wkv6(r, k, v, w, u.to("meta"))


def test_cpu_tensors_launch_nothing_and_ops_lists_the_kernel():
    assert ops.KERNELS["wkv6"] is wkv6
    ops.reset_launches()
    wkv6(*_t(_inputs(1, 3, 1, 8, np.float32, seed=0)))
    assert ops.launch_counts()["wkv6"] == 0


def _fma(a, b, c):
    """float32 fmaf: the product and sum in float64, rounded once (the
    float64 product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order_wkv6(r, k, v, w, u, s0, rows=8):
    """csrc/wkv6.cu's sums in float32 for dh = 64: per state element
    acc = fmaf(r_i, S_ij, acc) over each group of ``rows`` rows in order and
    S_ij = fmaf(d_i, S_ij, k_i * v_j); y_j = fmaf(v_j, ruk, sum of the
    groups' acc in order), where ruk adds the two 32-row halves' butterfly
    sums of (r_i * u_i) * k_i."""
    B, S, H, dh = r.shape
    G = dh // rows
    st = s0.clone().reshape(B, H, G, rows, dh)                # S[g*rows + ii][j]
    d = torch.exp(-torch.exp(w))
    lane = torch.arange(32)
    ys = []
    for t in range(S):
        rt, kt, vt, dt = (x[:, t].reshape(B, H, G, rows) for x in (r, k, v, d))
        vj = v[:, t][:, :, None, :]                           # (B, H, 1, dh)
        acc = torch.zeros((B, H, G, dh))
        for ii in range(rows):
            old = st[:, :, :, ii]
            acc = _fma(rt[..., ii, None], old, acc)
            st[:, :, :, ii] = _fma(dt[..., ii, None], old, kt[..., ii, None] * vj)
        part = acc[:, :, 0]
        for g in range(1, G):
            part = part + acc[:, :, g]
        prod = (r[:, t] * u) * k[:, t]                        # (B, H, dh)
        halves = []
        for half in prod.split(32, dim=-1):
            x = half
            for off in (16, 8, 4, 2, 1):
                x = x + x[..., lane ^ off]
            halves.append(x[..., 0])
        ruk = halves[0] + halves[1]
        ys.append(_fma(v[:, t], ruk[..., None], part))
    return torch.stack(ys, dim=1), st.reshape(B, H, dh, dh)


def test_kernel_sum_order_matches_plain_version():
    r, k, v, w, u = _t(_inputs(2, 512, 2, 64, np.float32, seed=11))
    s0 = torch.from_numpy(np.random.default_rng(12).normal(0, 0.5, (2, 2, 64, 64))
                          .astype(np.float32))
    y, s = kernel_order_wkv6(r, k, v, w, u, s0)
    yr, sr = wkv6_ref(r, k, v, w, u, init_state=s0)
    torch.testing.assert_close(y, yr, rtol=TOL[np.float32], atol=TOL[np.float32])
    torch.testing.assert_close(s, sr, rtol=TOL[np.float32], atol=TOL[np.float32])
    assert not torch.equal(y, yr)   # another order: not the plain version's bits
