"""The RWKV-6 training path's kernels on the card: ``wkv6_bwd`` against its
plain version ``wkv6_bwd_ref``, autograd through ``wkv6`` running the
backward kernel, and train steps of the smoke config on the card against the
same steps on the CPU.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  The file imports nothing of the JAX reference, so it also runs on a
GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances are stated beside each check.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd, wkv6_bwd_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _wkv6_inputs(B, S, H, dh, dev, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v, w = (torch.as_tensor(rng.normal(0, 0.5, (B, S, H, dh)), dtype=torch.float32,
                                  device=dev) for _ in range(4))
    u = torch.as_tensor(rng.normal(0, 0.1, (H, dh)), dtype=torch.float32, device=dev)
    return r, k, v, w, u


# the backward sums in another order than its plain version; float32
# gradients within rtol = atol = 1e-3, gradients stored in bfloat16 within 2
# of its ulps (rtol 8e-3: a float32 difference of an ulp can round either way)
WKV6_BWD_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (8e-3, 1e-3)}


def _wkv6_bwd_case(B, S, H, dh, dev, with_state, kv_dtype=torch.float32, seed=0):
    r, k, v, w, u = _wkv6_inputs(B, S, H, dh, dev, seed=seed)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((B, S, H, dh), generator=gen, device=dev)
    s0 = ds = None
    if with_state:
        s0 = torch.randn((B, H, dh, dh), generator=gen, device=dev) * 0.5
        ds = torch.randn((B, H, dh, dh), generator=gen, device=dev)
    return (r, k, v, w, u, s0, dy, ds)


def _close_grads(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        rtol, atol = WKV6_BWD_TOL[torch.bfloat16 if w.dtype == torch.bfloat16
                                  else torch.float32]
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)


# a (b, h) is a cluster of 2 blocks (32 rows each at dh = 64, 16 at dh = 32),
# one block at dh <= 16: S not a multiple of the 8-step chunk, a single
# cluster (B*H = 1), an odd H and S = 1 at each cluster size
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,dh", [(1, 1, 1, 8), (2, 7, 2, 16), (2, 130, 3, 32),
                                      (2, 64, 2, 64), (1, 17, 2, 64), (3, 9, 2, 8),
                                      (1, 13, 1, 64), (2, 1, 3, 64), (3, 21, 5, 64),
                                      (1, 9, 1, 32), (2, 1, 3, 32), (1, 1, 1, 16)])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_wkv6_bwd_kernel_matches_plain_version(cuda, B, S, H, dh, with_state, kv_dtype):
    args = _wkv6_bwd_case(B, S, H, dh, cuda, with_state, kv_dtype, seed=S + dh)
    before = wkv6_bwd.launches
    got = wkv6_bwd(*args)
    want = wkv6_bwd_ref(*args)
    torch.cuda.synchronize()
    assert wkv6_bwd.launches == before + 1
    _close_grads(got, want)
    again = wkv6_bwd(*args)   # no atomics: the same bits every run
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.cuda
def test_wkv6_autograd_on_the_card_runs_the_backward_kernel(cuda):
    r, k, v, w, u, s0, dy, ds = _wkv6_bwd_case(2, 21, 2, 64, cuda, True, seed=4)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    before = (wkv6.launches, wkv6_bwd.launches)
    y, s = wkv6(*ins[:5], init_state=ins[5])
    assert type(y.grad_fn).__name__ == "Wkv6FnBackward"
    torch.autograd.backward((y, s), (dy, ds))
    assert (wkv6.launches, wkv6_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = wkv6_bwd(r, k, v, w, u, s0, dy, ds)
    assert all(torch.equal(t.grad, g) for t, g in zip(ins, want))


@pytest.mark.cuda
def test_wkv6_bwd_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, w, u, _, dy, _ = _wkv6_bwd_case(1, 4, 2, 12, cuda, False)
    with pytest.raises(ValueError, match="dh in"):
        wkv6_bwd(r, k, v, w, u, None, dy)
    r, k, v, w, u, _, dy, _ = _wkv6_bwd_case(1, 4, 2, 8, cuda, False)
    with pytest.raises(ValueError, match="dy must be"):
        wkv6_bwd(r, k, v, w, u, None, dy[:, :3])
    before = wkv6_bwd.launches
    out = wkv6_bwd(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, None, dy[:, :0])
    assert wkv6_bwd.launches == before and not bool(out[4].any())
    # strided views are made contiguous by the wrapper
    sl = [t[:, ::2] for t in (r, k, v, w)]
    _close_grads(wkv6_bwd(*sl, u, None, dy[:, ::2]),
                 wkv6_bwd_ref(*sl, u, None, dy[:, ::2]))


@pytest.mark.cuda
def test_rwkv6_train_steps_on_the_card_equal_the_cpu(cuda):
    """Two AdamW steps of the smoke config (float32) through the wkv6 and
    wkv6_bwd kernels, held to the same steps on the CPU: loss and gnorm
    within rtol 1e-4 (the second step's gnorm 1.8e-5 apart on an H100: the
    first update, lr 1e-3, already carries the card's float32 rounding),
    parameters within atol 1e-4 (an update moves a parameter by up to 1e-3)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke_config("rwkv6-1.6b")
    params = model.init_params(0, cfg, device="cpu")
    opt = get_optimizer(cfg.optimizer)
    cpu = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    card = tree_map(lambda t: t.to(cuda), cpu)
    step = make_train_step(cfg, warmup=1, base_lr=1e-3)
    before = (wkv6.launches, wkv6_bwd.launches)
    for i in range(2):
        batch = make_batch(cfg, 2, 24, seed=7, step=i)
        cpu, mc = step(cpu, batch)
        card, mg = step(card, batch)
        for k in ("loss", "gnorm"):
            assert float(mg[k]) == pytest.approx(float(mc[k]), rel=1e-4)
    assert (wkv6.launches, wkv6_bwd.launches) == (before[0] + 2 * 2 * cfg.n_layers,
                                                  before[1] + 2 * cfg.n_layers)
    for a, b in zip(tree_leaves(card["params"]), tree_leaves(cpu["params"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
