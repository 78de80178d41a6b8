"""The train step's clip and AdamW (``repro_torch.kernels.adamw``) on the CPU.

- ``adamw().update`` with the clip's ``scale`` equals the eager clip
  followed by the eager AdamW update that the optimizer module ran before
  the kernels (written out below as it was), bit for bit: float32 and
  bfloat16 leaves, 1-dimensional and layer-stacked, a scale under 1 and a
  scale of 1, over three updates; Adafactor and SGD with ``scale`` equal
  their update of ``clip_to_norm``'s gradients bit for bit.
- ``grad_sq_norm`` on CPU tensors is ``clip_by_global_norm``'s norm and
  scale bit for bit, and launches nothing.
- Fake tensors take the kernels' path: outputs of the right shapes and
  dtypes, the kernels' bytes counted (no FLOPs: elementwise work counts
  none); what the kernels do not take raises.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_adamw_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.counting import WorkCounter
from repro_torch.kernels.adamw import (adamw_update, adamw_update_ref, adamw_update_work,
                                       grad_sq_norm, grad_sq_norm_work)
from repro_torch.kernels.ops import same_bits
from repro_torch.optim import clip as port_clip
from repro_torch.optim import optimizers as port_opt
from repro_torch.tree import tree_leaves, tree_map, tree_unzip

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, dtype, scale):
    shapes = {"w": (4, 6), "b": (6,), "stack": {"x": (2, 3, 5), "norm": (3, 7)}}
    return tree_map(lambda sh: torch.as_tensor(rng.normal(0, scale, sh).astype(np.float32))
                    .to(dtype), shapes)


def _eager_clip(tree, max_norm):
    """The clip as the optimizer module ran it before the kernels."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), gn


def _eager_adamw_update(grads, state, params, lr):
    """AdamW's update as the optimizer module ran it before the kernels."""
    c = state["count"] + 1
    bc1 = 1 - B1 ** c.float()
    bc2 = 1 - B2 ** c.float()

    def upd(g, m, v, p):
        g = g.float()
        m = B1 * m + (1 - B1) * g
        v = B2 * v + (1 - B2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        if p.ndim >= 2:
            step = step + WD * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    new_p, new_m, new_v = tree_unzip(tree_map(upd, grads, state["m"], state["v"], params), 3)
    return new_p, {"m": new_m, "v": new_v, "count": c}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm,clipped", [(0.5, True), (1e6, False)])
def test_scaled_update_equals_the_eager_clip_then_update(dtype, max_norm, clipped):
    rng = np.random.default_rng(3)
    opt = port_opt.adamw()
    params = _tree(rng, dtype, 1.0)
    new, new_state = params, opt.init(params)
    old, old_state = params, opt.init(params)
    for i, lr in enumerate((0.0, 3e-3, 1e-2)):
        grads = _tree(rng, dtype, 0.5 * (i + 1))
        gnorm, scale = grad_sq_norm(tree_leaves(grads), max_norm)
        assert (float(scale) < 1.0) == clipped and float(scale) <= 1.0
        lr = torch.tensor(lr, dtype=torch.float32)
        new, new_state = opt.update(grads, new_state, new, lr, scale=scale)
        clipped_grads, want_gn = _eager_clip(grads, max_norm)
        old, old_state = _eager_adamw_update(clipped_grads, old_state, old, lr)
        assert same_bits(gnorm, want_gn)
        assert same_bits(new, old) and same_bits(new_state, old_state), i
    assert all(p.dtype == dtype for p in tree_leaves(new))
    assert all(m.dtype == torch.float32 for m in tree_leaves(new_state["m"]))


@pytest.mark.parametrize("name", ["adafactor", "sgd_momentum"])
def test_other_optimizers_take_the_same_scale(name):
    rng = np.random.default_rng(5)
    opt = port_opt.get_optimizer(name)
    params = _tree(rng, torch.float32, 1.0)
    state = opt.init(params)
    grads = _tree(rng, torch.float32, 2.0)
    clipped, gn = port_clip.clip_by_global_norm(grads, 1.0)
    _, scale = grad_sq_norm(tree_leaves(grads), 1.0)
    assert float(scale) < 1.0
    want = opt.update(clipped, state, params, 1e-2)
    assert same_bits(opt.update(grads, state, params, 1e-2, scale=scale), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_sq_norm_is_the_clips_norm_and_scale(dtype):
    grads = _tree(np.random.default_rng(1), dtype, 3.0)
    before = (grad_sq_norm.launches, adamw_update.launches)
    gn, scale = grad_sq_norm(tree_leaves(grads), 1.0)
    want_gn = port_clip.global_norm(grads)
    assert same_bits(gn, want_gn)
    assert same_bits(scale, torch.clamp(1.0 / torch.clamp(want_gn, min=1e-9), max=1.0))
    assert gn.shape == scale.shape == () and gn.dtype == scale.dtype == torch.float32
    opt = port_opt.adamw()
    params = _tree(np.random.default_rng(2), dtype, 1.0)
    opt.update(grads, opt.init(params), params, 1e-2, scale=scale)
    assert (grad_sq_norm.launches, adamw_update.launches) == before   # the CPU launches nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_with_a_scale_leaves_its_arguments_untouched(dtype):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, dtype, 1.0), _tree(rng, dtype, 1.0)
    opt = port_opt.adamw()
    state = opt.init(params)
    scale = torch.tensor(0.25)
    before = [t.clone() for t in tree_leaves({"p": params, "g": grads, "s": state})]
    opt.update(grads, state, params, 1e-2, scale=scale)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves({"p": params, "g": grads, "s": state})))


def _fake_leaves(dtype, moment_dtype=torch.float32):
    shapes = ((4, 6), (6,), (2, 3, 5))
    grads = [torch.empty(sh, dtype=dtype) for sh in shapes]
    params = [torch.empty(sh, dtype=dtype) for sh in shapes]
    ms = [torch.empty(sh, dtype=moment_dtype) for sh in shapes]
    vs = [torch.empty(sh, dtype=moment_dtype) for sh in shapes]
    return grads, ms, vs, params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_tensors_take_the_kernels_path_and_count_their_bytes(dtype):
    with FakeTensorMode():
        grads, ms, vs, params = _fake_leaves(dtype)
        lr, bc1, bc2 = (torch.tensor(x) for x in (1e-3, 0.1, 0.05))
        with WorkCounter() as c:
            gn, scale = grad_sq_norm(grads, 1.0)
            new_p, new_m, new_v = adamw_update(grads, ms, vs, params, lr, bc1, bc2, scale)
    assert gn.shape == scale.shape == () and gn.dtype == torch.float32
    assert [(t.shape, t.dtype) for t in new_p] == [(t.shape, t.dtype) for t in params]
    assert all(t.dtype == torch.float32 for t in new_m + new_v)
    assert c.kernels["adamw"] == {"calls": 1, "flops": 0,
                                  "bytes": adamw_update_work(grads, params)[0]}
    assert c.kernels["grad_sq_norm"] == {"calls": 1, "flops": 0,
                                         "bytes": grad_sq_norm_work(grads)[0]}
    assert adamw_update_work(grads, params)[0] == \
        sum(t.numel() for t in params) * (3 * grads[0].element_size() + 16)


def test_what_the_kernels_do_not_take_raises():
    with FakeTensorMode():
        grads, ms, vs, params = _fake_leaves(torch.float16)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            adamw_update(grads, ms, vs, params, 1e-3, 0.1, 0.05)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            grad_sq_norm(grads, 1.0)
        grads, ms, vs, params = _fake_leaves(torch.float32, torch.bfloat16)
        with pytest.raises(ValueError, match="float32 moments"):
            adamw_update(grads, ms, vs, params, 1e-3, 0.1, 0.05)
    grads, ms, vs, params = (list(t) for t in _fake_leaves(torch.float32))
    with pytest.raises(ValueError, match="3 gradients"):
        adamw_update(grads, ms, vs, params[:2], 1e-3, 0.1, 0.05)
    with pytest.raises(ValueError, match="a parameter"):
        adamw_update(grads, ms, vs, params[::-1], 1e-3, 0.1, 0.05)
    with pytest.raises(TypeError, match="tensors"):
        grad_sq_norm([np.zeros(3, np.float32)], 1.0)
    with pytest.raises(ValueError, match="at least one leaf"):
        grad_sq_norm([], 1.0)


def test_plain_update_is_the_eager_update_leaf_by_leaf():
    rng = np.random.default_rng(4)
    shapes = ((5, 3), (7,))
    leaves = [[torch.as_tensor(rng.normal(0, 1, sh).astype(np.float32)) for sh in shapes]
              for _ in range(4)]
    leaves[2] = [v.abs() for v in leaves[2]]
    args = (*leaves, torch.tensor(1e-2), torch.tensor(0.19), torch.tensor(0.0975),
            torch.tensor(0.5))
    whole = adamw_update_ref(*args)
    for i in range(len(shapes)):
        one = adamw_update_ref(*([t[i]] for t in leaves), *args[4:])
        assert same_bits(tuple(o[0] for o in one), tuple(w[i] for w in whole))
    assert same_bits(adamw_update(*args), whole)
