"""The optimizer phase's kernels on the card (``repro_torch.kernels.adamw``):
``adamw_update`` and ``grad_sq_norm`` against their plain versions run on
the card, and a train step through them against the same step through the
plain versions.

These tests need a CUDA device and skip without one (the kernels have no CPU
mode).  The file imports nothing of the JAX reference, so it also runs on a
GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_adamw_cuda.py

Tolerances: ``adamw_update`` equals the eager update (its plain version on
the card) bit for bit at the same scale, on every path of the kernel
(16-byte and scalar, tails, bfloat16, more than one table of leaves);
``grad_sq_norm``'s norm is within 1e-6 relative of the plain version's
float32 ``torch.sum`` (the kernel sums in double in another order) and of a
float64 sum, and gives the same bits on every run; its scale is
``clip_scale`` of its norm bit for bit.  A train step through the kernels
keeps the plain step's state to float32 rounding: the two norms differ in
their last bits, so the scale and every moment after it may differ by an
ulp (each leaf within 1e-5 of its largest value).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels.adamw import (MAX_LEAVES, adamw_update, adamw_update_ref,
                                       grad_sq_norm, grad_sq_norm_ref)
from repro_torch.kernels.ops import same_bits
from repro_torch.optim import clip_scale

# numels 105, 1001, 198, 4096, 5 and 262,336: tails of 1-3 elements, 1-d
# leaves (no decay), a leaf of several chunks
SHAPES = ((3, 5, 7), (1001,), (2, 3, 33), (4, 1024), (5,), (64, 4099))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _args(shapes, dev, dtype=torch.float32, g_dtype=None, seed=0, scale=0.37, step=3):
    """adamw_update's arguments: leaves from a seed, the optimizer's rate and
    bias corrections at ``step`` (0-d float32 on the card), the clip's
    scale (None: no clip)."""
    rng = np.random.default_rng(seed)
    t = lambda sh, s, dt=torch.float32: torch.as_tensor(
        rng.normal(0, s, sh).astype(np.float32), device=dev).to(dt)
    grads = [t(sh, 1e-2, g_dtype or dtype) for sh in shapes]
    params = [t(sh, 0.5, dtype) for sh in shapes]
    ms = [t(sh, 1e-3) for sh in shapes]
    vs = [t(sh, 1e-3).square() for sh in shapes]
    c = torch.tensor(step, dtype=torch.int32, device=dev).float()
    lr = torch.tensor(3e-3, device=dev)
    s = None if scale is None else torch.tensor(scale, device=dev)
    return (grads, ms, vs, params, lr, 1 - 0.9 ** c, 1 - 0.95 ** c, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,g_dtype", [(torch.float32, None), (torch.bfloat16, None),
                                           (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("scale", [None, 0.37, 1.0])
def test_adamw_update_equals_the_eager_update_bit_for_bit(cuda, dtype, g_dtype, scale):
    args = _args(SHAPES, cuda, dtype, g_dtype, seed=len(SHAPES), scale=scale)
    before = adamw_update.launches
    got = adamw_update(*args)
    assert adamw_update.launches == before + 1
    want = adamw_update_ref(*args)
    assert same_bits(got, want)
    assert [t.dtype for t in got[0]] == [dtype] * len(SHAPES)


@pytest.mark.cuda
def test_adamw_update_off_alignment_and_over_one_table(cuda):
    # leaves 1 element past a 16-byte boundary take the scalar path; 40
    # leaves take two tables (two launches)
    args = _args(SHAPES, cuda, seed=1)
    off = tuple([torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in ts]
                for ts in args[:4])
    assert all(x.data_ptr() % 16 for ts in off for x in ts)
    before = adamw_update.launches
    got = adamw_update(*off, *args[4:])
    assert same_bits(got, adamw_update_ref(*off, *args[4:]))
    many = _args(((17,), (3, 4), (9, 2, 3), (6,)) * 10, cuda, seed=2)
    got = adamw_update(*many)
    assert same_bits(got, adamw_update_ref(*many))
    assert adamw_update.launches == before + 1 + -(-40 // MAX_LEAVES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_grad_sq_norm_within_1e6_and_the_same_bits_every_run(cuda, dtype, max_norm):
    shapes = SHAPES + ((3, 1_000_003),) + ((17,), (2, 5)) * 16     # 39 leaves: 2 tables
    grads = _args(shapes, cuda, dtype, seed=3)[0]
    grads = [g * 30 for g in grads]
    before = grad_sq_norm.launches
    runs = [grad_sq_norm(grads, max_norm) for _ in range(3)]
    assert grad_sq_norm.launches == before + 3 * (-(-len(shapes) // MAX_LEAVES) + 1)
    assert all(same_bits(r, runs[0]) for r in runs[1:])
    norm, scale = runs[0]
    want, _ = grad_sq_norm_ref(grads, max_norm)
    exact = torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in grads))
    assert abs(float(norm) - float(want)) <= 1e-6 * float(want)
    assert abs(float(norm) - float(exact)) <= 1e-6 * float(exact)
    assert same_bits(scale, clip_scale(norm, max_norm))
    assert (float(scale) < 1.0) == (max_norm == 1.0)


@pytest.mark.cuda
def test_what_the_kernels_do_not_take_raises_on_the_card(cuda):
    grads, ms, vs, params, lr, bc1, bc2, scale = _args(SHAPES[:2], cuda, seed=4)
    half = [g.half() for g in grads]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        adamw_update(half, ms, vs, params, lr, bc1, bc2, scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        grad_sq_norm(half, 1.0)
    with pytest.raises(ValueError, match="float32 moments"):
        adamw_update(grads, [m.bfloat16() for m in ms], vs, params, lr, bc1, bc2, scale)
    # the update leaves its arguments as they are
    before = [t.clone() for t in grads + ms + vs + params]
    adamw_update(grads, ms, vs, params, lr, bc1, bc2, scale)
    assert all(torch.equal(a, b) for a, b in zip(before, grads + ms + vs + params))


@pytest.mark.cuda
def test_rwkv6_train_steps_through_the_kernels_keep_the_plain_steps_state(cuda, monkeypatch):
    """Two AdamW steps of the smoke config (float32; the first at rate 0)
    through the kernels, then the same steps with the plain versions on the
    card: each leaf of the new state within 1e-5 of its largest value, the
    launch counters moved by a table's launches a step."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config("rwkv6-1.6b")
    params = model.init_params(0, cfg, device=cuda)
    start = {"params": params, "opt": get_optimizer(cfg.optimizer).init(params),
             "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    tables = -(-len(tree_leaves(params)) // MAX_LEAVES)
    batches = [make_batch(cfg, 2, 24, seed=7, step=i) for i in range(2)]

    def run():
        step, state, gnorms = steps_mod.make_train_step(cfg, warmup=1, base_lr=1e-3), start, []
        for b in batches:
            state, metrics = step(state, b)
            gnorms.append(float(metrics["gnorm"]))
        return state, gnorms

    before = (adamw_update.launches, grad_sq_norm.launches)
    got, got_gn = run()
    assert (adamw_update.launches, grad_sq_norm.launches) == \
        (before[0] + 2 * tables, before[1] + 2 * (tables + 1))
    monkeypatch.setattr(steps_mod, "grad_sq_norm", adamw_mod.grad_sq_norm_ref)
    monkeypatch.setattr(adamw_mod, "adamw_update", adamw_mod.adamw_update_ref)
    want, want_gn = run()
    assert (adamw_update.launches, grad_sq_norm.launches) == \
        (before[0] + 2 * tables, before[1] + 2 * (tables + 1))
    np.testing.assert_allclose(got_gn, want_gn, rtol=1e-5)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            gap = float((a.float() - b.float()).abs().max())
            assert gap <= 1e-5 * float(b.float().abs().max()) + 1e-30
        else:
            assert torch.equal(a, b)
