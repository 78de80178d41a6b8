"""The train step's CUDA-graph path on the CPU: a CPU state never captures
and every call counts as an op-by-op step, and the optimizers' ``out``
argument (where a replayed step writes its next state) gives the bits a
fresh update gives.  The graphs themselves are held to the op-by-op step in
``tests/test_torch_train_graph_cuda.py`` on a card.

Every comparison here is bit for bit: the same code runs on the same CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ops import same_bits
from repro_torch.launch import steps
from repro_torch.models import model
from repro_torch.obs import REGISTRY
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map


def _start(cfg):
    params = model.init_params(0, cfg, device="cpu")
    return {"params": params, "opt": get_optimizer(cfg.optimizer).init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _counts():
    return {p: REGISTRY.value("repro_train_steps_total", path=p) for p in ("graph", "eager")}


def test_cpu_step_never_captures_and_counts_every_call_eager(monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU train step captured a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(torch.cuda, "graph", no_graph)
    monkeypatch.setattr(torch.cuda, "Stream", no_graph)
    cfg = get_smoke_config("rwkv6-1.6b")
    batches = [make_batch(cfg, 2, 12, seed=3, step=i) for i in range(4)]
    step, state = steps.make_train_step(cfg, warmup=1, base_lr=1e-3), _start(cfg)
    before = _counts()
    for i, batch in enumerate(batches):
        # each call against a fresh step's first call on the same state
        want = steps.make_train_step(cfg, warmup=1, base_lr=1e-3)(state, batch)
        state = step(state, batch)
        assert same_bits(state, want)
        state = state[0]
    after = _counts()
    assert after["graph"] == before["graph"]
    # the four calls and the four fresh steps
    assert after["eager"] == before["eager"] + 8


def test_launch_snapshot_and_add_launches_cover_every_counter():
    """What a replayed graph credits: every wrapper's launches and
    ``bank_sched``'s per-route launches, added and taken back."""
    before = ops.launch_snapshot()
    assert {k for k, route in before if route is None} == set(ops.COUNTED)
    assert any(k == "bank_sched" and route is not None for k, route in before)
    assert {k: before[k, None] for k in ops.COUNTED} == ops.launch_counts()
    try:
        ops.add_launches(dict.fromkeys(before, 3))
        assert ops.launch_snapshot() == {k: n + 3 for k, n in before.items()}
    finally:
        ops.add_launches(dict.fromkeys(before, -3))
    assert ops.launch_snapshot() == before


def test_the_capturing_call_adopts_a_plain_state_and_copies_any_other():
    """Buffer 0 is the state's own leaves where each is contiguous with a
    storage of its own; else every leaf is copied, so that no replay
    writes a tensor that was handed in."""
    cfg = get_smoke_config("rwkv6-1.6b")
    plain = _start(cfg)
    graphed = steps._Graphed(run=None)
    graphed._adopt(plain)
    assert all(a is b for a, b in zip(graphed.bufs[0], tree_leaves(plain)))
    assert not {t.data_ptr() for t in graphed.bufs[1]} & \
        {t.data_ptr() for t in tree_leaves(plain)}
    for odd in (tree_map(lambda t: t.T.contiguous().T if t.ndim == 2 else t, plain),
                {**plain, "step": plain["opt"]["count"]}):
        graphed = steps._Graphed(run=None)
        graphed._adopt(odd)
        given = {t.untyped_storage().data_ptr() for t in tree_leaves(odd)}
        assert not {t.untyped_storage().data_ptr() for b in graphed.bufs for t in b} & given
        assert all(t.is_contiguous() for b in graphed.bufs for t in b)
        assert same_bits(graphed.bufs[0], tree_leaves(odd))


def _leaves(rng, n=3):
    shapes = [(4, 6), (6,), (2, 3, 5)][:n]
    return [torch.randn(s, generator=rng) for s in shapes]


def test_adamw_update_into_out_gives_a_fresh_updates_bits():
    rng = torch.Generator().manual_seed(5)
    grads, params = _leaves(rng), _leaves(rng)
    ms = [t.abs() * 0.1 for t in _leaves(rng)]
    vs = [t.abs() * 0.01 for t in _leaves(rng)]
    rates = (torch.tensor(1e-3), torch.tensor(0.19), torch.tensor(0.0975))
    scale = torch.tensor(0.5)
    before = [t.clone() for t in grads + ms + vs + params]
    want = adamw_mod.adamw_update(grads, ms, vs, params, *rates, scale)
    out = tuple([torch.full_like(t, float("nan")) for t in ts] for ts in (params, ms, vs))
    got = adamw_mod.adamw_update(grads, ms, vs, params, *rates, scale, out=out)
    assert same_bits(got, want)
    assert all(g is o for gs, os in zip(got, out) for g, o in zip(gs, os))
    assert same_bits(grads + ms + vs + params, before)


def test_adamw_update_rejects_an_out_that_does_not_fit():
    rng = torch.Generator().manual_seed(6)
    grads, params = _leaves(rng), _leaves(rng)
    ms, vs = [torch.zeros_like(t) for t in params], [torch.zeros_like(t) for t in params]
    rates = (1e-3, 0.1, 0.05)
    fits = [[torch.empty_like(t) for t in params] for _ in range(3)]
    with pytest.raises(ValueError, match="out takes"):
        adamw_mod.adamw_update(grads, ms, vs, params, *rates, out=fits[:2])
    wrong = [fits[0], fits[1], [t.double() for t in fits[2]]]
    with pytest.raises(ValueError, match="an output"):
        adamw_mod.adamw_update(grads, ms, vs, params, *rates, out=wrong)
    strided = [fits[0], fits[1], [torch.empty(t.shape[::-1]).T if t.ndim == 2
                                  else torch.empty_like(t) for t in fits[2]]]
    with pytest.raises(ValueError, match="an output"):
        adamw_mod.adamw_update(grads, ms, vs, params, *rates, out=strided)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd_momentum"])
def test_optimizer_update_into_out_gives_a_fresh_updates_bits(name):
    rng = torch.Generator().manual_seed(7)
    keys = ("w", "b", "x")
    params = dict(zip(keys, _leaves(rng)))
    grads = dict(zip(keys, _leaves(rng)))
    opt = get_optimizer(name)
    state = opt.init(params)
    # a second step, so that every moment is non-zero going in
    params, state = opt.update(grads, state, params, torch.tensor(1e-2))
    lr, scale = torch.tensor(3e-3), torch.tensor(0.75)
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(state)]
    want = opt.update(grads, state, params, lr, scale=scale)
    out = (tree_map(torch.empty_like, params), tree_map(torch.empty_like, state))
    got = opt.update(grads, state, params, lr, scale=scale, out=out)
    assert same_bits(got[0], want[0]) and same_bits(got[1], want[1])
    assert all(g is o for g, o in zip(tree_leaves(got[0]) + tree_leaves(got[1]),
                                      tree_leaves(out[0]) + tree_leaves(out[1])))
    assert same_bits(tree_leaves(params) + tree_leaves(state), before)
