"""The single-device train step replayed from CUDA graphs on the card, held
to the same steps run op by op.

``make_train_step`` captures at a batch shape's third call and replays from
then on; a step built fresh never captures before its third call, so a
fresh step a call gives the op-by-op result of the same state and batch.
The graphs launch the op-by-op step's kernels in its order on the same
inputs, so every comparison here is bit for bit: parameters, AdamW's
moments, the step count and the metrics.

These tests need a CUDA device and skip without one (the graphs and the
kernels in them have no CPU mode).  The file imports nothing of the JAX
reference, so it also runs on a GPU host without JAX:

    python -m pytest -q -m cuda tests/test_torch_train_graph_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import ops
from repro_torch.kernels.ops import same_bits
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model
from repro_torch.obs import REGISTRY
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_leaves, tree_map

STEP_KW = dict(warmup=1, base_lr=1e-3)
# one smoke config of each family make_train_step trains (hybrid's trains
# with Adafactor, whose update is copied into the step's buffers)
FAMILIES = {"dense": "qwen2-0.5b", "moe": "moonshot-v1-16b-a3b",
            "hybrid": "jamba-1.5-large-398b", "ssm": "rwkv6-1.6b",
            "audio": "whisper-medium", "vlm": "paligemma-3b"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's graphs and kernels have no CPU mode")
    return torch.device("cuda")


def _start(cfg, dev):
    params = model.init_params(0, cfg, device=dev)
    return {"params": params, "opt": get_optimizer(cfg.optimizer).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _batches(cfg, dev, n, batch=2, seq=24):
    """``n`` batches of device tensors (the benchmark's feed)."""
    return [{k: torch.as_tensor(v, device=dev) for k, v in
             make_batch(cfg, batch, seq, seed=7, step=i).items()} for i in range(n)]


def _copy(tree):
    return tree_map(torch.clone, tree)


def _eager(cfg, state, batch):
    """The op-by-op step: a fresh step's first call."""
    return make_train_step(cfg, **STEP_KW)(state, batch)


def _counts():
    return {p: REGISTRY.value("repro_train_steps_total", path=p) for p in ("graph", "eager")}


def _run(step, state, batches):
    """Each call's (new state copied, metrics); the launches and the
    step counter's moves over the calls."""
    before, steps0 = ops.launch_counts(), _counts()
    out = []
    for batch in batches:
        state, metrics = step(state, batch)
        out.append((_copy(state), metrics))
    torch.cuda.synchronize()
    after, steps1 = ops.launch_counts(), _counts()
    return out, {k: after[k] - before[k] for k in after}, \
        {k: steps1[k] - steps0[k] for k in steps1}


def test_graphed_rwkv6_steps_equal_the_op_by_op_steps(cuda):
    """Six steps of one step function (two op by op, then a capture and
    four replays) against the same six steps each run op by op: every
    leaf and metric bit for bit, the same kernel launches, four replays."""
    cfg = get_smoke_config("rwkv6-1.6b")
    start, batches = _start(cfg, cuda), _batches(cfg, cuda, 6)
    got, got_launches, got_steps = _run(make_train_step(cfg, **STEP_KW), start, batches)
    want, state = [], start
    before = ops.launch_counts()
    for batch in batches:
        state, metrics = _eager(cfg, state, batch)
        want.append((state, metrics))
    torch.cuda.synchronize()
    want_launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    for i, (g, w) in enumerate(zip(got, want)):
        assert same_bits(g, w), f"step {i}"
    assert got_launches == want_launches
    assert got_launches["wkv6"] == 6 * 2 * cfg.n_layers
    assert got_steps == {"graph": 4, "eager": 2}


def test_graphed_call_leaves_the_state_handed_in_as_it_is(cuda):
    cfg = get_smoke_config("rwkv6-1.6b")
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    batches = _batches(cfg, cuda, 5)
    for i, batch in enumerate(batches):
        handed = _copy(state)
        before = _counts()["graph"]
        new, _ = step(state, batch)
        torch.cuda.synchronize()
        assert same_bits(state, handed), f"call {i + 1}"
        assert _counts()["graph"] == before + (i >= 2)
        state = new


def test_a_strided_state_at_the_capture_is_copied_and_never_written(cuda):
    """A state with non-contiguous leaves handed to the capturing call:
    the step copies it rather than adopt it, that call and the ones after
    replay and equal the op-by-op steps on the same values, and no call
    writes the state handed in."""
    cfg = get_smoke_config("rwkv6-1.6b")
    batches = _batches(cfg, cuda, 5)
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    # every 2-d leaf laid out column-major: the same values, not contiguous
    strided = tree_map(lambda t: t.T.contiguous().T if t.ndim == 2 else t, state)
    assert not all(t.is_contiguous() for t in tree_leaves(strided))
    handed, before = _copy(strided), _counts()
    got = step(strided, batches[2])
    assert same_bits(got, _eager(cfg, state, batches[2]))
    state = got[0]
    for batch in batches[3:]:
        want = _eager(cfg, state, batch)
        state, metrics = step(state, batch)
        assert same_bits((state, metrics), want)
    torch.cuda.synchronize()
    assert same_bits(strided, handed)
    assert all(a.stride() == b.stride() for a, b in
               zip(tree_leaves(strided), tree_leaves(handed)))
    assert _counts()["graph"] == before["graph"] + 3


def test_returned_metrics_and_state_hold_through_the_next_call(cuda):
    """A returned state holds its values through the next call (the one
    after may write over it); returned metrics hold through every later
    call."""
    cfg = get_smoke_config("rwkv6-1.6b")
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    kept = []
    for batch in _batches(cfg, cuda, 6):
        prev, prev_copy = state, _copy(state)
        state, metrics = step(state, batch)
        kept.append((metrics, _copy(metrics)))
        torch.cuda.synchronize()
        assert same_bits(prev, prev_copy)
    for metrics, copy in kept:
        assert same_bits(metrics, copy)


def test_a_foreign_state_mid_run_gives_the_op_by_op_result(cuda):
    """After the capture, a state the step did not return (another run's)
    gives what the op-by-op step gives on it, and the calls after it
    replay again."""
    cfg = get_smoke_config("rwkv6-1.6b")
    batches = _batches(cfg, cuda, 7)
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    for batch in batches[:4]:
        state, _ = step(state, batch)
    foreign = _start(cfg, cuda)
    foreign, _ = _eager(cfg, foreign, batches[0])
    want = _eager(cfg, foreign, batches[4])
    before = _counts()
    got = step(foreign, batches[4])
    assert same_bits(got, want)
    assert _counts()["eager"] == before["eager"] + 1
    state = got[0]
    for batch in batches[5:]:
        want = _eager(cfg, state, batch)
        state, metrics = step(state, batch)
        assert same_bits((state, metrics), want)
    assert _counts()["graph"] == before["graph"] + 2


def test_a_second_batch_shape_captures_its_own_graph(cuda):
    """Two batch shapes in turn: each captures at its own third call, and
    every call equals the op-by-op step."""
    cfg = get_smoke_config("rwkv6-1.6b")
    short, long = _batches(cfg, cuda, 4, seq=16), _batches(cfg, cuda, 4, seq=40)
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    before = _counts()
    for pair in zip(short, long):
        for batch in pair:
            want = _eager(cfg, state, batch)
            state, metrics = step(state, batch)
            assert same_bits((state, metrics), want)
    moved = {k: v - before[k] for k, v in _counts().items()}
    # eager: each shape's first two calls and the eight fresh steps
    assert moved == {"graph": 4, "eager": 12}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_familys_graphed_steps_equal_the_op_by_op_steps(cuda, family):
    """Five steps of each family's smoke config, host batches as
    ``make_batch`` gives them (three replays), against the op-by-op
    steps: bit for bit."""
    cfg = get_smoke_config(FAMILIES[family])
    step, state = make_train_step(cfg, **STEP_KW), _start(cfg, cuda)
    before = _counts()
    for i in range(5):
        batch = make_batch(cfg, 2, 24, seed=7, step=i)
        want = _eager(cfg, state, batch)
        state, metrics = step(state, batch)
        assert same_bits((state, metrics), want), f"{family} step {i}"
    assert _counts()["graph"] == before["graph"] + 3
    assert len(tree_leaves(state)) == len(tree_leaves(want[0]))
