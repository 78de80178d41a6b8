"""Port parity: the FR-FCFS scheduler step and walk of
repro_torch.kernels.bank_sched against repro's, on the CPU.

``candidate_times`` must give the reference's int32 outputs exactly — the
reference's numpy helper and its Pallas kernel (interpret mode) — in numpy
and in torch, unbatched and with a walk axis.  The plain walk
``memsim_walk_ref`` (what ``memsim_walk`` runs on a CPU tensor) must give the
per-request (latency, hit) of the numpy walkers in service order, exactly.
Tier: exact (all integer arithmetic)."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops
from repro.kernels.bank_sched import candidate_times as ref_candidate_times
from repro.memsim import reference as ref_reference
from repro.memsim import sim as ref_sim
from repro_torch.kernels import ops
from repro_torch.kernels.bank_sched import (OUTPUTS, _launch, candidate_times,
                                            memsim_walk, memsim_walk_ref,
                                            walk_route)
from repro_torch.memsim import reference, sim

Q, B, R, C = 8, 16, 2, 2
FLAGS = list(itertools.product([False, True], [False, True]))


def _state(rng, Q=Q, B=B, R=R, C=C):
    """A random (queue, bank state) pair, as tests/test_memsim.py:27 draws."""
    return (rng.integers(0, B, Q).astype(np.int32),          # q_bank
            rng.integers(0, 50, Q).astype(np.int32),         # q_row
            rng.integers(0, 2, Q).astype(np.int32),          # q_write
            rng.integers(0, 400, Q).astype(np.int32),        # q_arrive
            rng.integers(0, 2, Q).astype(bool),              # q_valid
            rng.integers(-1, 50, B).astype(np.int32),        # open_row
            rng.integers(0, 500, B).astype(np.int32),        # ready
            rng.integers(-100, 500, B).astype(np.int32),     # pre_ready
            rng.integers(0, 500, C).astype(np.int32),        # bus_ready
            rng.integers(-100, 400, R).astype(np.int32),     # last_act
            rng.integers(-100, 400, R).astype(np.int32),     # faw_old
            np.int32(rng.integers(0, 400)),                  # t_now
            rng.integers(4, 30, (B, 6)).astype(np.int32),    # tc
            (np.arange(B) % R).astype(np.int32),             # bank_rank
            (np.arange(B) % C).astype(np.int32))             # bank_chan


@pytest.mark.parametrize("trial", range(3))
@pytest.mark.parametrize("use_bus,use_act", FLAGS)
def test_candidate_times_equals_reference_numpy_pallas_and_torch(
        use_bus, use_act, trial):
    args = _state(np.random.default_rng(trial))
    kw = dict(tbl=4, trrd=5, tfaw=24, use_bus=use_bus, use_act=use_act)
    want = ref_candidate_times(*args, xp=np, **kw)
    pallas = ref_ops.bank_sched(*args, pallas=True, **kw)
    host = candidate_times(*args, **kw)
    dev = candidate_times(*(torch.as_tensor(a) for a in args), **kw)
    for name, w, p, h, d in zip(OUTPUTS, want, pallas, host, dev):
        assert np.array_equal(np.asarray(p), w), name
        assert h.dtype == np.int32 and np.array_equal(h, w), name
        assert d.dtype == torch.int32 and np.array_equal(d.numpy(), w), name


@pytest.mark.parametrize("use_bus,use_act", FLAGS)
def test_candidate_times_walk_axis_equals_one_walk_at_a_time(use_bus,
                                                             use_act):
    """With a leading walk axis (the plain walk's batch), each row is the
    unbatched call on that walk's state."""
    rng = np.random.default_rng(7)
    states = [_state(rng) for _ in range(5)]
    kw = dict(tbl=4, trrd=5, tfaw=24, use_bus=use_bus, use_act=use_act)
    stacked = [torch.as_tensor(np.stack([s[i] for s in states]))
               for i in range(13)]
    stacked[11] = stacked[11][:, None]                       # t_now (N, 1)
    got = candidate_times(*stacked, torch.as_tensor(states[0][13]),
                          torch.as_tensor(states[0][14]), **kw)
    for i, s in enumerate(states):
        for name, g, w in zip(OUTPUTS, got, candidate_times(*s, **kw)):
            assert np.array_equal(g[i].numpy(), w), (i, name)


CONFIGS = {
    "default": sim.MemSimConfig(banks=8),
    "one_channel_one_rank": sim.MemSimConfig(banks=8, channels=1, ranks=1),
    "queue4_no_bus": sim.MemSimConfig(banks=8, queue=4, bus=False),
    "inorder": sim.inorder_config(8),
    "queue32": sim.MemSimConfig(banks=8, queue=32),
}


def _ref_config(cfg):
    return ref_sim.MemSimConfig(**{f: getattr(cfg, f) for f in (
        "banks", "ranks", "channels", "queue", "bus", "act_window", "tbl",
        "trrd", "tfaw")})


@pytest.mark.parametrize("n", [1, 5, 300])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_walk_equals_numpy_walkers(name, n):
    """Every (table, trace) walk of one batched call gives the per-request
    (latency, hit) of the port's and the reference's numpy walkers; n = 1
    and 5 are shorter than the queue."""
    cfg = CONFIGS[name]
    traces = [sim.make_trace(sim.WORKLOADS[w], n, cfg.banks, seed=w)
              for w in (0, 2, 3)]
    tables = [sim.STANDARD, np.array([[8.75, 23.75, 8.75, 6.25],
                                      [13.75, 35.0, 13.75, 15.0]])]
    tcs = [sim.timing_cycles_banks(t, cfg.banks) for t in tables]
    lat, hit = memsim_walk(
        torch.as_tensor(np.stack([sim.pack_trace(t) for t in traces])),
        torch.as_tensor(np.stack(tcs)), **sim._walk_kw(cfg))
    assert lat.shape == hit.shape == (2, 3, n) and lat.dtype == torch.int32
    for t, tc in enumerate(tcs):
        for w, tr in enumerate(traces):
            want = reference._walk(tr, tc, cfg)
            ref_want = ref_reference._walk(tr, tc, _ref_config(cfg))
            for k in range(2):
                assert np.array_equal(want[k], ref_want[k])
            assert np.array_equal(lat[t, w].numpy(), want[0]), (t, w)
            assert np.array_equal(hit[t, w].numpy(), want[1]), (t, w)


def _walk_args(n=6, banks=4):
    traces = torch.as_tensor(sim.pack_trace(
        sim.make_trace(sim.WORKLOADS[0], n, banks, seed=0))[None])
    tc = torch.as_tensor(sim.timing_cycles_banks(sim.STANDARD, banks)[None])
    return traces, tc, sim._walk_kw(sim.MemSimConfig(banks=banks))


def test_cpu_walk_takes_plain_version_and_counts_no_launch():
    assert ops.KERNELS["bank_sched"] is memsim_walk
    traces, tc, kw = _walk_args()
    before = memsim_walk.launches
    got = memsim_walk(traces, tc, **kw)
    want = memsim_walk_ref(traces, tc, **kw)
    assert memsim_walk.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad,err,match", [
    (dict(queue=33), ValueError, "queue"),
    (dict(queue=0), ValueError, "queue"),
    (dict(ranks=0), ValueError, "ranks"),
    (dict(traces_dtype=torch.int64), TypeError, "int32"),
    (dict(tc_dtype=torch.int64), TypeError, "int32"),
    (dict(traces_numpy=True), TypeError, "torch"),
    (dict(tc_shape=True), ValueError, "tc"),
    (dict(bank_out_of_range=True), ValueError, "banks"),
    (dict(tc_meta=True), ValueError, "meta"),
    (dict(both_meta=True), ValueError, "cpu or cuda"),
])
def test_walk_wrapper_rejects_what_the_kernel_does_not_take(bad, err, match):
    traces, tc, kw = _walk_args()
    kw.update({k: v for k, v in bad.items() if k in kw})
    if "traces_dtype" in bad:
        traces = traces.to(bad["traces_dtype"])
    if "tc_dtype" in bad:
        tc = tc.to(bad["tc_dtype"])
    if "traces_numpy" in bad:
        traces = traces.numpy()
    if "tc_shape" in bad:
        tc = tc[..., :4]
    if "bank_out_of_range" in bad:
        traces = traces.clone()
        traces[0, 0, 0] = 4
    if "tc_meta" in bad:
        tc = tc.to("meta")
    if "both_meta" in bad:
        traces, tc = traces.to("meta"), tc.to("meta")
    with pytest.raises(err, match=match):
        memsim_walk(traces, tc, **kw)


# ------------------------------------------------------------ route choice

@pytest.mark.parametrize("banks", [4, 16, 32])
@pytest.mark.parametrize("n", [1, 5, 300])
def test_memsim_traces_take_the_fast_route(banks, n):
    traces = sim._stack_traces(n, banks, 0, "cpu")
    assert walk_route(traces, banks, 2, 2) == "fast"
    assert walk_route(traces, banks, 32, 32) == "fast"


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("banks", [8, 16, 40])
def test_every_stacked_trace_has_strictly_increasing_arrivals(banks, seed):
    """The fast kernel's precondition holds for every trace memsim builds:
    arrivals are a cumsum of gaps >= 1."""
    arrive = sim._stack_traces(2000, banks, seed, "cpu")[..., 3]
    assert arrive.shape == (len(sim.WORKLOADS), 2000)
    assert bool((arrive[:, 1:] > arrive[:, :-1]).all())
    assert bool((arrive[:, 0] >= 1).all())


def test_a_decreasing_arrival_takes_the_general_route():
    traces = sim._stack_traces(300, 16, 0, "cpu").clone()
    tied = traces.clone()
    tied[:, 1::2, 3] = tied[:, 0::2, 3]
    assert walk_route(tied, 16, 2, 2) == "fast"      # ties keep the order
    traces[3, 150, 3] = traces[3, 149, 3] - 1
    assert walk_route(traces, 16, 2, 2) == "general"


@pytest.mark.parametrize("banks,ranks,channels",
                         [(33, 2, 2), (16, 33, 2), (16, 2, 33), (512, 64, 64)])
def test_more_than_32_banks_ranks_or_channels_take_the_general_route(
        banks, ranks, channels):
    traces = sim._stack_traces(50, min(banks, 16), 0, "cpu")
    assert walk_route(traces, banks, ranks, channels) == "general"


def test_n_of_2_to_the_25_takes_the_general_route_on_the_shape_alone():
    """The trace index packs into 25 bits; the route is decided from the
    shape, without reading the (here stride-0, unmaterialised) arrivals."""
    big = torch.zeros((1, 1, 4), dtype=torch.int32).expand(1, 2 ** 25, 4)
    assert walk_route(big, 16, 2, 2) == "general"
    assert walk_route(big[:, :2 ** 25 - 1], 16, 2, 2) == "fast"


def test_reset_launches_zeroes_each_route_count():
    memsim_walk.route_launches["fast"] += 3
    memsim_walk.route_launches["general"] += 1
    ops.reset_launches()
    assert memsim_walk.route_launches == {"fast": 0, "general": 0}
    assert ops.launch_counts()["bank_sched"] == 0


def test_launch_rejects_an_unknown_route():
    traces, tc, kw = _walk_args()
    kw.pop("queue")
    with pytest.raises(ValueError, match="route"):
        _launch(traces, tc, 8, route="scan", **kw)
