"""Port parity of the observability layer (``repro_torch.obs``) against
``repro.obs``: the same sequence of counter, gauge and histogram operations
gives identical Prometheus text and snapshots in both packages, spans record
the same trace events, a span bound to CPU tensors never touches CUDA, and
instrumentation leaves the fleet server's results as they were, on the
CPU."""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as robs
from repro.obs.metrics import Registry as RRegistry
from repro_torch import obs
from repro_torch.core import streaming as tst
from repro_torch.core.geometry import TINY
from repro_torch.core.population import synthetic_fleet
from repro_torch.obs import tracing
from repro_torch.obs.metrics import Registry
from repro_torch.serve import FleetConfig, FleetServer

D, CHUNK = 12, 5             # 5 does not divide 12: a ragged tail


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(reg):
    """One sequence of registry operations, every kind and edge."""
    c = reg.counter("repro_test_events_total", "events", ("path", "server"))
    c.labels(path="hit", server="0").inc(3)
    c.labels(path="conventional", server="0").inc()
    c.labels(path="hit", server="1").inc(2.5)
    plain = reg.counter("repro_test_total", "plain")
    plain.inc()
    g = reg.gauge("repro_test_age_years", "age", ("server",))
    g.labels(server="0").set(2.5)
    g.labels(server="0").dec(0.75)
    h = reg.histogram("repro_test_lat_seconds", "lat", ("server",),
                      buckets=(1e-3, 0.1, 1.0))
    for v in (5e-4, 0.05, 0.05, 3.0, 1e-3):
        h.labels(server="0").observe(v)
    d = reg.histogram("repro_test_default_seconds", "default buckets")
    for v in (1e-5, 0.3, 42.0, 1e3):
        d.observe(v)
    reg.enabled = False
    plain.inc(100)
    d.observe(7.0)
    reg.enabled = True
    reg.gauge("repro_test_unset")
    return reg


def test_registry_text_and_snapshot_match_reference():
    got, want = _drive(Registry()), _drive(RRegistry())
    assert got.prometheus_text() == want.prometheus_text()
    assert json.dumps(got.snapshot(), sort_keys=True) \
        == json.dumps(want.snapshot(), sort_keys=True)
    for name, kw in (("repro_test_lat_seconds", {"server": "0"}),
                     ("repro_test_default_seconds", {})):
        a, b = got.value(name, **kw), want.value(name, **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k]))
    for q in (0.0, 10.0, 50.0, 99.0, 100.0):
        assert got.get("repro_test_default_seconds").percentile(q) \
            == want.get("repro_test_default_seconds").percentile(q)
    got.reset()
    want.reset()
    assert got.prometheus_text() == want.prometheus_text()
    with pytest.raises(ValueError):
        got.gauge("repro_test_total")              # kind clash
    with pytest.raises(ValueError):
        got.counter("has-dash")


def _spans(mod):
    mod.start_tracing()
    try:
        with mod.span("test.outer", key="v", n=3) as sp:
            with mod.span("test.inner"):
                pass
            sp.set(extra=1.5)
        with mod.span("test.timed", hist=mod.Registry().histogram(
                "repro_test_span_seconds")):
            pass
    finally:
        events = mod.stop_tracing()
    with mod.span("test.after_stop"):                 # not collected
        pass
    return events


def test_trace_events_match_reference(tmp_path):
    got, want = _spans(obs), _spans(robs)
    strip = lambda evs: [{k: e[k] for k in ("name", "ph", "cat", "args")}
                         for e in evs]
    assert strip(got) == strip(want)
    assert [e["name"] for e in got] == ["test.inner", "test.outer",
                                        "test.timed"]
    for e in got:
        assert e["dur"] >= 0 and {"ts", "pid", "tid"} <= set(e)
    path = tmp_path / "trace.json"
    assert obs.write_chrome_trace(path) == str(path)
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"] == got
    assert obs.chrome_trace()["traceEvents"] == got


def test_span_bound_to_cpu_tensors_does_not_synchronize(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("a CPU span synchronized CUDA")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    bound = {"a": torch.zeros(3), "b": [torch.ones(2), (np.zeros(2), 4)]}
    with obs.span("test.cpu") as sp:
        sp.bind(bound)
    assert sp.duration_s >= 0 and sp._bound is None
    with obs.span("test.numpy") as sp:
        sp.bind(np.arange(4))
    assert tracing._cuda_devices(bound, set()) == set()
    meta = torch.empty(2, device="meta")
    assert tracing._cuda_devices([meta, {"x": meta}], set()) == set()


def test_enable_disable_and_peak_rss():
    assert obs.enabled()
    obs.disable()
    try:
        assert not obs.enabled() and not obs.REGISTRY.enabled
    finally:
        obs.enable()
    assert obs.enabled()
    assert obs.peak_rss_mb() > 1.0


def _serve_disabled_then_traced():
    out = []
    for traced in (False, True):
        if traced:
            obs.start_tracing()
        else:
            obs.disable()
        try:
            server = FleetServer(synthetic_fleet(D, TINY, seed=3,
                                                 device="cpu"),
                                 FleetConfig(chunk_size=CHUNK))
            server.ingest(now=0.0)
        finally:
            if traced:
                events = obs.stop_tracing()
            else:
                obs.enable()
        out.append(server)
    return out, events


def test_instrumentation_leaves_the_server_as_it_was():
    (off, on), events = _serve_disabled_then_traced()
    for field in ("serial", "table", "label", "path", "due_at"):
        np.testing.assert_array_equal(off.state.view(field),
                                      on.state.view(field))
    names = {e["name"] for e in events}
    assert {"serve.ingest_chunk", "stream.chunk"} <= names
    assert sum(e["name"] == "serve.ingest_chunk" for e in events) \
        == -(-D // CHUNK)
    # the streaming counters move at each chunk call
    before = obs.REGISTRY.value("repro_stream_chunks_total",
                                entry="stream_campaign")
    stats = on.ingest(now=0.0)                        # nothing left: no-op
    assert stats["ingested"] == 0
    assert obs.REGISTRY.value("repro_stream_chunks_total",
                              entry="stream_campaign") == before
    tst.hash_poisson_counts(on.stream.chunk(0, 2), "trp", 7.5)
    assert obs.REGISTRY.value("repro_stream_chunks_total",
                              entry="stream_campaign") == before + 1
    # metrics(): the serve layer's block, per server
    on.query(0)
    on.query_batch(np.asarray([1, 3, 3, 7]))
    met = on.metrics()
    assert met["queries"] == 5 and met["query_latency_seconds"]["count"] == 2
    assert met["ingested"] == D and "chunk_compiles" not in met
    assert met["paths"] == {k: int(obs.REGISTRY.value(
        "repro_serve_ingest_total", server=met["server"], path=k))
        for k in ("hit", "discover", "conventional")}
    assert off.metrics()["server"] != met["server"]


# ------------------------------------------------- the tracer on the profiler

def _profiler_ranges(prof, names) -> list:
    """(name, start ns) of the profiler's host ranges named in ``names``, in
    start order."""
    return sorted(((e.name(), e.start_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda r: r[1])


def test_span_shares_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        obs.start_tracing()
        try:
            for i in range(5):
                with obs.span("test.clock", i=i):
                    with obs.span("test.clock_inner"):
                        torch.ones(64).sum()
        finally:
            events = obs.stop_tracing()
    ranges = _profiler_ranges(prof, {"test.clock", "test.clock_inner"})
    spans = sorted(((e["name"], e["ts"] * 1e3) for e in events),
                   key=lambda r: r[1])
    assert [n for n, _ in ranges] == [n for n, _ in spans]
    assert len(spans) == 10
    for (_, r0), (_, s0) in zip(ranges, spans):
        assert abs(s0 - r0) < 0.5e6                   # 0.5 ms, in ns
    inner = [e for e in events if e["name"] == "test.clock_inner"]
    outer = {e["id"]: e for e in events if e["name"] == "test.clock"}
    assert len(outer) == 5 and all(e["parent"] is None
                                   for e in outer.values())
    for e in inner:
        up = outer[e["parent"]]
        assert up["ts"] <= e["ts"] and e["ts"] + e["dur"] <= up["ts"] \
            + up["dur"]


STAGES = ("stream.lower", "stream.prep", "stream.chunk", "stream.readback",
          "stream.fold")


def _tiny_batch(n=5):
    from repro_torch.core.population import make_population
    from repro_torch.core.substrate import DimmBatch
    return DimmBatch.from_population(make_population(TINY, n), device="cpu")


def _summary(batch):
    return tst.stream_error_summary(batch, "tras", 25.0, chunk_size=2,
                                    vdd=1.2, retention=True,
                                    collect_fail_maps=True)


def _profile(batch):
    return tst.stream_profile_population(batch, chunk_size=2, collect=True)


ENTRIES = {"stream_error_summary": _summary, "stream_profile": _profile}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_stream_stages_link_by_parent_and_chunk(entry):
    batch = _tiny_batch()
    obs.start_tracing()
    try:
        ENTRIES[entry](batch)
    finally:
        events = obs.stop_tracing()
    (call,) = [e for e in events if e["name"] == "stream.call"]
    assert call["parent"] is None
    assert call["args"] == {"entry": entry, "n_chunks": 3}
    stages = [e for e in events if e["name"] in STAGES]
    assert len(stages) == 3 * len(STAGES)
    assert all(e["parent"] == call["id"] for e in stages)
    by_chunk: dict = {}
    for e in stages:
        by_chunk.setdefault(e["args"]["chunk"], []).append(e["name"])
    assert sorted(by_chunk) == [(call["id"], lo) for lo in (0, 2, 4)]
    for names in by_chunk.values():
        assert names == list(STAGES)                  # closed in order
    ids = [e["id"] for e in events]
    assert len(set(ids)) == len(ids)
    chunks = {e["id"]: e for e in stages if e["name"] == "stream.chunk"}
    assert all(e["args"]["entry"] == entry for e in chunks.values())
    walks = [e for e in events if e["name"] == "sweep.param"]
    if entry == "stream_profile":
        assert len(walks) == 3 * 4                    # four timings a chunk
        for e in walks:
            assert e["args"]["chunk"] == chunks[e["parent"]]["args"]["chunk"]
    else:
        assert walks == []


@pytest.mark.parametrize("axes", [None, ("trcd", "tras", "trp", "twr",
                                         "vdd", "refresh")])
def test_sweep_points_count_the_walk(monkeypatch, axes):
    from repro_torch.core import substrate as tsub
    walked = {"n": 0}
    for fn in ("_region_eval", "_op_region_eval"):
        real = getattr(tsub, fn)

        def counted(*a, _real=real, **kw):
            walked["n"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tsub, fn, counted)
    kw = {} if axes is None else {"axes": axes, "vdd": 1.25}
    obs.start_tracing()
    try:
        tst.stream_profile_population(_tiny_batch(), chunk_size=2, **kw)
    finally:
        events = obs.stop_tracing()
    walks = [e for e in events if e["name"] == "sweep.param"]
    assert len(walks) == 3 * (4 if axes is None else 6)
    assert sum(e["args"]["points"] for e in walks) == walked["n"] > 0
    if axes is not None:
        assert {e["args"]["param"] for e in walks} == set(axes)


def test_no_event_outside_a_recording():
    from torch.profiler import ProfilerActivity, profile
    obs.start_tracing()
    obs.stop_tracing()                                # an empty buffer
    batch = _tiny_batch(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.outside") as sp:
            _profile(batch)
            _summary(batch)
    assert sp.id is None and sp.duration_s > 0
    assert obs.trace_events() == []
    names = {"test.outside", "sweep.param", "stream.call", *STAGES}
    assert _profiler_ranges(prof, names) == []
    with obs.span_if_active("test.off") as off:
        assert off.set(points=1).bind(torch.zeros(1)) is off
    assert off.id is None and obs.trace_events() == []


def _outputs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _outputs_equal(a[k], b[k])
        elif k == "fail_maps":
            for x, y in zip(a[k], b[k], strict=True):
                np.testing.assert_array_equal(x.bits, y.bits)
                assert x.shape == y.shape
        else:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_bit_identical_with_recording_on_and_off(entry):
    batch = _tiny_batch()
    off = ENTRIES[entry](batch)
    obs.start_tracing()
    try:
        on = ENTRIES[entry](batch)
    finally:
        events = obs.stop_tracing()
    assert events
    _outputs_equal(off, on)
