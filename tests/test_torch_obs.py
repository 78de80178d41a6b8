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
