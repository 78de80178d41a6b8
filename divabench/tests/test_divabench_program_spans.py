"""The readers of the program's stage spans on hand-built span lists, None
where the program records no such span; and one card-only case: on a CUDA
profile, ``trace.summarize`` counts no program range as a kernel or as busy
time, and names the device's idle time by the program stage around it."""
import time
from types import SimpleNamespace

import pytest
import torch

from divabench import harness


def _read(name, spans):
    return harness.metric_reader(name)(SimpleNamespace(spans=spans))


def _ev(name, id_, parent, dur_us, **args):
    return {"name": name, "ph": "X", "ts": 0.0, "dur": float(dur_us),
            "id": id_, "parent": parent, "args": args}


def _call(entry, call_id, chunks, host_us, points=()):
    """One ``stream.call`` of ``entry`` over chunks at ``chunks`` (their
    first DIMMs): each host stage ``host_us`` µs, the device program 10 ms,
    and under it one ``sweep.param`` a walk of ``points``."""
    out, nid = [], call_id + 1
    for lo in chunks:
        chunk = [call_id, lo]         # as JSON gives it back: a list
        for stage in ("stream.lower", "stream.prep"):
            out.append(_ev(stage, nid, call_id, host_us, chunk=chunk))
            nid += 1
        cid = nid
        out.append(_ev("stream.chunk", cid, call_id, 10_000.0, entry=entry,
                       chunk=chunk))
        nid += 1
        for p in points:
            out.append(_ev("sweep.param", nid, cid, 100.0, param="trcd",
                           points=p, chunk=chunk))
            nid += 1
        for stage in ("stream.readback", "stream.fold"):
            out.append(_ev(stage, nid, call_id, host_us, chunk=chunk))
            nid += 1
    out.append(_ev("stream.call", call_id, None, 1.0, entry=entry,
                   n_chunks=len(chunks)))
    return out


def test_stream_host_ms_sums_a_chunks_host_stages():
    spans = (_call("stream_profile", 1, [0, 1024], 500.0, (4, 7, 3, 5))
             + _call("stream_error_summary", 100, [0], 2_000.0)
             + _call("stream_profile", 200, [0], 1_000.0, (3, 7, 3, 5)))
    # profile: chunks of 4 x 0.5 ms, 4 x 0.5 ms and 4 x 1 ms
    assert _read("stream_host_ms.profile", spans) == pytest.approx(
        (2.0 + 2.0 + 4.0) / 3)
    assert _read("stream_host_ms.summary", spans) == pytest.approx(8.0)


def test_sweep_points_per_chunk_sums_a_chunks_walks():
    spans = (_call("stream_profile", 1, [0, 1024], 500.0, (4, 7, 3, 5))
             + _call("stream_profile", 200, [0], 500.0, (3, 7, 3, 4))
             + _call("stream_error_summary", 300, [0], 500.0, (99,)))
    assert _read("sweep_points_per_chunk.profile", spans) == pytest.approx(
        (19 + 19 + 17) / 3)


@pytest.mark.parametrize("name", ["stream_host_ms.profile",
                                  "stream_host_ms.summary",
                                  "sweep_points_per_chunk.profile"])
def test_no_span_reads_none(name):
    assert _read(name, []) is None
    # a program that records only ``stream.chunk`` (no stages, no chunk
    # ids, no walks): none of the three reads anything
    only_chunks = [{"name": "stream.chunk", "ph": "X", "ts": 0.0,
                    "dur": 9e4, "args": {"entry": e}}
                   for e in ("stream_profile", "stream_error_summary")]
    assert _read(name, only_chunks) is None
    other = _call("stream_lifetime", 1, [0], 500.0, (4,))
    assert _read(name, other) is None


@pytest.mark.cuda
def test_program_ranges_are_neither_kernels_nor_busy_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    from divabench.trace import WINDOW, summarize
    from repro_torch import obs
    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 22, device=dev)
    x.mul_(1.0)
    torch.cuda.synchronize(dev)
    n_chunks, n_ops, sleep_s = 5, 20, 0.02

    def window(traced: bool):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if traced:
                obs.start_tracing()
            with record_function(WINDOW):
                for lo in range(n_chunks):
                    chunk = (0, lo)
                    with obs.span_if_active("stream.prep", chunk=chunk):
                        time.sleep(sleep_s)   # host time the card idles
                    with obs.span_if_active("stream.chunk", entry="e",
                                            chunk=chunk) as sp:
                        for _ in range(n_ops):
                            x.mul_(1.0)
                        sp.bind(x)
                torch.cuda.synchronize(dev)
            events = obs.stop_tracing() if traced else []
        return summarize(prof), prof, events

    plain, _, _ = window(False)
    traced, prof, events = window(True)
    assert plain.kernel_launches == traced.kernel_launches == n_chunks * n_ops
    assert not any(s in name for name in traced.by_symbol
                   for s in ("stream.prep", "stream.chunk"))
    kernel_s = sum(s for _, s in traced.by_symbol.values())
    assert traced.busy_s <= kernel_s * (1 + 1e-6)
    assert traced.idle_gaps.get("stream.prep", 0.0) >= 0.8 * n_chunks * sleep_s
    assert "stream.prep" not in plain.idle_gaps
    # the spans sit on the profiler's clock
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "stream.prep"
                    and e.device_type() == torch.autograd.DeviceType.CPU)
    spans = sorted(e["ts"] * 1e3 for e in events if e["name"] == "stream.prep")
    assert len(starts) == len(spans) == n_chunks
    assert max(abs(a - b) for a, b in zip(starts, spans)) < 0.5e6
