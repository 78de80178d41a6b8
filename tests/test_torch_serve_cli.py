"""The serving CLI's fleet service (``repro_torch.launch.serve.main
--fleet``) against the reference's ``serve_fleet`` on the CPU: the same
stats keys (less the reference's compile counts), the same path split, a
Prometheus file naming the ingest paths and a trace of the ingest chunks."""
import json

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are small: one intra-op thread runs them as fast and
    leaves the host's cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_cli_fleet_matches_reference_keys(tmp_path):
    """``main(["--fleet", ...])``: the stats keys of the reference's
    ``serve_fleet`` less its ``chunk_compiles``, the Prometheus file names
    the ingest paths, the trace holds the ingest chunks' spans."""
    from repro.launch.serve import serve_fleet as ref_serve_fleet
    from repro_torch.launch.serve import main
    metrics, trace = tmp_path / "m.prom", tmp_path / "t.json"
    stats = main(["--fleet", "64", "--chunk", "32", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck"),
                  "--metrics-out", str(metrics), "--trace-out", str(trace)])
    want = ref_serve_fleet(64, 32)
    want["metrics"].pop("chunk_compiles")
    assert sorted(stats) == sorted(want)
    assert sorted(stats["metrics"]) == sorted(want["metrics"])
    for key in ("ingested", "hits", "misses", "conventional",
                "n_generations"):
        assert stats[key] == want[key], key
    text = metrics.read_text()
    sid = stats["metrics"]["server"]
    for path, key in (("hit", "hits"), ("discover", "misses"),
                      ("conventional", "conventional")):
        assert (f'repro_serve_ingest_total{{server="{sid}",path="{path}"}} '
                f'{stats[key]}\n') in text
    events = json.loads(trace.read_text())["traceEvents"]
    assert sum(e["name"] == "serve.ingest_chunk" for e in events) == 2
    assert (tmp_path / "ck" / "step_0" / "meta.json").exists()
