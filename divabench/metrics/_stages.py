"""The program's stage spans of one streamed entry point, grouped by chunk.

While a trace is recorded, the program's chunk loop records each
``stream_*`` call as a ``stream.call`` span (``entry``) and each chunk's
stages under it: ``stream.lower``, ``stream.prep``, ``stream.chunk``,
``stream.readback`` and ``stream.fold``, each with ``chunk`` = (the call's
span id, the chunk's first DIMM).  The profiling sweep records each walk of
a timing grid as a ``sweep.param`` span with the grid ``points`` it
evaluated, under its chunk.  A program without these spans reads None.
"""

# the host stages around a chunk's device program (``stream.chunk``)
HOST_STAGES = ("stream.lower", "stream.prep", "stream.readback",
               "stream.fold")


def _args(e) -> dict:
    return e.get("args") or {}


def _chunk(e):
    c = _args(e).get("chunk")
    return tuple(c) if c is not None else None


def host_ms(run, entry: str):
    """Mean over the window's chunks of ``entry`` of the summed durations of
    their host stages, in ms."""
    calls = {e.get("id") for e in run.spans if e.get("name") == "stream.call"
             and _args(e).get("entry") == entry}
    per_chunk: dict = {}
    for e in run.spans:
        c = _chunk(e)
        if e.get("name") in HOST_STAGES and c is not None and c[0] in calls:
            per_chunk[c] = per_chunk.get(c, 0.0) + e["dur"]
    if not per_chunk:
        return None
    return sum(per_chunk.values()) / len(per_chunk) / 1e3


def sweep_points(run, entry: str):
    """Mean over the window's chunks of ``entry`` (its ``stream.chunk``
    spans) of the summed ``points`` of their ``sweep.param`` spans: grid
    points walked a chunk, each one host sync."""
    chunks = {_chunk(e) for e in run.spans if e.get("name") == "stream.chunk"
              and _args(e).get("entry") == entry} - {None}
    walks = [e for e in run.spans if e.get("name") == "sweep.param"
             and _chunk(e) in chunks]
    if not walks:
        return None
    return sum(int(_args(e)["points"]) for e in walks) / len(chunks)
