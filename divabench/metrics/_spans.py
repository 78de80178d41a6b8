"""The program's ``stream.chunk`` spans of one streamed entry point: the
mean, in ms, of a chunk's host time to its device work's end (the span
waits for the chunk's outputs at close while a trace is recorded)."""


def chunk_ms(run, entry: str):
    durs = [e["dur"] for e in run.spans
            if e.get("name") == "stream.chunk"
            and e.get("args", {}).get("entry") == entry]
    if not durs:
        return None
    return sum(durs) / len(durs) / 1e3
