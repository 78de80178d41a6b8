"""stream_chunk_ms.summary: mean ms of the program's ``stream.chunk`` span
of ``stream_error_summary`` in the traced window."""
from divabench.metrics._spans import chunk_ms


def read(run):
    return chunk_ms(run, "stream_error_summary")
