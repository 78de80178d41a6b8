"""stream_chunk_ms.profile: mean ms of the program's ``stream.chunk`` span
of ``stream_profile_population`` in the traced window."""
from divabench.metrics._spans import chunk_ms


def read(run):
    return chunk_ms(run, "stream_profile")
