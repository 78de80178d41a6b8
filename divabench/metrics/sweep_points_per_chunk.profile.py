"""sweep_points_per_chunk.profile: timing-grid points the profiling sweep
evaluated a ``stream_profile_population`` chunk in the traced window (the
program's ``sweep.param`` spans): each is one host sync of the sweep's
early exit, which a fused or captured sweep would cut."""
from divabench.metrics._stages import sweep_points


def read(run):
    return sweep_points(run, "stream_profile")
