"""sweep_launches_per_dimm: kernels launched on the card in the traced
window (copies and fills left out) per DIMM profiled — the profiling
sweep's eager operations, which a fused sweep would cut."""


def read(run):
    if run.trace is None or not run.trace.kernel_launches:
        return None
    return run.trace.kernel_launches / run.dimms
