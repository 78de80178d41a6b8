"""summary_dimms_per_s: DIMMs of the fleet whose failure grids were
computed and summarized per second — every DIMM of the window's chunks over
all of the window's time (host clock)."""


def read(run):
    return run.dimms / run.window_s
