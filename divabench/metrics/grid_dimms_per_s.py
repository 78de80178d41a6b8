"""grid_dimms_per_s: DIMMs whose per-row expected error counts were
computed from their failure grids, per second — every DIMM of the window's
rounds over all of the window's time (host clock)."""


def read(run):
    return run.dimms / run.window_s
