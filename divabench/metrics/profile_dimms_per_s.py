"""profile_dimms_per_s: DIMMs given a DIVA timing table per second — every
DIMM the window's chunks profiled over all of the window's time (host
clock; the window ends with the chunk that crosses its length)."""


def read(run):
    return run.dimms / run.window_s
