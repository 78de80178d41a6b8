"""eval_dimms_per_s: DIMMs of a profiled population evaluated per second —
their error-correction exposure with and without DIVA Shuffling (Fig 17)
and their system speedup at their profiled timings (Fig 19) — every DIMM
of the window's rounds over all of the window's time (host clock)."""


def read(run):
    return run.dimms / run.window_s
