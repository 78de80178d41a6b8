"""setup_s: seconds from the process's start to the window's start —
imports, CUDA's start, the inputs made from the seed, the program's objects,
kernel builds and the launch tuner's sweeps, one warm-up unit (host
clock)."""


def read(run):
    return run.setup_s
