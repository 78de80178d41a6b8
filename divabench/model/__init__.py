"""Frozen copies of the port's host model (geometry, timing, latency,
hashing), kept with the benchmark so that its inputs and its plain
reference depend on nothing of the program."""
