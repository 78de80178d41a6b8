"""DIVA-DRAM core on PyTorch: the main path of the reference's ``repro.core``,
module for module (timing, geometry, latency, hashing, errors, population,
substrate, profiling)."""
